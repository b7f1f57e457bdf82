"""Fault-tolerant replicated serving tier (DESIGN.md §10).

Counterpart of the reference package's ``serving/replica.py``: the same
routing, retries, hedging, shard merge and breaker-gated ejection over
sessions of the port, on the ``BreakerCore`` of ``core.guardrails``.
The replicas are dispatched one after another in one process, as in the
reference: a batch's wall is virtual (the slowest shard's, or the hedge
race's winner), while each replica's own dispatch ends in its search's
device-to-host copy, so its measured wall includes its device time.  On
one card every replica holds its own layout, graphs and pools.

A replica may be a mesh session (``launch.mesh``, one process a rank).
Every rank then builds the same sessions in the same order and the same
``ReplicatedService``; rank 0 drives it and every other rank calls
``follow()`` (``serving.search_service``).  Routing, retries, hedges,
breakers, the timer and the fault hooks of the tier run on rank 0
alone; each dispatch that reaches a mesh replica's device, and each
add it applies, is first broadcast with the replica's index, so the
followers make the same sequence of mesh walks.  A replica that the
fault plan kills fails before the broadcast, and a search that fails on
any rank fails on all (``torch_engine.MeshSearchError``), which rank 0
counts as that replica's failure.  A one-card replica in the same tier
is searched on rank 0 alone.

The paper's verdict — DCO performance is unstable across hardware and
workloads — lands hardest in the deployment the "Bang for the Buck"
follow-up measures: noisy multi-tenant cloud hosts, where slow and dead
replicas are the norm rather than the exception.  Deadlines, shedding,
the WAL and the drift breaker harden a *single* session; this module
is the layer above it: ``ReplicatedService`` wraps R replica
``SearchSession``\\ s behind the exact submit/step/drain/health ticket
lifecycle of ``SearchService`` and turns replica faults into bounded,
*flagged* degradation instead of wrong answers or hung requests.

Two layouts, one service:

``mode="replicate"``
    every replica holds the full corpus.  Batches route round-robin over
    healthy replicas; a failed dispatch **retries** on a different replica
    under capped exponential backoff with deterministic jitter (injectable
    RNG), and a slow primary is **hedged** — when its measured wall
    exceeds an adaptive delay derived from the fleet's best windowed-p99
    EWMA, the batch is re-dispatched to another healthy replica and the
    first (virtual-timeline) finisher wins, with hedge-rate and win/loss
    telemetry in ``health()``.

``mode="shard"``
    each replica holds a contiguous row range (the partition-major layout
    lifted to whole sessions); every batch fans out to all live
    shards and the per-shard top-k merge re-bases local ids by the shard's
    row offset.  When a shard stays dead through its retries, the batch is
    answered from the *surviving* shards — the anytime semantics
    extended from temporal to spatial partial coverage: per-query
    ``coverage`` becomes the fraction of corpus rows actually visited,
    every query's exactness certificate is withdrawn via
    ``uncertified_mask`` (an unvisited shard may hold a true neighbor),
    and the batch is flagged ``degraded`` in its stats and counted in
    ``health()`` — while the accounting invariant
    ``submitted == completed + shed + timeouts + failures + pending``
    holds exactly (degraded completions are completions).

Health-gated routing reuses the guardrail's breaker state machine
(``core.guardrails.BreakerCore``) per replica: ``eject_after`` consecutive
dispatch failures flip a replica closed -> open (ejected from routing);
after ``probe_after`` quiet rounds it goes half_open and is probed with
real traffic; ``promote_after`` consecutive probe successes re-admit it
(closed), one failure re-ejects it.  When *every* replica is ejected the
service keeps probing rather than refusing — and only when all retries
against all replicas fail does the batch fail (the ticket lifecycle
absorbs it as ``status="failed"``; the service survives).

Timing is *virtual* where it must be replay-exact: backoff and hedge
delays are charged to the batch's service wall (the same simulated
timeline a discrete-event driver replays Poisson arrivals on) rather than
slept, the hedge race is resolved on measured walls
(``min(primary, delay + secondary)``), and both the jitter RNG and the
per-dispatch timer are injectable — two chaos runs with the same seeds
and timer produce identical routing, hedging, and timelines.  Pass
``sleeper=time.sleep`` to make live-mode backoff actually wait.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.engine import (EXTRA_COVERAGE, EXTRA_DEGRADED,
                                     EXTRA_HEDGED, EXTRA_REPLICA,
                                     EXTRA_UNCERTIFIED_MASK,
                                     EXTRA_UNCERTIFIED_QUERIES, ScanStats)
from repro_torch.core.guardrails import BreakerCore
from repro_torch.serving.search_service import (FOLLOW_COUNTS, SearchService,
                                                _mesh_roles, _MeshChannel,
                                                spans_ranks)
from repro_torch.testing import faults

REPLICA_MODES = ("replicate", "shard")


class ReplicaDispatchError(RuntimeError):
    """Every routable replica (or every shard) failed a batch, retries
    included.  Carries ``wall_s`` — the virtual time the failed attempts
    consumed — so the serving loop charges the failure honestly."""

    def __init__(self, msg: str, wall_s: float = 0.0):
        super().__init__(msg)
        self.wall_s = float(wall_s)


@dataclasses.dataclass(frozen=True)
class ReplicaPolicy:
    """Static knobs of the replicated tier (frozen: safe to share).

    ``max_retries``       extra dispatch attempts per batch after the
                          first fails (replicate: each on a different
                          replica; shard: against the same shard).
    ``backoff_base_s``    backoff before retry attempt i is
                          ``min(cap, base * 2**(i-1)) * (1 + jitter*u)``,
                          u ~ U[0,1) from the injectable RNG — capped
                          exponential with deterministic jitter.
    ``backoff_cap_s``     the cap above.
    ``jitter``            the jitter fraction above (0 = none).
    ``hedge``             arm hedged requests (replicate mode only).
    ``hedge_factor``      hedge when the primary's wall exceeds
                          ``hedge_factor * min windowed-p99 EWMA`` over
                          routable replicas — adaptive: a uniformly slow
                          fleet hedges rarely, one straggler hedges often.
    ``hedge_min_delay_s`` floor on that adaptive delay (keeps cold-start
                          p99 estimates from hedging everything).
    ``eject_after``       consecutive dispatch failures before a replica
                          is ejected (closed -> open).
    ``probe_after``       quiet rounds an ejected replica waits before
                          half-open probing begins.
    ``promote_after``     consecutive successful probes before
                          re-admission (half_open -> closed).
    ``seed``              jitter RNG seed (replay-exact chaos runs).
    """

    max_retries: int = 2
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 0.5
    jitter: float = 0.25
    hedge: bool = True
    hedge_factor: float = 2.0
    hedge_min_delay_s: float = 0.005
    eject_after: int = 2
    probe_after: int = 3
    promote_after: int = 2
    seed: int = 0


class ReplicaState:
    """One replica's runtime: its session, its row range, its breaker, and
    its latency/outcome telemetry (the ``health()`` per-replica row)."""

    def __init__(self, idx: int, session: SearchSession, id_offset: int = 0):
        self.idx = idx
        self.session = session
        self.id_offset = int(id_offset)   # global id of the shard's row 0
        self.rows = int(session.n)        # rows this replica serves
        self.on_mesh = spans_ranks(session)   # its calls are broadcast
        self.breaker = BreakerCore()
        self.consecutive_failures = 0
        self.promote_streak = 0           # successes while half_open
        self.dispatches = 0
        self.served = 0
        self.failures = 0
        self.probes = 0                   # dispatches served while half_open
        self.rounds = 0                   # routing rounds observed
        self._lat_window: deque = deque(maxlen=64)
        self.p99_ewma: float | None = None

    @property
    def state(self) -> str:
        return self.breaker.state

    def observe(self, wall: float) -> None:
        """Fold one successful dispatch wall into the windowed p99 EWMA
        (the hedge-delay input)."""
        self._lat_window.append(float(wall))
        w = sorted(self._lat_window)
        p99 = w[min(len(w) - 1, int(0.99 * len(w)))]
        self.p99_ewma = (p99 if self.p99_ewma is None
                         else 0.8 * self.p99_ewma + 0.2 * p99)

    def report(self) -> dict:
        """The per-replica ``health()`` row."""
        return {
            "idx": self.idx,
            "state": self.state,
            "rows": self.rows,
            "id_offset": self.id_offset,
            "p99_ewma_s": self.p99_ewma,
            "dispatches": self.dispatches,
            "served": self.served,
            "failures": self.failures,
            "consecutive_failures": self.consecutive_failures,
            "probes": self.probes,
            "transitions": list(self.breaker.transitions),
        }


class ReplicatedService(SearchService):
    """R-replica serving front behind the ``SearchService`` lifecycle.

    Construction takes the replica sessions (same D; ``mode="shard"``
    additionally assumes they partition one corpus in contiguous row
    ranges — use :func:`open_replicated` to build both layouts from a
    single corpus).  All ``SearchService`` knobs (slots/k/max_queue/
    admission/deadline_s/clock) apply unchanged; the tier only overrides
    *dispatch* — routing, retries, hedging, fan-out/merge — plus ``add()``
    (write fan-out) and ``health()`` (replica telemetry).

    ``rng`` injects the jitter RNG (default: seeded from the policy);
    ``timer`` injects a per-dispatch wall override ``timer(replica_idx,
    measured_wall) -> wall`` so chaos tests replace measured time with a
    deterministic timeline; ``sleeper`` (e.g. ``time.sleep``) makes
    live-mode backoff actually wait instead of only charging the virtual
    wall.
    """

    def __init__(self, sessions, *, mode: str = "replicate",
                 replica_policy: ReplicaPolicy | None = None,
                 rng=None, timer=None, sleeper=None, **kwargs):
        sessions = list(sessions)
        if not sessions:
            raise ValueError("ReplicatedService needs at least one session")
        if mode not in REPLICA_MODES:
            raise ValueError(
                f"mode must be one of {REPLICA_MODES}, got {mode!r}")
        dims = {int(s.dim) for s in sessions}
        if len(dims) != 1:
            raise ValueError(
                f"replica sessions disagree on D: {sorted(dims)}")
        super().__init__(sessions[0], **kwargs)
        # any replica on the mesh opens the channel, not only the first
        self.rank, self._channel = _mesh_roles(sessions)
        self.mode = mode
        self.rpolicy = replica_policy or ReplicaPolicy()
        self._rng = rng if rng is not None \
            else np.random.default_rng(self.rpolicy.seed)
        self._timer = timer
        self._sleeper = sleeper
        offsets = np.cumsum([0] + [int(s.n) for s in sessions[:-1]])
        self.replicas = [
            ReplicaState(i, s, offsets[i] if mode == "shard" else 0)
            for i, s in enumerate(sessions)]
        self._rr = 0                      # round-robin cursor
        # tier counters (health(); accounting stays the base invariant)
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.hedge_losses = 0
        self.degraded = 0                 # completed requests with lost shards

    # -- routing -------------------------------------------------------------
    def _tick_round(self) -> None:
        """One routing round: every breaker dwells one step, and ejected
        replicas that served their ``probe_after`` quiet rounds move to
        half_open (probed with real traffic from the next pick on)."""
        for rs in self.replicas:
            rs.rounds += 1
            rs.breaker.tick()
            if rs.state == "open" \
                    and rs.breaker.dwell >= self.rpolicy.probe_after:
                rs.breaker.transition("half_open", "probe window open",
                                      at=rs.rounds)

    def _pick(self, exclude=()) -> ReplicaState | None:
        """Next replica to try: round-robin over routable replicas —
        closed and half_open alike, so probes ride real traffic instead of
        starving behind healthy peers — then, desperation (all ejected),
        the open replica that has waited longest.  ``None`` once
        ``exclude`` covers everyone."""
        order = [self.replicas[(self._rr + j) % len(self.replicas)]
                 for j in range(len(self.replicas))]
        live = [rs for rs in order
                if rs.state != "open" and rs.idx not in exclude]
        if live:
            self._rr = (live[0].idx + 1) % len(self.replicas)
            return live[0]
        left = [rs for rs in self.replicas if rs.idx not in exclude]
        return max(left, key=lambda rs: rs.breaker.dwell) if left else None

    def _backoff(self, attempt: int) -> float:
        """Virtual seconds charged before retry ``attempt`` (1-based):
        capped exponential with deterministic jitter from the injected
        RNG."""
        pol = self.rpolicy
        base = min(pol.backoff_cap_s,
                   pol.backoff_base_s * (2.0 ** (attempt - 1)))
        delay = base * (1.0 + pol.jitter * float(self._rng.random()))
        if self._sleeper is not None:
            self._sleeper(delay)
        return delay

    def _note_failure(self, rs: ReplicaState, exc: Exception) -> None:
        rs.failures += 1
        rs.consecutive_failures += 1
        rs.promote_streak = 0
        if rs.state == "half_open":
            rs.breaker.transition(
                "open", f"probe failed ({type(exc).__name__})", at=rs.rounds)
        elif rs.state == "closed" \
                and rs.consecutive_failures >= self.rpolicy.eject_after:
            rs.breaker.transition(
                "open", f"ejected: {rs.consecutive_failures} consecutive "
                f"failures ({type(exc).__name__})", at=rs.rounds)

    def _note_success(self, rs: ReplicaState, wall: float) -> None:
        rs.served += 1
        rs.consecutive_failures = 0
        rs.observe(wall)
        if rs.state == "half_open":
            rs.probes += 1
            rs.promote_streak += 1
            if rs.promote_streak >= self.rpolicy.promote_after:
                rs.breaker.transition(
                    "closed", f"re-admitted: {rs.promote_streak} probe "
                    "successes", at=rs.rounds)
        elif rs.state == "open":      # desperation probe paid off
            rs.breaker.transition("half_open", "desperation probe succeeded",
                                  at=rs.rounds)

    # -- one replica dispatch ------------------------------------------------
    def _replica_search(self, rs: ReplicaState, Q, deadline_s):
        """One dispatch against one replica: fault hooks first (a dead
        replica fails before touching the device, like a broken
        connection), then the real search — on a mesh replica, after the
        broadcast that makes the other ranks join it.  Returns ``(result,
        wall)``; raisers carry ``wall_s``.  The wall is measured, then
        overridden by the injected ``timer`` (determinism), then charged
        the slow-replica fault stall (virtual, never slept)."""
        plan = faults.active(rs.session.policy)
        rs.dispatches += 1
        t0 = time.perf_counter()
        try:
            faults.check_replica(plan, rs.idx)
            if rs.on_mesh:
                self._channel.send(_MeshChannel.SEARCH, Q, replica=rs.idx,
                                   k=self.k, nprobe=self.nprobe,
                                   deadline_s=deadline_s)
            res = rs.session.search(Q, self.k, nprobe=self.nprobe,
                                    deadline_s=deadline_s)
        except Exception as exc:
            if not hasattr(exc, "wall_s"):
                exc.wall_s = time.perf_counter() - t0
            raise
        wall = time.perf_counter() - t0
        if self._timer is not None:
            wall = float(self._timer(rs.idx, wall))
        wall += faults.replica_delay(plan, rs.idx)
        return res, wall

    # -- dispatch: replicate mode --------------------------------------------
    def _dispatch_replicate(self, Q, deadline_s):
        pol = self.rpolicy
        total = 0.0
        tried: list[int] = []
        last: Exception | None = None
        for attempt in range(pol.max_retries + 1):
            rs = self._pick(exclude=tried)
            if rs is None:
                break
            if attempt > 0:
                self.retries += 1
                total += self._backoff(attempt)
            try:
                res, w = self._replica_search(rs, Q, deadline_s)
            except Exception as exc:          # noqa: BLE001 — any dispatch
                self._note_failure(rs, exc)   # error means try elsewhere
                total += getattr(exc, "wall_s", 0.0)
                tried.append(rs.idx)
                last = exc
                continue
            self._note_success(rs, w)
            winner, served_w, hedged = rs, w, 0.0
            if pol.hedge:
                hres = self._maybe_hedge(rs, res, w, Q, deadline_s,
                                         exclude=tried + [rs.idx])
                if hres is not None:
                    res, winner, served_w, hedged = hres
            total += served_w
            res.stats.extra[EXTRA_REPLICA] = float(winner.idx)
            res.stats.extra[EXTRA_HEDGED] = hedged
            res.stats.extra[EXTRA_DEGRADED] = 0.0
            return res, total
        raise ReplicaDispatchError(
            f"all replica dispatch attempts failed (tried {tried or 'none'}"
            f" of {len(self.replicas)} replicas, last error: "
            f"{type(last).__name__ if last else 'no routable replica'}"
            f"{f': {last}' if last else ''})", wall_s=total)

    def _fleet_p99(self) -> float | None:
        """The hedge-delay input: the *fastest* routable replica's
        windowed-p99 EWMA.  Keyed to the fleet rather than the primary's
        own history — a consistent straggler's own p99 already contains
        its slowness, so self-relative hedging would never fire exactly
        when hedging pays most.  ``None`` until any replica has data."""
        vals = [rs.p99_ewma for rs in self.replicas
                if rs.p99_ewma is not None and rs.state != "open"]
        return min(vals) if vals else None

    def _maybe_hedge(self, primary: ReplicaState, res, w: float,
                     Q, deadline_s, *, exclude):
        """Hedge a slow primary: if its wall ``w`` exceeded the adaptive
        delay (``hedge_factor`` x the fleet's best p99 EWMA, floored),
        race a duplicate on another healthy replica and take the
        virtual-timeline winner (``min(w, delay + secondary_wall)``).
        Returns ``(result, winner, served_wall, 1.0)`` or ``None`` when no
        hedge fired.

        The race is resolved *post hoc* on measured walls: both dispatches
        run to completion (in-process sessions are synchronous), but the
        timeline charged to the ticket is exactly what a concurrent race
        would produce, and the telemetry (hedges / wins / losses) is what
        an operator tunes ``hedge_factor`` by."""
        p99 = self._fleet_p99()
        if p99 is None:
            return None                   # cold start: no estimate yet
        delay = max(self.rpolicy.hedge_min_delay_s,
                    self.rpolicy.hedge_factor * p99)
        if w <= delay:
            return None
        other = self._pick(exclude=exclude)
        if other is None or other.state == "open":
            return None                   # nobody healthy to race
        self.hedges += 1
        try:
            res2, w2 = self._replica_search(other, Q, deadline_s)
        except Exception as exc:          # noqa: BLE001 — a failed hedge
            self._note_failure(other, exc)   # never hurts the primary win
            self.hedge_losses += 1
            return res, primary, w, 1.0
        self._note_success(other, w2)
        if delay + w2 < w:
            self.hedge_wins += 1
            return res2, other, delay + w2, 1.0
        self.hedge_losses += 1
        return res, primary, w, 1.0

    # -- dispatch: shard mode ------------------------------------------------
    def _dispatch_shard(self, Q, deadline_s):
        pol = self.rpolicy
        nq = Q.shape[0]
        served: list[tuple[ReplicaState, SearchResult, float]] = []
        missing: list[ReplicaState] = []
        total_rows = sum(rs.rows for rs in self.replicas)
        walls: list[float] = []
        for rs in self.replicas:
            if rs.state == "open":
                missing.append(rs)        # ejected: don't waste the budget
                continue
            shard_wall, got = 0.0, None
            for attempt in range(pol.max_retries + 1):
                if attempt > 0:
                    self.retries += 1
                    shard_wall += self._backoff(attempt)
                try:
                    got, w = self._replica_search(rs, Q, deadline_s)
                except Exception as exc:  # noqa: BLE001 — shard retry
                    self._note_failure(rs, exc)
                    shard_wall += getattr(exc, "wall_s", 0.0)
                    if rs.state == "open":
                        break             # ejected mid-retry: stop burning
                    continue
                self._note_success(rs, w)
                shard_wall += w
                break
            walls.append(shard_wall)
            if got is None:
                missing.append(rs)
            else:
                served.append((rs, got, shard_wall))
        # the fan-out runs shards concurrently: the batch wall is the
        # slowest shard's (retries included), not the sum
        wall = max(walls, default=0.0)
        if not served:
            raise ReplicaDispatchError(
                f"all {len(self.replicas)} shards failed or are ejected",
                wall_s=wall)
        return self._merge_shards(served, missing, nq, total_rows), wall

    def _merge_shards(self, served, missing, nq: int, total_rows: int):
        """Merge per-shard top-k into the global top-k: re-base local ids
        by each shard's row offset, concatenate, and keep the k best per
        query.  Coverage/certificates compose shard-wise: a query's
        spatial coverage is the row-weighted mean of its per-shard scan
        coverage over *served* shards (missing shards contribute 0), and
        its certificate survives only if every shard is present and
        certified."""
        from repro_torch.api.types import SearchResult

        k = self.k
        dists = np.concatenate([r.dists for _, r, _ in served], axis=1)
        ids = np.concatenate(
            [r.ids + rs.id_offset for rs, r, _ in served], axis=1)
        # mask padded/invalid lanes (a shard with n < k pads with inf)
        order = np.argsort(dists, axis=1, kind="stable")[:, :k]
        rowi = np.arange(nq)[:, None]
        out_d = dists[rowi, order]
        out_i = ids[rowi, order]
        cov = np.zeros(nq, np.float32)
        unc = np.zeros(nq, bool)
        stats = ScanStats()
        for rs, r, _ in served:
            frac = rs.rows / max(total_rows, 1)
            scov = r.stats.extra.get(EXTRA_COVERAGE)
            cov += np.float32(frac) * (np.ones(nq, np.float32) if scov is None
                                       else np.asarray(scov, np.float32))
            smask = r.stats.extra.get(EXTRA_UNCERTIFIED_MASK)
            if smask is not None:
                unc |= np.asarray(smask, bool)
            stats.dims_scanned += r.stats.dims_scanned
            stats.dims_total += r.stats.dims_total
            stats.n_dco += r.stats.n_dco
            stats.n_true += r.stats.n_true
        degraded = bool(missing)
        if degraded:
            unc |= True                   # an unvisited shard may hold a
        stats.extra = {                   # true neighbor: withdraw all
            EXTRA_UNCERTIFIED_MASK: unc,
            EXTRA_UNCERTIFIED_QUERIES: float(unc.mean()),
            EXTRA_COVERAGE: cov,
            EXTRA_DEGRADED: 1.0 if degraded else 0.0,
            EXTRA_REPLICA: -1.0,
            EXTRA_HEDGED: 0.0,
        }
        return SearchResult(out_d, out_i, stats, 0.0,
                            served[0][1].backend)

    # -- SearchService overrides ---------------------------------------------
    def _dispatch(self, Q, deadline_s):
        self._tick_round()
        if self.mode == "shard":
            return self._dispatch_shard(Q, deadline_s)
        return self._dispatch_replicate(Q, deadline_s)

    def _visible_rows(self) -> int:
        if self.mode == "shard":
            return sum(rs.rows for rs in self.replicas)
        return max(int(rs.session.n) for rs in self.replicas)

    def step(self, *, now: float | None = None):
        out = super().step(now=now)
        for req in out:
            if req.status == "done" and req.stats.get(EXTRA_DEGRADED):
                self.degraded += 1
        return out

    def add(self, Xnew, *, now: float | None = None) -> dict:
        """Write fan-out.  ``replicate``: every replica applies the rows
        (replicas stay identical).  ``shard``: the rows append to the
        *last* shard — the one holding the tail of the global id range —
        so global ids stay contiguous and merge re-basing stays a plain
        offset add.  A mesh replica's rows go to every rank first."""
        self._lead("add")
        t0 = time.perf_counter()
        if self.mode == "shard":
            targets = [max(self.replicas, key=lambda rs: rs.id_offset)]
        else:
            targets = self.replicas
        for rs in targets:
            if rs.on_mesh:
                self._send_add(Xnew, rs.idx)
            rs.session.add(Xnew)
            rs.rows = int(rs.session.n)
        wall = time.perf_counter() - t0
        mode = targets[-1].session.last_write_mode
        rows = int(np.atleast_2d(Xnew).shape[0])
        self.rows_inserted += rows
        self.insert_s += wall
        self.write_modes[mode] = self.write_modes.get(mode, 0) + 1
        return {"rows": rows, "mode": mode, "wall_s": wall}

    def _target(self, replica: int):
        return self.replicas[replica].session

    def _follow_counts(self, counts: dict) -> dict:
        zero = dict.fromkeys(FOLLOW_COUNTS, 0)
        per = [counts.get(rs.idx, zero) for rs in self.replicas]
        return {**{key: sum(c[key] for c in per) for key in FOLLOW_COUNTS},
                "replicas": per}

    def health(self) -> dict:
        """The base snapshot (accounting invariant unchanged) plus the
        tier: per-replica state rows, retry/hedge telemetry, and the
        degraded-completion count (a subset of ``completed``)."""
        h = super().health()
        h["mode"] = self.mode
        h["replicas"] = [rs.report() for rs in self.replicas]
        h["retries"] = self.retries
        h["hedges"] = self.hedges
        h["hedge_wins"] = self.hedge_wins
        h["hedge_losses"] = self.hedge_losses
        h["degraded"] = self.degraded
        return h


def open_replicated(X, *, replicas: int = 3, mode: str = "replicate",
                    index: str = "flat", method: str = "DADE",
                    backend: str = "torch", schedule=None,
                    replica_policy: ReplicaPolicy | None = None,
                    seed: int = 0, device=None,
                    **serving_kwargs) -> ReplicatedService:
    """Build a replicated serving tier from one corpus.

    ``mode="replicate"`` fits ``replicas`` identical sessions over the
    full corpus (deterministic fits: same rows, same seed).
    ``mode="shard"`` splits the rows into ``replicas`` contiguous ranges
    and fits one session per range; the tier re-bases ids at merge time,
    so results match a single session over the whole corpus wherever all
    shards are live.  Every session runs on ``backend`` (default the torch
    backend on ``device``, the CUDA card unless the caller asks for the
    CPU).  Remaining kwargs go to ``ReplicatedService`` /
    ``SearchService`` (slots, k, max_queue, clock, rng, timer, ...).
    """
    from repro_torch.api.session import open_index

    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if mode not in REPLICA_MODES:
        raise ValueError(f"mode must be one of {REPLICA_MODES}, got {mode!r}")
    X = np.ascontiguousarray(np.atleast_2d(X), np.float32)
    if mode == "shard":
        bounds = np.linspace(0, X.shape[0], replicas + 1).astype(int)
        parts = [X[bounds[i]:bounds[i + 1]] for i in range(replicas)]
        if any(p.shape[0] == 0 for p in parts):
            raise ValueError(
                f"cannot cut {X.shape[0]} rows into {replicas} non-empty "
                "shards")
    else:
        parts = [X] * replicas
    sessions = [open_index(p, index=index, method=method, backend=backend,
                           schedule=schedule, seed=seed, device=device)
                for p in parts]
    return ReplicatedService(sessions, mode=mode,
                             replica_policy=replica_policy, **serving_kwargs)

"""Continuous-batching serving front over a ``SearchSession``.

Counterpart of the reference package's ``serving/search_service.py``, with
the same tickets, counters and admission rules; it serves a session of
either backend of the port.

``SearchSession.search`` is a synchronous full-batch call — fine for the
paper's figures, wrong for serving, where queries arrive one at a time and
tail latency is the contract.  ``SearchService`` closes that gap with the
same slot pattern ``serving/engine.py`` proved for LM decode: arriving
single queries enqueue (O(1) deque admission) and each ``step()`` packs up
to ``slots`` of them into ONE fixed-shape device batch — the batch is always
padded to exactly ``slots`` rows, so on the card the streaming engine's
graph cache (keyed on the chunk's input shapes) captures the block walk
once and every later step replays it, no matter how many requests are
waiting.  A write drops the cached graphs with the layout they walk
(``TorchBackend._build_delta``), so the first step after an ``add()``
pays the delta build and one new capture.  Under load, requests that arrive while a batch is in flight are
served together in the next step: the continuous-batching dynamic that
trades a little per-request latency for sustained throughput.

Overload protection (DESIGN.md §7) keeps that contract under bursts the
device cannot absorb.  Admission is bounded: with ``max_queue`` set, a full
queue either rejects the new request (``admission="reject"``) or sheds the
oldest queued one to make room (``admission="shed_oldest"``) — either way
the victim's ticket resolves with ``status="shed"`` instead of silently
growing the queue.  Every request may carry a ``deadline_s`` budget (per
request or the service default): expire while *queued* and the ticket
resolves ``status="timeout"`` without ever touching the device; reach the
device with little budget left and the batch runs as an *anytime* search
(``SearchSession.search(deadline_s=...)``) that returns the running top-k
as a partial result (``coverage < 1``, ``certified=False``).  A device-step
exception (e.g. an injected ``testing.faults.FaultError``) fails only the
batch that hit it — its requests resolve ``status="failed"`` and the
service keeps serving.  ``health()`` snapshots queue depth, an EWMA of the
windowed p99 latency, the shed/timeout/partial/uncertified/failure
counters, and — when the session is guarded (DESIGN.md §9) — the circuit
breaker's state and drift/audit EWMAs; every submitted request is
accounted for by exactly one of
``completed + shed + timeouts + failures + pending``.

Writes ride the LSM-style delta path (DESIGN.md §6): ``add()`` appends to
the session, whose torch backend keeps its cached main block layout and
scans the new rows from a small delta segment under the same running tau —
inserts no longer re-materialize the corpus, so a mixed read/write workload
keeps serving between merges.

Each completed request carries its own ids/dists, the per-query exactness
certificate (``certified``; from the streaming engine's dropped-estimate
bound, DESIGN.md §4), its scan ``coverage``, and the batch's policy stats,
so a caller can retry or degrade per request instead of per batch.

Timing is injectable: by default ``submit``/``step`` stamp
``time.perf_counter()``, but both accept an explicit ``now`` so a
discrete-event driver (``chip_smoke.py``'s serving phases) can replay
Poisson arrivals against measured service times without sleeping through
the arrival process.  A step's measured wall includes the device time:
the torch backend's search ends in the device-to-host copy of its
result.

A mesh session (one process a rank, ``launch.mesh``) is served by one
service a rank with one clock: rank 0's.  Every rank calls
``session.serve(...)`` (or ``open_index(..., mesh=, serving=True)``);
rank 0 then drives it (``submit``/``step``/``drain``/``add``/``health``,
and ``close()`` at the end) and makes every host decision alone —
admission, shedding, expiry, packing and the batch's budget — while the
other ranks call ``follow()``, which returns when rank 0 closes.  Each
device step is one broadcast from rank 0 (a fixed-size header, then the
padded batch or the new rows: host tensors on a gloo group, device
tensors on an nccl one), after which every rank makes the same
``session.search`` or ``session.add`` call.  A step fails on every rank
or on none (``backends.TorchBackend.search``), so rank 0 fails the
batch and the followers go on to the next command.  Followers keep no
queue and no counters and never read a clock; a world of one serves
with no broadcast.  The replica tier (``serving.replica``) serves mesh
sessions the same way: every rank builds the same replicas in the same
order, the header names the replica a command is for, and rank 0
broadcasts each dispatch that reaches a mesh replica.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.engine import EXTRA_COVERAGE, EXTRA_UNCERTIFIED_MASK
from repro_torch.utils import trace

#: Terminal ticket states (``SearchRequest.status``); "pending" is the only
#: non-terminal one.  Exactly one terminal state per submitted request.
REQUEST_STATUSES = ("pending", "done", "timeout", "shed", "failed")
ADMISSION_POLICIES = ("reject", "shed_oldest")
#: what a mesh follower counts (``SearchService.follow``)
FOLLOW_COUNTS = ("searches", "adds", "failures")


class _MeshChannel:
    """Rank 0's step commands to the other ranks of a mesh session: a
    (7,) float64 header ``[command, replica, rows, dim, k, nprobe, budget
    or NaN]`` and, for a search or an add, the (rows, dim) float32
    payload, each one broadcast from rank 0 — on the session's device for
    an nccl group, on the host for gloo.  ``replica`` is the index of the
    tier's replica the command is for, -1 for a plain service's
    session."""

    STOP, SEARCH, ADD = 0, 1, 2

    def __init__(self, session):
        import torch
        import torch.distributed as dist
        nccl = "nccl" in str(dist.get_backend())
        self.device = (session.backend.device if nccl
                       else torch.device("cpu"))

    def send(self, cmd: int, rows=None, *, replica: int = -1, k: int = 0,
             nprobe: int = 0, deadline_s: float | None = None) -> None:
        import torch
        import torch.distributed as dist
        n, dim = (0, 0) if rows is None else rows.shape
        head = torch.tensor(
            [cmd, replica, n, dim, k, nprobe,
             float("nan") if deadline_s is None else deadline_s],
            dtype=torch.float64, device=self.device)
        dist.broadcast(head, 0)
        if rows is not None:
            # the raw buffer goes out: a padded batch may be laid out
            # column-major (np.concatenate keeps a broadcast's order)
            rows = np.ascontiguousarray(rows, np.float32)
            dist.broadcast(torch.from_numpy(rows).to(self.device), 0)

    def recv(self):
        """The next command: (command, replica, rows or None, k, nprobe,
        budget or None)."""
        import torch
        import torch.distributed as dist
        head = torch.empty(7, dtype=torch.float64, device=self.device)
        dist.broadcast(head, 0)
        cmd, replica, n, dim, k, nprobe, budget = head.tolist()
        rows = None
        if cmd != self.STOP:
            buf = torch.empty((int(n), int(dim)), dtype=torch.float32,
                              device=self.device)
            dist.broadcast(buf, 0)
            rows = buf.cpu().numpy()
        return (int(cmd), int(replica), rows, int(k), int(nprobe),
                None if np.isnan(budget) else budget)


def spans_ranks(session) -> bool:
    """True for a mesh session of several ranks: its searches and adds
    are collective, so rank 0 broadcasts each one to the other ranks."""
    if getattr(session, "mesh", None) is None:
        return False
    import torch.distributed as dist
    return dist.get_world_size() > 1


def _mesh_roles(sessions) -> tuple:
    """(this rank, the channel or None) of a service over ``sessions``:
    rank 0 leads every mesh session's commands, and the channel opens
    when any of them spans several ranks (the port's one mesh group)."""
    meshed = [s for s in sessions if getattr(s, "mesh", None) is not None]
    if not meshed:
        return 0, None
    import torch.distributed as dist
    spans = [s for s in meshed if spans_ranks(s)]
    return dist.get_rank(), _MeshChannel(spans[0]) if spans else None


@dataclass
class SearchRequest:
    """One in-flight (then resolved) query and its per-request telemetry."""

    rid: int
    q: np.ndarray                  # (D,) float32
    t_submit: float
    t_deadline: float | None = None  # absolute; None = no budget
    status: str = "pending"
    t_done: float | None = None
    service_s: float | None = None   # wall time of the batch that served it
    batch_size: int = 0              # real (non-pad) requests in that batch
    n_visible: int = 0               # corpus rows visible when served
    ids: np.ndarray | None = None    # (k,) int64
    dists: np.ndarray | None = None  # (k,) float32
    certified: bool | None = None    # per-query exactness certificate
    coverage: float | None = None    # scanned fraction (anytime; 1.0 = full)
    error: str | None = None         # set when status == "failed"
    stats: dict = field(default_factory=dict)   # batch-level policy stats

    @property
    def done(self) -> bool:
        """True once this request was actually served with results."""
        return self.status == "done"

    @property
    def resolved(self) -> bool:
        """True once the ticket reached any terminal state (served, timed
        out, shed, or failed) — i.e. waiting on it is over."""
        return self.status != "pending"

    @property
    def latency_s(self) -> float:
        """Submit-to-resolution latency (queueing + service)."""
        if self.t_done is None:
            raise ValueError(f"request {self.rid} is still pending")
        return self.t_done - self.t_submit


class SearchService:
    """Continuous-batching query front: ``submit()`` -> ``step()``/``drain()``.

    ``slots`` is the fixed device batch width (pad-to-``slots`` keeps the
    captured block walk's shapes static; make it a multiple of the session's
    ``policy.query_chunk`` so one step is a whole number of engine chunks).
    ``k``/``nprobe`` are fixed per service so result shapes stay static too.

    Robustness knobs (DESIGN.md §7): ``max_queue`` bounds admission (None =
    unbounded, the pre-robustness behavior), ``admission`` picks the full-
    queue policy (``"reject"`` the newcomer or ``"shed_oldest"`` victim),
    and ``deadline_s`` is the default per-request budget — queued past it
    resolves ``timeout``, served near it runs as an anytime partial scan.

    Over a mesh session of several ranks, rank 0's service is the one
    that serves (and ``close()``s it); every other rank's only call is
    ``follow()`` (see the module docstring).
    """

    def __init__(self, session, *, slots: int = 16, k: int = 10,
                 nprobe: int = 16, clock=time.perf_counter,
                 max_queue: int | None = None, admission: str = "reject",
                 deadline_s: float | None = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of {ADMISSION_POLICIES}, "
                             f"got {admission!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, got {max_queue}")
        if deadline_s is not None and deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0 or None, got {deadline_s}")
        self.session = session
        self.slots = slots
        self.k = k
        self.nprobe = nprobe
        self.max_queue = max_queue
        self.admission = admission
        self.deadline_s = deadline_s
        self._clock = clock
        self._queue: deque[SearchRequest] = deque()
        self._next_rid = 0
        # service-level counters (the serving drivers' headline inputs)
        self.submitted = 0
        self.completed = 0
        self.steps = 0
        self.busy_s = 0.0            # wall time spent inside search calls
        self.rows_inserted = 0
        self.insert_s = 0.0          # wall time spent inside add calls
        self.write_modes: dict = {}  # mode -> count (delta/merge/rebuild/...)
        # robustness counters (DESIGN.md §7; health() snapshots these)
        self.shed = 0                # admission victims (reject or shed_oldest)
        self.timeouts = 0            # budget expired while queued
        self.partials = 0            # served with coverage < 1.0
        self.uncertified = 0         # served with a withdrawn certificate
        self.failures = 0            # requests lost to a device-step error
        self._lat_window: deque[float] = deque(maxlen=128)
        self._p99_ewma: float | None = None
        # a mesh session: rank 0 leads, the other ranks follow
        self.rank, self._channel = _mesh_roles([session])
        self._closed = False

    def _lead(self, op: str) -> None:
        """Refuse ``op`` on a follower, and (``health`` aside) on a
        closed service."""
        if self.rank != 0:
            raise RuntimeError(
                f"{op}() on rank {self.rank}: a mesh session's service is "
                "driven by rank 0 alone; call follow() on this rank")
        if self._closed and op != "health":
            raise RuntimeError(f"{op}() after close(): the other ranks "
                               "have stopped following")

    # -- admission -----------------------------------------------------------
    @property
    def pending(self) -> int:
        """Requests admitted but not yet served."""
        return len(self._queue)

    def submit(self, q, *, now: float | None = None,
               deadline_s: float | None = None) -> SearchRequest:
        """Enqueue one query; returns its request ticket.

        The ticket usually comes back ``pending`` (serve it with ``step``/
        ``drain``), but under a full bounded queue with
        ``admission="reject"`` it resolves immediately as ``shed`` — check
        ``req.resolved``.  ``deadline_s`` overrides the service default
        budget for this request."""
        self._lead("submit")
        q = np.asarray(q, np.float32).reshape(-1)
        if q.shape[0] != self.session.dim:
            raise ValueError(
                f"submit(): query has dimension {q.shape[0]}, but the index "
                f"was built with D={self.session.dim}")
        if not np.isfinite(q).all():
            raise ValueError(
                "submit(): query contains NaN/Inf values; distances to "
                "non-finite queries are meaningless and would poison the "
                "whole batch's running top-k threshold")
        if deadline_s is not None and deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0 or None, got {deadline_s}")
        t = self._clock() if now is None else now
        budget = deadline_s if deadline_s is not None else self.deadline_s
        req = SearchRequest(
            rid=self._next_rid, q=q, t_submit=t,
            t_deadline=None if budget is None else t + budget)
        self._next_rid += 1
        self.submitted += 1
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if self.admission == "reject":
                req.status = "shed"
                self.shed += 1
                return req            # resolved, never enqueued
            victim = self._queue.popleft()     # shed_oldest
            victim.status = "shed"
            victim.t_done = t
            self.shed += 1
        self._queue.append(req)
        return req

    def add(self, Xnew, *, now: float | None = None) -> dict:
        """Insert rows through the session's delta write path; returns
        ``{"rows", "mode", "wall_s"}`` (mode per backends.notify_append).
        On a mesh the rows go to every rank first; each rank's ``add``
        then raises alike on rows it refuses."""
        self._lead("add")
        t0 = time.perf_counter()
        if self._channel is not None:
            self._send_add(Xnew)
        self.session.add(Xnew)
        wall = time.perf_counter() - t0
        mode = self.session.last_write_mode
        rows = int(np.atleast_2d(Xnew).shape[0])
        self.rows_inserted += rows
        self.insert_s += wall
        self.write_modes[mode] = self.write_modes.get(mode, 0) + 1
        return {"rows": rows, "mode": mode, "wall_s": wall}

    def _send_add(self, Xnew, replica: int = -1) -> None:
        """Broadcast an add's rows to the other ranks; rows that every
        rank's ``add`` refuses alike (not a numeric 2-D array) stay
        here."""
        rows = np.atleast_2d(np.asarray(Xnew))
        if rows.ndim == 2 and rows.dtype.kind in "fiu":
            self._channel.send(_MeshChannel.ADD, rows, replica=replica)

    # -- serving -------------------------------------------------------------
    def _expire_queued(self, t: float) -> list[SearchRequest]:
        """Resolve every queued request whose budget has already expired as
        ``timeout`` (it never reaches the device — the anytime engines would
        only burn a block group on it)."""
        expired: list[SearchRequest] = []
        if not self._queue:
            return expired
        alive: deque[SearchRequest] = deque()
        for req in self._queue:
            if req.t_deadline is not None and t > req.t_deadline:
                req.status = "timeout"
                req.t_done = t
                self.timeouts += 1
                self._observe_latency(req)
                expired.append(req)
            else:
                alive.append(req)
        self._queue = alive
        return expired

    def _observe_latency(self, req: SearchRequest) -> None:
        self._lat_window.append(req.latency_s)
        w = sorted(self._lat_window)
        p99 = w[min(len(w) - 1, int(0.99 * len(w)))]
        self._p99_ewma = (p99 if self._p99_ewma is None
                          else 0.8 * self._p99_ewma + 0.2 * p99)

    def _dispatch(self, Q, deadline_s):
        """One device dispatch: run the session search on the padded batch
        and return ``(result, service_wall_s)``.

        This is the replica tier's override point (serving.replica,
        DESIGN.md §10): ``ReplicatedService`` swaps in retry/hedge/fan-out
        routing and a *virtual* wall (the simulated timeline of those
        dispatches), while everything around it — ticket admission, padding,
        timeout expiry, accounting — stays this class's.  A raised exception
        fails the batch; raisers may attach ``wall_s`` to the exception to
        charge the time the failure consumed."""
        t0 = time.perf_counter()
        if self._channel is not None:
            self._channel.send(_MeshChannel.SEARCH, Q, k=self.k,
                               nprobe=self.nprobe, deadline_s=deadline_s)
        res = self.session.search(Q, self.k, nprobe=self.nprobe,
                                  deadline_s=deadline_s)
        return res, time.perf_counter() - t0

    def _visible_rows(self) -> int:
        """Corpus rows visible to a batch served now (replica tier:
        aggregate over shards)."""
        return int(self.session.n)

    def step(self, *, now: float | None = None) -> list[SearchRequest]:
        """Serve ONE fixed-shape batch: resolve budget-expired queued
        requests as ``timeout``, pop up to ``slots`` survivors, pad to
        exactly ``slots`` queries, run one session search (anytime-capped at
        the tightest member budget), and fill each served request
        (ids/dists/certificate/coverage/stats + timestamps).

        With ``now`` given (simulated time), completions are stamped
        ``now + measured_service_wall``; otherwise the real clock is used.
        Returns every request *resolved* by this step — served ones plus
        any that timed out in the queue ([] when nothing was pending)."""
        self._lead("step")
        t_now = self._clock() if now is None else now
        resolved = self._expire_queued(t_now)
        if not self._queue:
            return resolved
        with trace.span("service.step") as sp:
            batch = [self._queue.popleft()
                     for _ in range(min(self.slots, len(self._queue)))]
            if sp:
                sp.attrs.update(step=self.steps, batch_size=len(batch),
                                rids=[r.rid for r in batch])
            Q = np.stack([r.q for r in batch])
            if len(batch) < self.slots:
                # pad with a replay of the last real query: static (slots, D)
                # shape -> one captured block walk serves every step
                Q = np.concatenate(
                    [Q, np.broadcast_to(Q[-1], (self.slots - len(batch),
                                                Q.shape[1]))])
            # the batch scans together, so its anytime budget is the tightest
            # member's remaining budget (members with no budget impose none)
            budgets = [r.t_deadline - t_now for r in batch
                       if r.t_deadline is not None]
            deadline = max(min(budgets), 1e-4) if budgets else None
            t0 = time.perf_counter()
            try:
                res, wall = self._dispatch(Q, deadline)
            except Exception as exc:          # noqa: BLE001 — fail the batch,
                wall = getattr(exc, "wall_s", None)  # not the service (§7)
                if wall is None:
                    wall = time.perf_counter() - t0
                t_done = (now + wall) if now is not None else self._clock()
                for req in batch:
                    req.status = "failed"
                    req.error = f"{type(exc).__name__}: {exc}"
                    req.t_done = t_done
                    req.service_s = wall
                    req.batch_size = len(batch)
                    self._observe_latency(req)
                self.failures += len(batch)
                self.steps += 1
                self.busy_s += wall
                return resolved + batch
            t_done = (now + wall) if now is not None else self._clock()
            mask = res.stats.extra.get(EXTRA_UNCERTIFIED_MASK)
            cov = res.stats.extra.get(EXTRA_COVERAGE)
            stats = {key: v for key, v in res.stats.extra.items()
                     if np.isscalar(v)}
            n_visible = self._visible_rows()
            for j, req in enumerate(batch):
                req.ids = res.ids[j]
                req.dists = res.dists[j]
                req.certified = None if mask is None else bool(~mask[j])
                if req.certified is False:
                    self.uncertified += 1
                req.coverage = None if cov is None else float(cov[j])
                if req.coverage is not None and req.coverage < 1.0:
                    self.partials += 1
                req.stats = stats
                req.status = "done"
                req.t_done = t_done
                req.service_s = wall
                req.batch_size = len(batch)
                req.n_visible = n_visible
                self._observe_latency(req)
            self.steps += 1
            self.completed += len(batch)
            self.busy_s += wall
            return resolved + batch

    def drain(self, *, now: float | None = None) -> list[SearchRequest]:
        """Serve until the queue is empty; in simulated time consecutive
        batches complete back-to-back (each step starts when the previous
        finished).  Budget-expired requests resolve ``timeout`` instead of
        being served, so drain always terminates even mid-overload.
        Returns all resolved requests in resolution order."""
        self._lead("drain")
        served: list[SearchRequest] = []
        t = now
        while self._queue:
            batch = self.step(now=t)
            if t is not None and batch:
                t = max(r.t_done for r in batch)
            served.extend(batch)
        return served

    # -- the mesh's other ranks -----------------------------------------------
    def _target(self, replica: int):
        """The session a broadcast command is for (``replica`` is -1 on
        a plain service)."""
        return self.session

    def _follow_counts(self, counts: dict) -> dict:
        """What :meth:`follow` returns from its per-replica counts."""
        return counts.get(-1, dict.fromkeys(FOLLOW_COUNTS, 0))

    def follow(self) -> dict:
        """On a mesh rank other than 0: make every search and add that
        rank 0's service broadcasts, until rank 0 calls ``close()``.  A
        command that raises here raised on rank 0 too (the step failed
        on every rank), so the loop goes on to the next; a failed
        broadcast raises.  Returns ``{"searches", "adds", "failures"}``:
        the commands made and how many of them raised (a tier adds them
        per replica under ``"replicas"``)."""
        if self.rank == 0:
            raise RuntimeError("follow() is for the mesh's ranks other than "
                               "0; rank 0 drives the service")
        counts: dict = {}
        while True:
            cmd, replica, rows, k, nprobe, budget = self._channel.recv()
            if cmd == _MeshChannel.STOP:
                return self._follow_counts(counts)
            done = counts.setdefault(replica,
                                     dict.fromkeys(FOLLOW_COUNTS, 0))
            session = self._target(replica)
            try:
                if cmd == _MeshChannel.SEARCH:
                    done["searches"] += 1
                    session.search(rows, k, nprobe=nprobe, deadline_s=budget)
                else:
                    done["adds"] += 1
                    session.add(rows)
            except Exception:           # noqa: BLE001 - rank 0 failed it too
                done["failures"] += 1

    def close(self) -> None:
        """On rank 0 of a mesh: tell the followers to stop (their
        ``follow()`` returns); a no-op elsewhere and when called again."""
        if self.rank == 0 and self._channel is not None and not self._closed:
            self._channel.send(_MeshChannel.STOP)
            self._closed = True

    # -- observability --------------------------------------------------------
    def health(self) -> dict:
        """Snapshot of the service's load state (DESIGN.md §7): queue depth,
        EWMA of the windowed p99 request latency (seconds; None until the
        first resolution), and the full request-accounting counters.
        ``submitted == completed + shed + timeouts + failures + pending``
        holds at every quiescent point (``partials`` and ``uncertified``
        sub-count completed requests — coverage < 1.0 and withdrawn
        exactness certificates respectively).

        When the session carries a guardrail (``SchedulePolicy(guardrails=
        ...)``, DESIGN.md §9), the snapshot also reports its breaker state
        and sentinel/audit EWMAs under ``breaker_state`` / ``drift_score``
        / ``audit_recall`` / ``demoted_batches``."""
        self._lead("health")
        h = {
            "queue_depth": len(self._queue),
            "p99_ewma_s": self._p99_ewma,
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "timeouts": self.timeouts,
            "partials": self.partials,
            "uncertified": self.uncertified,
            "failures": self.failures,
            "steps": self.steps,
            "busy_s": self.busy_s,
            "rows_inserted": self.rows_inserted,
        }
        g = self.session.guardrails() if hasattr(self.session, "guardrails") \
            else None
        if g is not None:
            h["breaker_state"] = g["state"]
            h["drift_score"] = g["drift_score"]
            h["audit_recall"] = g["audit_recall"]
            h["demoted_batches"] = g["demoted_batches"]
        wal = getattr(self.session, "wal", None)
        if wal is not None:
            h["wal_bytes"] = wal.total_bytes()
        return h

"""Guardrail layer: drift sentinel, online recall audits, circuit breaker.

A numpy copy of the reference package's ``core/guardrails.py``.  The
backends (``api.backends``) route every non-deadline batch of an armed
session through :meth:`Guardrail.run`; on the torch backend the demoted
path is the streaming engine's forced full-scan body (``step_full``).

The paper's production verdict is that DCO screening is *unstable*: pruning
power collapses under query drift (OOD batches), and a screen that has gone
net-negative keeps burning cycles until a human notices.  The adaptive
policy (``core.policy``) reacts per block, but nothing detects *sustained*
degradation and durably demotes screening with a re-qualification path.
This module is that layer (DESIGN.md §9):

**Drift sentinel** — at session build time we fit cheap reference
statistics of the indexed corpus: per-dim mean, the top-``lead_r``
principal directions (randomized subspace iteration on a row subsample —
a full D x D eigendecomposition is infeasible at ultra-high D), and the
reference fraction of centered energy that lands in that lead subspace.
Every incoming batch is scored by its *lead-energy deficit*: OOD batches in
the spectrum-shift regime (``vecdata.make_ood_queries`` — energy pushed
into the lowest-variance directions, where lower-bound screening prunes
nothing) lose almost all lead energy, so the deficit approaches 1 while
in-distribution batches sit near 0.  Corpora are typically stored under a
random rotation, so per-dim variances alone are ~isotropic and carry no
drift signal — the principal split is what makes the sentinel sensitive to
exactly the shift that breaks screening.  A norm-deviation term catches
scale drift the projection is blind to.  Scores fold into an EWMA.

**Online audit** — while the breaker is closed, a deterministic ~1/64
sample of served queries (fractional accumulator, seeded per batch index so
replays are reproducible) is shadow re-executed through the certified
full-scan path and compared against the screening answers: sampled recall
and the screened-vs-certified wall-clock ratio feed EWMAs.  Audits never
touch the served results — closed-state answers are bit-identical with or
without guardrails.

**Circuit breaker** — per (method, backend) state machine::

    closed --(sustained drift AND evidence)--> open
    open   --(drift EWMA back under threshold, dwell served)--> half_open
    half_open --(canary screen fails or drift resurges)--> open
    half_open --(promote_after clean canaries, dwell served)--> closed

While open (and half-open), every batch is served by the certified
full-scan body of the adaptive machinery
(``PolicyConfig(force_fallback=True)`` -> ``step_full``): recall is exact
by construction, so a tripped breaker bounds the damage at fdscan cost.
Half-open batches are still served certified; the *canary* shadow-screens a
sampled query and compares it against the certified answers, so a failed
probe costs nothing served.  ``min_dwell`` gates every serving-mode flip
(closed->open, half_open->closed) and the open->half_open probe decision,
bounding flaps under alternating id/ood bursts to at most one transition
per dwell window; a failed canary re-opens immediately (both states serve
the same certified path, so that flip changes no served result).

Evidence for the trip is any of: audited recall EWMA under
``audit_recall_floor``, this batch's uncertified-certificate fraction over
``uncertified_ceiling`` (severe OOD overflows the per-block completion
budget immediately — the fastest honest signal), or the audited cost ratio
over ``cost_ceiling`` (screening slower than the certified scan).  Drift
alone never trips (the sentinel could be wrong); evidence alone never
trips (a one-off capacity spill is the adaptive policy's job).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.engine import (EXTRA_AUDIT_RECALL, EXTRA_BREAKER_STATE,
                               EXTRA_DRIFT_SCORE, EXTRA_UNCERTIFIED_QUERIES)
from repro_torch.testing import faults

#: Breaker states (``Guardrail.state`` / the ``breaker_state`` stat).
BREAKER_STATES = ("closed", "open", "half_open")


class BreakerCore:
    """The bare closed -> open -> half_open state machine: current state,
    dwell bookkeeping, and a bounded transition log.

    Two owners share it, as in the reference package: the drift guardrail
    below (demotes DCO screening, DESIGN.md §9) and the replicated serving
    tier's per-replica ejection breaker (``serving.replica``, DESIGN.md
    §10).  The core is mechanism only — *when* to flip (drift + evidence, consecutive failures, probe
    outcomes) stays with the owner; the core records flips, resets dwell,
    and rejects unknown state names.
    """

    def __init__(self):
        self.state = "closed"
        self.dwell = 0                      # steps spent in the current state
        self.transitions: deque = deque(maxlen=256)

    def tick(self) -> None:
        """One observation in the current state (dwell grows by one)."""
        self.dwell += 1

    def transition(self, to: str, reason: str, *, at: int = 0) -> None:
        """Flip to ``to`` (validated), logging ``{at, from, to, reason}``
        and resetting dwell."""
        if to not in BREAKER_STATES:
            raise ValueError(
                f"breaker state must be one of {BREAKER_STATES}, got {to!r}")
        self.transitions.append(
            {"batch": int(at), "from": self.state, "to": to,
             "reason": reason})
        self.state = to
        self.dwell = 0


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Static guardrail knobs (hashable: rides inside the frozen
    ``SchedulePolicy``).

    ``drift_threshold``     EWMA drift score above which a batch counts as
                            drifted (lead-energy deficit is ~0 in
                            distribution, ~1 under a full spectrum shift).
    ``drift_alpha``         EWMA weight of the newest batch's raw score.
    ``trip_after``          consecutive drifted batches (with evidence)
                            before closed -> open.
    ``min_dwell``           batches a state must hold before a serving-mode
                            transition (closed->open, half_open->closed) or
                            an open->half_open probe; bounds flapping.
    ``promote_after``       consecutive clean canaries before half_open ->
                            closed.
    ``audit_rate``          expected fraction of served queries shadow
                            re-executed through the certified path while
                            closed (fractional accumulator: exact in
                            expectation, deterministic given the seed).
    ``audit_batch``         queries per shadow audit call.  The accumulator
                            waits until a full group is owed, then audits
                            them together from the current batch: the
                            shadow search pads to the engine's query chunk
                            anyway, so G queries cost the same wall as 1 —
                            larger groups mean the same audited fraction at
                            ~1/G the shadow dispatches (that amortization
                            is what keeps audit overhead in the low single
                            digits).
                            Also the per-batch cap on audit work.
    ``canary_queries``      queries shadow-screened per half-open batch.
    ``audit_recall_floor``  audited/canary recall below this is evidence of
                            a failing screen (estimator rules with a
                            naturally lossy screen may need it lowered).
    ``uncertified_ceiling`` batch certificate-failure fraction above this
                            is evidence (capacity overflow under OOD).
    ``cost_ceiling``        screened-vs-certified per-query wall ratio
                            above this is evidence (screening net-negative).
    ``lead_r``              principal directions in the sentinel's lead
                            split (clamped to D // 4).
    ``seed``                sentinel subsampling + audit/canary sampling
                            seed (replays are reproducible).
    """

    drift_threshold: float = 0.35
    drift_alpha: float = 0.5
    trip_after: int = 2
    min_dwell: int = 4
    promote_after: int = 2
    audit_rate: float = 1.0 / 64.0
    audit_batch: int = 16
    canary_queries: int = 1
    audit_recall_floor: float = 0.999
    uncertified_ceiling: float = 0.25
    cost_ceiling: float = 1.0
    lead_r: int = 32
    seed: int = 0


class DriftSentinel:
    """Reference statistics of the fitted corpus + batch drift scoring.

    Fit once per session from the method's stored corpus; ``score`` is
    O(nq * D * r) per batch — noise next to one corpus block's matmul.
    """

    def __init__(self, mean, lead, ref_lead_frac, ref_norm):
        self.mean = mean                    # (D,) corpus mean
        self.lead = lead                    # (D, r) orthonormal lead basis
        self.ref_lead_frac = ref_lead_frac  # corpus energy fraction in lead
        self.ref_norm = ref_norm            # mean centered row norm

    @classmethod
    def fit(cls, X, *, r: int = 32, seed: int = 0,
            sample: int = 4096) -> "DriftSentinel":
        """Fit from corpus rows: subsample, then randomized subspace
        iteration for the top-``r`` principal directions (two power steps —
        plenty for a split this coarse, and it never materializes D x D)."""
        X = np.asarray(X, np.float32)
        n, D = X.shape
        rng = np.random.default_rng(seed)
        sub = X if n <= sample else X[rng.choice(n, sample, replace=False)]
        mu = sub.mean(0)
        Xc = (sub - mu).astype(np.float64)
        r = max(1, min(int(r), max(1, D // 4), Xc.shape[0] - 1))
        Y = Xc.T @ (Xc @ rng.standard_normal((D, min(D, r + 8))))
        for _ in range(2):
            Q, _ = np.linalg.qr(Y)
            Y = Xc.T @ (Xc @ Q)
        Q, _ = np.linalg.qr(Y)
        B = Xc @ Q
        _, _, Vt = np.linalg.svd(B, full_matrices=False)
        lead = (Q @ Vt[:r].T).astype(np.float32)          # (D, r)
        tot = np.maximum((Xc ** 2).sum(1), 1e-12)
        frac = ((Xc @ lead) ** 2).sum(1) / tot
        return cls(mu.astype(np.float32), lead,
                   float(frac.mean()), float(np.sqrt(tot).mean()))

    def score(self, Q) -> float:
        """Raw drift score of one batch in [0, 1]: the batch's mean
        lead-energy deficit relative to the corpus reference, maxed with a
        clipped norm-deviation term (scale drift)."""
        Qc = np.asarray(Q, np.float32) - self.mean
        tot = np.maximum((Qc ** 2).sum(1), 1e-12)
        frac = float((((Qc @ self.lead) ** 2).sum(1) / tot).mean())
        deficit = max(0.0, (self.ref_lead_frac - frac)
                      / max(self.ref_lead_frac, 1e-9))
        norm_dev = abs(float(np.sqrt(tot).mean()) / max(self.ref_norm, 1e-9)
                       - 1.0)
        return float(min(1.0, max(deficit, min(norm_dev, 1.0))))


def _sample_recall(test_ids, ref_ids, k: int) -> float:
    """Top-k overlap of the screening answers vs the certified answers,
    averaged over the sampled queries (1.0 = identical neighbor sets)."""
    hits = 0
    for t, ref in zip(np.asarray(test_ids), np.asarray(ref_ids)):
        hits += len(set(map(int, t[:k])) & set(map(int, ref[:k])))
    return hits / float(max(k * len(np.asarray(ref_ids)), 1))


class Guardrail:
    """Mutable per-(method, backend) breaker runtime; owns the sentinel,
    the audit/canary sampling state, and the transition log.

    The backend routes every non-deadline batch through :meth:`run`, which
    dispatches to the screening or certified callable by breaker state and
    stamps ``drift_score`` / ``audit_recall`` / ``breaker_state`` into the
    batch stats.  Results in the closed state are bit-identical to an
    unguarded session (observation and audits never touch the served
    arrays).
    """

    def __init__(self, cfg: GuardrailConfig, method, backend: str):
        self.cfg = cfg
        self.method_name = method.name
        self.backend_name = backend
        self.sentinel = DriftSentinel.fit(
            method.state["X"], r=cfg.lead_r, seed=cfg.seed)
        self._core = BreakerCore()  # state + dwell + transition log
        self.batches = 0            # batches observed over the lifetime
        self.drift_raw = 0.0
        self.drift_ewma = 0.0
        self.audit_recall = 1.0     # EWMA of audited/canary sample recall
        self.cost_ratio = 0.0       # EWMA screened/certified wall per query
        self.drift_streak = 0
        self.promote_streak = 0
        self.audits = 0             # audited batches (closed state)
        self.audited_queries = 0
        self.canaries = 0           # canary probes (half-open state)
        self.demoted_batches = 0    # batches served by the certified path
        self._audit_acc = 0.0       # fractional audit accumulator

    # -- state machine (delegated to BreakerCore) ----------------------------
    @property
    def state(self) -> str:
        return self._core.state

    @property
    def dwell(self) -> int:
        return self._core.dwell

    @property
    def transitions(self) -> deque:
        return self._core.transitions

    def _transition(self, to: str, reason: str) -> None:
        self._core.transition(to, reason, at=self.batches)
        self.drift_streak = 0
        self.promote_streak = 0

    def force_state(self, state: str) -> None:
        """Operator/test override: jump the breaker to ``state`` (logged)."""
        self._transition(state, "forced")

    # -- sampling ------------------------------------------------------------
    def _take_audit(self, nq: int) -> int:
        """Fractional-accumulator sampling: audited queries are
        ``audit_rate`` of served queries in the long run, deterministic,
        and flushed in groups of ``audit_batch`` (one shadow dispatch per
        group; audit work per batch is capped at one group, so the
        effective rate saturates at ``audit_batch / nq`` for huge
        batches)."""
        self._audit_acc += nq * self.cfg.audit_rate
        g = max(1, self.cfg.audit_batch)
        if self._audit_acc < g:
            return 0
        n = min(g, nq)
        self._audit_acc -= n
        return n

    def _sample(self, nq: int, n: int) -> np.ndarray:
        """Deterministic query pick for this batch index (seeded, so a
        replay of the same stream audits the same queries)."""
        rng = np.random.default_rng([self.cfg.seed, self.batches])
        return np.sort(rng.choice(nq, size=min(n, nq), replace=False))

    def _fold_audit(self, recall: float, cost: float | None) -> None:
        a = self.cfg.drift_alpha
        self.audit_recall = (recall if self.audits + self.canaries == 0
                             else a * recall + (1 - a) * self.audit_recall)
        if cost is not None:
            self.cost_ratio = (cost if self.audits == 0
                               else a * cost + (1 - a) * self.cost_ratio)

    # -- the guarded batch ---------------------------------------------------
    def run(self, Q, k: int, *, screen, certified, plan=None):
        """Serve one batch under the breaker.

        ``screen(Q)`` / ``certified(Q)`` are backend callables returning
        ``(dists, ids, stats)`` — the configured screening path and the
        certified full-scan path.  ``plan`` is an optional
        ``testing.FaultPlan`` whose drift/audit overrides make state-machine
        edges deterministically testable."""
        cfg = self.cfg
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        nq = Q.shape[0]
        raw = faults.drift_override(plan, self.sentinel.score(Q))
        a = cfg.drift_alpha
        self.drift_raw = raw
        self.drift_ewma = (raw if self.batches == 0
                           else a * raw + (1 - a) * self.drift_ewma)
        drifted = self.drift_ewma > cfg.drift_threshold
        self.drift_streak = self.drift_streak + 1 if drifted else 0
        served_state = self.state

        if self.state == "closed":
            t0 = time.perf_counter()
            d, i, stats = screen(Q)
            wall = time.perf_counter() - t0
            unc = float(stats.extra.get(EXTRA_UNCERTIFIED_QUERIES, 0.0))
            n_aud = self._take_audit(nq)
            if n_aud:
                idx = self._sample(nq, n_aud)
                t0 = time.perf_counter()
                _, ref_ids, _ = certified(Q[idx])
                ref_wall = time.perf_counter() - t0
                rec = faults.audit_override(
                    plan, _sample_recall(i[idx], ref_ids, k))
                cost = ((wall / max(nq, 1))
                        / max(ref_wall / len(idx), 1e-9))
                self._fold_audit(rec, cost)
                self.audits += 1
                self.audited_queries += len(idx)
            evidence = (self.audit_recall < cfg.audit_recall_floor
                        or unc > cfg.uncertified_ceiling
                        or self.cost_ratio > cfg.cost_ceiling)
            self.batches += 1
            self._core.tick()
            if (drifted and self.drift_streak >= cfg.trip_after
                    and evidence and self.dwell >= cfg.min_dwell):
                self._transition(
                    "open",
                    f"drift ewma {self.drift_ewma:.3f} x{cfg.trip_after}+ "
                    f"with evidence (audit_recall {self.audit_recall:.3f}, "
                    f"uncertified {unc:.3f}, cost {self.cost_ratio:.2f})")
        else:
            d, i, stats = certified(Q)
            self.demoted_batches += 1
            if self.state == "half_open":
                idx = self._sample(nq, max(1, cfg.canary_queries))
                _, can_ids, _ = screen(Q[idx])
                rec = faults.audit_override(
                    plan, _sample_recall(can_ids, i[idx], k))
                self._fold_audit(rec, None)
                self.canaries += 1
                ok = rec >= cfg.audit_recall_floor and not drifted
                self.promote_streak = self.promote_streak + 1 if ok else 0
                self.batches += 1
                self._core.tick()
                if not ok:
                    # re-open immediately: half-open batches are already
                    # served certified, so this flip changes nothing served
                    self._transition(
                        "open", f"canary failed (recall {rec:.3f}, drift "
                        f"ewma {self.drift_ewma:.3f})")
                elif (self.promote_streak >= cfg.promote_after
                        and self.dwell >= cfg.min_dwell):
                    self._transition(
                        "closed", f"{self.promote_streak} clean canaries "
                        f"(recall {self.audit_recall:.3f})")
            else:                           # open
                self.batches += 1
                self._core.tick()
                if not drifted and self.dwell >= cfg.min_dwell:
                    self._transition(
                        "half_open",
                        f"drift ewma {self.drift_ewma:.3f} recovered")
        stats.extra[EXTRA_DRIFT_SCORE] = float(self.drift_ewma)
        stats.extra[EXTRA_AUDIT_RECALL] = float(self.audit_recall)
        stats.extra[EXTRA_BREAKER_STATE] = served_state
        return d, i, stats

    # -- observability -------------------------------------------------------
    def report(self) -> dict:
        """Snapshot for ``session.guardrails()``:
        breaker state, sentinel EWMAs, audit counters, and the transition
        log (most recent last)."""
        return {
            "method": self.method_name,
            "backend": self.backend_name,
            "state": self.state,
            "batches": self.batches,
            "dwell": self.dwell,
            "drift_score": float(self.drift_ewma),
            "drift_raw": float(self.drift_raw),
            "audit_recall": float(self.audit_recall),
            "cost_ratio": float(self.cost_ratio),
            "audits": self.audits,
            "audited_queries": self.audited_queries,
            "canaries": self.canaries,
            "demoted_batches": self.demoted_batches,
            "transitions": list(self.transitions),
        }

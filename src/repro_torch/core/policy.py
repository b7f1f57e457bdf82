"""Adaptive DCO policy engine: notice when screening stops paying, fall back.

A numpy copy of the reference package's ``core/policy.py``; the torch
streaming engine (``core.stream_engine``) and the host scan
(``core.engine.scan_topk``) read it.

The paper's central negative result is that DCO screening is *not* a silver
bullet: pruning power collapses under out-of-distribution queries and shifts
with dimensionality and hardware, sometimes landing slower than a plain
full-dimensional scan.  A production session therefore cannot hard-code one
rule: this module turns the engines' per-block telemetry (survivor counts —
already produced by the streaming engine of DESIGN.md §4) into a running
cost model and a device-side decision that degrades the active screening
rule to ``fdscan`` — the thing that is never wrong — while it is losing, and
returns to screening on recovery.  DESIGN.md §5 is the narrative reference.

Cost model (all quantities per candidate row, in scanned dims):

    screened cost  ~  d_screen + pass_fraction * d_complete + overhead_dims
    fdscan cost    ~  D

``pass_fraction`` is the fraction of a block's rows that survive the screen
(the engines measure it per block; an EWMA smooths it).  Screening is
predicted net-positive while

    fallback_margin * screened_cost  <=  fdscan_cost

which solves to the survivor-fraction threshold of :func:`pass_threshold`.
``fallback_margin > 1`` demands screening beat the full scan by that factor
before it is trusted (headroom for the compaction / merge work the dim
count does not see); ``overhead_dims`` charges the fixed per-row cost of
screening bookkeeping in dim units.

Certified-fallback invariant (DESIGN.md §5): a fallback decision only ever
*adds* scanned dims — fallback blocks complete every candidate row exactly,
so the exactness certificate of the streaming engine (``dropped_min_est``)
and the host scan's exhaustive completion are unaffected.  Adaptive mode can
restore certification that a fixed rule loses (a fallback block drops
nothing), never the reverse.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine import (EXTRA_EST_SAVED_FLOPS, EXTRA_FALLBACK_BLOCKS,
                               EXTRA_RULE_TIMELINE)

#: private ScanStats.extra accumulator used by the host scan between
#: ``scan_topk`` calls; :func:`finalize_adaptive_extra` folds it into the
#: public keys and removes it.
_ACC_KEY = "_adaptive_acc"


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static knobs of the adaptive policy (hashable: rides inside the
    frozen ``DcoEngineConfig``, a key of the engine's graph cache).

    ``fallback_margin`` — how much cheaper than fdscan the cost model must
    predict screening to be before it stays active (DESIGN.md §5 tuning
    guidance).  ``ewma_alpha`` — weight of the newest block's survivor
    fraction in the running estimate.  ``overhead_dims`` — fixed per-row
    screening overhead in dim units (compaction, merges).  ``hysteresis`` —
    fraction of the entry threshold the EWMA must drop below before the
    policy flips back to screening (avoids mode thrash at the boundary).
    ``force_fallback`` — pin the policy in fallback: every block/chunk runs
    the dedicated certified full-scan body and never returns to screening.
    This is the guardrail breaker's demotion lever (DESIGN.md §9): the OPEN
    state serves batches through a config with ``force_fallback=True``,
    reusing the engine's dedicated ``step_full`` body.
    """

    adaptive: bool = True
    fallback_margin: float = 1.5
    ewma_alpha: float = 0.5
    overhead_dims: float = 8.0
    hysteresis: float = 0.9
    force_fallback: bool = False

    @classmethod
    def from_schedule(cls, schedule) -> "PolicyConfig | None":
        """Build from a facade ``SchedulePolicy``; None when not adaptive."""
        if not getattr(schedule, "adaptive", False):
            return None
        return cls(adaptive=True, fallback_margin=schedule.fallback_margin)


def pass_threshold(D: int, d_screen: float, d_complete: float,
                   margin: float, overhead_dims: float) -> float:
    """Survivor-fraction threshold above which screening is predicted
    net-negative.

    Solves ``margin * (d_screen + f * d_complete + overhead_dims) == D`` for
    ``f``.  A result <= 0 means screening can never pay at this geometry
    (e.g. ``d_screen`` ~ D): the policy then serves every block by fdscan.
    A result >= 1 means screening always pays in this model and the policy
    never falls back.
    """
    return (D / max(margin, 1e-9) - d_screen - overhead_dims) / max(d_complete, 1.0)


class HostPolicy:
    """Mutable per-query mirror of the scan policy for the host engine.

    The host staged scan (``core.engine.scan_topk``) completes every screen
    survivor exhaustively, so host adaptivity is purely a performance
    feature — results are unchanged by construction (the fallback invariant
    is trivial).  The decision is history-based: block ``t`` is served by
    the mode implied by blocks ``< t``.  In fallback mode a first-stage
    *shadow* screen (cheap: ``stages[0]`` dims per row) keeps the survivor
    signal alive so the policy can flip back on recovery; its cost is
    charged to ``dims_scanned`` like any real screening work.
    """

    def __init__(self, cfg: PolicyConfig, D: int):
        self.cfg = cfg
        self.D = float(D)
        # force_fallback (the guardrail demotion) starts AND stays in
        # fallback: every candidate block completes exactly
        self.mode = bool(cfg.force_fallback)
        self.ewma = 0.0
        self._n_obs = 0
        self.fallback_blocks = 0
        self.saved_flops = 0.0
        self.timeline: list[bool] = []

    def block_served(self, fallback: bool, n: int, completed: int,
                     charged_dims: float) -> None:
        """Record how a candidate block was actually served.

        ``n`` candidate rows, ``completed`` rows exactly completed,
        ``charged_dims`` total screening dims charged for the block.
        ``est_saved_flops`` accumulates the measured saving vs an
        always-fdscan baseline (2 FLOPs per row-dim, fused multiply-add).
        """
        self.timeline.append(bool(fallback))
        if fallback:
            self.fallback_blocks += 1
            # fallback pays the shadow screen on top of the full scan
            self.saved_flops -= 2.0 * charged_dims
        else:
            self.saved_flops += 2.0 * ((n - completed) * self.D - charged_dims)

    def observe(self, n: int, n_pass: int, d_screen: float) -> None:
        """Fold one block's survivor fraction into the EWMA and re-decide.

        ``d_screen`` is the measured per-row screening dims of this block
        (the shadow stage's dims while in fallback), so the threshold tracks
        what screening actually costs on this scan.
        """
        if n <= 0 or self.cfg.force_fallback:
            return                  # demoted: the mode never flips back
        frac = n_pass / n
        a = self.cfg.ewma_alpha
        self.ewma = frac if self._n_obs == 0 else a * frac + (1 - a) * self.ewma
        self._n_obs += 1
        thr = pass_threshold(self.D, d_screen, self.D,
                             self.cfg.fallback_margin, self.cfg.overhead_dims)
        if self.mode:
            self.mode = self.ewma > thr * self.cfg.hysteresis
        else:
            self.mode = self.ewma > thr

    def flush(self, stats) -> None:
        """Accumulate this query's telemetry into ``stats.extra`` (private
        accumulator; the backend calls :func:`finalize_adaptive_extra` once
        per batch to produce the public keys)."""
        if stats is None:
            return
        acc = stats.extra.setdefault(
            _ACC_KEY, {"fb": 0, "saved": 0.0, "nq": 0, "tl_fb": [], "tl_n": []})
        acc["fb"] += self.fallback_blocks
        acc["saved"] += self.saved_flops
        acc["nq"] += 1
        for b, fb in enumerate(self.timeline):
            while len(acc["tl_fb"]) <= b:
                acc["tl_fb"].append(0)
                acc["tl_n"].append(0)
            acc["tl_fb"][b] += int(fb)
            acc["tl_n"][b] += 1


def finalize_adaptive_extra(stats) -> None:
    """Convert the host accumulator into the public ``ScanStats.extra``
    telemetry keys (``fallback_blocks`` mean per query, ``est_saved_flops``
    batch total, ``rule_timeline`` per-block fallback fraction) — the same
    keys the torch backend reports, so host and device runs are comparable."""
    acc = stats.extra.pop(_ACC_KEY, None)
    if acc is None or acc["nq"] == 0:
        return
    stats.extra[EXTRA_FALLBACK_BLOCKS] = acc["fb"] / acc["nq"]
    stats.extra[EXTRA_EST_SAVED_FLOPS] = acc["saved"]
    stats.extra[EXTRA_RULE_TIMELINE] = [
        f / max(n, 1) for f, n in zip(acc["tl_fb"], acc["tl_n"])]

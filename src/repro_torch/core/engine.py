"""Staged top-k scan engine (host/numpy path) and the statistics shared
by the backends.

A copy of the reference ``core/engine.py``: the canonical
``ScanStats.extra`` key names, the paper's (Delta_0, Delta_d) stage
schedule, ``ScanStats``, ``QueryBatch`` and the host scan ``scan_topk``,
the batched form of Alg. 1/2/3's inner loop: for each block of candidates
the method's screening stages run with real compaction (survivors only
move to the next stage), then exact distances are completed in original
coordinates and merged into the running top-k, whose k-th distance is the
DCO threshold ``tau``.  It is the oracle the IVF index searches through,
with the adaptive host policy (``core.policy.HostPolicy``) and anytime
deadlines (a wall-clock check before each candidate block).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# --- canonical ScanStats.extra keys -----------------------------------------
# Both backends report batch telemetry under these names and ONLY these names
# (api.types re-exports and documents them as STAT_EXTRA_KEYS; the fix for
# the host/jax key drift lives here — add new keys here, never inline).
EXTRA_SURVIVORS_MEAN = "survivors_mean"          # rows exactly completed / query
EXTRA_SCREEN_PASS_MEAN = "screen_pass_mean"      # rows passing the screen / query
EXTRA_UNCERTIFIED_QUERIES = "uncertified_queries"  # frac with failed certificate
EXTRA_FALLBACK_BLOCKS = "fallback_blocks"        # adaptive: fdscan blocks / query
EXTRA_EST_SAVED_FLOPS = "est_saved_flops"        # adaptive: saved vs fdscan, batch
EXTRA_RULE_TIMELINE = "rule_timeline"            # adaptive: fallback frac / block
EXTRA_UNCERTIFIED_MASK = "uncertified_mask"      # per-query certificate failures
EXTRA_COVERAGE = "coverage"                      # per-query scanned fraction
                                                 # (anytime search; 1.0 = full)
EXTRA_DIMS_READ_MEAN = "dims_read_mean"          # dims touched per candidate
                                                 # (screen + completed tails)
EXTRA_DRIFT_SCORE = "drift_score"                # guardrails: EWMA drift score
EXTRA_AUDIT_RECALL = "audit_recall"              # guardrails: audited recall EWMA
EXTRA_BREAKER_STATE = "breaker_state"            # guardrails: breaker state that
                                                 # served the batch
EXTRA_DEGRADED = "degraded"                      # replica tier: 1.0 when the
                                                 # batch lost >= 1 shard
EXTRA_REPLICA = "replica"                        # replica tier: serving replica
                                                 # index (-1 = sharded fan-out)
EXTRA_HEDGED = "hedged"                          # replica tier: 1.0 when a
                                                 # hedge served/raced the batch


def make_schedule(D: int, delta0: int = 32, delta_d: int = 64, max_stages: int = 4):
    """Stage dims per the paper's (Delta_0, Delta_d) parameterization, capped
    to a handful of stages (block-level screening; DESIGN.md §3)."""
    dims, d = [], delta0
    while d < D and len(dims) < max_stages:
        dims.append(d)
        d += delta_d
        delta_d *= 2          # geometric growth keeps stage count bounded
    return dims


@dataclass
class ScanStats:
    dims_scanned: float = 0.0
    dims_total: float = 0.0
    n_dco: int = 0
    n_true: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def pruning_ratio(self) -> float:
        return 1.0 - self.dims_scanned / max(self.dims_total, 1e-9)


@dataclass
class QueryBatch:
    """One prepped batch of queries flowing through the scan/index layers:
    the method's online pre-processing output (``ctx``, which holds the raw
    queries under ``"Q"`` plus any rotated views), the stage schedule and
    the per-batch ``ScanStats``."""

    ctx: dict
    schedule: list
    stats: ScanStats

    @classmethod
    def create(cls, method, Q, schedule=None, stats: ScanStats | None = None):
        """Prep ``Q`` with ``method`` and attach a schedule (defaults to the
        paper's (Delta_0, Delta_d) schedule for the method's D)."""
        ctx = method.prep_queries(Q)
        if schedule is None:
            schedule = make_schedule(method.state["D"])
        return cls(ctx, list(schedule),
                   stats if stats is not None else ScanStats())

    @property
    def Q(self):
        return self.ctx["Q"]

    def __len__(self) -> int:
        return int(self.ctx["Q"].shape[0])


def topk_merge(best_d, best_i, new_d, new_i, k):
    d = np.concatenate([best_d, new_d])
    i = np.concatenate([best_i, new_i])
    order = np.argpartition(d, min(k - 1, len(d) - 1))[:k]
    order = order[np.argsort(d[order])]
    return d[order], i[order]


def scan_topk(method, batch: QueryBatch, qi: int, cand_ids, k, *,
              block: int = 1024, init_d=None, init_i=None, policy=None,
              deadline_ts=None):
    """DCO-accelerated exact-completion top-k over ``cand_ids`` for query
    ``qi`` of ``batch``.  Stats accumulate into ``batch.stats``.

    ``policy`` (a ``core.policy.PolicyConfig`` with ``adaptive=True``)
    enables the adaptive fallback of DESIGN.md §5: when the running survivor
    fraction says screening is net-negative, later blocks skip the stage
    loop and complete every candidate exactly (an fdscan block).  Fallback
    only *adds* scanned dims, so results are unchanged — the host scan
    completes every survivor exhaustively either way.

    ``deadline_ts`` (absolute ``time.monotonic()`` timestamp) arms anytime
    mode (DESIGN.md §7): the wall clock is checked before each candidate
    block and on expiry the running top-k is returned as-is.  The fraction
    of candidate blocks actually scanned is appended to the private
    ``stats.extra["_coverage"]`` list (one entry per scan call, in call
    order); the backend folds it into the public ``EXTRA_COVERAGE`` array
    and flags partial queries via ``EXTRA_UNCERTIFIED_MASK``.
    """
    import time as _time

    from repro_torch.testing import faults

    D = method.state["D"]
    ctx, stats = batch.ctx, batch.stats
    stages = method.stage_dims(batch.schedule)
    hp = None
    if policy is not None and getattr(policy, "adaptive", False) and stages:
        from repro_torch.core.policy import HostPolicy
        hp = HostPolicy(policy, D)
    best_d = init_d if init_d is not None else np.full(k, np.inf, np.float32)
    best_i = init_i if init_i is not None else np.full(k, -1, np.int64)
    cand_ids = np.asarray(cand_ids, np.int64)
    fp = faults.active() if deadline_ts is not None else None
    blocks_done, n_blocks = 0, max(1, -(-len(cand_ids) // block))
    for s in range(0, len(cand_ids), block):
        if deadline_ts is not None:
            if _time.monotonic() > deadline_ts:
                break
            faults.sleep_block(fp)
        blocks_done += 1
        ids = cand_ids[s:s + block]
        tau_sq = float(best_d[-1])
        alive = ids
        fallback = hp is not None and hp.mode
        charged_blk = 0.0
        if stats is not None:
            stats.n_dco += len(ids)
            stats.dims_total += len(ids) * D
        if np.isfinite(tau_sq):
            if fallback:
                # shadow screen at the first stage only: keeps the survivor
                # signal alive for recovery, prunes nothing (alive stays ids)
                d0 = max(stages[0], 1)
                keep, charged = method.screen(ids, ctx, qi, d0, tau_sq)
                charged_blk = len(ids) * charged
                if stats is not None:
                    stats.dims_scanned += charged_blk
                hp.observe(len(ids), int(keep.sum()), charged)
            else:
                # methods exposing partial_range (pure-partial lower bounds:
                # PDScanning/+) screen incrementally: each stage reads only
                # the strided dim group [prev_d, d) and adds it to a carried
                # partial — the host mirror of the device PDX layout
                # (DESIGN.md §8).  Same keep decisions (the accumulated
                # partial IS the stage partial), fewer dims charged.
                pr_fn = getattr(method, "partial_range", None)
                acc, prev_d = None, 0
                for d in stages:
                    if len(alive) == 0:
                        break
                    d_eff = max(d, 1)
                    if pr_fn is not None:
                        if d_eff <= prev_d:
                            continue
                        part = pr_fn(alive, ctx, qi, prev_d, d_eff)
                        acc = part if acc is None else acc + part
                        keep, charged = acc <= tau_sq, float(d_eff - prev_d)
                        prev_d = d_eff
                    else:
                        keep, charged = method.screen(alive, ctx, qi, d_eff,
                                                      tau_sq)
                    charged_blk += len(alive) * charged
                    if stats is not None:
                        stats.dims_scanned += len(alive) * charged
                    alive = alive[keep]
                    if acc is not None:
                        acc = acc[keep]
                if hp is not None:
                    hp.observe(len(ids), len(alive), charged_blk / len(ids))
        if hp is not None:
            hp.block_served(fallback, len(ids), len(alive), charged_blk)
        if len(alive) == 0:
            continue
        ex = method.exact_sq(alive, ctx, qi)
        if stats is not None:
            stats.dims_scanned += len(alive) * D
            stats.n_true += int((ex <= tau_sq).sum()) if np.isfinite(tau_sq) else len(alive)
            # host completion == screen pass (no completion budget); the
            # backend converts these totals to the per-query means of
            # EXTRA_SURVIVORS_MEAN / EXTRA_SCREEN_PASS_MEAN
            stats.extra["_completed_total"] = (
                stats.extra.get("_completed_total", 0) + len(alive))
        best_d, best_i = topk_merge(best_d, best_i, ex.astype(np.float32), alive, k)
    if hp is not None:
        hp.flush(stats)
    if deadline_ts is not None and stats is not None:
        cov = 1.0 if len(cand_ids) == 0 else blocks_done / n_blocks
        stats.extra.setdefault("_coverage", []).append(cov)
    return best_d, best_i

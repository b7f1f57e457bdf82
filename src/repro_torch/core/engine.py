"""Engine constants and per-search statistics shared by the backends.

The subset of the reference ``core/engine.py`` that the flat streaming
search needs: the canonical ``ScanStats.extra`` key names, the paper's
(Delta_0, Delta_d) stage schedule and ``ScanStats``.  The host staged scan
(``scan_topk``) is not ported yet (ROADMAP A4).
"""
from __future__ import annotations

from dataclasses import dataclass, field

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

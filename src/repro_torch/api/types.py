"""Value types of the facade: scheduling policy, search results, stat keys.

A copy of the reference package's ``api/types.py`` with the same fields and
defaults, so one ``SchedulePolicy`` reads the same in both packages.  The
torch backend serves the flat fixed-path streaming search; the options it
does not serve yet (adaptive, guardrails, dim_groups > 1, engine="two_stage",
faults) are refused by ``repro_torch.api.open_index``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import (EXTRA_AUDIT_RECALL, EXTRA_BREAKER_STATE,
                               EXTRA_COVERAGE, EXTRA_DEGRADED,
                               EXTRA_DIMS_READ_MEAN, EXTRA_DRIFT_SCORE,
                               EXTRA_EST_SAVED_FLOPS, EXTRA_FALLBACK_BLOCKS,
                               EXTRA_HEDGED, EXTRA_REPLICA,
                               EXTRA_RULE_TIMELINE, EXTRA_SCREEN_PASS_MEAN,
                               EXTRA_SURVIVORS_MEAN, EXTRA_UNCERTIFIED_MASK,
                               EXTRA_UNCERTIFIED_QUERIES, ScanStats,
                               make_schedule)

#: The canonical ``SearchResult.stats.extra`` keys, with their semantics.
#: Both backends report batch telemetry under these names and only these
#: names (the constants live in ``core.engine`` so the engines and the
#: facade share one spelling; this dict is the normative documentation).
STAT_EXTRA_KEYS: dict = {
    EXTRA_SURVIVORS_MEAN:
        "Mean rows per query whose exact distance was completed (stage-2 "
        "work actually done; measured, not a capacity bound).",
    EXTRA_SCREEN_PASS_MEAN:
        "Mean rows per query that passed the screening rule.  On the host "
        "path this equals survivors_mean (no completion budget); on the jax "
        "streaming path survivors are additionally capped per block by "
        "block_capacity, and under the adaptive policy fallback blocks "
        "complete rows the (shadow) screen rejected.",
    EXTRA_UNCERTIFIED_QUERIES:
        "Fraction of queries whose streaming-engine exactness certificate "
        "failed: some estimate dropped by the per-block completion budget "
        "was <= the returned k-th distance, so a true neighbor may have "
        "been truncated (DESIGN.md §4-5).  0.0 on the host path, which "
        "completes every survivor.  Advisory for estimator rules.",
    EXTRA_FALLBACK_BLOCKS:
        "Adaptive policy only: mean candidate blocks per query served by "
        "the certified fdscan fallback instead of the configured rule.",
    EXTRA_EST_SAVED_FLOPS:
        "Adaptive policy only: cost-model estimate of FLOPs saved by "
        "screening vs an always-fdscan baseline, summed over the batch "
        "(2 FLOPs per row-dim avoided, minus modeled overhead; negative "
        "when screening was pure loss).",
    EXTRA_RULE_TIMELINE:
        "Adaptive policy only: per block index, the fraction of the batch "
        "(query chunks on jax, queries on host) served by the fallback — "
        "the scan-time story of which rule was active when.",
    EXTRA_UNCERTIFIED_MASK:
        "Per-query bool array: row i is True iff query i's exactness "
        "certificate failed (the per-query view of uncertified_queries; "
        "serving.SearchService threads it into per-request results).  All "
        "False on the host path; absent on the legacy two_stage engine, "
        "which has no per-block certificate.",
    EXTRA_DIMS_READ_MEAN:
        "Mean dimensions actually touched per candidate row (screening "
        "reads plus exact-completion tails), the direct evidence that "
        "early exit is firing — compare against D (no pruning) and the "
        "schedule's d1/stage dims.  Measured from the scan itself on the "
        "stream and host paths (per-group/per-stage alive counts, "
        "DESIGN.md §8); formula-derived on the legacy two_stage engine "
        "and the mesh path (screen dims + completed tails).",
    EXTRA_DRIFT_SCORE:
        "Guardrail sessions only (SchedulePolicy.guardrails armed): the "
        "drift sentinel's EWMA-smoothed query-drift score for this batch, "
        "in [0, 1] — 0 = queries look like the reference corpus sample, "
        "1 = maximal spectral/norm deviation (DESIGN.md §9).",
    EXTRA_AUDIT_RECALL:
        "Guardrail sessions only: EWMA of the online recall audit — a "
        "deterministic ~1/64 query sample shadow-re-executed through the "
        "certified full scan, top-k overlap vs the served answer.  1.0 "
        "until the first audit fires.",
    EXTRA_BREAKER_STATE:
        "Guardrail sessions only: the circuit-breaker state that actually "
        "served this batch — 'closed' (screening), 'open' (demoted to the "
        "certified full scan), or 'half_open' (screening canary probe "
        "during recovery).",
    EXTRA_COVERAGE:
        "Per-query float32 array: fraction of candidate blocks actually "
        "scanned for query i (anytime search, DESIGN.md §7).  1.0 "
        "everywhere unless the search ran with a ``deadline_s`` that "
        "expired mid-scan; any value < 1.0 also sets that query's "
        "uncertified_mask bit, since an unscanned block may hold a true "
        "neighbor.  On the jax path the whole batch advances together, so "
        "coverage is uniform across queries; the host path checks the "
        "deadline per query, so later queries can report 0.0.  The replica "
        "tier (DESIGN.md §10) extends the same key *spatially*: under "
        "shard loss, coverage is the fraction of corpus rows the surviving "
        "shards actually hold, again with the certificate withdrawn.",
    EXTRA_DEGRADED:
        "Replica tier only (serving.ReplicatedService, DESIGN.md §10): 1.0 "
        "when this batch was answered from a strict subset of shards — at "
        "least one shard was down after retries, so coverage < 1 and every "
        "query's certificate is withdrawn.  0.0 on fully-covered batches.",
    EXTRA_REPLICA:
        "Replica tier only: index of the replica that served this batch "
        "(mode='replicate'; the hedge winner when a hedge fired), or -1.0 "
        "for a sharded fan-out, where every live shard contributed.",
    EXTRA_HEDGED:
        "Replica tier only: 1.0 when a hedged duplicate dispatch raced "
        "this batch (the primary exceeded its adaptive hedge delay), else "
        "0.0 — whether the hedge *won* is in health()'s hedge_wins.",
}


@dataclasses.dataclass(frozen=True)
class SchedulePolicy:
    """How a session stages its DCO screening, on both backends.

    Host (staged numpy scan): ``delta0``/``delta_d``/``max_stages`` set the
    paper's (Delta_0, Delta_d) stage dims.  Device: ``d1`` is the stage-1
    lead width, ``query_chunk`` the lax.map batch granularity, ``tau_slack``
    the extra slack on the certified threshold.  ``engine`` picks the device
    engine — ``"stream"`` (default; block-fused scan with a running top-k,
    core.stream_engine) or ``"two_stage"`` (legacy one-shot engine that
    materializes the (query_chunk, N) estimate matrix; ``capacity`` is its
    survivor budget).  Streaming knobs: ``row_block`` corpus rows per scan
    step (bigger = fewer merges, more VMEM/HBM per tile), ``block_capacity``
    survivors tail-completed per block per query (must comfortably exceed k;
    the per-block analogue of ``capacity``), ``use_kernel`` routes stage 1
    through the kernels (None = only on a CUDA device).  See DESIGN.md §4.

    ``dim_groups`` > 1 selects the PDX vertical layout (DESIGN.md §8): each
    row block stores its lead dims in that many contiguous groups and the
    streaming scan refines candidates group by group, freezing each one
    whose running partial crosses the certified tau — with the group-0
    R-cut's best dropped estimate folded into the exactness certificate, so
    PDX scans stay certified by construction.  Ignored (forced to 1) for
    methods without a partial-distance screen (FDScanning, DDCopq), by the
    two_stage engine, and on the mesh path.  The host backend mirrors it
    automatically: lower-bound methods screen via incremental
    ``partial_range`` group reads whenever stages are staged.
    ``group_capacity`` bounds the candidates each query carries past group 0
    on the jnp path (0 = auto: max(4*block_capacity, 512)); raise it if
    ``uncertified_queries`` reports R-cut drops.

    ``delta_merge_threshold`` governs the jax backend's LSM-style write path
    (DESIGN.md §6): ``add()`` appends rows to a small delta segment that is
    scanned alongside the cached main block layout (same running tau), and
    the main layout is only re-materialized (a "merge") once the delta holds
    more than this many rows.  0 disables the delta path entirely — every
    insert re-materializes, the pre-PR-6 behavior.

    ``adaptive=True`` arms the adaptive DCO policy (DESIGN.md §5): the
    engines watch per-block survivor fractions and degrade the configured
    rule to the certified fdscan fallback while screening is predicted
    net-negative, recovering when it pays again.  ``fallback_margin`` is
    how much cheaper than a full scan the cost model must predict screening
    to be before it is trusted (>1 = demand headroom; raise it to fall back
    earlier).  Served by the streaming jax engine and the host flat/IVF
    scan; ignored by host HNSW walks and rejected on the mesh path.

    ``wal_max_bytes`` rotates the crash-safe delta WAL (DESIGN.md §7/§10):
    once the active segment reaches this many bytes, later ``add()``
    appends open a fresh numbered segment (``.wal.0001``, ...), replayed in
    order on load with per-segment torn-tail truncation — bounding the
    single-file size (and the blast radius of one torn tail) between
    snapshots.  0 = never rotate, the single-segment pre-PR-10 behavior.

    ``anytime_block_group`` is the deadline-check granularity of anytime
    search on the jax backend (DESIGN.md §7): a ``deadline_s`` search runs
    the streaming scan this many row blocks at a time, syncing with the
    host between groups to test the wall clock.  Smaller = finer deadline
    resolution but more device/host round-trips; the first group always
    completes, so a result is returned even for an already-expired
    deadline.  ``faults`` optionally scopes a ``repro.testing.FaultPlan``
    to sessions built with this policy (chaos testing; see
    ``repro.testing.faults``).

    ``guardrails`` arms the guardrail layer (DESIGN.md §9): pass a
    ``repro.core.guardrails.GuardrailConfig`` (or ``True`` for defaults)
    and the session fits a query-drift sentinel at open time, shadow-audits
    a deterministic ~1/64 query sample against the certified full scan,
    and runs a per-(method, backend) circuit breaker that demotes DCO
    screening to the certified full-scan body while drift plus audit
    evidence says screening can't be trusted — recovering via half-open
    canary probes.  Supported for scan-shaped searches (index 'flat' or
    'ivf') on both backends; rejected for HNSW (a graph walk has no
    certified fallback) and on the mesh path; a no-op for FDScanning
    sessions, which are already the fallback.
    """

    delta0: int = 32
    delta_d: int = 64
    max_stages: int = 4
    d1: int = 128
    capacity: int = 2048
    query_chunk: int = 16
    tau_slack: float = 1.0
    engine: str = "stream"
    row_block: int = 4096
    block_capacity: int = 128
    use_kernel: bool | None = None
    dim_groups: int = 1
    group_capacity: int = 0
    adaptive: bool = False
    fallback_margin: float = 1.5
    delta_merge_threshold: int = 4096
    wal_max_bytes: int = 0
    anytime_block_group: int = 8
    faults: object | None = None
    guardrails: object | None = None

    def stage_dims(self, D: int) -> list:
        """Host screening stage dims for dimensionality ``D`` (the paper's
        (Delta_0, Delta_d) schedule, capped at ``max_stages``)."""
        return make_schedule(D, delta0=self.delta0, delta_d=self.delta_d,
                             max_stages=self.max_stages)


@dataclasses.dataclass
class SearchResult:
    """Batched search output: row ``i`` answers query ``i``.

    ``dists`` are squared Euclidean distances (the monotone form every method
    computes in); ``stats`` aggregates DCO work over the whole batch (see
    ``STAT_EXTRA_KEYS`` for the ``stats.extra`` telemetry); ``wall_time_s``
    is the facade-measured end-to-end time including online query
    pre-processing.
    """

    dists: np.ndarray          # (nq, k) float32
    ids: np.ndarray            # (nq, k) int64
    stats: ScanStats
    wall_time_s: float
    backend: str

    @property
    def nq(self) -> int:
        """Number of queries answered."""
        return int(self.ids.shape[0])

    @property
    def k(self) -> int:
        """Neighbors returned per query."""
        return int(self.ids.shape[1])

    @property
    def qps(self) -> float:
        """Queries per second over the facade-measured wall time."""
        return self.nq / max(self.wall_time_s, 1e-12)

"""The backends behind ``SearchSession``: the torch backend and the host
backend.

``HostBackend`` is a numpy copy of the reference package's host backend:
the staged scan (``core.engine.scan_topk``) over a flat corpus, an IVF
partition probe (``search.ivf.IVFIndex.search``) or an HNSW graph walk
(``search.hnsw.HNSWIndex.search``), on the host.  It runs no kernel.

``TorchBackend`` is the counterpart of the reference package's
``JaxBackend`` on one device (a CUDA card unless the caller asks for the
CPU): it lays the fitted method's uniform ``device_state()`` export out
row-blocked or in the PDX dim-group layout, partition-major for an IVF
index, and serves batched searches through the streaming engine
(``core.stream_engine``), or through the legacy two-stage engine
(``SchedulePolicy(engine="two_stage")``) from a row-major layout.
Inserts take the LSM-style write path: new rows are served from a small
delta segment scanned after the cached main blocks until the delta
exceeds ``SchedulePolicy.delta_merge_threshold`` rows.  On a CUDA device
each query chunk's block walk replays a CUDA graph cached beside the
layout (``stream_engine._ChunkGraph``).

Both backends serve the adaptive policy (``SchedulePolicy(adaptive=True)``,
``core.policy``), anytime deadlines (``search(deadline_s=)``) with the
fault hooks of ``testing.faults``, and the guardrail breaker
(``SchedulePolicy(guardrails=)``, ``core.guardrails``), whose demoted path
on the torch backend is the streaming engine's full-scan body.

With a ``mesh`` (``launch.mesh``) the torch backend shards a flat corpus
over the mesh's ranks: every rank holds only its own rows on its device,
walks them with either engine and the ranks merge their top-k lists
(``torch_engine.make_distributed_topk``).  The mesh path serves the fixed
policy on one dim group; DDCopq screens with the exact lower-bound rule
there, and an IVF index, the adaptive policy, guardrails and deadlines
are single-device, as in the reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import transforms as T
from repro_torch.core.engine import (EXTRA_COVERAGE, EXTRA_DIMS_READ_MEAN,
                                     EXTRA_EST_SAVED_FLOPS,
                                     EXTRA_FALLBACK_BLOCKS,
                                     EXTRA_RULE_TIMELINE,
                                     EXTRA_SCREEN_PASS_MEAN,
                                     EXTRA_SURVIVORS_MEAN,
                                     EXTRA_UNCERTIFIED_MASK,
                                     EXTRA_UNCERTIFIED_QUERIES, QueryBatch,
                                     ScanStats, scan_topk)
from repro_torch.core.policy import PolicyConfig, finalize_adaptive_extra
from repro_torch.core.stream_engine import (append_stream_blocks,
                                            build_stream_blocks, stream_topk)
from repro_torch.core.torch_engine import (DcoEngineConfig,
                                           _aligned_row_block,
                                           build_device_state,
                                           exchange_failure,
                                           make_distributed_topk,
                                           rule_scalars, shard_of,
                                           two_stage_topk)
from repro_torch.testing import faults
from repro_torch.utils import trace


#: per-row device tensors that build_stream_blocks turns into the blocks
_ROW_KEYS = ("x_lead", "x_tail", "lead_sq", "tail_sq", "row_ids", "row_part",
             "codes")


def _arm_guardrail(method, index_kind: str, policy, backend: str):
    """Build the per-(method, backend) breaker when the schedule asks for
    one (DESIGN.md §9).  HNSW walks have no scan-shaped certified fallback
    to demote to (rejected); ``FDScanning`` already IS the certified full
    scan, so there is nothing to guard (silently unarmed)."""
    gcfg = getattr(policy, "guardrails", None)
    if gcfg is None or gcfg is False:
        return None
    if index_kind == "hnsw":
        raise ValueError(
            "guardrails demote scan-shaped searches (index='flat'/'ivf') to "
            "a certified full scan; an HNSW graph walk has no such fallback "
            "(DESIGN.md §9)")
    if method.name == "FDScanning":
        return None
    from repro_torch.core.guardrails import Guardrail, GuardrailConfig
    if gcfg is True:
        gcfg = GuardrailConfig()
    return Guardrail(gcfg, method, backend)


def _code_dtype(n_codes: int):
    """PQ codes as the device holds them: one byte each when the codebooks
    have at most 256 entries (the host's uint16 codes narrow losslessly),
    else int32."""
    return np.uint8 if n_codes <= 256 else np.int32


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` means the CUDA card (on a mesh, card ``rank % cards``); a
    CUDA device without a card raises instead of quietly running on the
    CPU, and a device of another type than the mesh's ``ValueError``."""
    if device is None and mesh is not None and torch.cuda.is_available():
        import torch.distributed as dist
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=None runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type!r} mesh cannot serve a "
                         f"session on {dev}: pass a device of its type")
    return dev


class HostBackend:
    """Numpy staged-scan execution over flat / IVF / HNSW candidates."""

    name = "host"

    def __init__(self, method, index_kind: str, index, policy):
        self.method = method
        self.index_kind = index_kind
        self.index = index
        self.policy = policy
        # adaptive fdscan fallback (DESIGN.md §5) for the scan-shaped index
        # kinds; HNSW graph walks screen tiny per-hop batches and ignore it
        self._pol = PolicyConfig.from_schedule(policy)
        # demoted serving: every candidate block completes exactly
        self._pol_demoted = PolicyConfig(adaptive=True, force_fallback=True)
        self.guardrail = _arm_guardrail(method, index_kind, policy, "host")

    def invalidate(self):
        """No-op: nothing is cached on the host path."""

    def notify_append(self, n_new: int, parts=None) -> str:
        """Inserts need no layout work on the host path (the scan reads the
        method's live numpy arrays); returns the write mode for telemetry
        parity with the torch backend."""
        return "noop"

    def search(self, Q, k: int, *, nprobe: int, ef: int,
               deadline_s: float | None = None):
        """Batched staged-scan top-k; returns (dists, ids, stats).

        ``deadline_s`` (seconds of wall budget for the whole batch) arms
        anytime mode (DESIGN.md §7): the scan checks the clock between
        candidate blocks, queries past the budget return their running
        top-k, and per-query ``coverage`` (candidate blocks scanned, 1.0 =
        complete) lands in ``stats.extra`` with partial queries flagged in
        ``uncertified_mask``.  With ``SchedulePolicy(guardrails=...)``
        armed, non-deadline batches route through the breaker (DESIGN.md
        §9); deadline calls bypass it."""
        faults.check_search(faults.active(self.policy))
        g = self.guardrail
        if g is not None and deadline_s is None:
            return g.run(
                Q, k,
                screen=lambda q: self._search(q, k, nprobe=nprobe, ef=ef),
                certified=lambda q: self._search(q, k, nprobe=nprobe, ef=ef,
                                                 demoted=True),
                plan=faults.active(self.policy))
        return self._search(Q, k, nprobe=nprobe, ef=ef,
                            deadline_s=deadline_s)

    def _search(self, Q, k: int, *, nprobe: int, ef: int,
                deadline_s: float | None = None, demoted: bool = False):
        """The scan itself; ``demoted=True`` serves every candidate block
        by the exhaustive exact completion (``PolicyConfig(force_fallback)``
        pins the host policy's fallback mode: the guardrail's certified
        path)."""
        m = self.method
        t_end = None
        if deadline_s is not None:
            if self.index_kind == "hnsw":
                raise ValueError(
                    "anytime deadlines interrupt scan-shaped searches "
                    "(index='flat'/'ivf'); an HNSW graph walk has no block "
                    "boundary to stop at (DESIGN.md §7)")
            t_end = time.monotonic() + float(deadline_s)
        pol = self._pol_demoted if demoted else self._pol
        batch = QueryBatch.create(m, Q, self.policy.stage_dims(m.state["D"]))
        dists = np.empty((len(batch), k), np.float32)
        ids = np.empty((len(batch), k), np.int64)
        all_ids = None
        for qi in range(len(batch)):
            if self.index_kind == "flat":
                if all_ids is None:
                    all_ids = np.arange(m.state["N"])
                d, i = scan_topk(m, batch, qi, all_ids, k, policy=pol,
                                 deadline_ts=t_end)
            elif self.index_kind == "ivf":
                d, i = self.index.search(m, batch, qi, k, nprobe,
                                         policy=pol, deadline_ts=t_end)
            else:                   # hnsw
                d, i = self.index.search(m, batch, qi, k, max(ef, k))
            n = min(k, len(d))
            dists[qi, :n], ids[qi, :n] = d[:n], i[:n]
            if n < k:
                dists[qi, n:], ids[qi, n:] = np.inf, -1
        self._finalize_stats(batch.stats, len(batch))
        return dists, ids, batch.stats

    @staticmethod
    def _finalize_stats(stats, nq: int) -> None:
        """Fold scan accumulators into the canonical ``extra`` telemetry
        keys (api.types.STAT_EXTRA_KEYS) so host batches report the same
        fields as the torch backend."""
        completed = stats.extra.pop("_completed_total", None)
        if completed is not None:
            # no completion budget on the host scan: pass == completed
            stats.extra[EXTRA_SURVIVORS_MEAN] = completed / max(nq, 1)
            stats.extra[EXTRA_SCREEN_PASS_MEAN] = completed / max(nq, 1)
        # every host survivor is exactly completed -> certified, UNLESS an
        # anytime deadline cut the scan short: unscanned candidate blocks
        # may hold true neighbors, so partial queries are uncertified
        cov = stats.extra.pop("_coverage", None)
        coverage = np.ones(nq, np.float32)
        if cov is not None:
            coverage[:len(cov)] = np.asarray(cov, np.float32)
        stats.extra[EXTRA_COVERAGE] = coverage
        stats.extra[EXTRA_UNCERTIFIED_MASK] = coverage < 1.0
        stats.extra[EXTRA_UNCERTIFIED_QUERIES] = float(
            (coverage < 1.0).mean())
        stats.extra[EXTRA_DIMS_READ_MEAN] = (
            stats.dims_scanned / max(stats.n_dco, 1))
        finalize_adaptive_extra(stats)


class TorchBackend:
    """Streaming DCO search over a flat or IVF-probed corpus on one torch
    device, with an LSM-style delta segment for inserts, or over a flat
    corpus sharded on a mesh (one shard a rank)."""

    name = "torch"

    def __init__(self, method, policy, *, index_kind: str = "flat",
                 index=None, device=None, mesh=None):
        if index_kind == "ivf" and mesh is not None:
            raise ValueError(
                "device IVF probing is single-device; mesh-shard a flat "
                "corpus instead")
        if mesh is not None and getattr(policy, "adaptive", False):
            raise ValueError(
                "the adaptive DCO policy is single-device for now — drop "
                "SchedulePolicy(adaptive=True) on the mesh path "
                "(DESIGN.md §5)")
        if mesh is not None and getattr(policy, "guardrails", None) is not None:
            raise ValueError(
                "guardrails are single-device (the breaker's demotion runs "
                "the streaming engine's forced full-scan body) — drop "
                "SchedulePolicy(guardrails=...) on the mesh path "
                "(DESIGN.md §9)")
        self.method = method
        self.index_kind = index_kind
        self.index = index
        self.policy = policy
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self._dstate = None         # host-side device_state() export
        self._state = None          # device tensors
        self._blocks = None         # cached stream-engine corpus layout
        self._d1 = None
        self._groups = 1            # PDX dim groups of that layout
        self._list_sizes = None     # IVF partition sizes (probe stats)
        # (k, anytime, demoted) -> DcoEngineConfig
        self._cfg_cache: dict = {}
        self.guardrail = _arm_guardrail(method, index_kind, policy, "torch")
        # captured block walks (stream_engine._ChunkGraph) over the cached
        # layout; a graph holds its addresses, so it goes with the layout
        self._graphs: dict = {}
        # mesh path: cfg -> DistributedTopK, the shard-aligned row_block
        self._mesh_fns: dict = {}
        self._mesh_row_block = None
        self._mesh_joined = False   # this search reached the exchange
        # ---- LSM-style delta segment ----
        self._n_main = 0            # rows in the materialized main layout
        self._delta_parts = np.empty(0, np.int32)   # IVF parts of delta rows
        self._delta_blocks = None   # cached combined main + delta layout
        self._delta_state = None    # _state with the combined tail_min
        self._delta_dirty = False
        # write-path telemetry (insert amplification)
        self.rows_inserted = 0      # rows arriving through notify_append
        self.rows_written = 0       # rows laid out on the device (main + delta)
        self.merges = 0             # threshold-triggered re-materializations

    # -- state management ---------------------------------------------------
    def invalidate(self):
        """Drop the device layout (full re-materialization on the next
        search; ``notify_append`` is the cheaper delta path for adds)."""
        self._dstate = self._state = self._blocks = None
        self._groups = 1
        self._list_sizes = None
        self._cfg_cache.clear()
        self._graphs.clear()
        self._mesh_fns.clear()
        self._mesh_row_block = None
        self._n_main = 0
        self._delta_parts = np.empty(0, np.int32)
        self._delta_blocks = self._delta_state = None
        self._delta_dirty = False

    def _resolved_engine(self) -> str:
        """The engine ``search`` runs: opq, IVF probing, the adaptive policy
        and the guardrail's demotion are stream-only.  Requires a
        materialized ``_dstate``."""
        if (self._dstate["kind"] == "opq" or self.index_kind == "ivf"
                or PolicyConfig.from_schedule(self.policy) is not None
                or self.guardrail is not None):
            return "stream"
        return self.policy.engine

    @property
    def delta_rows(self) -> int:
        """Rows currently served from the delta segment (0 when merged)."""
        if self._dstate is None:
            return 0
        return int(self.method.state["N"]) - self._n_main

    def notify_append(self, n_new: int, parts=None) -> str:
        """Register ``n_new`` rows just appended to the method state.

        Returns the write mode taken:
          ``"delta"``    rows join the delta segment; the cached main block
                         layout survives and the next search scans both
                         segments under one running tau;
          ``"merge"``    the delta exceeded ``delta_merge_threshold``: the
                         whole layout re-materializes on the next search;
          ``"rebuild"``  delta path unavailable (mesh, two_stage engine
                         or threshold 0): full invalidation;
          ``"cold"``     nothing was materialized yet, so the first search
                         lays out everything at once anyway.
        ``parts`` is the IVF partition assignment of the new rows (required
        for index_kind='ivf'; ``IVFIndex.insert`` returns it)."""
        self.rows_inserted += int(n_new)
        if self._dstate is None:
            self.invalidate()
            return "cold"
        thresh = self.policy.delta_merge_threshold
        if (self.mesh is not None or thresh <= 0
                or self._resolved_engine() != "stream"):
            self.invalidate()
            return "rebuild"
        if self.index_kind == "ivf":
            if parts is None:
                raise ValueError("notify_append(index='ivf') needs the "
                                 "partition assignment of the new rows")
            self._delta_parts = np.concatenate(
                [self._delta_parts, np.asarray(parts, np.int32)])
        if self.delta_rows > thresh:
            self.merges += 1
            self.invalidate()
            return "merge"
        self._delta_dirty = True
        return "delta"

    def _build_delta(self):
        """(Re)build the delta segment's blocks at the main layout's width
        and concatenate them after the cached main blocks (the LSM write
        path).  Host work is O(delta): methods keep Xrot incrementally, and
        the segment is padded to whole blocks on the host.  The device-side
        concatenation copies the main blocks (O(N) bandwidth) but never
        re-materializes them."""
        n_total = int(self.method.state["N"])
        n_delta = n_total - self._n_main
        ds = self.method.device_state()
        if ds["kind"] != self._dstate["kind"]:
            # the method was re-trained under us (kind flip, e.g. DDCopq
            # lb -> opq): the cached main layout is for the wrong rule
            self.invalidate()
            self._materialize()
            return
        xr = np.asarray(ds["Xrot"], np.float32)[self._n_main:]
        d1 = self._d1
        B = int(self._blocks["xl"].shape[-2])
        pad = -n_delta % B
        delta_tail_min = float((xr[:, d1:] ** 2).sum(1).min())
        row_ids = np.arange(self._n_main, n_total, dtype=np.int32)
        parts = np.asarray(self._delta_parts, np.int32)
        codes = None
        if ds["kind"] == "opq":     # the main layout's code dtype
            codes = np.asarray(ds["codes"][self._n_main:], _code_dtype(
                ds["books"].shape[1]))
        if pad:
            xr = np.concatenate([xr, np.zeros((pad, xr.shape[1]),
                                              np.float32)])
            row_ids = np.concatenate([row_ids, np.full(pad, -1, np.int32)])
            if parts.size:      # edge-mode, as build_stream_blocks pads
                parts = np.concatenate([parts, np.full(pad, parts[-1],
                                                       np.int32)])
            if codes is not None:
                codes = np.concatenate(
                    [codes, np.zeros((pad, codes.shape[1]), codes.dtype)])

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        dstate = {
            "x_lead": dev(xr[:, :d1]), "x_tail": dev(xr[:, d1:]),
            "lead_sq": dev((xr[:, :d1] ** 2).sum(1)),
            "tail_sq": dev((xr[:, d1:] ** 2).sum(1)),
            "row_ids": dev(row_ids),
        }
        if self.index_kind == "ivf":
            dstate["row_part"] = dev(parts)
        if codes is not None:
            dstate["codes"] = dev(codes)
        self._graphs.clear()        # they walk the layout being replaced
        self._delta_blocks = append_stream_blocks(self._blocks, dstate)
        # thread the combined tail-norm minimum so the ddcres screen stays
        # as loose as fitted
        self._delta_state = dict(self._state)
        if "tail_min" in self._state:
            self._delta_state["tail_min"] = torch.clamp_max(
                self._state["tail_min"], delta_tail_min)
        self._delta_dirty = False
        self.rows_written += n_delta

    def _materialize(self):
        dstate = self.method.device_state()
        if self.mesh is not None and dstate["kind"] == "opq":
            # PQ screening is single-device; the shards fall back to the
            # exact lower-bound rule of the base export
            from repro_torch.core.methods import DCOMethod
            dstate = DCOMethod.device_state(self.method)
        xr = np.asarray(dstate["Xrot"], np.float32)
        D = self.method.state["D"]
        if xr.shape[1] != D:
            raise ValueError(
                f"{self.method.name}: rotation rank {xr.shape[1]} < D={D}; "
                "the device engine needs a full-rank rotation for exact "
                "stage-2 completion")
        n = xr.shape[0]
        rows = {"Xrot": xr}
        row_ids = np.arange(n, dtype=np.int32)
        if dstate["kind"] == "opq":
            rows["codes"] = np.asarray(dstate["codes"],
                                       _code_dtype(dstate["books"].shape[1]))
        if self.index_kind == "ivf":
            # partition-major layout: the streaming engine probes by gating
            # row blocks whose partition span holds no probed partition
            part = np.empty(n, np.int64)
            for j, lst in enumerate(self.index.lists):
                part[lst] = j
            perm = np.argsort(part, kind="stable")
            rows = {key: a[perm] for key, a in rows.items()}
            row_ids = perm.astype(np.int32)
            rows["row_part"] = part[perm].astype(np.int32)
            self._list_sizes = np.array([len(lst)
                                         for lst in self.index.lists])
        self._dstate = dstate
        self._d1 = min(self.policy.d1, D)
        self._n_main = n
        self.rows_written += n
        self._groups = 1
        if self.mesh is not None:
            self._materialize_shard(dstate, xr)
            return
        if self._resolved_engine() == "two_stage":
            # the two-stage engine reads the corpus row-major, without pad
            # rows (zero norms would enter its top-k); the blocks are not
            # built, so the corpus lies on the device once
            self._state = build_device_state(dict(dstate, Xrot=xr), self._d1,
                                             self.device)
            return
        # PDX layout (DESIGN.md §8): the group count the scan runs with,
        # forced to 1 for rules with no partial-distance screen (what
        # stream_engine._effective_groups resolves)
        if dstate["kind"] not in ("fdscan", "opq"):
            self._groups = max(1, int(self.policy.dim_groups))
        # lay the corpus out on the host: pad the rows to whole row blocks
        # (ids -1, partitions edge-padded) and build the blocks (for PDX,
        # the dim-group-major lead) from CPU tensors, so the one copy to the
        # device is the final layout and the corpus lies on the device once
        pad = (-n) % min(self.policy.row_block, n)
        if pad:
            row_ids = np.pad(row_ids, (0, pad), constant_values=-1)
            rows = {key: np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                                mode="edge" if key == "row_part"
                                else "constant")
                    for key, a in rows.items()}
        state = build_device_state(dict(dstate, Xrot=rows.pop("Xrot")),
                                   self._d1, "cpu")
        state["row_ids"] = torch.from_numpy(row_ids)
        state.update({key: torch.from_numpy(a) for key, a in rows.items()})
        blocks = build_stream_blocks(state, self.policy.row_block,
                                     dim_groups=self._groups)
        self._blocks = {key: v.to(self.device) for key, v in blocks.items()}
        # the engine reads the corpus through the blocks only; keep the
        # per-rule scalars and the real rows' least tail energy (ddcres)
        state["tail_min"] = state["tail_sq"][:n].min()
        self._state = {key: v.to(self.device) for key, v in state.items()
                       if key not in _ROW_KEYS}

    def _materialize_shard(self, dstate: dict, xr: np.ndarray):
        """The mesh path's layout: this rank's rows only, on one dim group.
        The squared norms are row sums, so the shard's equal the whole
        corpus's rows; ``tail_min`` is the shard's own (the reference's
        local engine takes it over the shard's rows), the rule scalars the
        whole corpus's.  The row block is aligned to the shard size, so
        the streaming layout is a view of the shard's rows (no pad row)."""
        index, n_shards = shard_of(self.mesh)
        per_shard = max(1, self._n_main // n_shards)
        lo = index * per_shard
        state = build_device_state(dict(dstate, Xrot=xr[lo:lo + per_shard]),
                                   self._d1, self.device)
        state["tail_min"] = state["tail_sq"].min()
        self._state = state
        self._mesh_extra_state = rule_scalars(dstate, self._d1, self.device)
        self._mesh_row_block = _aligned_row_block(per_shard,
                                                  self.policy.row_block)
        if self._resolved_engine() == "stream":
            self._blocks = build_stream_blocks(state, self._mesh_row_block)

    def _config(self, k: int, anytime: bool = False,
                demoted: bool = False) -> DcoEngineConfig:
        """The engine config for ``k``, cached: a deadline call (``anytime``)
        runs the fixed walk, so it strips the policy, as fdscan does (it has
        nothing to fall back to); a ``demoted`` one (the guardrail's open
        breaker and its audits) pins ``force_fallback``.  An adaptive
        policy screens inline except on opq, whose ``pq_lookup`` keeps its
        kernel."""
        key = (k, anytime, demoted)
        if key in self._cfg_cache:
            return self._cfg_cache[key]
        ds, p = self._dstate, self.policy
        row_block = p.row_block if self.mesh is None else self._mesh_row_block
        kw = dict(kind=ds["kind"], d1=self._d1, k=k, capacity=p.capacity,
                  query_chunk=p.query_chunk, tau_slack=p.tau_slack,
                  row_block=row_block, block_capacity=p.block_capacity,
                  use_kernel=p.use_kernel, dim_groups=self._groups,
                  group_capacity=p.group_capacity)
        if ds["kind"] == "adsampling":
            kw["eps0"] = float(ds.get("eps0", 2.1))
        elif ds["kind"] == "ddcres":
            kw["m"] = float(ds.get("m", 3.0))
        elif ds["kind"] == "ratio":
            kw["theta"] = self._ratio_theta(k)
        elif ds["kind"] == "opq":
            kw["theta"] = float(ds["theta"])
        if demoted:
            kw["policy"] = PolicyConfig(adaptive=True, force_fallback=True,
                                        fallback_margin=p.fallback_margin)
        elif ds["kind"] != "fdscan" and not anytime:
            kw["policy"] = PolicyConfig.from_schedule(p)
        if kw.get("policy") is not None and ds["kind"] != "opq":
            kw["use_kernel"] = False
        elif kw["use_kernel"] is None:
            kw["use_kernel"] = self.device.type == "cuda"
        cfg = DcoEngineConfig(**kw)
        self._cfg_cache[key] = cfg
        return cfg

    def _ratio_theta(self, k: int) -> float:
        """Largest trained stage <= d1 for the trained k; theta=1.0 (exact
        lower-bound rule) when no model applies."""
        models = self._dstate.get("models") or {}
        trained = [(d, th) for (kk, d), th in models.items()
                   if kk == self._dstate.get("trained_k") and d <= self._d1]
        return max(trained)[1] if trained else 1.0

    def _prep_queries(self, Q):
        """Rotate/center queries into the device basis + per-query extras
        (DDCres tail energy and variance at d1, or the DDCopq PQ lookup
        tables), in numpy as the reference computes them."""
        ds, d1 = self._dstate, self._d1
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        Qp = Q - ds["mean"] if ds.get("mean") is not None else Q
        Qr = Qp @ ds["W"] if ds.get("W") is not None else Qp
        q_extra = {}
        if ds["kind"] == "ddcres":
            qres = np.clip((Qp ** 2).sum(1) - (Qr ** 2).sum(1), 0.0, None)
            var = ((Qr[:, d1:] ** 2) * ds["sigma_sq"][None, d1:]).sum(1)
            q_extra = {
                "qtail_sq": (Qr[:, d1:] ** 2).sum(1) + qres,
                "var_d1": var + qres * float(ds["tail_var"]),
            }
        elif ds["kind"] == "opq":
            pq = {"books": ds["books"], "splits": ds["splits"]}
            q_extra = {"lut": np.stack([T.pq_query_lut(pq, q) for q in Qr])}
        return Qr[:, :d1], Qr[:, d1:], q_extra

    def _probe(self, Q, nprobe: int):
        """Rank partitions by centroid distance (the rule of the host
        ``IVFIndex.probe_ids``) -> (nq, nprobe) partition ids and candidate
        counts."""
        cent = self.index.centroids
        npb = min(nprobe, cent.shape[0])
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        d2 = (cent ** 2).sum(1)[None, :] - 2.0 * Q @ cent.T   # +||q||^2 const
        probed = np.argpartition(d2, npb - 1, axis=1)[:, :npb]
        return probed.astype(np.int32), self._list_sizes[probed].sum(1)

    # -- search --------------------------------------------------------------
    def search(self, Q, k: int, *, nprobe: int = 16, ef: int = 64,
               deadline_s: float | None = None):
        """Batched device top-k; returns (dists, ids, stats).  ``nprobe``
        is the IVF probe width; ``ef`` is accepted for signature parity
        with the host backend (unused).

        ``deadline_s`` (seconds of wall budget for the whole batch) arms
        the streaming engine's anytime mode (DESIGN.md §7): the corpus is
        walked in ``SchedulePolicy.anytime_block_group`` block groups with
        a wall check at each boundary, an expired budget returns the
        running top-k, and the scanned fraction lands in
        ``stats.extra["coverage"]`` with partial queries flagged
        uncertified (the adaptive policy is stripped for the call).

        With ``SchedulePolicy(guardrails=...)`` armed, non-deadline batches
        route through the breaker (DESIGN.md §9): drift is scored, a
        sampled audit shadow-runs the forced full scan, and an OPEN breaker
        serves the whole batch through it.  Deadline calls bypass it.

        On a mesh every rank calls this with the same queries and gets the
        same result or the same failure: deadlines raise there on every
        rank (``ValueError``, before any collective), and a rank that
        fails alone (a fault plan armed in its process, an error in its
        walk) still joins the exchange with its part marked failed, so
        every rank raises (``torch_engine.exchange_failure``)."""
        if self.mesh is not None:
            return self._mesh_search(Q, k, nprobe=nprobe,
                                     deadline_s=deadline_s)
        faults.check_search(faults.active(self.policy))
        g = self.guardrail
        if g is not None and deadline_s is None:
            return g.run(
                Q, k,
                screen=lambda q: self._search(q, k, nprobe=nprobe),
                certified=lambda q: self._search(q, k, nprobe=nprobe,
                                                 demoted=True),
                plan=faults.active(self.policy))
        return self._search(Q, k, nprobe=nprobe, deadline_s=deadline_s)

    def _mesh_search(self, Q, k: int, *, nprobe: int,
                     deadline_s: float | None):
        """:meth:`search` on a mesh (no IVF probe, no guardrail).  The
        fault hook counts the call first, as on one device; a deadline
        then raises on every rank alike (``_search``, after the layout, as
        the reference), and any other error before this rank reaches the
        exchange joins it marked failed."""
        if deadline_s is not None:
            faults.check_search(faults.active(self.policy))
            return self._search(Q, k, nprobe=nprobe, deadline_s=deadline_s)
        self._mesh_joined = False
        try:
            faults.check_search(faults.active(self.policy))
            return self._search(Q, k, nprobe=nprobe)
        except Exception as exc:        # noqa: BLE001 - joined, then raised
            if self._mesh_joined:
                raise
            exchange_failure(np.atleast_2d(Q).shape[0], k, self.device, exc)

    def _search(self, Q, k: int, *, nprobe: int,
                deadline_s: float | None = None, demoted: bool = False):
        """The engine dispatch itself; ``demoted=True`` swaps in the
        forced-fallback config (every chunk runs the full-scan body: the
        guardrail's certified path)."""
        # the layout builds a search triggers are set-up spans (no
        # synchronize: device work still queued ends in the next graph's
        # warm-up)
        if self._dstate is None:
            with trace.setup_span("backend.layout"):
                self._materialize()
        if self.delta_rows and (self._delta_dirty
                                or self._delta_blocks is None):
            with trace.setup_span("backend.delta_build",
                                  rows=self.delta_rows):
                self._build_delta()
        t_end = None
        if deadline_s is not None:
            if self.mesh is not None:
                raise ValueError(
                    "anytime deadlines are single-device (the mesh scan has "
                    "no per-group host sync to check the clock at; "
                    "DESIGN.md §7)")
            t_end = time.monotonic() + float(deadline_s)
        cfg = self._config(k, anytime=t_end is not None, demoted=demoted)
        engine = self._resolved_engine()
        if t_end is not None:
            engine = "stream"       # only the streaming engine serves it
        if engine == "stream" and self._blocks is None:
            # a two-stage session's deadline call: lay the blocks out once
            self._blocks = build_stream_blocks(self._state,
                                               self.policy.row_block)

        def dev(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        with trace.span("backend.prep"):
            ql, qt, qe = self._prep_queries(Q)
            ql_t, qt_t = dev(ql), dev(qt)
            qe_t = {key: dev(v) for key, v in qe.items()}
        nq, N, D = ql.shape[0], self.method.state["N"], self.method.state["D"]
        cand_per_q = np.full(nq, N, np.float64)
        passed = dmin = dims_read = report = coverage = None
        n_anchor = 0                # two_stage completes k anchors per query
        if self.mesh is not None:
            if cfg not in self._mesh_fns:
                self._mesh_fns[cfg] = make_distributed_topk(
                    self.mesh, cfg, tuple(self.mesh.mesh_dim_names),
                    extra_state=self._mesh_extra_state, engine=engine,
                    n_rows=self._n_main)
            self._mesh_joined = True    # it joins the exchange, come what may
            with trace.span("backend.walk"):
                out = self._mesh_fns[cfg](self._state, ql_t, qt_t, qe_t,
                                          blocks=self._blocks,
                                          graphs=self._graphs)
            with trace.span("backend.readback"):
                d, i, surv, dmin = (o.cpu().numpy() for o in out)
            if engine == "two_stage":
                n_anchor = nq * k * shard_of(self.mesh)[1]
        elif engine == "two_stage":
            with trace.span("backend.walk"):
                out = two_stage_topk(self._state, ql_t, qt_t, cfg, qe_t)
            # one transfer back per output, after the whole batch is queued
            with trace.span("backend.readback"):
                d, i, surv = (o.cpu().numpy() for o in out)
            n_anchor = nq * k
        else:
            blocks, st = self._blocks, self._state
            if self.delta_rows:
                blocks, st = self._delta_blocks, self._delta_state
            probe = None
            if self.index_kind == "ivf":
                with trace.span("backend.prep"):
                    probed, cand_per_q = self._probe(Q, nprobe)
                    probe = dev(probed, np.int32)
                nd = self.delta_rows
                if nd:
                    # delta rows are probe candidates too when their
                    # partition was selected
                    cand_per_q = cand_per_q + (
                        self._delta_parts[None, :nd, None]
                        == probed[:, None, :]).any(-1).sum(1)
            with trace.span("backend.walk"):
                out = stream_topk(st, ql_t, qt_t, cfg, qe_t, probe,
                                  blocks=blocks, deadline_ts=t_end,
                                  block_group=self.policy.anytime_block_group,
                                  graphs=self._graphs)
            with trace.span("backend.readback"):
                if cfg.policy is not None:
                    out, report = out[:6], {key: v.cpu().numpy()
                                            for key, v in out[6].items()}
                elif t_end is not None:
                    out, coverage = out[:6], out[6]
                    # a partial scan touched only this share of the
                    # corpus: charge candidate work pro rata
                    cand_per_q = cand_per_q * coverage
                d, i, surv, passed, dmin, dims_read = (o.cpu().numpy()
                                                       for o in out)
        with trace.span("backend.stats"):
            stats = ScanStats(n_dco=int(cand_per_q.sum()),
                              dims_total=float((cand_per_q * D).sum()))
            if cfg.kind == "fdscan":
                stats.dims_scanned = stats.dims_total
            else:
                # stage 1 streams d1 dims for every candidate row; stage 2
                # (plus the two-stage engine's k anchor completions) streams
                # the tail for the actual survivors
                stats.dims_scanned = (float((cand_per_q * self._d1).sum())
                                      + float(surv.sum() + n_anchor)
                                      * (D - self._d1))
                stats.extra[EXTRA_SURVIVORS_MEAN] = float(surv.mean())
                if passed is not None:  # the mesh path does not count passes
                    stats.extra[EXTRA_SCREEN_PASS_MEAN] = float(passed.mean())
                if dmin is not None:    # one device's two-stage: no certificate
                    self._certify(stats, d, dmin)
            if dims_read is not None:
                # the streaming scan measured its own reads (screen dims
                # entered plus completed tails; full rows in fallback blocks)
                stats.dims_scanned = float(np.asarray(dims_read,
                                                      np.float64).sum())
            stats.extra[EXTRA_DIMS_READ_MEAN] = (
                stats.dims_scanned / max(stats.n_dco, 1))
            if report is not None:
                stats.extra[EXTRA_FALLBACK_BLOCKS] = float(
                    report["fallback_blocks"].mean())
                stats.extra[EXTRA_EST_SAVED_FLOPS] = float(
                    report["est_saved_flops"].sum())
                stats.extra[EXTRA_RULE_TIMELINE] = [
                    float(v) for v in report["rule_timeline"]]
            # anytime coverage: the whole batch advances together, so every
            # query shares the scanned fraction; a partial scan is uncertified
            # even where the certificate held over the scanned prefix
            cov_arr = np.full(nq, 1.0 if coverage is None else coverage,
                              np.float32)
            stats.extra[EXTRA_COVERAGE] = cov_arr
            mask = stats.extra.get(EXTRA_UNCERTIFIED_MASK)
            if mask is not None and coverage is not None and coverage < 1.0:
                stats.extra[EXTRA_UNCERTIFIED_MASK] = mask | (cov_arr < 1.0)
                stats.extra[EXTRA_UNCERTIFIED_QUERIES] = float(
                    stats.extra[EXTRA_UNCERTIFIED_MASK].mean())
            return (np.asarray(d, np.float32), np.asarray(i, np.int64), stats)

    @staticmethod
    def _certify(stats, d, dmin):
        """Streaming-engine exactness certificate: a query is certified iff
        every estimate the per-block completion budget dropped exceeds its
        returned k-th distance.  For estimator rules the stat is
        advisory."""
        fail = np.asarray(dmin) <= np.asarray(d)[:, -1]
        stats.extra[EXTRA_UNCERTIFIED_QUERIES] = float(fail.mean())
        stats.extra[EXTRA_UNCERTIFIED_MASK] = fail


def make_backend(name: str, method, policy, *, index_kind: str = "flat",
                 index=None, device=None, mesh=None):
    """Construct the executor for ``name``: ``"torch"`` (the device
    engines on ``device``, sharded over ``mesh`` when one is given) or
    ``"host"`` (the numpy scan; ``device`` is not used)."""
    if name == "torch":
        return TorchBackend(method, policy, index_kind=index_kind,
                            index=index, device=device, mesh=mesh)
    if name == "host":
        if mesh is not None:
            raise ValueError("mesh sharding is a torch-backend feature")
        return HostBackend(method, index_kind, index, policy)
    raise ValueError(f"unknown backend {name!r} (expected 'torch' or "
                     "'host')")

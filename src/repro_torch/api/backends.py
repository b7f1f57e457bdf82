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
layout (``stream_engine._ChunkGraph``).  The adaptive policy (ROADMAP A3),
deadlines (A4), guardrails (A5) and the mesh (A7) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transforms as T
from repro_torch.core.engine import (EXTRA_COVERAGE, EXTRA_DIMS_READ_MEAN,
                                     EXTRA_SCREEN_PASS_MEAN,
                                     EXTRA_SURVIVORS_MEAN,
                                     EXTRA_UNCERTIFIED_MASK,
                                     EXTRA_UNCERTIFIED_QUERIES, QueryBatch,
                                     ScanStats, scan_topk)
from repro_torch.core.stream_engine import (append_stream_blocks,
                                            build_stream_blocks, stream_topk)
from repro_torch.core.torch_engine import (DcoEngineConfig,
                                           build_device_state, two_stage_topk)


#: per-row device tensors that build_stream_blocks turns into the blocks
_ROW_KEYS = ("x_lead", "x_tail", "lead_sq", "tail_sq", "row_ids", "row_part",
             "codes")


def _code_dtype(n_codes: int):
    """PQ codes as the device holds them: one byte each when the codebooks
    have at most 256 entries (the host's uint16 codes narrow losslessly),
    else int32."""
    return np.uint8 if n_codes <= 256 else np.int32


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises
    instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the torch backend runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


class HostBackend:
    """Numpy staged-scan execution over flat / IVF / HNSW candidates."""

    name = "host"

    def __init__(self, method, index_kind: str, index, policy):
        self.method = method
        self.index_kind = index_kind
        self.index = index
        self.policy = policy

    def invalidate(self):
        """No-op: nothing is cached on the host path."""

    def notify_append(self, n_new: int, parts=None) -> str:
        """Inserts need no layout work on the host path (the scan reads the
        method's live numpy arrays); returns the write mode for telemetry
        parity with the torch backend."""
        return "noop"

    def search(self, Q, k: int, *, nprobe: int, ef: int):
        """Batched staged-scan top-k; returns (dists, ids, stats)."""
        m = self.method
        batch = QueryBatch.create(m, Q, self.policy.stage_dims(m.state["D"]))
        dists = np.empty((len(batch), k), np.float32)
        ids = np.empty((len(batch), k), np.int64)
        all_ids = None
        for qi in range(len(batch)):
            if self.index_kind == "flat":
                if all_ids is None:
                    all_ids = np.arange(m.state["N"])
                d, i = scan_topk(m, batch, qi, all_ids, k)
            elif self.index_kind == "ivf":
                d, i = self.index.search(m, batch, qi, k, nprobe)
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
        fields as the torch backend.  Every host survivor is exactly
        completed, so every query is certified and covered.  The adaptive
        keys come with the adaptive policy (ROADMAP A3): a fixed scan
        reports none, as the reference's ``finalize_adaptive_extra`` then
        adds none."""
        completed = stats.extra.pop("_completed_total", None)
        if completed is not None:
            # no completion budget on the host scan: pass == completed
            stats.extra[EXTRA_SURVIVORS_MEAN] = completed / max(nq, 1)
            stats.extra[EXTRA_SCREEN_PASS_MEAN] = completed / max(nq, 1)
        coverage = np.ones(nq, np.float32)
        stats.extra[EXTRA_COVERAGE] = coverage
        stats.extra[EXTRA_UNCERTIFIED_MASK] = coverage < 1.0
        stats.extra[EXTRA_UNCERTIFIED_QUERIES] = float(
            (coverage < 1.0).mean())
        stats.extra[EXTRA_DIMS_READ_MEAN] = (
            stats.dims_scanned / max(stats.n_dco, 1))


class TorchBackend:
    """Streaming DCO search over a flat or IVF-probed corpus on one torch
    device, with an LSM-style delta segment for inserts."""

    name = "torch"

    def __init__(self, method, policy, *, index_kind: str = "flat",
                 index=None, device=None):
        self.method = method
        self.index_kind = index_kind
        self.index = index
        self.policy = policy
        self.device = resolve_device(device)
        self._dstate = None         # host-side device_state() export
        self._state = None          # device tensors
        self._blocks = None         # cached stream-engine corpus layout
        self._d1 = None
        self._groups = 1            # PDX dim groups of that layout
        self._list_sizes = None     # IVF partition sizes (probe stats)
        self._cfg_cache: dict = {}  # k -> DcoEngineConfig
        # captured block walks (stream_engine._ChunkGraph) over the cached
        # layout; a graph holds its addresses, so it goes with the layout
        self._graphs: dict = {}
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
        self._n_main = 0
        self._delta_parts = np.empty(0, np.int32)
        self._delta_blocks = self._delta_state = None
        self._delta_dirty = False

    def _resolved_engine(self) -> str:
        """The engine ``search`` runs: opq and IVF probing are stream-only.
        Requires a materialized ``_dstate``."""
        if self._dstate["kind"] == "opq" or self.index_kind == "ivf":
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
          ``"rebuild"``  delta path unavailable (two_stage engine or
                         threshold 0): full invalidation;
          ``"cold"``     nothing was materialized yet, so the first search
                         lays out everything at once anyway.
        ``parts`` is the IVF partition assignment of the new rows (required
        for index_kind='ivf'; ``IVFIndex.insert`` returns it)."""
        self.rows_inserted += int(n_new)
        if self._dstate is None:
            self.invalidate()
            return "cold"
        thresh = self.policy.delta_merge_threshold
        if thresh <= 0 or self._resolved_engine() != "stream":
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

    def _config(self, k: int) -> DcoEngineConfig:
        if k in self._cfg_cache:
            return self._cfg_cache[k]
        ds, p = self._dstate, self.policy
        kw = dict(kind=ds["kind"], d1=self._d1, k=k, capacity=p.capacity,
                  query_chunk=p.query_chunk, tau_slack=p.tau_slack,
                  row_block=p.row_block, block_capacity=p.block_capacity,
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
        if kw["use_kernel"] is None:
            kw["use_kernel"] = self.device.type == "cuda"
        cfg = DcoEngineConfig(**kw)
        self._cfg_cache[k] = cfg
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
    def search(self, Q, k: int, *, nprobe: int = 16, ef: int = 64):
        """Batched device top-k; returns (dists, ids, stats).  ``nprobe``
        is the IVF probe width; ``ef`` is accepted for signature parity
        with the reference's host backend (unused)."""
        if self._dstate is None:
            self._materialize()
        if self.delta_rows and (self._delta_dirty
                                or self._delta_blocks is None):
            self._build_delta()
        cfg = self._config(k)
        ql, qt, qe = self._prep_queries(Q)
        nq, N, D = ql.shape[0], self.method.state["N"], self.method.state["D"]

        def dev(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        ql_t, qt_t = dev(ql), dev(qt)
        qe_t = {key: dev(v) for key, v in qe.items()}
        cand_per_q = np.full(nq, N, np.float64)
        passed = dmin = dims_read = None
        n_anchor = 0                # two_stage completes k anchors per query
        if self._resolved_engine() == "two_stage":
            out = two_stage_topk(self._state, ql_t, qt_t, cfg, qe_t)
            # one transfer back per output, after the whole batch is queued
            d, i, surv = (o.cpu().numpy() for o in out)
            n_anchor = nq * k
        else:
            blocks, st = self._blocks, self._state
            if self.delta_rows:
                blocks, st = self._delta_blocks, self._delta_state
            probe = None
            if self.index_kind == "ivf":
                probed, cand_per_q = self._probe(Q, nprobe)
                probe = dev(probed, np.int32)
                nd = self.delta_rows
                if nd:
                    # delta rows are probe candidates too when their
                    # partition was selected
                    cand_per_q = cand_per_q + (
                        self._delta_parts[None, :nd, None]
                        == probed[:, None, :]).any(-1).sum(1)
            out = stream_topk(st, ql_t, qt_t, cfg, qe_t, probe, blocks=blocks,
                              graphs=self._graphs)
            d, i, surv, passed, dmin, dims_read = (o.cpu().numpy()
                                                   for o in out)
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
            if passed is not None:  # the two-stage engine has no certificate
                stats.extra[EXTRA_SCREEN_PASS_MEAN] = float(passed.mean())
                self._certify(stats, d, dmin)
        if dims_read is not None:
            # the streaming scan measured its own reads (screen dims
            # entered plus completed tails)
            stats.dims_scanned = float(np.asarray(dims_read,
                                                  np.float64).sum())
        stats.extra[EXTRA_DIMS_READ_MEAN] = (
            stats.dims_scanned / max(stats.n_dco, 1))
        stats.extra[EXTRA_COVERAGE] = np.ones(nq, np.float32)
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
                 index=None, device=None):
    """Construct the executor for ``name``: ``"torch"`` (the device
    engines on ``device``) or ``"host"`` (the numpy scan; ``device`` is
    not used)."""
    if name == "torch":
        return TorchBackend(method, policy, index_kind=index_kind,
                            index=index, device=device)
    if name == "host":
        return HostBackend(method, index_kind, index, policy)
    raise ValueError(f"unknown backend {name!r} (expected 'torch' or "
                     "'host')")

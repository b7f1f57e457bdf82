"""The torch backend behind ``SearchSession``.

``TorchBackend`` is the counterpart of the reference package's
``JaxBackend`` for a flat corpus: it lays the fitted method's uniform
``device_state()`` export out on one device (a CUDA card unless the caller
asks for the CPU), row-blocked or in the PDX dim-group layout, and serves
batched searches through the streaming engine (``core.stream_engine``).
IVF probing, the delta write path, the adaptive policy, guardrails,
deadlines and the mesh are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transforms as T
from repro_torch.core.engine import (EXTRA_COVERAGE, EXTRA_DIMS_READ_MEAN,
                                     EXTRA_SCREEN_PASS_MEAN,
                                     EXTRA_SURVIVORS_MEAN,
                                     EXTRA_UNCERTIFIED_MASK,
                                     EXTRA_UNCERTIFIED_QUERIES, ScanStats)
from repro_torch.core.stream_engine import build_stream_blocks, stream_topk
from repro_torch.core.torch_engine import DcoEngineConfig, build_device_state


#: per-row device tensors that build_stream_blocks turns into the blocks
_ROW_KEYS = ("x_lead", "x_tail", "lead_sq", "tail_sq", "row_ids", "codes")


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


class TorchBackend:
    """Flat-corpus streaming DCO search on one torch device."""

    name = "torch"

    def __init__(self, method, policy, device=None):
        self.method = method
        self.policy = policy
        self.device = resolve_device(device)
        self._dstate = None         # host-side device_state() export
        self._state = None          # device tensors
        self._blocks = None         # cached stream-engine corpus layout
        self._d1 = None
        self._groups = 1            # PDX dim groups of that layout
        self._cfg_cache: dict = {}  # k -> DcoEngineConfig

    def invalidate(self):
        """Drop the device layout (re-materialized on the next search)."""
        self._dstate = self._state = self._blocks = None
        self._cfg_cache.clear()

    def _materialize(self):
        dstate = self.method.device_state()
        xr = np.asarray(dstate["Xrot"], np.float32)
        D = self.method.state["D"]
        if xr.shape[1] != D:
            raise ValueError(
                f"{self.method.name}: rotation rank {xr.shape[1]} < D={D}; "
                "the device engine needs a full-rank rotation for exact "
                "stage-2 completion")
        self._dstate = dstate
        self._d1 = min(self.policy.d1, D)
        # PDX layout (DESIGN.md §8): the group count the scan runs with,
        # forced to 1 for rules with no partial-distance screen (what
        # stream_engine._effective_groups resolves)
        self._groups = 1
        if dstate["kind"] not in ("fdscan", "opq"):
            self._groups = max(1, int(self.policy.dim_groups))
        # lay the corpus out on the host: pad the rows to whole row blocks
        # and build the blocks (for PDX, the dim-group-major lead) from CPU
        # tensors, so the one copy to the device is the final layout and
        # the corpus lies on the device once
        n = xr.shape[0]
        pad = (-n) % min(self.policy.row_block, n)
        rows = {"Xrot": xr}
        if dstate["kind"] == "opq":
            rows["codes"] = np.asarray(dstate["codes"],
                                       _code_dtype(dstate["books"].shape[1]))
        if pad:
            rows = {key: np.pad(a, ((0, pad), (0, 0)))
                    for key, a in rows.items()}
        state = build_device_state(dict(dstate, Xrot=rows["Xrot"]), self._d1,
                                   "cpu")
        state["row_ids"] = torch.cat([
            torch.arange(n, dtype=torch.int32),
            torch.full((pad,), -1, dtype=torch.int32)])
        if "codes" in rows:
            state["codes"] = torch.from_numpy(rows["codes"])
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

    def search(self, Q, k: int):
        """Batched device top-k; returns (dists, ids, stats)."""
        if self._dstate is None:
            self._materialize()
        cfg = self._config(k)
        ql, qt, qe = self._prep_queries(Q)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                self.device)

        out = stream_topk(self._state, dev(ql), dev(qt), cfg,
                          {key: dev(v) for key, v in qe.items()},
                          blocks=self._blocks)
        # one transfer back per output, after the whole batch is queued
        d, i, surv, passed, dmin, dims_read = (o.cpu().numpy() for o in out)
        nq, N, D = ql.shape[0], self.method.state["N"], self.method.state["D"]
        cand_per_q = np.full(nq, N, np.float64)
        stats = ScanStats(n_dco=int(cand_per_q.sum()),
                          dims_total=float((cand_per_q * D).sum()))
        if cfg.kind == "fdscan":
            stats.dims_scanned = stats.dims_total
        else:
            stats.extra[EXTRA_SURVIVORS_MEAN] = float(surv.mean())
            stats.extra[EXTRA_SCREEN_PASS_MEAN] = float(passed.mean())
            self._certify(stats, d, dmin)
        # the streaming scan measured its own reads (screen dims entered
        # plus completed tails)
        stats.dims_scanned = float(np.asarray(dims_read, np.float64).sum())
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


def make_backend(name: str, method, policy, *, device=None):
    """Construct the executor for ``name``; only ``"torch"`` is ported."""
    if name == "torch":
        return TorchBackend(method, policy, device=device)
    if name == "host":
        raise NotImplementedError(
            "backend='host' (the numpy staged scan) is not ported yet "
            "(ROADMAP A4)")
    raise ValueError(f"unknown backend {name!r} (expected 'torch')")

"""Device DCO engine: configuration, device state and the two-stage engine.

Counterpart of the reference package's ``core/jax_engine.py``: the engine
config, the dimension-blocked device state built from a fitted method's
``device_state()`` export, the per-rule replicated scalars, the batched
query rotation and the legacy one-shot engine ``two_stage_topk``
(``SchedulePolicy(engine="two_stage")``), which forms a full
(query_chunk, N) estimate matrix per chunk with one ``torch.matmul`` and
runs no hand-written kernel, as the reference forms it outside any Pallas
kernel.  The streaming engine (``core.stream_engine``) is the default
device path.  :func:`make_distributed_topk` runs either engine on each
rank's shard of a mesh and merges the shards' top-k lists.

Per query chunk the two-stage engine computes

  stage 1  partial squared distances over the leading ``d1`` rotated dims
           for every row, and the rule's estimate from them;
  anchor   exact distances for the k best rows BY ESTIMATE: their largest
           is a certified upper bound tau on the true k-th distance;
  stage 2  tail completion for at most ``capacity`` rows whose estimate
           passes tau, then the final top-k.

Every ``lax.top_k`` of the reference is ``stream_engine._smallest``, so
ties keep the lower index first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class DcoEngineConfig:
    kind: str = "lb"           # fdscan|lb|adsampling|dade|ddcres|ratio|opq
    d1: int = 128              # stage-1 dims
    k: int = 20
    capacity: int = 2048       # two-stage survivor capacity per query
    eps0: float = 2.1          # adsampling
    z_alpha: float = 2.0       # dade
    m: float = 3.0             # ddcres
    theta: float = 1.0         # ratio (DDCpca) / opq (DDCopq) threshold
    tau_slack: float = 1.0     # extra slack on the certified tau
    query_chunk: int = 16      # queries per chunk of the block loop
    # --- streaming engine (core.stream_engine) knobs ---
    row_block: int = 4096      # candidate rows per block step
    block_capacity: int = 128  # survivors tail-completed per block per query
    use_kernel: bool | None = None  # CUDA kernels for stage 1 (None ->
                                    # only on a CUDA device)
    policy: object | None = None    # core.policy.PolicyConfig: the
                                    # adaptive fdscan fallback
    dim_groups: int = 1        # PDX layout: lead dim groups (1 = flat)
    group_capacity: int = 0    # PDX R-cut budget of the inline path
                               # (0 = max(4 * block_capacity, 512))


def build_device_state(method_or_arrays, d1: int, device) -> dict:
    """Dimension-blocked device tensors from a fitted host method's
    ``device_state()`` export (or a raw dict with 'Xrot').  The squared
    norms are computed in numpy, exactly as the reference does, and then
    moved to ``device``.  Requires a full-rank rotation so that lead + tail
    == exact."""
    if isinstance(method_or_arrays, dict):
        extras = method_or_arrays
    else:
        extras = method_or_arrays.device_state()
    xr = np.asarray(extras["Xrot"], np.float32)
    D = xr.shape[1]
    d1 = min(d1, D)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = {
        "x_lead": dev(xr[:, :d1]),
        "x_tail": dev(xr[:, d1:]),
        "lead_sq": dev((xr[:, :d1] ** 2).sum(1)),
        "tail_sq": dev((xr[:, d1:] ** 2).sum(1)),
    }
    state.update(rule_scalars(extras, d1, device))
    return state


def rule_scalars(extras: dict, d1: int, device) -> dict:
    """Per-rule scalars the engine needs beyond the blocked arrays (DADE
    eigen-mass and slack at d1), as float32 0-d tensors on ``device``."""
    out = {}
    if "mass" in extras:
        out["mass_d1"] = torch.tensor(
            max(float(extras["mass"][d1 - 1]), 1e-9), dtype=torch.float32,
            device=device)
        out["eps_d1"] = torch.tensor(float(extras["eps_d"][d1 - 1]),
                                     dtype=torch.float32, device=device)
    return out


def rotate_queries(W: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Batched online pre-processing: one matmul for the whole batch."""
    return Q @ W


def _estimate(cfg: DcoEngineConfig, partial, D, state, q_extra):
    d1 = cfg.d1
    if cfg.kind in ("lb", "fdscan"):
        return partial
    if cfg.kind == "adsampling":
        return partial * (D / d1) / (1.0 + cfg.eps0 / np.sqrt(d1)) ** 2
    if cfg.kind == "dade":
        return partial / state["mass_d1"] / (1.0 + state["eps_d1"]) ** 2
    if cfg.kind == "ratio":
        return partial / cfg.theta
    if cfg.kind == "ddcres":
        # full-distance estimate: lead partial + exact tail norms, minus the
        # Gaussian slack on the unscanned cross term (core.methods Eq. 7)
        slack = 2.0 * cfg.m * torch.sqrt(torch.clamp_min(q_extra["var_d1"],
                                                         0.0))
        return (partial + state["tail_sq"][None, :]
                + q_extra["qtail_sq"][:, None] - slack[:, None])
    raise ValueError(cfg.kind)


def _two_stage_topk_padded(state: dict, q_lead, q_tail, q_extra: dict,
                           cfg: DcoEngineConfig):
    """Chunked two-stage top-k; requires nq to divide into query chunks."""
    from repro_torch.core.stream_engine import _smallest

    x_lead, x_tail = state["x_lead"], state["x_tail"]
    n, d1 = x_lead.shape
    D = d1 + x_tail.shape[1]
    k, C = cfg.k, min(cfg.capacity, n)
    nq = q_lead.shape[0]
    c = min(cfg.query_chunk, nq)

    def one_chunk(ql, qt, qe):
        rows = torch.arange(ql.shape[0], device=ql.device)[:, None]
        # ---- stage 1: one contiguous-stream matmul --------------------
        partial = torch.clamp_min(
            state["lead_sq"][None, :] - 2.0 * (ql @ x_lead.T)
            + (ql ** 2).sum(1)[:, None], 0.0)                 # (c, n)
        est = _estimate(cfg, partial, D, state, qe)
        if cfg.kind == "fdscan":
            exact = partial + (state["tail_sq"][None, :]
                               - 2.0 * (qt @ x_tail.T)
                               + (qt ** 2).sum(1)[:, None])
            dists, ids = _smallest(exact, k)
            return dists, ids, torch.full((ql.shape[0],), n,
                                          dtype=torch.int32, device=ql.device)
        # ---- anchor: certified tau from k exact completions -----------
        _, anchor = _smallest(est, k)                     # (c, k) by estimate
        a_tail = x_tail[anchor]                           # (c, k, Dt)
        a_exact = partial[rows, anchor] + torch.clamp_min(
            ((a_tail - qt[:, None, :]) ** 2).sum(-1), 0.0)
        tau = a_exact.max(-1).values * cfg.tau_slack      # (c,)
        # ---- screening + capacity selection ---------------------------
        score = torch.where(est <= tau[:, None], est, float("inf"))
        s, cand = _smallest(score, C)                     # (c, C) survivors
        alive = torch.isfinite(s)
        # ---- stage 2: tail completion only for survivors --------------
        c_tail = x_tail[cand]                             # (c, C, Dt)
        exact = partial[rows, cand] + torch.clamp_min(
            ((c_tail - qt[:, None, :]) ** 2).sum(-1), 0.0)
        exact = torch.where(alive, exact, float("inf"))
        dists, pos = _smallest(exact, k)
        return dists, torch.gather(cand, 1, pos), alive.sum(
            -1, dtype=torch.int32)

    outs = [one_chunk(q_lead[s:s + c], q_tail[s:s + c],
                      {key: v[s:s + c] for key, v in q_extra.items()})
            for s in range(0, nq, c)]
    d, i, surv = (torch.cat([o[j] for o in outs]) for j in range(3))
    return d, i.to(torch.int32), surv


def two_stage_topk(state: dict, q_lead, q_tail, cfg: DcoEngineConfig,
                   q_extra: dict | None = None):
    """Top-k over the corpus for a batch of (already rotated) queries.

    q_lead (Q, d1), q_tail (Q, D - d1) tensors on the state's device, a
    :func:`build_device_state` export with its per-row tensors.  Ragged
    batches (``nq`` not a multiple of ``cfg.query_chunk``) are zero-padded
    to a whole number of chunks and the padding rows sliced off the
    results.  ``q_extra`` carries optional per-query scalars (DDCres tail
    norms / variance suffix).  Returns (dists_sq (Q, k), ids (Q, k) int32,
    survivors (Q,) number of stage-2 rows actually alive)."""
    q_extra = dict(q_extra or {})
    nq = q_lead.shape[0]
    if nq == 0:
        raise ValueError("two_stage_topk needs at least one query")
    c = min(cfg.query_chunk, nq)
    pad = (-nq) % c
    if pad:
        def padq(v):
            return torch.nn.functional.pad(v, (0, 0) * (v.dim() - 1) + (0, pad))
        q_lead, q_tail = padq(q_lead), padq(q_tail)
        q_extra = {key: padq(v) for key, v in q_extra.items()}
    d, i, s = _two_stage_topk_padded(state, q_lead, q_tail, q_extra, cfg)
    return d[:nq], i[:nq], s[:nq]


def _aligned_row_block(per_shard: int, row_block: int) -> int:
    """The largest divisor of ``per_shard`` that is <= ``row_block`` — the
    biggest certificate-safe streaming block for a mesh shard of that size
    (worst case 1, which is always safe)."""
    rb = max(1, min(int(row_block), int(per_shard)))
    while per_shard % rb:
        rb -= 1
    return rb


def make_distributed_topk(mesh, cfg: DcoEngineConfig,
                          shard_axes=("data", "model"),
                          extra_state: dict | None = None,
                          engine: str = "stream", n_rows: int | None = None):
    """The sharded engine: corpus rows sharded over ``shard_axes`` of
    ``mesh`` (a ``launch.mesh`` ``DeviceMesh``), queries and per-query
    extras replicated; a local top-k per shard, then an all-gather of
    the shards' lists and a global merge.

    The reference's ``shard_map`` becomes SPMD by process: every rank
    calls the returned :class:`DistributedTopK` with its own shard, and
    every rank gets the same (dists (Q, k), ids (Q, k), survivors (Q,),
    dropped_min_est (Q,)).  The local engine is the streaming scan
    (``core.stream_engine``, the default) or the two-stage engine.
    ``extra_state`` carries the replicated rule scalars of
    :func:`rule_scalars`.  Survivors are the real stage-2 completions
    summed over the shards; ``dropped_min_est`` is the least over the
    shards (the weakest certificate), +inf for the two-stage engine.

    ``n_rows`` (the total row count) arms the reference's build-time
    checks: rows that do not shard evenly, and for the streaming engine a
    shard that is not a ``row_block`` multiple (its last block would be
    padded with phantom rows, weakening the shard's certificate).  Only
    the mesh's shape is read here."""
    from repro_torch.launch.mesh import mesh_axes

    if engine not in ("stream", "two_stage"):
        raise ValueError(f"engine must be 'stream' or 'two_stage', got {engine!r}")
    if cfg.policy is not None and getattr(cfg.policy, "adaptive", False):
        raise ValueError(
            "the adaptive DCO policy is single-device for now — drop "
            "SchedulePolicy(adaptive=True) on the mesh path (DESIGN.md §5)")
    if n_rows is not None:
        sizes = mesh_axes(mesh)
        n_shards = int(np.prod([sizes[a] for a in shard_axes]))
        per_shard, rem = divmod(int(n_rows), n_shards)
        if rem:
            raise ValueError(
                f"make_distributed_topk: {n_rows} rows do not shard evenly "
                f"over {n_shards} devices ({shard_axes}); pad the corpus to "
                f"a multiple of {n_shards} rows before sharding")
        if engine == "stream" and per_shard % cfg.row_block:
            raise ValueError(
                f"make_distributed_topk: shard size {per_shard} is not a "
                f"multiple of row_block={cfg.row_block} — the per-shard "
                "streaming layout would pad the last block with phantom "
                "zero rows, weakening every shard's exactness certificate "
                "(DESIGN.md §4/§10).  Use a row_block that divides the "
                f"shard size (e.g. {_aligned_row_block(per_shard, cfg.row_block)}) "
                "or pad the corpus; the facade's mesh path auto-aligns")
    return DistributedTopK(mesh, cfg, tuple(shard_axes),
                           dict(extra_state or {}), engine)


def _shard_index(mesh, coord, axes) -> int:
    """The shard index of mesh coordinate ``coord``: row-major over
    ``axes``, as the reference's ``axis_index`` arithmetic computes it."""
    names = tuple(mesh.mesh_dim_names)
    index = 0
    for a in axes:
        j = names.index(a)
        index = index * tuple(mesh.shape)[j] + int(coord[j])
    return index


def shard_of(mesh, shard_axes=None) -> tuple[int, int]:
    """(this rank's shard index, shard count) over ``shard_axes``
    (default: every dim of the mesh)."""
    axes = tuple(mesh.mesh_dim_names if shard_axes is None else shard_axes)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return (_shard_index(mesh, mesh.get_coordinate(), axes),
            int(np.prod([sizes[a] for a in axes])))


class DistributedTopK:
    """The per-rank callable of :func:`make_distributed_topk`.

    ``self(state, q_lead, q_tail, q_extra=None, *, blocks=None,
    graphs=None)``: ``state`` is the rank's shard as a
    :func:`build_device_state` export (with, for ddcres, the shard's own
    ``tail_min``, as the reference's local engine takes it); ``blocks``
    and ``graphs`` are the shard's cached streaming layout and its CUDA
    graphs (``stream_topk``), built once by the caller.

    The exchange: each rank packs its (Q, k) distances and globalised
    ids, its survivors, its ``dropped_min_est`` and a failure word into
    one (Q, 2k + 3) int32 buffer (the floats' bits), and one
    ``all_gather`` over the process group gives every rank every shard's
    buffer; the ranks of
    this rank's replica group (same coordinates off ``shard_axes``) are
    taken in shard order, the lists merged into (Q, S * k) with column
    ``s * k + j`` and the k smallest kept in ``lax.top_k``'s order
    (``stream_engine._smallest``), survivors summed and the estimates'
    minimum taken: the reference's all_gather, psum and pmin in one
    collective.  On an nccl group the buffers stay on the device; on a
    gloo group they are copied to the CPU for the exchange (gloo's CUDA
    support is partial), and the merged result is on the CPU.  A failed
    collective raises.

    The ranks agree on failure: a rank whose local walk raises still
    joins the exchange, its part marked failed by the failure word (the
    error's text in the part's other words, see :func:`exchange_failure`),
    and then every rank raises: the failed rank its own error, the others
    :class:`MeshSearchError` with that text.  No rank waits for a part
    that will not come.

    Each call records two hot-path spans (``utils.trace``): ``mesh.local``,
    the local engine up to its results on the device (a synchronize), and
    ``mesh.exchange``, the exchange with the merge (it includes waiting
    for the slowest rank); ``on_device`` says whether it exchanged device
    tensors."""

    def __init__(self, mesh, cfg: DcoEngineConfig, shard_axes: tuple,
                 extra_state: dict, engine: str):
        self.mesh, self.cfg, self.engine = mesh, cfg, engine
        self.shard_axes, self.extra_state = shard_axes, extra_state
        self._src = self._state = None
        self._order = None
        self.on_device = None

    def _replica_ranks(self) -> list:
        """Global ranks holding this rank's replica group's shards, in
        shard order."""
        if self._order is None:
            names = tuple(self.mesh.mesh_dim_names)
            ranks = self.mesh.mesh
            if ranks.numel() != dist.get_world_size():
                raise ValueError("the mesh must span every rank of the "
                                 "process group")
            me = self.mesh.get_coordinate()
            order = []
            for r in range(ranks.numel()):
                coord = [int(c) for c in (ranks == r).nonzero()[0]]
                if all(coord[j] == me[j] for j, a in enumerate(names)
                       if a not in self.shard_axes):
                    order.append((_shard_index(self.mesh, coord,
                                               self.shard_axes), r))
            self._order = [r for _, r in sorted(order)]
        return self._order

    def __call__(self, state: dict, q_lead, q_tail, q_extra=None, *,
                 blocks=None, graphs=None):
        from repro_torch.core.stream_engine import _smallest, stream_topk

        with trace.span("mesh.local"):
            try:
                if state is not self._src:   # one dict, so cached graphs match
                    self._src, self._state = state, {**state, **self.extra_state}
                st, cfg = self._state, self.cfg
                if self.engine == "stream":
                    d, i, surv, _, dmin, _ = stream_topk(
                        st, q_lead, q_tail, cfg, q_extra, blocks=blocks,
                        graphs=graphs)
                else:
                    d, i, surv = two_stage_topk(st, q_lead, q_tail, cfg, q_extra)
                    dmin = torch.full((d.shape[0],), float("inf"),
                                      device=d.device)
                index, _ = shard_of(self.mesh, self.shard_axes)
                i = i + index * state["x_lead"].shape[0]
                packed = torch.cat([d.contiguous().view(torch.int32),
                                    i.to(torch.int32),
                                    surv.to(torch.int32)[:, None],
                                    dmin.contiguous().view(torch.int32)[:, None],
                                    torch.zeros_like(i[:, :1], dtype=torch.int32)],
                                   1)
                if packed.is_cuda:
                    torch.cuda.synchronize(packed.device)
            except Exception as exc:        # noqa: BLE001 - joined, then raised
                exchange_failure(q_lead.shape[0], self.cfg.k, q_lead.device, exc)
        k = self.cfg.k
        with trace.span("mesh.exchange"):
            parts, on_device = _all_gather(packed)
            _raise_failed(parts, k)
            got = torch.stack([parts[r] for r in self._replica_ranks()])
            nq = got.shape[1]
            dg = got[..., :k].view(torch.float32).permute(1, 0, 2).reshape(nq, -1)
            ig = got[..., k:2 * k].permute(1, 0, 2).reshape(nq, -1)
            best, pos = _smallest(dg, k)
            out = (best, torch.gather(ig, 1, pos),
                   got[..., 2 * k].sum(0, dtype=torch.int32),
                   got[..., 2 * k + 1].view(torch.float32).amin(0))
            if on_device:
                torch.cuda.synchronize(packed.device)
        self.on_device = on_device
        return out


class MeshSearchError(RuntimeError):
    """Raised on every rank of a mesh search whose exchange carried a
    part marked failed by another rank; the message names that rank and
    gives its error's text."""


def _all_gather(packed):
    """Every rank's (Q, 2k + 3) buffer, in rank order, and whether they
    were exchanged on the device (an nccl group; gloo gets host copies)."""
    on_device = packed.is_cuda and "nccl" in str(dist.get_backend())
    if packed.is_cuda and not on_device:
        packed = packed.cpu()
    parts = [torch.empty_like(packed) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, packed)
    return parts, on_device


def _raise_failed(parts, k: int) -> None:
    """Raise :class:`MeshSearchError` when a part is marked failed."""
    words = torch.stack([part[0, 2 * k + 2] for part in parts]).tolist()
    for r, n in enumerate(words):
        if n:
            text = bytes(parts[r][:, :2 * k + 2].contiguous()
                         .view(torch.uint8).cpu().reshape(-1)[:n - 1]
                         .tolist())
            raise MeshSearchError(
                f"the mesh search failed on rank {r}: "
                f"{text.decode('utf-8', 'replace')}")


def exchange_failure(nq: int, k: int, device, exc: BaseException):
    """Join a mesh search's exchange with this rank's part marked failed,
    then raise ``exc``: a rank that fails before or during its local walk
    calls this, so the other ranks, which reach the same ``all_gather``,
    learn of it there and raise too, instead of waiting for the part.
    The part is the (nq, 2k + 3) buffer of :class:`DistributedTopK`: its
    failure word (the last column) holds 1 + the length of the error's
    text, which fills the part's other words as UTF-8 (cut to fit)."""
    room = nq * (2 * k + 2) * 4
    text = f"{type(exc).__name__}: {exc}".encode()[:room]
    body = torch.zeros(room, dtype=torch.uint8)
    body[:len(text)] = torch.tensor(list(text), dtype=torch.uint8)
    packed = torch.cat([body.view(torch.int32).reshape(nq, 2 * k + 2),
                        torch.full((nq, 1), len(text) + 1,
                                   dtype=torch.int32)], 1)
    _all_gather(packed.to(device))
    raise exc

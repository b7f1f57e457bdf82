"""Parameters, batches and caches placed on a ``DeviceMesh``.

The port's counterpart of what GSPMD does for the reference package's
models on a mesh (``configs/sharding.py``'s specs applied by
``NamedSharding``):

* a parameter is **stored** as a ``DTensor`` in its ``param_specs``
  placement, each rank holding its shard (``place``, ``place_module``);
* a block **computes** on its weights gathered whole just before use
  (``gathered``, which swaps the gathered tensors in and the shards back
  after), except the MoE expert stacks, which ``models.moe``'s
  expert-parallel branch gathers over the DP dims only;
* activations are plain local tensors holding the rank's DP share of the
  batch rows (``Rows``); ranks along ``"model"`` hold the same rows;
* a cache whose batch the DP ranks do not divide is split on its
  sequence axis instead (``cache_specs``): each rank holds a contiguous
  range of positions (``SeqShard``), attends over it, and the ranks'
  softmax terms are merged by all-reduces of O(B x H x hd) values
  (``merge_softmax``, flash-decoding), never by gathering the cache;
* every collective here is a ``torch.distributed`` call on the group of
  one mesh dim.  A gloo group given CUDA tensors is served through host
  memory: the choice is made by the group's backend, never by catching
  a failure, and an NCCL group always gets the device tensors.

Collectives that autograd records (``sum_out``, ``sum_grad``) give the
gradient of the global function: a sum over ranks that hold the same
rows and replicated results passes its cotangent through unchanged, and
an input replicated over a dim whose ranks compute different partial
results gets the sum of their cotangents.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.sharding import Placed, Spec, cache_specs, mesh_sizes


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_placed(t) -> bool:
    return isinstance(t, _dtensor())


def mesh_names(mesh) -> list:
    return list(mesh_sizes(mesh))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its CUDA card (``rank % cards``) or
    the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def _size(mesh, name) -> int:
    return mesh_sizes(mesh)[name]


def _staged(group, t) -> bool:
    """Whether a collective on ``t`` goes through host memory: a gloo
    group given a CUDA tensor."""
    return t.is_cuda and "gloo" in str(dist.get_backend(group))


# ------------------------------------------------------------ collectives --
def all_gather(t, mesh, name: str, dim: int, device=None):
    """``t`` of every rank along mesh dim ``name``, concatenated on tensor
    dim ``dim`` in the dim's coordinate order, on ``device`` (``t``'s by
    default)."""
    device = t.device if device is None else device
    n = _size(mesh, name)
    if n == 1:
        return t.to(device)
    group = mesh.get_group(name)
    src = t.detach().contiguous()
    if _staged(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(device)


def all_reduce(t, mesh, names, *, op="sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``t`` over the ranks of the
    mesh dims ``names`` (a new tensor; ``t`` is untouched)."""
    out = t.detach().clone()
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for name in names:
        if _size(mesh, name) == 1:
            continue
        group = mesh.get_group(name)
        buf = out.cpu() if _staged(group, out) else out
        dist.all_reduce(buf, op=reduce_op, group=group)
        if buf is not out:
            out.copy_(buf)
    return out


class _SumOut(torch.autograd.Function):
    """Forward: the sum over ``names``' ranks.  Backward: the cotangent
    unchanged, as every rank of those dims holds the same result and
    its cotangent is that of the one global value."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        return all_reduce(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity on an input replicated over ``names``.
    Backward: the sum of its cotangents over those ranks, each of which
    used it for a different partial result."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.names), None, None


def sum_out(x, mesh, names):
    names = [n for n in names if _size(mesh, n) > 1]
    return _SumOut.apply(x, mesh, names) if names else x


def sum_grad(x, mesh, names):
    names = [n for n in names if _size(mesh, n) > 1]
    return _SumGrad.apply(x, mesh, names) if names else x


# ------------------------------------------------------------- placement --
def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(mesh, axes) -> tuple[int, int]:
    """(this rank's block index, block count) over ``axes``, the first
    axis major (JAX's order for ``P(("pod", "data"))``)."""
    idx, n = 0, 1
    for a in axes:
        size = _size(mesh, a)
        idx, n = idx * size + mesh.get_local_rank(a), n * size
    return idx, n


def local_part(full, mesh, spec):
    """This rank's shard of ``full`` under ``spec`` (a contiguous copy, so
    ``full`` can be freed)."""
    out = full
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = _index(mesh, axes)
        step = full.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out.contiguous() if out is full else out.clone()


def spec_of(t) -> Spec:
    """The spec of a ``DTensor``, read back from its placements."""
    names = mesh_names(t.device_mesh)
    spec = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if p.is_shard():
            spec[p.dim].append(name)
    return Spec(*(None if not a else a[0] if len(a) == 1 else tuple(a)
                  for a in spec))


def place(full, mesh, spec):
    """``full`` (the same on every rank) as a ``DTensor`` holding this
    rank's shard under ``spec``."""
    DTensor = _dtensor()
    return DTensor.from_local(local_part(full, mesh, spec), mesh,
                              Placed(mesh, spec).placements, run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


def full(t, names=None, *, dtype=None, device=None):
    """A ``DTensor`` gathered whole (over every mesh dim, or only over
    ``names``) as a plain tensor, cast to ``dtype`` first if given, on
    ``device`` (its own by default); a plain tensor is returned as it is
    (cast, moved)."""
    out = local(t)
    if dtype is not None:
        out = out.to(dtype)
    if is_placed(t):
        mesh = t.device_mesh
        for d, entry in enumerate(spec_of(t)):
            for a in reversed(_axes(entry)):        # minor axis first
                if names is None or a in names:
                    out = all_gather(out, mesh, a, d, device)
    return out if device is None else out.to(device)


def local(t):
    """A ``DTensor``'s shard on this rank; a plain tensor as it is."""
    return t.to_local() if is_placed(t) else t


def like(t, local_tensor):
    """``local_tensor`` as a ``DTensor`` placed as ``t`` is (plain if ``t``
    is)."""
    if not is_placed(t):
        return local_tensor
    DTensor = _dtensor()
    return DTensor.from_local(local_tensor, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def replication(t) -> int:
    """How many ranks hold the same shard as this one: the product of the
    mesh dims that ``t`` replicates over (1 for a plain tensor)."""
    if not is_placed(t):
        return 1
    sizes = list(tuple(t.device_mesh.shape))
    return int(np.prod([s for s, p in zip(sizes, t.placements)
                        if not p.is_shard()]))


def place_module(model, mesh, specs: dict):
    """Every parameter of ``model`` replaced by a ``DTensor`` parameter in
    its ``specs[name]`` placement, in place; returns ``model``."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            place(p.detach(), mesh, specs[name]), requires_grad=False)
    return model


@contextlib.contextmanager
def gathered(module, *, recurse: bool = True):
    """Inside, each ``DTensor`` parameter of ``module`` (of its own
    parameters only with ``recurse=False``) reads as its whole tensor;
    the shards come back on exit.  A MoE module's expert stacks (the
    names in its ``expert_stacks``) stay placed."""
    swaps = []
    mods = module.modules() if recurse else [module]
    try:
        for mod in mods:
            skip = getattr(mod, "expert_stacks", ())
            for name, p in list(mod._parameters.items()):
                if name in skip or not is_placed(p):
                    continue
                mod._parameters[name] = full(p)
                swaps.append((mod, name, p))
        yield module
    finally:
        for mod, name, p in reversed(swaps):
            mod._parameters[name] = p


# ------------------------------------------------------------------ rows --
def dp_size(mesh, dp_axes) -> int:
    sizes = mesh_sizes(mesh)
    return int(np.prod([sizes[a] for a in dp_axes]))


class Rows:
    """A call's batch on a mesh: ``batch`` global rows, split over the DP
    dims when they divide it (each rank its consecutive share, pod-major)
    and held whole by every rank otherwise, as ``batch_specs`` places
    them."""

    def __init__(self, mesh, dp_axes, batch: int):
        self.mesh, self.dp_axes, self.batch = mesh, tuple(dp_axes), batch
        self.dp = dp_size(mesh, self.dp_axes)
        self.split = batch % self.dp == 0
        self.index = _index(mesh, self.dp_axes)[0]

    def take(self, x):
        """This rank's rows of ``x`` (a tensor or array of ``batch`` rows,
        or anything else, which passes as it is)."""
        if not self.split or self.dp == 1 or not hasattr(x, "shape") \
                or len(x.shape) == 0 or x.shape[0] != self.batch:
            return x
        n = self.batch // self.dp
        return x[self.index * n:(self.index + 1) * n]

    def total(self, x):
        """The sum over the DP ranks of a per-rank term of a global value
        (autograd passes its cotangent through); the term itself when the
        rows are not split."""
        return sum_out(x, self.mesh, self.dp_axes) if self.split else x

    def count(self, x):
        """The sum over the DP ranks of a count (no autograd)."""
        return all_reduce(x, self.mesh, self.dp_axes) if self.split else x

    def out(self, x, batch_axis: int = 0):
        """A local result of this rank's rows as a ``DTensor`` of the
        global batch (``Shard`` over the DP dims, or replicated)."""
        shape = list(x.shape)
        spec = [None] * len(shape)
        if self.split:
            shape[batch_axis] = self.batch
            spec[batch_axis] = self.dp_axes
        return _from_local(x, self.mesh, Spec(*spec), shape)

    def _spec(self, shape, batch_axis, seq_axis):
        return cache_specs(torch.Size(shape), self.mesh, dp=self.dp_axes,
                           batch_axis=batch_axis,
                           seq_axis=len(shape) if seq_axis is None
                           else seq_axis)

    def cache(self, tree, *, batch_axis: int = 1, seq_axis: int = 2):
        """A cache computed on this rank (nested dicts, tuples and lists of
        tensors of its rows and every position; other leaves pass as they
        are) placed by ``cache_specs``: the batch over DP, or the
        sequence axis over DP (this rank keeps its positions, a copy), or
        replicated; ``seq_axis=None`` for a state without one."""
        if isinstance(tree, dict):
            return {k: self.cache(v, batch_axis=batch_axis,
                                  seq_axis=seq_axis) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.cache(v, batch_axis=batch_axis,
                                         seq_axis=seq_axis) for v in tree)
        if not torch.is_tensor(tree):
            return tree
        shape = list(tree.shape)
        if self.split:
            shape[batch_axis] = self.batch
        spec = self._spec(shape, batch_axis, seq_axis)
        if seq_axis is not None and spec[seq_axis] is not None:
            sh = SeqShard(self.mesh, self.dp_axes, shape[seq_axis])
            tree = tree.narrow(seq_axis, sh.start, sh.size).clone()
        return _from_local(tree, self.mesh, spec, shape)

    def zeros(self, shape, dtype, device, *, batch_axis: int = 1,
              seq_axis: int = 2):
        """A zero cache leaf of the global ``shape`` placed by
        ``cache_specs``, allocating only this rank's part."""
        spec = self._spec(shape, batch_axis, seq_axis)
        local_shape = list(shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                local_shape[d] //= dp_size(self.mesh, _axes(entry))
        return _from_local(torch.zeros(local_shape, dtype=dtype,
                                       device=device),
                           self.mesh, spec, shape)


def _from_local(x, mesh, spec, shape):
    """``x`` as this rank's part of a ``DTensor`` of global ``shape``
    placed by ``spec``."""
    DTensor = _dtensor()
    return DTensor.from_local(
        x, mesh, Placed(mesh, spec).placements, run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


# ------------------------------------------------------ sequence shards --
class SeqShard:
    """A cache's sequence axis of ``smax`` positions split over the mesh
    dims ``names`` (rank-major, as ``NamedSharding`` splits
    ``P(("pod", "data"))``): this rank holds positions ``[start, start +
    size)``.  ``softmax_mix`` merges the ranks' attention over their
    positions."""

    def __init__(self, mesh, names, smax: int):
        idx, n = _index(mesh, tuple(names))
        self.mesh, self.names, self.smax = mesh, tuple(names), smax
        self.size = smax // n
        self.start = idx * self.size

    def softmax_mix(self, s, valid, mix):
        """The softmax over every rank's positions of this rank's scores
        ``s`` (..., S_local) under ``valid``, mixed with the values by
        ``mix`` (``merge_softmax`` by three all-reduces over the DP dims:
        two of B x H values and one of B x H x hd, whatever the
        length)."""
        return merge_softmax(s, valid, mix, lambda x, op: all_reduce(
            x, self.mesh, self.names, op=op))


def merge_softmax(s, valid, mix, reduce):
    """Flash-decoding over pieces of the positions: the softmax of the
    scores ``s`` (..., S_piece) under ``valid`` over every piece's
    positions, mixed with the values: ``mix(p)`` gives the piece's (...,
    d) f32 sum of its values weighted by p; ``reduce(x, op)`` is the max
    (``op="max"``) or the sum over the pieces.  The max ``M`` of the
    pieces' maxima (one reduction of max), the sum ``l`` of ``exp(s -
    M)`` (one reduction of sum) and the weighted values (one more): the
    weights are normalised, ``exp(s - M) / l``, before ``mix`` rounds
    them, as the one-piece softmax's are, so a split of the positions
    rounds as the whole does (merging unnormalised terms rounds each
    weight at another scale: at random weights that moves every later
    bf16 rounding, ~1e-2 of max |logits|).  A piece with no valid
    position gives weights 0, never NaN."""
    masked = torch.where(valid, s, -torch.inf)
    top = reduce(masked.amax(-1), "max")
    e = torch.exp(masked - top[..., None])
    l = reduce(e.sum(-1), "sum")
    return reduce(mix(e / l[..., None]), "sum")


def seq_shard(t, seq_axis: int = 2):
    """The ``SeqShard`` of a placed cache leaf whose ``seq_axis`` is split
    over mesh dims; None for a plain tensor or another placement."""
    if not is_placed(t):
        return None
    names = [n for n, p in zip(mesh_names(t.device_mesh), t.placements)
             if p.is_shard(seq_axis)]
    return SeqShard(t.device_mesh, names, t.shape[seq_axis]) \
        if names else None


def local_tree(tree):
    """A placed cache (nested dicts, tuples, lists) as this rank's local
    tensors, sharing their storage, so in-place writes reach it."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local_tree(v) for v in tree)
    return local(tree)

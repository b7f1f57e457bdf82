"""Sharding rules: param/batch/cache specs with divisibility fallbacks.

Counterpart of the reference package's ``configs/sharding.py``, on the
port's parameter names and ``torch.distributed`` meshes:

  * dense 2D weights: (fsdp, "model") — FSDP over the data axes on d_in,
    tensor parallel over "model" on d_out (row-parallel matrices
    transposed);
  * MoE expert stacks (E, D, F): experts over "model" (EP), d_model over
    the DP axes (FSDP), as ``models.moe``'s expert-parallel branch takes
    them;
  * vocab over "model" for embed / lm_head;
  * batch over the DP axes; long-context (batch < dp) shards the KV-cache
    sequence axis over the DP axes instead.

A spec (``Spec``, the port's ``PartitionSpec``) is a tuple with one entry
a tensor dim: a mesh dim name, a tuple of names (split major to minor, as
JAX splits ``P(("pod", "data"))``), or None (replicated).  Every rule passes through ``_maybe``: an axis is used
only when the dim divides by the mesh axes' product, otherwise that dim
replicates; nothing is sharded unevenly.

The functions read only ``mesh.shape`` and the dim names (a dict
``{name: size}`` or a ``DeviceMesh``'s tuple with ``mesh_dim_names``), so
they run on a mesh that has only a shape.  ``param_specs`` keys on the
port's parameter names (``moe_layers.1.moe.wg``): the reference's rule
for the same leaf, whose stacked leading dims the port does not have.
"""
from __future__ import annotations

import numpy as np


class Spec(tuple):
    """One tensor's spec: per dim a mesh dim name, a tuple of names or
    None; equal to the plain tuple of its entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"Spec{tuple(self)}"


def mesh_sizes(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` or of a mesh whose
    ``shape`` is already such a dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _maybe(mesh, dim, axes):
    """axes if dim divides evenly, else None (replicate)."""
    return axes if (axes and dim % _axsize(mesh, axes) == 0) else None


# the reference's trailing-dims rules per leaf name: 'F' = fsdp, 'T' = tp
_RULES = {
    "embed":    ("T", "F"),
    "lm_head":  ("F", "T"),
    "wq": ("F", "T"), "wk": ("F", "T"), "wv": ("F", "T"), "wo": ("T", "F"),
    "wg": ("F", "T"), "wu": ("F", "T"), "wd": ("T", "F"),
    "w1": ("F", "T"), "w2": ("T", "F"),
    "wq_a": ("F", "T"), "wq_b": ("F", "T"),
    "wkv_a": ("F", "T"), "wk_b": ("F", "T"), "wv_b": ("F", "T"),
    "in_proj": ("F", "T"), "out_proj": ("T", "F"),
    "proj": ("F", "T"),
    "router": ("F", None),
    "conv_w": (None, None),
}

# MoE expert stacks (E, D, F) / (E, F, D): experts on TP, d_model on FSDP
_MOE_RULES = {
    "wg": ("T", "F", None),
    "wu": ("T", "F", None),
    "wd": ("T", None, "F"),
    "router": ("F", None),
}


def _resolve(mesh, shape, rule, fsdp, tp) -> tuple:
    spec = [None] * len(shape)
    k = len(rule)
    for i, r in enumerate(rule):
        dim_idx = len(shape) - k + i
        if dim_idx < 0:
            continue
        axes = {"F": fsdp, "T": tp, None: None}[r]
        spec[dim_idx] = _maybe(mesh, shape[dim_idx], axes)
    return Spec(*spec)


def _shapes(model_or_shapes) -> dict:
    """``{name: shape}`` of an ``nn.Module``'s named parameters (meta
    tensors will do) or of such a dict of shapes or tensors."""
    if hasattr(model_or_shapes, "named_parameters"):
        return {n: tuple(p.shape)
                for n, p in model_or_shapes.named_parameters()}
    return {n: tuple(getattr(s, "shape", s))
            for n, s in model_or_shapes.items()}


def leaf_spec(name: str, shape, mesh, *, fsdp=("data",), tp="model"):
    """The spec of one parameter by its dotted name: the reference's rule
    for the leaf at the same key path (the name less its list indices)."""
    path = [q for q in name.split(".") if not q.isdigit()]
    leaf = path[-1]
    in_moe = any(p in ("moe", "shared") for p in path[:-1])
    if in_moe and leaf in _MOE_RULES and path[-2] != "shared":
        return _resolve(mesh, shape, _MOE_RULES[leaf], fsdp, tp)
    rule = _RULES.get(leaf)
    if rule is None:
        return Spec(*(None,) * len(shape))      # norms / scalars: replicate
    return _resolve(mesh, shape, rule, fsdp, tp)


def param_specs(model_or_shapes, mesh, *, fsdp=("data",), tp="model") -> dict:
    """``{name: spec}`` for every parameter of ``model_or_shapes`` (a
    model, on the meta device or not, or a dict of shapes)."""
    return {name: leaf_spec(name, shape, mesh, fsdp=fsdp, tp=tp)
            for name, shape in _shapes(model_or_shapes).items()}


def batch_specs(batch, mesh, *, dp=("data",)) -> dict:
    """tokens (B, S) etc.: the batch dim over DP if divisible."""
    def one(x):
        shape = tuple(getattr(x, "shape", x))
        return Spec(_maybe(mesh, shape[0], dp), *(None,) * (len(shape) - 1))
    return {k: one(v) for k, v in batch.items()}


def cache_specs(cache, mesh, *, dp=("data",), tp="model", batch_axis=1,
                seq_axis=2):
    """KV caches (L, B, S, ...): batch over DP when divisible, otherwise
    the sequence axis over DP (long-context flash-decoding sharding).  A
    nested dict, tuple or list of leaves gives the same structure of
    specs."""
    def one(x):
        shape = tuple(getattr(x, "shape", x))
        spec = [None] * len(shape)
        if len(shape) > batch_axis and _maybe(mesh, shape[batch_axis], dp):
            spec[batch_axis] = dp
        elif len(shape) > seq_axis and _maybe(mesh, shape[seq_axis], dp):
            spec[seq_axis] = dp
        return Spec(*spec)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)) and not all(
                isinstance(d, (int, np.integer)) for d in t):
            return type(t)(walk(v) for v in t)
        return one(t)
    return walk(cache)


class Placed:
    """A spec on a mesh, as DTensor placements: ``placements[i]`` is
    ``Shard(d)`` when mesh dim i splits tensor dim d, else
    ``Replicate()`` (the counterpart of ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh, self.spec = mesh, tuple(spec)
        names = list(mesh_sizes(mesh))
        place = [Replicate()] * len(names)
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec {spec}: a dim split over {axes} "
                                 f"must name them in the mesh's order "
                                 f"{tuple(names)}")
            for p in pos:
                place[p] = Shard(d)
        self.placements = tuple(place)

    def __repr__(self):
        return f"Placed({self.spec}, {self.placements})"


def named(mesh, specs):
    """``specs`` (a ``Spec``, or a dict, tuple or list of them, nested)
    with each ``Spec`` as a ``Placed`` on ``mesh``."""
    if isinstance(specs, Spec):
        return Placed(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    return type(specs)(named(mesh, v) for v in specs)

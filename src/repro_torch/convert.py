"""Carry fitted state across from the reference package.

For the search system the "weights" are a fitted DCO method's state; for
the LM stack they are the model's parameter tree.  These helpers copy
them duck-typed — by attribute, key and array protocol — so the port
never imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.backends import resolve_device
from repro_torch.core.methods import make_method
from repro_torch.models.lm import DenseLM, EncDecLM, HybridLM, MoELM, SSMLM
from repro_torch.search.ivf import IVFIndex


def _copy(v):
    if isinstance(v, dict):
        return {key: _copy(x) for key, x in v.items()}
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def method_from_reference(ref_method):
    """The port's method of the same ``.name`` holding a copy of
    ``ref_method``'s ``params`` and fitted ``state`` (every numpy array
    copied), so both packages search identical fitted states."""
    m = make_method(ref_method.name, **_copy(dict(ref_method.params)))
    m.state = _copy(dict(ref_method.state))
    return m


def state_from_reference(d: dict, device=None) -> dict:
    """A dict of array-likes (numpy arrays or anything ``np.asarray``
    reads) as torch tensors on ``device``."""
    return {key: torch.as_tensor(np.asarray(v), device=device)
            for key, v in d.items()}


def index_from_reference(ref_index) -> IVFIndex:
    """The port's ``IVFIndex`` holding a copy of ``ref_index``'s built
    state (``centroids``, ``lists``, ``n_list``, ``n``, read by attribute),
    so both packages probe the same partitions."""
    idx = IVFIndex(ref_index.n_list, seed=getattr(ref_index, "seed", 0),
                   kmeans_iters=getattr(ref_index, "kmeans_iters", 10))
    idx.centroids = np.array(ref_index.centroids, np.float32)
    idx.lists = [np.array(lst, np.int64) for lst in ref_index.lists]
    idx.n = int(ref_index.n)
    return idx


_FAMILIES = {"dense": DenseLM, "vlm": DenseLM, "encdec": EncDecLM,
             "ssm": SSMLM, "moe": MoELM, "hybrid": HybridLM}


def _model(cfg, device):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the "
                         f"families are {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family](cfg, None, device=device)


def reference_leaves(cfg, model, ref_params):
    """Yield ``(name, parameter, array)`` for each of ``model``'s named
    parameters: the f32 numpy array that ``ref_params`` (the reference's
    tree for ``cfg``, read through ``np.asarray``) holds for it, by the
    walk ``params_from_reference`` describes.  Refuses what that refuses."""
    if ("lm_head" in ref_params) != hasattr(model, "lm_head"):
        raise ValueError(f"lm_head in the reference tree does not fit the "
                         f"{cfg.family!r} family at "
                         f"tie_embeddings={cfg.tie_embeddings}")
    extra = set(ref_params) - {name.split(".")[0]
                               for name, _ in model.named_parameters()}
    if extra:
        raise ValueError(f"the reference tree holds {sorted(extra)}, which "
                         f"the {cfg.family!r} model of this config does not")
    stacked: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        # the reference's key path, and the index on each stacked axis
        path = tuple(q for q in parts if not q.isdigit())
        idx = tuple(int(q) for q in parts if q.isdigit())
        if path not in stacked:
            leaf = ref_params
            for key in path:
                leaf = leaf[key]
            stacked[path] = np.array(leaf, np.float32)
            axes = [j for j, q in enumerate(parts) if q.isdigit()]
            for axis, j in enumerate(axes):
                n = len(model.get_submodule(".".join(parts[:j])))
                got = stacked[path].shape[axis] \
                    if stacked[path].ndim > axis else None
                if got != n:
                    raise ValueError(
                        f"{name}: the reference stacks {got} "
                        f"{parts[j - 1]}, the model holds {n}")
        src = stacked[path][idx]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: the reference holds {src.shape}, "
                             f"the model {tuple(p.shape)}")
        yield name, p, np.ascontiguousarray(src)


def params_from_reference(cfg, ref_params, device=None, *, mesh=None,
                          dp_axes=None) -> torch.nn.Module:
    """The port's model of ``cfg``'s family on ``device`` (default: the
    CUDA card) holding ``ref_params``, the reference's parameter tree for
    ``cfg``, read through ``np.asarray``:

    * dense and VLM (``DenseLM``): ``embed``, ``final_norm``, ``layers``
      (``n1`` and ``n2`` None for the non-parametric norm) and, untied,
      ``lm_head``;
    * encdec (``EncDecLM``): ``embed``, ``enc``, ``dec``, ``enc_norm``,
      ``final_norm`` and ``lm_head``;
    * ssm (``SSMLM``): ``embed``, ``layers`` (``mixer`` with ``in_proj``,
      ``conv_w``, ``A_log``, ``D``, ``dt_bias``, ``norm``, ``out_proj``,
      and ``n1``) and ``final_norm``;
    * moe (``MoELM``): ``embed``, ``dense_layers`` and ``moe_layers``
      (``attn``, ``n1``, ``n2`` and ``mlp`` or ``moe``), ``final_norm``,
      ``lm_head`` and, with ``cfg.mtp``, ``mtp`` (``proj``, ``block``,
      ``norm``);
    * hybrid (``HybridLM``): ``embed``, ``groups`` (``mamba``, ``attn``,
      ``moe``, ``mlp``, ``ffn_norms``), ``final_norm`` and, untied,
      ``lm_head``.

    A list of blocks is one leaf stacked over a leading axis in the
    reference's tree: ``layers``, ``enc``, ``dec``, ``dense_layers`` and
    ``moe_layers`` over the model's depth, ``groups`` over the groups and,
    within a group, ``mamba``, ``moe`` and ``mlp`` over a second axis
    (``mtp`` is not stacked).  Every leaf is copied into the model's
    tensor of the same name, so matmul weights and the embedding are
    rounded once to bf16, and the gains, the mixer's f32 leaves and the
    MoE router stay f32: both packages compute on the same numbers.  A
    leaf of another shape, a stack of another depth, an ``lm_head`` the
    family does not hold (or lacks), or a part the model does not hold
    (V3's ``mtp`` for a config without it) is refused.

    With ``mesh`` (a ``DeviceMesh``; every rank passes the same tree) each
    parameter is then placed as ``build_model(cfg, mesh=mesh)`` places
    it, by ``configs.sharding.param_specs`` with ``dp_axes`` (default:
    the mesh's ``"pod"`` and ``"data"`` dims) as the FSDP dims."""
    model = _model(cfg, resolve_device(device, mesh))
    with torch.no_grad():
        for _, p, src in reference_leaves(cfg, model, ref_params):
            p.copy_(torch.from_numpy(src))
    if mesh is None:
        return model
    from repro_torch.configs.sharding import param_specs
    from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
    from repro_torch.models.placement import place_module
    fsdp = tuple(dp_axes) if dp_axes is not None else mesh_dp_axes(mesh)
    return place_module(model, mesh, param_specs(model, mesh, fsdp=fsdp))


def train_state_from_reference(cfg, ref_state, device=None, *, mesh=None,
                               dp_axes=None):
    """The port's ``TrainState`` (``repro_torch.train``) on ``device``
    (default: the CUDA card) from the reference's: its f32 parameter tree
    (``ref_state.params``) as the masters, its AdamW moments
    (``ref_state.opt["m"]``, ``["v"]``, in their dtype) and step counts,
    each leaf read through ``np.asarray`` by ``params_from_reference``'s
    walk, so both packages step from the same state.  With ``mesh`` the
    masters and moments are placed as ``params_from_reference`` places
    the parameters."""
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device, mesh)
    names = _model(cfg, "meta")
    specs = None
    if mesh is not None:
        from repro_torch.configs.sharding import param_specs
        from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
        from repro_torch.models.placement import place
        fsdp = tuple(dp_axes) if dp_axes is not None else mesh_dp_axes(mesh)
        specs = param_specs(names, mesh, fsdp=fsdp)

    def tree(ref_tree, dtype=torch.float32):
        out = {name: torch.from_numpy(src).to(device=dev, dtype=dtype)
               for name, _, src in reference_leaves(cfg, names, ref_tree)}
        if specs is None:
            return out
        return {n: place(t, mesh, specs[n]) for n, t in out.items()}

    def dtype_of(ref_tree):
        leaf = next(iter(_leaves(ref_tree)))
        return torch.bfloat16 if "bfloat16" in str(leaf.dtype) \
            else torch.float32

    opt = ref_state.opt
    step = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                        device=dev)
    return TrainState(
        params=tree(ref_state.params),
        opt={"m": tree(opt["m"], dtype_of(opt["m"])),
             "v": tree(opt["v"], dtype_of(opt["v"])), "step": step},
        step=torch.tensor(int(np.asarray(ref_state.step)), dtype=torch.int32,
                          device=dev))


def _leaves(tree):
    """The leaves of a nested dict (None leaves skipped)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree

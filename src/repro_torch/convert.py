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
from repro_torch.models.lm import DenseLM, EncDecLM, SSMLM
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


def params_from_reference(cfg, ref_params, device=None) -> torch.nn.Module:
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
      and ``n1``) and ``final_norm``.

    The leaves of ``layers``, ``enc`` and ``dec`` are stacked over a
    leading (L, ...) axis of the model's depth.  Every leaf is copied into the model's tensor of
    the same name, so matmul weights and the embedding are rounded once to
    bf16, and the gains and the mixer's f32 leaves stay f32: both packages
    compute on the same numbers.  A leaf of another shape, or an
    ``lm_head`` that does not fit ``tie_embeddings``, is refused."""
    families = {"dense": DenseLM, "vlm": DenseLM, "encdec": EncDecLM,
                "ssm": SSMLM}
    if cfg.family not in families:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP A9 (b))")
    model = families[cfg.family](cfg, None, device=resolve_device(device))
    if ("lm_head" in ref_params) == bool(cfg.tie_embeddings):
        raise ValueError(f"lm_head in the reference tree does not fit "
                         f"tie_embeddings={cfg.tie_embeddings}")
    stacked: dict = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] in ("layers", "enc", "dec"):
                path = (parts[0],) + tuple(parts[2:])
                if path not in stacked:
                    leaf = ref_params
                    for key in path:
                        leaf = leaf[key]
                    stacked[path] = np.array(leaf, np.float32)
                    n = len(getattr(model, parts[0]))
                    if stacked[path].shape[0] != n:
                        raise ValueError(
                            f"{name}: the reference stacks "
                            f"{stacked[path].shape[0]} {parts[0]}, the model "
                            f"holds {n}")
                src = stacked[path][int(parts[1])]
            else:
                src = np.array(ref_params[name], np.float32)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: the reference holds {src.shape}, "
                                 f"the model {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    return model

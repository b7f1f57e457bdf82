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
from repro_torch.models.lm import DenseLM
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


def params_from_reference(cfg, ref_params, device=None) -> DenseLM:
    """The port's dense or VLM decoder (``DenseLM``) on ``device``
    (default: the CUDA card) holding ``ref_params``, the reference's
    parameter tree for ``cfg``: a dict with ``embed``, ``final_norm``,
    ``layers`` (every leaf stacked over a leading (L, ...) axis; ``n1``
    and ``n2`` None for the non-parametric norm) and, untied, ``lm_head``,
    read through ``np.asarray``.  Matmul weights and the embedding are
    rounded once to bf16, the gains kept f32, so both packages compute on
    the same numbers."""
    model = DenseLM(cfg, None, device=resolve_device(device))
    if ("lm_head" in ref_params) == bool(cfg.tie_embeddings):
        raise ValueError(f"lm_head in the reference tree does not fit "
                         f"tie_embeddings={cfg.tie_embeddings}")
    stacked: dict = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers":
                path = tuple(parts[2:])
                if path not in stacked:
                    leaf = ref_params["layers"]
                    for key in path:
                        leaf = leaf[key]
                    stacked[path] = np.array(leaf, np.float32)
                src = stacked[path][int(parts[1])]
            else:
                src = np.array(ref_params[name], np.float32)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: the reference holds {src.shape}, "
                                 f"the model {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    return model

"""Carry fitted state across from the reference package.

For this system the "weights" are a fitted DCO method's state.  These
helpers copy it duck-typed — by attribute and array protocol — so the port
never imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.methods import make_method
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

"""Public wrappers of the kernels: shape handling and dispatch.

Dispatch goes by the tensors' device only: a CUDA tensor reaches the
hand-written kernel (a failed build or launch raises), a CPU tensor the
plain PyTorch version.  The CUDA kernels bound-check ragged N, Q and d1
instead of padding them, which gives the same results as the reference's
padding: padded queries (tau = -1) prune everything, padding rows never
keep or count, and a padding dim block has logical width 0.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.dco_scan import dco_scan_cuda, dco_scan_plain
from repro_torch.kernels.pq_lookup import pq_lookup_cuda, pq_lookup_plain


@functools.lru_cache(maxsize=64)
def _widths(d1: int, block_d: int, device: torch.device):
    """Logical dims per dim block; cached so the engine's block loop never
    copies from the host."""
    nd = -(-d1 // block_d)
    w = np.clip(d1 - np.arange(nd) * block_d, 0, block_d).astype(np.float32)
    return torch.as_tensor(w, device=device)


def dco_scan_op(x, q, tau, scales, nrows=None, *, block_n: int = 256,
                block_d: int = 128):
    """Staged scan over arbitrary (N, Q, d1): returns (partial (N, Q),
    keep (N, Q) int8, counts (ceil(N/block_n), Q), dims (ceil(N/block_n),
    Q)).  ``nrows`` (int or 1-element tensor; default N) marks how many
    leading rows of ``x`` are real; a tensor stays on the device, so the
    streaming engine's block loop never syncs with the host.  ``scales``
    shorter than the number of dim blocks is extended with its last
    entry."""
    n, d1 = x.shape
    nd = -(-d1 // block_d)
    sc = scales
    if sc.shape[0] < nd:
        sc = torch.cat([sc, sc[-1:].expand(nd - sc.shape[0])])
    sc = sc[:nd].to(torch.float32).contiguous()
    if nrows is None:
        nrows = n
    if isinstance(nrows, torch.Tensor):
        nr = nrows.reshape(1).to(device=x.device, dtype=torch.int32)
    else:
        nr = torch.full((1,), int(nrows), dtype=torch.int32, device=x.device)
    fn = dco_scan_cuda if x.is_cuda else dco_scan_plain
    return fn(x.contiguous(), q.contiguous(), tau.contiguous(), sc,
              _widths(d1, block_d, x.device), nr, block_n=block_n,
              block_d=block_d)


def pq_lookup_op(codes, lut):
    """PQ scan: codes (N, M) int, lut (Q, M, K) f32 -> adist (N, Q) f32."""
    codes = codes.to(torch.int32).contiguous()
    if codes.is_cuda:
        return pq_lookup_cuda(codes, lut.contiguous())
    return pq_lookup_plain(codes, lut)

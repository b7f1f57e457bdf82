"""The PQ asymmetric-distance scan: binding of the CUDA kernel
``csrc/pq_lookup.cu`` and its plain PyTorch version.

Both compute ``adist[n, q] = sum_m lut[q, m, codes[n, m]]`` for codes
(N, M) int32 and lut (Q, M, K) f32, returning (N, Q) f32 — the semantics of
the reference Pallas kernel (src/repro/kernels/pq_lookup.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (the plain version never counts)
launches = 0

#: shared memory one block stages, in bytes: the LUTs of as many queries as
#: fit (at least one), leaving room for a second block on the SM.  The
#: hardware cap per block is 227 KB.
_SMEM_TARGET = 96 * 1024
_SMEM_MAX = 232_448


def pq_lookup_plain(codes, lut):
    """Plain PyTorch version of the kernel: one gather, summed over m."""
    m = codes.shape[1]
    g = lut[:, torch.arange(m, device=lut.device)[None, :], codes.long()]
    return g.sum(-1).T.contiguous()


def pq_lookup_cuda(codes, lut):
    """Launch the CUDA kernel on the current stream."""
    global launches
    dev = codes.device
    n, m = codes.shape
    nq, m2, k = lut.shape
    if m2 != m or n == 0 or nq == 0:
        raise ValueError(f"pq_lookup: codes {tuple(codes.shape)} and lut "
                         f"{tuple(lut.shape)} do not match")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise ValueError("pq_lookup: codes must be contiguous int32")
    if lut.device != dev or lut.dtype != torch.float32 \
            or not lut.is_contiguous():
        raise ValueError(f"pq_lookup: lut must be contiguous float32 on {dev}")
    per_q = m * k * 4
    if per_q > _SMEM_MAX:
        raise ValueError(f"pq_lookup: one query's LUT ({per_q} B) exceeds "
                         "the shared memory of a block")
    lib = _build.load_library()
    bq = max(1, min(nq, _SMEM_TARGET // per_q))
    out = torch.empty((n, nq), dtype=torch.float32, device=dev)
    err = lib.pq_lookup_launch(
        codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, nq, m, k, bq,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pq_lookup")
    launches += 1
    return out

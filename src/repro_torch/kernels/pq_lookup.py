"""The PQ asymmetric-distance scan: binding of the CUDA kernel
``csrc/pq_lookup.cu`` and its plain PyTorch version.

Both compute ``adist[n, q] = sum_m lut[q, m, codes[n, m]]`` for codes
(N, M) uint8 or int32 and lut (Q, M, K) f32, returning (N, Q) f32 — the
semantics of the reference Pallas kernel (src/repro/kernels/pq_lookup.py).
A code outside [0, K) adds nothing in the kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

#: kernel launches since the last reset (the plain version never counts)
launches = 0

#: shared memory one block stages at most, in bytes (the LUTs of its
#: queries, at least one); the hardware cap per block is 227 KB
_SMEM_TARGET = 64 * 1024
_SMEM_MAX = 232_448
_ROWS_PER_BLOCK = 256           # one row per thread of a block
_ENTRY = {torch.uint8: "pq_lookup_u8_launch",
          torch.int32: "pq_lookup_i32_launch"}


def pq_lookup_plain(codes, lut):
    """Plain PyTorch version of the kernel: one gather, summed over m."""
    m = codes.shape[1]
    g = lut[:, torch.arange(m, device=lut.device)[None, :], codes.long()]
    return g.sum(-1).T.contiguous()


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _queries_per_block(n: int, nq: int, per_q_bytes: int, sms: int) -> int:
    """Queries whose LUTs one block stages: the grid of (row tiles x query
    groups) should hold two blocks per SM, and a block at most
    ``_SMEM_TARGET`` bytes of LUTs (at least one query's)."""
    row_tiles = -(-n // _ROWS_PER_BLOCK)
    by_grid = (row_tiles * nq) // (2 * sms)
    return max(1, min(nq, _SMEM_TARGET // per_q_bytes, by_grid))


def pq_lookup_cuda(codes, lut):
    """Launch the CUDA kernel on the current stream; codes uint8 or int32,
    as the engine stores them (no cast here)."""
    global launches
    dev = codes.device
    n, m = codes.shape
    nq, m2, k = lut.shape
    if m2 != m or n == 0 or nq == 0:
        raise ValueError(f"pq_lookup: codes {tuple(codes.shape)} and lut "
                         f"{tuple(lut.shape)} do not match")
    if codes.dtype not in _ENTRY or not codes.is_contiguous():
        raise ValueError("pq_lookup: codes must be contiguous uint8 or int32, "
                         f"got {codes.dtype}")
    if lut.device != dev or lut.dtype != torch.float32 \
            or not lut.is_contiguous():
        raise ValueError(f"pq_lookup: lut must be contiguous float32 on {dev}")
    per_q = m * k * 4
    if per_q > _SMEM_MAX:
        raise ValueError(f"pq_lookup: one query's LUT ({per_q} B) exceeds "
                         "the shared memory of a block")
    lib = _build.load_library()
    bq = _queries_per_block(n, nq, per_q, _sm_count(dev.index))
    out = torch.empty((n, nq), dtype=torch.float32, device=dev)
    err = getattr(lib, _ENTRY[codes.dtype])(
        codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, nq, m, k, bq,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pq_lookup")
    launches += 1
    return out

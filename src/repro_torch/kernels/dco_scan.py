"""The staged DCO scan: binding of the CUDA kernel ``csrc/dco_scan.cu`` and
its plain PyTorch version.

Both compute, for x (N, d1) lead dims, q (Q, d1) queries, tau (Q,),
scales (nd,) and widths (nd,) over nd = ceil(d1 / block_d) dim blocks and
nrows (1,) int32 (rows at or beyond it never keep and never count):

  partial (N, Q) f32   running partial distances (frozen pairs keep the
                       value at which they were pruned);
  keep    (N, Q) int8  the final screening decision;
  counts  (ceil(N / block_n), Q) i32  keep counts per row block;
  dims    (ceil(N / block_n), Q) f32  dims entered per row block.

The semantics are those of the reference Pallas kernel
(src/repro/kernels/dco_scan.py); ``kernels.ops.dco_scan_op`` is the caller.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _block_contrib

#: kernel launches since the last reset (the plain version never counts)
launches = 0


def _block_sum(a, block_n: int):
    """(N, Q) -> (ceil(N / block_n), Q) sums over row blocks."""
    n, nq = a.shape
    nb = -(-n // block_n)
    a = torch.nn.functional.pad(a, (0, 0, 0, nb * block_n - n))
    return a.reshape(nb, block_n, nq).sum(1, dtype=a.dtype)


def dco_scan_plain(x, q, tau, scales, widths, nrows, *, block_n: int,
                   block_d: int):
    """Plain PyTorch version of the kernel: the same four outputs, computed
    for all (row, query) pairs at once per dim block."""
    n, d1 = x.shape
    nd = -(-d1 // block_d)
    valid = (torch.arange(n, device=x.device) < nrows)[:, None]
    acc = torch.zeros((n, q.shape[0]), dtype=torch.float32, device=x.device)
    entered = torch.zeros_like(acc)
    for di in range(nd):
        alive = acc * scales[max(di - 1, 0)] <= tau[None, :]
        entered = entered + (alive & valid) * widths[di]
        lo, hi = di * block_d, min((di + 1) * block_d, d1)
        contrib = _block_contrib(x[:, lo:hi], q[:, lo:hi])
        acc = torch.where(alive, acc + torch.clamp_min(contrib, 0.0), acc)
    keep = alive & (acc * scales[nd - 1] <= tau[None, :]) & valid
    return (acc, keep.to(torch.int8),
            _block_sum(keep.to(torch.int32), block_n),
            _block_sum(entered, block_n))


def _check(t, name, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"dco_scan: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {t.dtype} on {t.device}")


def dco_scan_cuda(x, q, tau, scales, widths, nrows, *, block_n: int,
                  block_d: int):
    """Launch the CUDA kernel on the current stream (no padding: ragged N,
    Q and d1 are bound-checked inside the kernel)."""
    global launches
    dev = x.device
    n, d1 = x.shape
    nq = q.shape[0]
    nd = -(-d1 // block_d)
    if q.shape[1] != d1 or tau.shape != (nq,) or scales.shape[0] < nd \
            or widths.shape[0] < nd or nrows.numel() != 1:
        raise ValueError(
            f"dco_scan: inconsistent shapes x {tuple(x.shape)}, q "
            f"{tuple(q.shape)}, tau {tuple(tau.shape)}, scales "
            f"{tuple(scales.shape)}, widths {tuple(widths.shape)} for "
            f"block_d={block_d}")
    if block_n < 1 or block_d < 1 or n == 0 or nq == 0:
        raise ValueError("dco_scan: empty input or non-positive block size")
    for t, name in ((x, "x"), (q, "q"), (tau, "tau"), (scales, "scales"),
                    (widths, "widths")):
        _check(t, name, torch.float32, dev)
    _check(nrows, "nrows", torch.int32, dev)
    nb = -(-n // block_n)
    partial = torch.empty((n, nq), dtype=torch.float32, device=dev)
    keep = torch.empty((n, nq), dtype=torch.int8, device=dev)
    zeros = torch.zeros((2, nb, nq), dtype=torch.int32, device=dev)
    counts, dims = zeros[0], zeros[1].view(torch.float32)   # 0 bits == 0.0f
    lib = _build.load_library()
    err = lib.dco_scan_launch(
        x.data_ptr(), q.data_ptr(), tau.data_ptr(), scales.data_ptr(),
        widths.data_ptr(), nrows.data_ptr(), partial.data_ptr(),
        keep.data_ptr(), counts.data_ptr(), dims.data_ptr(), n, nq, d1,
        block_d, block_n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "dco_scan")
    launches += 1
    return partial, keep, counts, dims

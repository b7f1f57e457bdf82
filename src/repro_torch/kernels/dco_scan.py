"""The staged DCO scan: bindings of the CUDA kernels ``csrc/dco_scan.cu``
and their plain PyTorch versions.

``dco_scan`` takes x (N, d1) lead dims and q (Q, d1) queries, cut into
nd = ceil(d1 / block_d) dim blocks; ``dco_scan_grouped`` takes the PDX
vertical layout, x (G, N, dg) and q (G, Q, dg), whose nd = G dim blocks are
the groups.  Both take tau (Q,), scales (nd,), widths (nd,) (the logical
dims of each block) and nrows (1,) int32 (rows at or beyond it never keep
and never count), and compute:

  partial (N, Q) f32   running partial distances (frozen pairs keep the
                       value at which they were pruned);
  keep    (N, Q) int8  the final screening decision;
  counts  (ceil(N / block_n), Q) i32  keep counts per row block;
  dims    (ceil(N / block_n), Q) f32  dims entered per row block.

The semantics are those of the reference Pallas kernels
(src/repro/kernels/dco_scan.py); ``kernels.ops.dco_scan_op`` and
``dco_scan_grouped_op`` are the callers.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _block_contrib

#: kernel launches since the last reset (the plain versions never count)
launches = 0            # dco_scan
grouped_launches = 0    # dco_scan_grouped


def _block_sum(a, block_n: int):
    """(N, Q) -> (ceil(N / block_n), Q) sums over row blocks."""
    n, nq = a.shape
    nb = -(-n // block_n)
    a = torch.nn.functional.pad(a, (0, 0, 0, nb * block_n - n))
    return a.reshape(nb, block_n, nq).sum(1, dtype=a.dtype)


def _staged_plain(blocks, n: int, tau, scales, widths, nrows, block_n: int):
    """The gating of both kernels over ``blocks``, the (x_b (N, w),
    q_b (Q, w)) pairs of each dim block in order."""
    dev = tau.device
    valid = (torch.arange(n, device=dev) < nrows)[:, None]
    acc = torch.zeros((n, tau.shape[0]), dtype=torch.float32, device=dev)
    entered = torch.zeros_like(acc)
    for di, (xb, qb) in enumerate(blocks):
        alive = acc * scales[max(di - 1, 0)] <= tau[None, :]
        entered = entered + (alive & valid) * widths[di]
        contrib = _block_contrib(xb, qb)
        acc = torch.where(alive, acc + torch.clamp_min(contrib, 0.0), acc)
    keep = alive & (acc * scales[di] <= tau[None, :]) & valid
    return (acc, keep.to(torch.int8),
            _block_sum(keep.to(torch.int32), block_n),
            _block_sum(entered, block_n))


def dco_scan_plain(x, q, tau, scales, widths, nrows, *, block_n: int,
                   block_d: int):
    """Plain PyTorch version of the kernel: the same four outputs, computed
    for all (row, query) pairs at once per dim block."""
    d1 = x.shape[1]
    blocks = ((x[:, lo:lo + block_d], q[:, lo:lo + block_d])
              for lo in range(0, d1, block_d))
    return _staged_plain(blocks, x.shape[0], tau, scales, widths, nrows,
                         block_n)


def dco_scan_grouped_plain(x, q, tau, scales, widths, nrows, *,
                           block_n: int):
    """Plain PyTorch version of the grouped kernel: ``dco_scan_plain``'s
    gating with group g as dim block g, each charging its logical width
    ``widths[g]`` (the zero padding of a ragged last group adds nothing)."""
    return _staged_plain(zip(x, q), x.shape[1], tau, scales, widths, nrows,
                         block_n)


def _check(t, name, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"dco_scan: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {t.dtype} on {t.device}")


@functools.lru_cache(maxsize=None)
def fill_free(block_n: int) -> bool:
    """Whether the flat kernel stores counts and dims itself at this
    ``block_n``: one thread block cluster of 32-row tiles covers a row
    block, so ``block_n`` must be a multiple of 32 up to 256 rows (the
    engine's 256 is).  Otherwise the op zeroes them first and the kernel
    adds with atomics.  The rule lives in the kernel library
    (``dco_scan_fill_free``); it depends on ``block_n`` alone, so the
    answer is cached."""
    return bool(_build.load_library().dco_scan_fill_free(block_n))


def _launch(entry: str, x, q, tau, scales, widths, nrows, n: int, nq: int,
            layout: tuple, block_n: int, *, zeroed: bool = True):
    """Check the operands, allocate the outputs (counts and dims zeroed
    when ``zeroed``, a fill the entry then adds to; else left for the
    entry to store) and launch ``entry`` of the kernel library on the
    current stream; ``layout`` is (d1, block_d) or (G, dg).  Raises on a
    launch error."""
    dev = x.device
    if block_n < 1 or min(layout) < 1 or n == 0 or nq == 0:
        raise ValueError(f"{entry}: empty input or non-positive block size")
    for t, name in ((x, "x"), (q, "q"), (tau, "tau"), (scales, "scales"),
                    (widths, "widths")):
        _check(t, name, torch.float32, dev)
    _check(nrows, "nrows", torch.int32, dev)
    nb = -(-n // block_n)
    partial = torch.empty((n, nq), dtype=torch.float32, device=dev)
    keep = torch.empty((n, nq), dtype=torch.int8, device=dev)
    alloc = torch.zeros if zeroed else torch.empty
    sums = alloc((2, nb, nq), dtype=torch.int32, device=dev)
    counts, dims = sums[0], sums[1].view(torch.float32)     # 0 bits == 0.0f
    lib = _build.load_library()
    err = getattr(lib, entry)(
        x.data_ptr(), q.data_ptr(), tau.data_ptr(), scales.data_ptr(),
        widths.data_ptr(), nrows.data_ptr(), partial.data_ptr(),
        keep.data_ptr(), counts.data_ptr(), dims.data_ptr(), n, nq, *layout,
        block_n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, entry)
    return partial, keep, counts, dims


def dco_scan_cuda(x, q, tau, scales, widths, nrows, *, block_n: int,
                  block_d: int):
    """Launch the CUDA kernel on the current stream (no padding: ragged N,
    Q and d1 are bound-checked inside the kernel).  At a ``block_n`` for
    which :func:`fill_free` holds (the engine's), the op is the kernel
    alone: one device operation, no zero fill."""
    global launches
    n, d1 = x.shape
    nq = q.shape[0]
    nd = -(-d1 // max(block_d, 1))
    if q.shape[1] != d1 or tau.shape != (nq,) or scales.shape[0] < nd \
            or widths.shape[0] < nd or nrows.numel() != 1:
        raise ValueError(
            f"dco_scan: inconsistent shapes x {tuple(x.shape)}, q "
            f"{tuple(q.shape)}, tau {tuple(tau.shape)}, scales "
            f"{tuple(scales.shape)}, widths {tuple(widths.shape)} for "
            f"block_d={block_d}")
    out = _launch("dco_scan_launch", x, q, tau, scales, widths, nrows, n, nq,
                  (d1, block_d), block_n, zeroed=not fill_free(block_n))
    launches += 1
    return out


def dco_scan_grouped_cuda(x, q, tau, scales, widths, nrows, *, block_n: int):
    """Launch the grouped CUDA kernel on the current stream (no padding:
    ragged N, Q and dg are bound-checked inside the kernel)."""
    global grouped_launches
    if x.dim() != 3 or q.dim() != 3:
        raise ValueError(f"dco_scan_grouped: x and q must be (G, N, dg) and "
                         f"(G, Q, dg), got {tuple(x.shape)} and "
                         f"{tuple(q.shape)}")
    G, n, dg = x.shape
    nq = q.shape[1]
    if q.shape[0] != G or q.shape[2] != dg or tau.shape != (nq,) \
            or scales.shape[0] < G or widths.shape[0] < G \
            or nrows.numel() != 1:
        raise ValueError(
            f"dco_scan_grouped: inconsistent shapes x {tuple(x.shape)}, q "
            f"{tuple(q.shape)}, tau {tuple(tau.shape)}, scales "
            f"{tuple(scales.shape)}, widths {tuple(widths.shape)}")
    out = _launch("dco_scan_grouped_launch", x, q, tau, scales, widths,
                  nrows, n, nq, (G, dg), block_n)
    grouped_launches += 1
    return out

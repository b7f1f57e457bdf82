"""The plain reference: exact k-nearest neighbours under L2, in float64.

Plain torch, blocked over the corpus's rows so that it fits beside
nothing else on the card.  It imports nothing of the program and works
only from the corpus and the queries that the benchmark made.  The
control (``topk(..., precision="tf32")``) is the same search with every
input of the inner product rounded to TF32 (10 mantissa bits, products
summed in float32): what a tensor-core matmul with TF32 on computes, and
the step below the configuration's float32 that would tempt a later
change.
"""
from __future__ import annotations

import torch

#: corpus rows per block of the float64 product
ROW_BLOCK = 1 << 16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest, ties away, at TF32's 10
    mantissa bits, as the tensor cores read it."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _block(X: torch.Tensor, lo: int, hi: int, precision: str, dev):
    x = X[lo:hi].to(dev)
    if precision == "float64":
        x = x.double()
        return x, (x * x).sum(1)
    xf = x.float()
    return round_tf32(xf), (xf * xf).sum(1)


def topk(X: torch.Tensor, Q: torch.Tensor, k: int, *,
         precision: str = "float64", row_block: int = ROW_BLOCK) -> tuple:
    """The ``k`` nearest rows of ``X`` to each row of ``Q``, nearest first:
    ``(d2, ids)``, squared distances (float64) and int64 row ids.  ``X``
    and ``Q`` may live on any device; the work runs on ``Q``'s.
    ``precision="tf32"`` is the control."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    dev = Q.device
    if precision == "float64":
        q = Q.double()
        qn = (q * q).sum(1)
    else:
        qf = Q.float()
        q, qn = round_tf32(qf), (qf * qf).sum(1)
    best_d = torch.full((Q.shape[0], 0), float("inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.empty((Q.shape[0], 0), dtype=torch.int64, device=dev)
    for lo in range(0, X.shape[0], row_block):
        hi = min(lo + row_block, X.shape[0])
        x, xn = _block(X, lo, hi, precision, dev)
        d = (qn[:, None] + xn[None, :] - 2.0 * (q @ x.T)).double()
        kk = min(k, d.shape[1])
        bd, bi = torch.topk(d, kk, dim=1, largest=False)
        best_d = torch.cat([best_d, bd], 1)
        best_i = torch.cat([best_i, bi + lo], 1)
        best_d, order = torch.topk(best_d, min(k, best_d.shape[1]), dim=1,
                                   largest=False)
        best_i = torch.gather(best_i, 1, order)
    return best_d, best_i


def distances(X: torch.Tensor, Q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Squared distances, in float64 and by differences, of each query to
    the rows ``ids`` names: (nq, k) for ``ids`` of shape (nq, k)."""
    rows = X[ids.reshape(-1).to(X.device)].to(Q.device).double()
    diff = rows.reshape(*ids.shape, -1) - Q.double()[:, None, :]
    return (diff * diff).sum(-1)

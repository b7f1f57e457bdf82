"""Plain torch oracles for the kernels (the allclose targets).

Counterparts of the reference package's ``kernels/ref.py``: the same
semantics, written on torch tensors so they run on whatever device their
inputs live on.
"""
from __future__ import annotations

import numpy as np
import torch


def _block_contrib(xb, qb):
    """Per-dim-block squared-distance contribution, before the clamp:
    ``||x_b||^2 - 2 x_b.q_b + ||q_b||^2`` for every (row, query)."""
    return ((xb * xb).sum(1)[:, None] - 2.0 * (xb @ qb.T)
            + (qb * qb).sum(1)[None, :])


def dco_scan_ref(x, q, tau, scales, block_d: int):
    """Incremental staged DCO scan, reference semantics.

    x (N, d1), q (Q, d1); scales (n_dblocks,) per-stage estimate
    multipliers.  A (row, query) pair freezes at the first dim block where
    its scaled partial exceeds tau[query]; its partial keeps the frozen
    value and keep=0.  Returns (partial (N, Q) f32, keep (N, Q) int8).
    """
    n, d1 = x.shape
    nq = q.shape[0]
    nblk = (d1 + block_d - 1) // block_d
    acc = torch.zeros((n, nq), dtype=torch.float32, device=x.device)
    alive = torch.ones((n, nq), dtype=torch.bool, device=x.device)
    for b in range(nblk):
        lo, hi = b * block_d, min((b + 1) * block_d, d1)
        contrib = _block_contrib(x[:, lo:hi], q[:, lo:hi])
        acc = torch.where(alive, acc + torch.clamp_min(contrib, 0.0), acc)
        alive = alive & (acc * scales[b] <= tau[None, :])
    return acc, alive.to(torch.int8)


def dco_scan_dims_ref(x, q, tau, scales, block_d: int, block_n: int,
                      nrows=None):
    """Oracle for the kernel's per-(row-block, query) ``dims`` output: a
    pair enters dim block b iff its partial scaled by the PREVIOUS block's
    scale is still <= tau (at b=0 iff tau >= 0) and its row is below
    ``nrows``; each entering pair charges the block's logical width.
    Returns dims (ceil(N/block_n), Q) f32."""
    n, d1 = x.shape
    nq = q.shape[0]
    nblk = (d1 + block_d - 1) // block_d
    nb = -(-n // block_n)
    rows = torch.arange(n, device=x.device)
    valid = (rows < (n if nrows is None else nrows))[:, None]
    acc = torch.zeros((n, nq), dtype=torch.float32, device=x.device)
    dims = torch.zeros((nb, nq), dtype=torch.float32, device=x.device)
    for b in range(nblk):
        lo, hi = b * block_d, min((b + 1) * block_d, d1)
        prev = scales[b - 1] if b > 0 else 0.0
        alive = (acc * prev) <= tau[None, :]
        entering = (alive & valid).to(torch.float32)
        ep = torch.nn.functional.pad(entering, (0, 0, 0, nb * block_n - n))
        dims = dims + ep.reshape(nb, block_n, nq).sum(1) * float(hi - lo)
        contrib = _block_contrib(x[:, lo:hi], q[:, lo:hi])
        acc = torch.where(alive, acc + torch.clamp_min(contrib, 0.0), acc)
    return dims


def block_keep_counts_ref(keep, block_n: int):
    """Oracle for the kernel's per-candidate-block counts output: the (N, Q)
    keep mask summed over row blocks of ``block_n`` (pad rows count 0)."""
    n, nq = keep.shape
    nb = -(-n // block_n)
    kp = torch.nn.functional.pad(keep.to(torch.int32),
                                 (0, 0, 0, nb * block_n - n))
    return kp.reshape(nb, block_n, nq).sum(1, dtype=torch.int32)


def pq_lookup_ref(codes, lut):
    """codes (N, M) int, lut (Q, M, K) f32 -> adist (N, Q) f32, by the
    gather ``adist[n, q] = sum_m lut[q, m, codes[n, m]]``."""
    m = codes.shape[1]
    g = lut[:, torch.arange(m, device=lut.device)[None, :], codes.long()]
    return g.sum(-1).T                               # (Q, N, M) -> (N, Q)


def make_dco_scales(kind: str, d1: int, block_d: int, D: int, *,
                    eps0: float = 2.1, mass=None, eps_d=None,
                    theta: float = 1.0, device=None):
    """Per-dim-block estimate multipliers matching core.methods decisions
    (computed in float64 numpy, returned as float32 like the reference)."""
    nblk = (d1 + block_d - 1) // block_d
    ds = np.minimum((np.arange(1, nblk + 1)) * block_d, d1).astype(np.float64)
    if kind in ("lb", "fdscan"):
        s = np.ones(nblk)
    elif kind == "adsampling":
        s = (D / ds) / (1.0 + eps0 / np.sqrt(ds)) ** 2
    elif kind == "dade":
        m = np.asarray(mass, np.float64)[np.minimum(ds.astype(int) - 1, len(mass) - 1)]
        e = np.asarray(eps_d, np.float64)[np.minimum(ds.astype(int) - 1, len(eps_d) - 1)]
        s = 1.0 / (np.maximum(m, 1e-9) * (1.0 + e) ** 2)
    elif kind == "ratio":
        s = np.full(nblk, 1.0 / max(theta, 1e-9))
    else:
        raise ValueError(kind)
    return torch.as_tensor(s.astype(np.float32), device=device)

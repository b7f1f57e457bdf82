"""Mixture-of-Experts feed-forward: routed top-k experts and always-on
shared experts.

Counterpart of the mesh-free branch of the reference package's
``models/moe.py`` (plain array code there too: no Pallas).  A mesh (expert
parallelism) raises naming ROADMAP A9 (d).  Two paths, chosen by the
token count T = B x S exactly as in the reference:

* T <= 32, dropless: each token runs its own top-k experts, whose
  weights are gathered a (token, expert) pair at a time;
  ``silu(x @ wg) * (x @ wu)`` stays bf16, the down projection is an f32
  product;
* T > 32, capacity: each expert takes its ``min(cap, T)`` highest-gated
  tokens, ``cap = int(T * top_k / E * capacity_factor)``, the rest of its
  tokens are dropped; the SwiGLU runs on f32 products and its output is
  scattered back (``index_add_``).

Every top-k keeps the lower index first among equal values, as
``lax.top_k`` does: two identical tokens at the capacity cut-off keep the
earlier one (``stream_engine._smallest`` on the negated scores).

``MoE`` holds ``router`` (d, E) in f32, as the reference routes in f32
(a bf16 router flips near-tied expert choices), ``wg`` and ``wu`` (E, d,
F) and ``wd`` (E, F, d) in bf16, and optionally ``shared`` (``wg``,
``wu``, ``wd`` at ``n_shared * F``) in bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stream_engine import _smallest
from repro_torch.models.layers import (CDTYPE, _weight, bmm_f32, dense_init,
                                       make_constrainer, silu, weight_dtype)

DROPLESS_TOKENS = 32      # the reference's dropless path serves T <= 32


def _normal(gen, shape, scale, dtype, device):
    """``N(0, 1) * scale`` drawn in f32 on ``gen`` and cast once to
    ``dtype``; uninitialised with ``gen=None``."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


class SharedExperts(torch.nn.Module):
    """``wg``, ``wu`` (d, n_shared * F) and ``wd`` (n_shared * F, d) bf16."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        d, fs = cfg.d_model, cfg.moe.n_shared * cfg.moe.d_expert
        self.wg = _weight(dense_init(gen, d, fs, device=device))
        self.wu = _weight(dense_init(gen, d, fs, device=device))
        self.wd = _weight(dense_init(gen, fs, d, device=device))


class MoE(torch.nn.Module):
    """``router`` f32 ``N(0, 1) * 0.02``; ``wg``, ``wu`` ``N(0, 1) /
    sqrt(d)`` and ``wd`` ``N(0, 1) / sqrt(F)`` in bf16 (f32 in
    ``layers.master_init``); ``shared`` with ``n_shared``."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        mc = cfg.moe
        d, E, f = cfg.d_model, mc.n_experts, mc.d_expert
        wdt = weight_dtype()
        self.router = _weight(_normal(gen, (d, E), 0.02, torch.float32,
                                      device))
        self.wg = _weight(_normal(gen, (E, d, f), 1.0 / np.sqrt(d), wdt,
                                  device))
        self.wu = _weight(_normal(gen, (E, d, f), 1.0 / np.sqrt(d), wdt,
                                  device))
        self.wd = _weight(_normal(gen, (E, f, d), 1.0 / np.sqrt(f), wdt,
                                  device))
        if mc.n_shared:
            self.shared = SharedExperts(cfg, gen, device=device)


def _top_k(a, k: int):
    """The ``k`` largest entries of each f32 row, descending, lower index
    first among ties (``lax.top_k``'s order)."""
    neg, idx = _smallest(-a, k)
    return -neg, idx


def router_probs(params, x_flat):
    """Softmax over the f32 router logits of x_flat (T, D): (T, E) f32."""
    logits = x_flat.to(torch.float32) @ params.router.to(torch.float32)
    return torch.softmax(logits, -1)


def _gates(vals):
    """The top-k probabilities renormalised to sum to one a token."""
    return vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)


def _expert_compute(xg, wg, wu, wd):
    """xg (E, C, D) -> (E, C, D) f32 through each expert's SwiGLU, the
    intermediate f32 and cast to xg's dtype before the down projection."""
    h = silu(bmm_f32(xg, wg)) * bmm_f32(xg, wu)
    return bmm_f32(h.to(xg.dtype), wd)


def _dropless(params, mc, x_flat, probs):
    """Each token through its own top-k experts: (T, D) f32."""
    vals, idx = _top_k(probs, mc.top_k)
    vals = _gates(vals)
    xc = x_flat.to(CDTYPE)[:, None, :]                         # (T, 1, D)
    out = torch.zeros(x_flat.shape, dtype=torch.float32,
                      device=x_flat.device)
    for j in range(mc.top_k):
        e = idx[:, j]
        h = silu(torch.bmm(xc, params.wg[e])) * torch.bmm(xc, params.wu[e])
        out = out + vals[:, j, None] * bmm_f32(h, params.wd[e])[:, 0]
    return out


def _capacity(params, mc, x_flat, probs, capacity: int):
    """Expert choice over the normalised top-k gates: each expert's
    ``min(capacity, T)`` highest-gated tokens, the rest dropped: (T, D)
    f32."""
    T, D = x_flat.shape
    E = probs.shape[1]
    gate_vals, gate_idx = _top_k(probs, mc.top_k)
    gmat = torch.zeros((T, E), dtype=torch.float32, device=x_flat.device)
    gmat.scatter_(1, gate_idx, _gates(gate_vals))
    loc = gmat.T                                               # (E, T)
    score = torch.where(loc > 0, loc, -torch.inf)
    top_val, tok_idx = _top_k(score.contiguous(), min(capacity, T))
    gates = torch.where(torch.isfinite(top_val), top_val, 0.0)
    flat_idx = tok_idx.reshape(-1)
    xg = x_flat[flat_idx].reshape(E, -1, D).to(CDTYPE)
    y = _expert_compute(xg, params.wg, params.wu, params.wd)  # (E, C, D)
    y = y * gates[..., None]
    out = torch.zeros((T, D), dtype=torch.float32, device=x_flat.device)
    return out.index_add_(0, flat_idx, y.reshape(-1, D))


def _aux_loss(probs):
    """The soft switch load-balance loss E * sum_e mean(prob_e)^2."""
    me = probs.mean(0)
    return probs.shape[1] * torch.sum(me * me)


def moe_forward(params, cfg, x, *, mesh=None, dp_axes=("data",)):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss * weight)."""
    make_constrainer(mesh, dp_axes)
    mc = cfg.moe
    B, S, D = x.shape
    x_flat = x.reshape(-1, D)
    T = x_flat.shape[0]
    probs = router_probs(params, x_flat)                       # (T, E)
    if T <= DROPLESS_TOKENS:
        # a decode step's routing must not depend on the other requests
        # of its batch, so tiny token counts do not compete for capacity
        out = _dropless(params, mc, x_flat, probs)
    else:
        cap = max(1, int(T * mc.top_k / mc.n_experts * mc.capacity_factor))
        out = _capacity(params, mc, x_flat, probs, cap)
    out = out.reshape(B, S, D).to(x.dtype)
    if mc.n_shared:
        sp = params.shared
        xc = x.to(CDTYPE)
        h = silu(xc @ sp.wg) * (xc @ sp.wu)
        out = out + (h @ sp.wd).to(x.dtype)
    return out, _aux_loss(probs) * mc.aux_loss_weight

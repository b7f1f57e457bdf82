"""Mixture-of-Experts feed-forward: routed top-k experts and always-on
shared experts.

Counterpart of the reference package's ``models/moe.py`` (plain array
code there too: no Pallas).  Without a mesh (or on one that cannot shard
the call) two paths, chosen by the token count T = B x S exactly as in
the reference:

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

On a mesh whose DP ranks split the batch and whose ``"model"`` ranks
split the experts, the expert-parallel branch (the reference's
``shard_map``): each rank gathers its E / tp experts over the DP dims,
routes its DP share of the tokens among them on the capacity path, with
the capacity of its local token count (a decode step too), and the
partial outputs are summed over ``"model"`` (in bf16 with
``psum_dtype=torch.bfloat16`` or ``REPRO_MOE_PSUM_BF16`` set); the aux
loss is the mean over the DP ranks of each rank's.  Its backward is the
gradient of the global function (``models.placement``).

``MoE`` holds ``router`` (d, E) in f32, as the reference routes in f32
(a bf16 router flips near-tied expert choices), ``wg`` and ``wu`` (E, d,
F) and ``wd`` (E, F, d) in bf16, and optionally ``shared`` (``wg``,
``wu``, ``wd`` at ``n_shared * F``) in bf16.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.configs.sharding import mesh_sizes
from repro_torch.core.stream_engine import _smallest
from repro_torch.models import placement as P
from repro_torch.models.layers import (CDTYPE, _weight, bmm_f32, dense_init,
                                       silu, weight_dtype)

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

    #: placed stacks that ``placement.gathered`` leaves to ``moe_forward``
    expert_stacks = ("wg", "wu", "wd")

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


def _capacity(params, mc, x_flat, probs, capacity: int, *, e_offset=0,
              n_local=None):
    """Expert choice over the normalised top-k gates: each of the experts
    ``e_offset .. e_offset + n_local`` (``params`` holds their stacks)
    takes its ``min(capacity, T)`` highest-gated tokens, the rest
    dropped: (T, D) f32, the sum of those experts' outputs."""
    T, D = x_flat.shape
    E = probs.shape[1]
    n_local = E if n_local is None else n_local
    gate_vals, gate_idx = _top_k(probs, mc.top_k)
    gmat = torch.zeros((T, E), dtype=torch.float32, device=x_flat.device)
    gmat.scatter_(1, gate_idx, _gates(gate_vals))
    loc = gmat[:, e_offset:e_offset + n_local].T               # (El, T)
    score = torch.where(loc > 0, loc, -torch.inf)
    top_val, tok_idx = _top_k(score.contiguous(), min(capacity, T))
    gates = torch.where(torch.isfinite(top_val), top_val, 0.0)
    flat_idx = tok_idx.reshape(-1)
    xg = x_flat[flat_idx].reshape(n_local, -1, D).to(CDTYPE)
    y = _expert_compute(xg, params.wg, params.wu, params.wd)  # (El, C, D)
    y = y * gates[..., None]
    out = torch.zeros((T, D), dtype=torch.float32, device=x_flat.device)
    return out.index_add_(0, flat_idx, y.reshape(-1, D))


def _aux_loss(probs):
    """The soft switch load-balance loss E * sum_e mean(prob_e)^2."""
    me = probs.mean(0)
    return probs.shape[1] * torch.sum(me * me)


def _local_experts(w, mesh, dp_axes, m: int, n_local: int):
    """Model rank m's experts, whole over the DP dims: a placed stack
    gathered over them, or the rows m * n_local ... of a whole one (the
    train step's working copy)."""
    if P.is_placed(w):
        return P.full(w, names=dp_axes)
    return w[m * n_local:(m + 1) * n_local]


def moe_forward(params, cfg, x, *, mesh=None, dp_axes=("data",),
                psum_dtype=None, global_batch=None):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss * weight).

    On a mesh, x holds this rank's rows of a call over ``global_batch``
    rows (default: x is the rank's DP share, ``B * dp``); when the DP
    ranks cannot split that batch, or the ``"model"`` ranks the experts,
    every rank holds all rows and runs the mesh-free code on the whole
    experts, as the reference falls back.  The expert stacks may be
    placed (``DTensor``) or whole."""
    if psum_dtype is None and os.environ.get("REPRO_MOE_PSUM_BF16"):
        psum_dtype = torch.bfloat16
    mc = cfg.moe
    B, S, D = x.shape
    E = mc.n_experts
    tp_axis = "model"
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    dp = P.dp_size(mesh, dp_axes) if tp_axis in sizes else 1
    batch = B * dp if global_batch is None else global_batch
    unshardable = (tp_axis not in sizes or batch % dp != 0
                   or E % sizes[tp_axis] != 0)
    x_flat = x.reshape(-1, D)
    if unshardable:
        if mesh is not None and batch != B:
            raise ValueError(f"a batch of {batch} rows that the mesh cannot "
                             f"shard must be held whole, not as {B} rows")
        w = SimpleNamespace(**{k: P.full(getattr(params, k))
                               for k in ("router", "wg", "wu", "wd")})
        T = x_flat.shape[0]
        probs = router_probs(w, x_flat)                        # (T, E)
        if T <= DROPLESS_TOKENS:
            # a decode step's routing must not depend on the other
            # requests of its batch, so tiny token counts do not compete
            # for capacity
            out = _dropless(w, mc, x_flat, probs)
        else:
            cap = max(1, int(T * mc.top_k / E * mc.capacity_factor))
            out = _capacity(w, mc, x_flat, probs, cap)
        aux = _aux_loss(probs)
    else:
        tp = sizes[tp_axis]
        n_local, m = E // tp, mesh.get_local_rank(tp_axis)
        w = SimpleNamespace(**{k: _local_experts(getattr(params, k), mesh,
                                                 dp_axes, m, n_local)
                               for k in ("wg", "wu", "wd")})
        cap = max(1, int(x_flat.shape[0] * mc.top_k / E * mc.capacity_factor))
        probs = router_probs(SimpleNamespace(router=P.full(params.router)),
                             x_flat)
        aux = P.sum_out(_aux_loss(probs), mesh, dp_axes) / dp
        # the "model" ranks hold the same tokens and route them alike;
        # each computes its experts' share, and the tokens' and the
        # probabilities' cotangents are summed over those shares
        out = _capacity(w, mc, P.sum_grad(x_flat, mesh, [tp_axis]),
                        P.sum_grad(probs, mesh, [tp_axis]), cap,
                        e_offset=m * n_local, n_local=n_local)
        if psum_dtype is not None:
            out = out.to(psum_dtype)
        out = P.sum_out(out, mesh, [tp_axis])
    out = out.reshape(B, S, D).to(x.dtype)
    if mc.n_shared:
        sp = params.shared
        xc = x.to(CDTYPE)
        h = silu(xc @ P.full(sp.wg)) * (xc @ P.full(sp.wu))
        out = out + (h @ P.full(sp.wd)).to(x.dtype)
    return out, aux * mc.aux_loss_weight

"""Multi-head Latent Attention (DeepSeek v2/v3).

Counterpart of the reference package's ``models/mla.py`` (plain array code
there too: no Pallas).  Prefill runs the "expanded" form; decode runs the
ABSORBED form: the rank-``kv_lora`` latent ``c_kv`` and the shared RoPE key
``k_rope`` are the whole cache, ``W_uk`` is folded into the query and
``W_uv`` into the output, so a step reads ``Smax x (kv_lora + rope_dim)``
cache values a slot instead of ``Smax x 2 x H x hd``.

``MLA`` holds ``wq_a``, ``wq_b``, ``wkv_a``, ``wk_b``, ``wv_b`` and ``wo``
in bf16 and the gains ``q_norm`` and ``kv_norm`` in f32.  The decode's
scores and context are f32 products of bf16 operands over the latent
cache (``layers.bmm_f32``), and its write into the caller's cache is in
place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (CDTYPE, _weight, apply_rope,
                                       blockwise_attention, bmm_f32,
                                       dense_init, rms_norm, rope_table,
                                       write_index)


class MLA(torch.nn.Module):
    """The projections (d_in, d_out) bf16, the gains (f32 ones) and the
    RoPE frequencies over ``rope_dim`` as a buffer."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        f32 = dict(dtype=torch.float32, device=device)
        self.wq_a = _weight(dense_init(gen, d, m.q_lora, device=device))
        self.q_norm = _weight(torch.ones(m.q_lora, **f32))
        self.wq_b = _weight(dense_init(gen, m.q_lora,
                                       H * (m.nope_dim + m.rope_dim),
                                       device=device))
        self.wkv_a = _weight(dense_init(gen, d, m.kv_lora + m.rope_dim,
                                        device=device))
        self.kv_norm = _weight(torch.ones(m.kv_lora, **f32))
        self.wk_b = _weight(dense_init(gen, m.kv_lora, H * m.nope_dim,
                                       device=device))
        self.wv_b = _weight(dense_init(gen, m.kv_lora, H * m.v_dim,
                                       device=device))
        self.wo = _weight(dense_init(gen, H * m.v_dim, d, device=device))
        self.register_buffer("freqs", rope_table(m.rope_dim, cfg.rope_theta,
                                                 device), persistent=False)


def _project_q(params, cfg, x, positions):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    ql = rms_norm(x.to(CDTYPE) @ params.wq_a, params.q_norm)
    q = (ql.to(CDTYPE) @ params.wq_b).reshape(B, S, H,
                                               m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta,
                              params.freqs)


def _project_kv_latent(params, cfg, x, positions):
    """(c_kv (B, S, kv_lora), k_rope (B, S, rope_dim)), both bf16."""
    m = cfg.mla
    kv = x.to(CDTYPE) @ params.wkv_a
    c_kv = rms_norm(kv[..., :m.kv_lora], params.kv_norm)
    k_rope = apply_rope(kv[..., None, m.kv_lora:], positions,
                        cfg.rope_theta, params.freqs)
    return c_kv, k_rope[..., 0, :]


def mla_forward(params, cfg, x):
    """Expanded prefill attention over x (B, S, d); returns (out, (c_kv,
    k_rope))."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _project_q(params, cfg, x, pos)
    c_kv, k_rope = _project_kv_latent(params, cfg, x, pos)
    k_nope = (c_kv.to(CDTYPE) @ params.wk_b).reshape(B, S, H, m.nope_dim)
    v = (c_kv.to(CDTYPE) @ params.wv_b).reshape(B, S, H, m.v_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H,
                                                         m.rope_dim)], -1)
    # v_dim != the q/k head dim: pad v for the shared blockwise attention,
    # trim after
    v_p = F.pad(v, (0, m.nope_dim + m.rope_dim - m.v_dim))
    out = blockwise_attention(q, k, v_p, kind="causal",
                              scale=1.0 / np.sqrt(m.nope_dim + m.rope_dim),
                              block_q=cfg.attn_block_q,
                              block_kv=cfg.attn_block_kv)
    out = out[..., :m.v_dim].reshape(B, S, H * m.v_dim)
    out = (out.to(CDTYPE) @ params.wo).to(x.dtype)
    return out, (c_kv, k_rope)


def mla_decode(params, cfg, x, cache, cur_len, *, drop=False, seq=None):
    """Absorbed one-token decode of x (B, 1, d).  ``cache`` = {'c_kv' (B,
    Smax, kv_lora), 'k_rope' (B, Smax, rope_dim)}, written in place at
    ``cur_len - 1`` (a scalar or a (B,) tensor on x's device) and returned.
    With ``drop``, a slot whose position lies past Smax writes nothing and
    attends over all Smax positions, as the reference's out-of-range
    scatter does.  ``seq`` (a ``placement.SeqShard``) says the cache holds
    this rank's range of the positions only: the rank that holds a
    slot's position writes it, and the latent context is merged over the
    ranks before ``wv_b``'s absorption (both are linear)."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    idx = torch.as_tensor(cur_len, device=x.device).long().expand(B) - 1
    pos = idx[:, None]
    q_nope, q_rope = _project_q(params, cfg, x, pos)           # (B,1,H,·)
    c_new, kr_new = _project_kv_latent(params, cfg, x, pos)    # (B,1,·)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    rows = torch.arange(B, device=x.device)
    c_new, kr_new = c_new[:, 0].to(c_kv.dtype), kr_new[:, 0].to(k_rope.dtype)
    held = c_kv.shape[1]
    idx, keep = write_index(idx, held, drop, seq)
    if keep is not None:
        # a slot that writes nothing here writes back what its row holds,
        # with no host read of the lengths
        c_new = torch.where(keep[:, None], c_new, c_kv[rows, idx])
        kr_new = torch.where(keep[:, None], kr_new, k_rope[rows, idx])
    c_kv.index_put_((rows, idx), c_new)
    k_rope.index_put_((rows, idx), kr_new)
    # absorb W_uk into q: q_eff[b, h] = q_nope[b, h] @ wk_b[:, h]^T, a
    # (B, nope) @ (nope, kv_lora) product a head
    wkb = params.wk_b.reshape(m.kv_lora, H, m.nope_dim)
    q_eff = bmm_f32(q_nope[:, 0].transpose(0, 1),
                    wkb.permute(1, 2, 0)).transpose(0, 1)      # (B,H,kv_lora)
    s = (bmm_f32(q_eff.to(CDTYPE), c_kv.transpose(1, 2))
         + bmm_f32(q_rope[:, 0].to(CDTYPE), k_rope.transpose(1, 2)))
    s = s / np.sqrt(m.nope_dim + m.rope_dim)                   # (B,H,S)
    n = torch.as_tensor(cur_len, device=x.device).reshape(-1, 1).expand(B, 1)
    pos = torch.arange(held, device=x.device)
    valid = (pos if seq is None else pos + seq.start)[None, :] < n
    if seq is None:
        p = torch.softmax(torch.where(valid[:, None, :], s, -torch.inf),
                          dim=-1)
        ctx = bmm_f32(p.to(CDTYPE), c_kv)                      # (B,H,kv_lora)
    else:
        ctx = seq.softmax_mix(s, valid[:, None, :],
                              lambda p: bmm_f32(p.to(CDTYPE), c_kv))
    # absorb W_uv into the output projection
    wvb = params.wv_b.reshape(m.kv_lora, H, m.v_dim)
    o = bmm_f32(ctx.to(CDTYPE).transpose(0, 1),
                wvb.transpose(0, 1)).transpose(0, 1)           # (B,H,v_dim)
    out = (o.reshape(B, 1, H * m.v_dim).to(CDTYPE) @ params.wo).to(x.dtype)
    return out, cache


def init_mla_cache(cfg, batch, max_len, dtype=CDTYPE, *, device=None):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.rope_dim), dtype=dtype,
                                  device=device)}

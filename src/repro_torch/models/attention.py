"""GQA/MQA attention module (projections + RoPE + qk_norm + cache).

Counterpart of the reference package's ``models/attention.py``.  The
decode path writes the new token's K/V into the caller's preallocated
cache in place (``index_put_`` at each slot's ``cur_len - 1``) and
returns that same cache.  On a cache split on its sequence axis over a
mesh (``placement.SeqShard``) the rank whose range holds a slot's
position writes it, each rank attends over its positions, and the
ranks' softmax terms are merged.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (CDTYPE, _weight, apply_rope,
                                       blockwise_attention, decode_attention,
                                       decode_attention_sharded, dense_init,
                                       rms_norm, rope_table, write_index)


class Attention(torch.nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` (d_in, d_out) bf16; ``q_gamma`` and
    ``k_gamma`` (hd,) f32 with qk-norm; the RoPE frequencies as a
    buffer."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _weight(dense_init(gen, d, H * hd, device=device))
        self.wk = _weight(dense_init(gen, d, Hkv * hd, device=device))
        self.wv = _weight(dense_init(gen, d, Hkv * hd, device=device))
        self.wo = _weight(dense_init(gen, H * hd, d, device=device))
        if cfg.qk_norm:
            self.q_gamma = _weight(torch.ones(hd, dtype=torch.float32,
                                              device=device))
            self.k_gamma = _weight(torch.ones(hd, dtype=torch.float32,
                                              device=device))
        self.register_buffer("freqs", rope_table(hd, cfg.rope_theta, device),
                             persistent=False)


def _qkv(params, cfg, xq, xkv, q_positions, *, rope: bool):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xq_c, xkv_c = xq.to(CDTYPE), xkv.to(CDTYPE)
    q = (xq_c @ params.wq).reshape(B, Sq, H, hd)
    k = (xkv_c @ params.wk).reshape(B, Skv, Hkv, hd)
    v = (xkv_c @ params.wv).reshape(B, Skv, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_gamma)
        k = rms_norm(k, params.k_gamma)
    if rope:
        kv_positions = (torch.arange(Skv, device=xq.device)[None, :]
                        if Sq != Skv else q_positions)
        q = apply_rope(q, q_positions, cfg.rope_theta, params.freqs)
        k = apply_rope(k, kv_positions, cfg.rope_theta, params.freqs)
    return q, k, v


def attention_forward(params, cfg, x, *, kind="causal", prefix_len=0,
                      memory=None, return_kv=False):
    """Training / prefill path.  ``memory`` (B, Sm, D) switches to
    cross-attention (no RoPE, full mask)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    if memory is None:
        q, k, v = _qkv(params, cfg, x, x, pos, rope=True)
    else:
        q, k, v = _qkv(params, cfg, x, memory, pos, rope=False)
        kind = "full"
    out = blockwise_attention(q, k, v, kind=kind, prefix_len=prefix_len,
                              block_q=cfg.attn_block_q,
                              block_kv=cfg.attn_block_kv)
    out = (out.reshape(B, S, -1).to(CDTYPE) @ params.wo).to(x.dtype)
    return (out, (k, v)) if return_kv else out


def attention_decode(params, cfg, x, cache, cur_len, *, cross=False,
                     drop=False, seq=None):
    """One-token decode.  ``cache`` = {'k','v'} (B, Smax, Hkv, hd) for self-
    attention (written in place at cur_len-1) or static cross K/V
    (read-only).  ``cur_len`` is a scalar or a (B,) int tensor on x's
    device.  With ``drop``, a slot whose position cur_len-1 lies past
    Smax writes nothing and attends over all Smax positions, as the
    reference's out-of-range scatter does.  ``seq`` (a
    ``placement.SeqShard``) says the cache holds this rank's range of
    the positions only."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xc = x.to(CDTYPE)
    q = (xc @ params.wq).reshape(B, 1, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_gamma)
    k_cache, v_cache = cache["k"], cache["v"]
    if cross:
        n = k_cache.shape[1] if seq is None else seq.smax
    else:
        idx = torch.as_tensor(cur_len, device=x.device).long().expand(B) - 1
        pos = idx[:, None]
        k = (xc @ params.wk).reshape(B, 1, Hkv, hd)
        v = (xc @ params.wv).reshape(B, 1, Hkv, hd)
        if cfg.qk_norm:
            k = rms_norm(k, params.k_gamma)
        q = apply_rope(q, pos, cfg.rope_theta, params.freqs)
        k = apply_rope(k, pos, cfg.rope_theta, params.freqs)
        # write at per-slot positions (cur_len may be scalar or (B,))
        rows = torch.arange(B, device=x.device)
        k_new, v_new = k[:, 0].to(k_cache.dtype), v[:, 0].to(v_cache.dtype)
        idx, keep = write_index(idx, k_cache.shape[1], drop, seq)
        if keep is not None:
            # a slot that writes nothing here writes back what its row
            # holds, with no host read of the lengths (they may be a
            # device tensor)
            k_new = torch.where(keep[:, None, None], k_new, k_cache[rows, idx])
            v_new = torch.where(keep[:, None, None], v_new, v_cache[rows, idx])
        k_cache.index_put_((rows, idx), k_new)
        v_cache.index_put_((rows, idx), v_new)
        n = cur_len
    if seq is None:
        out = decode_attention(q, k_cache, v_cache, n)
    else:
        out = decode_attention_sharded(q, k_cache, v_cache, n, seq)
    out = (out.reshape(B, 1, -1).to(CDTYPE) @ params.wo).to(x.dtype)
    return out, cache


def init_kv_cache(cfg, batch, max_len, dtype=CDTYPE, *, device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

"""DCO-screened attention: the paper's two-stage pruning applied to
long-context decode.

Counterpart of the reference package's ``serving/dco_attention.py``,
in plain PyTorch (the reference computes it outside any Pallas kernel).

Attention at decode is a vector similarity search: the query scans every
cached key for the largest inner products.  Keys are cached in a
PCA-rotated basis (rotation fitted on key statistics, distance- and
inner-product-preserving); stage 1 computes PARTIAL scores on the leading
``d1`` rotated dims for all S cached keys; the top-C candidates by partial
score go to stage 2 (exact scores on all dims) and the softmax is taken
over those C only.  Per step and KV head the keys read drop from S * hd
to S * d1 + C * hd values.

This is APPROXIMATE attention (the softmax mass outside the top-C is
dropped).  Scores accumulate in float32 whatever the inputs' type (the
reference's ``preferred_element_type``), and the output is cast to
``q.dtype``.
"""
from __future__ import annotations

import numpy as np
import torch


def fit_key_rotation(keys: np.ndarray) -> np.ndarray:
    """PCA rotation (hd, hd) from sampled key vectors (n, hd)."""
    k = np.asarray(keys, np.float64)
    k = k - k.mean(0)
    cov = k.T @ k / max(1, k.shape[0] - 1)
    evals, evecs = np.linalg.eigh(cov)
    return np.ascontiguousarray(evecs[:, ::-1]).astype(np.float32)


def _f32(*ts):
    return tuple(t.to(torch.float32) for t in ts)


def _valid(cur_len, B: int, S: int, device):
    """(B, 1, 1, S) mask of the positions below each row's ``cur_len`` (a
    scalar or (B,))."""
    lens = torch.as_tensor(cur_len, device=device).reshape(-1).expand(B)
    return (torch.arange(S, device=device)[None, :]
            < lens[:, None])[:, None, None, :]


def _top_c(s1, C: int):
    """Positions of the C largest entries of each row of ``s1`` (..., S),
    largest first, the lower position first among ties and masked -inf
    positions last in position order: what the reference's
    ``lax.top_k(s1, C)`` selects (``stream_engine._smallest`` of the
    negated scores, whose int64 keys make every entry unique)."""
    from repro_torch.core.stream_engine import _smallest

    rows = (-s1).reshape(-1, s1.shape[-1])
    _, idx = _smallest(rows, C)
    return idx.reshape(*s1.shape[:-1], C)


def dco_decode_attention(q, k_rot_cache, v_cache, rot, cur_len, *,
                         d1: int = 32, cap: int = 512, scale=None):
    """q (B, H, hd); k_rot_cache (B, S, Hkv, hd) keys ALREADY in the rotated
    basis; v_cache (B, S, Hkv, hd); rot (hd, hd); ``cur_len`` a scalar or
    (B,) count of valid cache positions.  Returns (B, H, hd) in
    ``q.dtype``.  GQA: H = G * Hkv."""
    B, H, hd = q.shape
    S, Hkv = k_rot_cache.shape[1], k_rot_cache.shape[2]
    G = H // Hkv
    C = min(cap, S)
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    rot_dtype = torch.promote_types(q.dtype, rot.dtype)
    q_rot = torch.einsum("bhd,de->bhe", *_f32(q, rot)).to(rot_dtype)
    q_rot = q_rot.reshape(B, Hkv, G, hd)
    # ---- stage 1: partial scores on the leading d1 rotated dims ----------
    s1 = torch.einsum("bhgd,bshd->bhgs", *_f32(q_rot[..., :d1],
                                              k_rot_cache[..., :d1]))
    s1 = torch.where(_valid(cur_len, B, S, q.device), s1, -torch.inf)
    # ---- top-C screening --------------------------------------------------
    idx = _top_c(s1, C)                                  # (B, Hkv, G, C)
    # ---- stage 2: exact scores for the survivors --------------------------
    bidx = torch.arange(B, device=q.device)[:, None, None, None]
    hidx = torch.arange(Hkv, device=q.device)[None, :, None, None]
    k_sel = k_rot_cache[bidx, idx, hidx]                 # (B, Hkv, G, C, hd)
    v_sel = v_cache[bidx, idx, hidx]
    s2 = torch.einsum("bhgd,bhgcd->bhgc", *_f32(q_rot, k_sel)) * scale
    alive = torch.gather(torch.isfinite(s1), -1, idx)
    s2 = torch.where(alive, s2, -torch.inf)
    p = torch.softmax(s2, dim=-1)
    out = torch.einsum("bhgc,bhgcd->bhgd",
                       *_f32(p.to(v_sel.dtype), v_sel))
    return out.reshape(B, H, hd).to(q.dtype)


def exact_decode_attention(q, k_cache, v_cache, cur_len, *, scale=None):
    """Full softmax attention over the cache (the oracle of the screened
    version): q (B, H, hd), k_cache and v_cache (B, S, Hkv, hd)."""
    B, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", *_f32(qg, k_cache)) * scale
    s = torch.where(_valid(cur_len, B, S, q.device), s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", *_f32(p.to(v_cache.dtype), v_cache))
    return out.reshape(B, H, hd).to(q.dtype)

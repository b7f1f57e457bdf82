"""Shared model layers: norms, RoPE, blockwise attention, MLPs.

Counterpart of the reference package's ``models/layers.py`` in plain
PyTorch (the reference computes all of it outside any Pallas kernel).

Conventions:
  * parameters live in ``nn.Module``s (``models/lm.py``); the functions
    here take the module, or plain tensors, and read its attributes;
  * matmul weights and the embedding are held in bf16 (``CDTYPE``), the
    norm gains in f32; the reference casts its f32 weights to bf16 at
    every use, and round-to-nearest-even makes the two the same numbers;
  * attention scores and the P.V product are f32 results of bf16
    operands (the reference's ``preferred_element_type=float32``): on a
    CUDA tensor one ``torch.bmm(..., out_dtype=torch.float32)``, on the
    CPU both operands widened to f32 first (a product of two bf16 values
    is exact in f32); softmax in f32;
  * attention is blockwise (online softmax over KV chunks) so a long
    prefill never materializes an (S x S) score matrix;
  * every init function takes an explicit ``torch.Generator``; inside
    ``master_init()`` the random draws stay f32 (the training path's
    master weights), else they are rounded once to bf16;
  * under autograd the f32-result GEMM gives each bf16 operand the
    reference's cotangent (``bmm_out_f32``), and blockwise attention
    recomputes each query chunk in the backward, as the reference's
    ``jax.checkpoint`` does, so no (S x S) tile is kept (inside a layer
    checkpointed whole, ``remat_region``, the layer's recompute is the
    only one).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CDTYPE = torch.bfloat16    # compute dtype
_WEIGHT_DTYPE = [CDTYPE]   # what a random draw is rounded to (master_init)
_REMAT_DEPTH = [0]         # enclosing checkpointed regions (remat_region)


@contextlib.contextmanager
def master_init():
    """Inside, every random matmul weight and embedding is kept as its f32
    draw instead of being rounded to bf16: the same generator calls, so
    rounding a master gives the serving init's weight bit for bit."""
    _WEIGHT_DTYPE[0] = torch.float32
    try:
        yield
    finally:
        _WEIGHT_DTYPE[0] = CDTYPE


@contextlib.contextmanager
def remat_region():
    """Marks code that its caller checkpoints whole (``models.lm``'s
    ``remat="block"``): inside, blockwise attention does not checkpoint
    its query chunks again, since the region's recompute keeps one
    layer's tiles only until that layer's backward."""
    _REMAT_DEPTH[0] += 1
    try:
        yield
    finally:
        _REMAT_DEPTH[0] -= 1


def weight_dtype():
    """The dtype a random weight is held in: bf16, f32 in ``master_init``."""
    return _WEIGHT_DTYPE[0]


def dense_init(gen, d_in, d_out, scale=None, *, device=None):
    """``N(0, 1) / sqrt(d_in)`` (or ``* scale``) drawn in f32 on ``gen``'s
    device and rounded once to bf16 (kept f32 in ``master_init``);
    ``gen=None`` leaves the weight uninitialised (it is about to be
    overwritten)."""
    if gen is None:
        return torch.empty(d_in, d_out, dtype=weight_dtype(), device=device)
    s = (1.0 / np.sqrt(d_in)) if scale is None else scale
    w = torch.randn(d_in, d_out, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * s).to(weight_dtype())


def rms_norm(x, gamma=None, eps=1e-6):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    return y.to(x.dtype)


def nonparam_layer_norm(x, eps=1e-6):
    """OLMo-style non-parametric LayerNorm (no gain/bias)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_constrainer(mesh, dp_axes):
    """Activation sharding constraint: batch rows over the DP axes.  The
    identity without a mesh, on a plain tensor (on a mesh the port's
    activations are already the rank's rows, ``models.placement.Rows``)
    and when the leading dim does not divide over the DP ranks; a
    ``DTensor`` is redistributed to ``Shard(0)`` over the DP dims,
    replicated over the others."""
    if mesh is None:
        return lambda x: x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.placement import dp_size, mesh_names
    dp = dp_size(mesh, dp_axes)
    placements = [Shard(0) if name in dp_axes else Replicate()
                  for name in mesh_names(mesh)]

    def constrain(x):
        if not isinstance(x, DTensor) or x.ndim == 0 or x.shape[0] % dp:
            return x
        return x.redistribute(mesh, placements)

    return constrain


def make_norm(cfg):
    """(init, apply): ``init(d, device)`` gives the gain (f32 ones, or
    None for the non-parametric norm), ``apply(gain, x)`` the norm."""
    if cfg.nonparam_ln:
        return (lambda d, device=None: None), \
            (lambda p, x: nonparam_layer_norm(x))
    return (lambda d, device=None: torch.ones(d, dtype=torch.float32,
                                              device=device)), \
        (lambda p, x: rms_norm(x, p))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_table(head_dim, theta, device=None):
    """``rope_freqs`` in f32 on ``device``: a model holds it once, so a
    decode step copies nothing from the host per layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta, freqs=None):
    """x (..., S, H, hd); positions (..., S).  Split-half rotation; the
    angles are f32.  ``freqs`` is ``rope_table(hd, theta)`` if given."""
    hd = x.shape[-1]
    if freqs is None:
        freqs = rope_table(hd, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (...,S,hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# f32 products of bf16 operands
# ---------------------------------------------------------------------------


def _einsum_f32(eq, a, b):
    """``einsum`` with f32 accumulation: the operands widened to f32."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


class _BmmOutF32(torch.autograd.Function):
    """One bf16 ``bmm`` with an f32 result, differentiable: autograd has
    no formula for ``aten::bmm.dtype``.  Each operand's cotangent is the
    f32 cotangent times the other operand, formed in f32 and rounded to
    the operand's dtype, which is what ``jax.grad`` of a
    ``preferred_element_type=float32`` dot gives."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.to(torch.float32).transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(torch.float32).transpose(1, 2), g).to(b.dtype)
        return ga, gb


def bmm_out_f32(a, b):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` of bf16 operands, with
    a backward (``_BmmOutF32``) when autograd records it."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _BmmOutF32.apply(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def bmm_f32(a, b):
    """``torch.bmm`` with an f32 result (the reference's
    ``preferred_element_type=float32``): of two bf16 CUDA operands one
    bf16 GEMM with an f32 output, read in place; otherwise both operands
    widened to f32 first (the CPU has no bf16 GEMM with an f32 output)."""
    if a.is_cuda and a.dtype == b.dtype == CDTYPE:
        return bmm_out_f32(a, b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def grouped_scores_upcast(qg, k):
    """qg (B, Hkv, G, hd), k (B, S, Hkv, hd) -> (B, Hkv, G, S) f32, the
    operands widened to f32 (the CPU form)."""
    return _einsum_f32("bhgd,bshd->bhgs", qg, k)


def grouped_mix_upcast(p, v):
    """p (B, Hkv, G, S), v (B, S, Hkv, hd) -> (B, Hkv, G, hd) f32."""
    return _einsum_f32("bhgs,bshd->bhgd", p, v)


def _block_diagonal(qg):
    """(B, Hkv, G, hd) -> (B, Hkv * G, Hkv * hd): row (h, g) holds q[h, g]
    in column block h and zeros elsewhere."""
    B, Hkv, G, hd = qg.shape
    eye = torch.eye(Hkv, dtype=qg.dtype, device=qg.device)
    return (qg[:, :, :, None, :] * eye[None, :, None, :, None]).reshape(
        B, Hkv * G, Hkv * hd)


def grouped_scores_bmm(qg, k):
    """The CUDA form of ``grouped_scores_upcast``: one bf16 ``bmm`` with
    an f32 result over each sequence's (S, Hkv * hd) keys, read in place.
    The query is laid block-diagonally over the KV heads, so every score
    is the same f32 sum of exact products plus exact zeros; no f32 copy
    of the cache is made."""
    B, Hkv, G, _ = qg.shape
    S = k.shape[1]
    s = bmm_out_f32(_block_diagonal(qg), k.reshape(B, S, -1).transpose(1, 2))
    return s.view(B, Hkv, G, S)


def grouped_mix_bmm(p, v):
    """The CUDA form of ``grouped_mix_upcast``: one bf16 ``bmm`` of the
    probabilities over every head's values with an f32 result, whose
    diagonal head blocks are kept."""
    B, Hkv, G, S = p.shape
    hd = v.shape[-1]
    r = bmm_out_f32(p.reshape(B, Hkv * G, S), v.reshape(B, S, Hkv * hd))
    return torch.diagonal(r.view(B, Hkv, G, Hkv, hd), dim1=1,
                          dim2=3).permute(0, 3, 1, 2)


def grouped_scores(qg, k):
    return grouped_scores_bmm(qg, k) if qg.is_cuda \
        else grouped_scores_upcast(qg, k)


def grouped_mix(p, v):
    return grouped_mix_bmm(p, v) if p.is_cuda else grouped_mix_upcast(p, v)


# ---------------------------------------------------------------------------
# Blockwise attention (training / prefill)
# ---------------------------------------------------------------------------


def _mask(q_pos, kv_pos, kind, prefix_len):
    if kind == "full":
        return torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    m = q_pos[:, None] >= kv_pos[None, :]
    if kind == "prefix":   # bidirectional over the leading prefix tokens
        m = m | (kv_pos[None, :] < prefix_len)
    return m


def _pick(S, target):
    """largest divisor of S that is <= target."""
    for b in range(min(target, S), 0, -1):
        if S % b == 0:
            return b
    return S


def _q_chunk(qc, kg, vg, q_pos, kind, prefix_len, scale):
    """One query chunk's online softmax over every KV chunk: qc (B, bq,
    Hkv, G, hd), kg/vg (B, nk, bk, Hkv, hd) -> (B, Hkv, G, bq, hd) f32."""
    B, block_q, Hkv, G, hd = qc.shape
    nk, block_kv = kg.shape[1], kg.shape[2]
    dev = qc.device
    m_run = torch.full((B, Hkv, G, block_q), -torch.inf, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Hkv, G, block_q), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, block_q, hd), dtype=torch.float32,
                      device=dev)
    for ik in range(nk):
        kc, vc = kg[:, ik], vg[:, ik]                    # (B, bk, Hkv, hd)
        s = _einsum_f32("bqhgd,bkhd->bhgqk", qc, kc) * scale
        kv_pos = ik * block_kv + torch.arange(block_kv, device=dev)
        msk = _mask(q_pos, kv_pos, kind, prefix_len)
        s = torch.where(msk, s, -torch.inf)
        m_new = torch.maximum(m_run, s.amax(-1))
        # guard fully-masked rows (m_new = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(msk, p, 0.0)
        corr = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_safe),
                           0.0)
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + _einsum_f32(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc)
        m_run = m_new
    return acc / torch.clamp(l_run[..., None], min=1e-20)


def blockwise_attention(q, k, v, *, kind="causal", prefix_len=0, q_offset=0,
                        block_q=512, block_kv=1024, scale=None):
    """q (B, Sq, H, hd); k/v (B, Skv, Hkv, hd).  Online-softmax over KV
    chunks; memory is O(block_q * block_kv) per (batch, head).  When
    autograd records outside a ``remat_region``, each query chunk is
    checkpointed, as the reference's ``jax.checkpoint`` of it: the
    backward recomputes its KV walk instead of keeping every (bq x bk)
    tile of the sequence."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    block_q = _pick(Sq, block_q)
    block_kv = _pick(Skv, block_kv)
    nq, nk = Sq // block_q, Skv // block_kv
    recorded = torch.is_grad_enabled() and not _REMAT_DEPTH[0] and (
        q.requires_grad or k.requires_grad or v.requires_grad)

    qg = q.reshape(B, nq, block_q, Hkv, G, hd)
    kg = k.reshape(B, nk, block_kv, Hkv, hd)
    vg = v.reshape(B, nk, block_kv, Hkv, hd)
    outs = []
    for iq in range(nq):
        q_pos = q_offset + iq * block_q + torch.arange(block_q,
                                                       device=q.device)
        args = (qg[:, iq], kg, vg, q_pos, kind, prefix_len, scale)
        outs.append(checkpoint(_q_chunk, *args, use_reentrant=False)
                    if recorded else _q_chunk(*args))
    out = torch.cat(outs, 3)                              # (B, Hkv, G, Sq, hd)
    return out.reshape(B, H, Sq, hd).transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *, scale=None):
    """Single-step decode: q (B, 1, H, hd); caches (B, Smax, Hkv, hd);
    cur_len (B,) or scalar valid lengths (the new token is at cur_len-1).
    Attends over all Smax positions, -inf beyond cur_len."""
    B, _, H, hd = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd)
    s = grouped_scores(qg, k_cache) * scale
    n = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1).expand(B, 1)
    valid = torch.arange(Smax, device=q.device)[None, :] < n
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = grouped_mix(p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_sharded(q, k_cache, v_cache, cur_len, seq, *,
                             scale=None):
    """``decode_attention`` over a cache that holds a range of the
    positions, global ``seq.start`` on (``seq`` a
    ``placement.SeqShard``): this rank's scores, valid below ``cur_len``,
    go through ``seq.softmax_mix``, which merges every rank's softmax and
    weighted values."""
    B, _, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    s = grouped_scores(q.reshape(B, Hkv, G, hd), k_cache) * scale
    n = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1).expand(B, 1)
    valid = (seq.start + torch.arange(S, device=q.device))[None, :] < n
    out = seq.softmax_mix(s, valid[:, None, None, :],
                          lambda p: grouped_mix(p.to(v_cache.dtype), v_cache))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def write_index(idx, rows_held: int, drop: bool, seq):
    """(the local row each slot writes, and None or a (B,) mask of the
    slots that really write there) for global positions ``idx``: past
    the cache a slot writes nothing with ``drop``; on a sequence shard
    only the rank whose range holds ``idx`` writes it."""
    if seq is None:
        if not drop:
            return idx, None
        return idx.clamp(max=rows_held - 1), idx < rows_held
    local = idx - seq.start
    keep = (local >= 0) & (local < rows_held)
    if drop:
        keep = keep & (idx < seq.smax)
    return local.clamp(0, rows_held - 1), keep


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _weight(w):
    return torch.nn.Parameter(w, requires_grad=False)


class MLP(torch.nn.Module):
    """``wg``, ``wu``, ``wd`` (gated: swiglu, geglu) or ``w1``, ``w2``
    (gelu), each (d_in, d_out) bf16 as the reference lays them out."""

    def __init__(self, cfg, gen=None, d_ff=None, *, device=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.act in ("swiglu", "geglu"):
            self.wg = _weight(dense_init(gen, d, f, device=device))
            self.wu = _weight(dense_init(gen, d, f, device=device))
            self.wd = _weight(dense_init(gen, f, d, device=device))
        else:
            self.w1 = _weight(dense_init(gen, d, f, device=device))
            self.w2 = _weight(dense_init(gen, f, d, device=device))


def silu(x):
    """``x * (1 / (1 + exp(-x)))`` op by op in x's dtype, as the
    reference's ``jax.nn.silu`` is written: in bf16 each of the four ops
    rounds, where ``F.silu`` rounds once, and the two differ in about 40 %
    of bf16 elements.  Those one-ulp gaps flip near-tied MoE routing
    between the two packages; op by op the port's bf16 SwiGLU equals the
    reference's on the CPU."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(params, cfg, x):
    xc = x.to(CDTYPE)
    if cfg.act in ("swiglu", "geglu"):
        act = silu if cfg.act == "swiglu" else _gelu
        h = act(xc @ params.wg) * (xc @ params.wu)
        return (h @ params.wd).to(x.dtype)
    h = _gelu(xc @ params.w1)
    return (h @ params.w2).to(x.dtype)

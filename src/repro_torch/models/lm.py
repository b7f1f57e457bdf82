"""Model assembly: every LM family of the reference behind one ``ModelApi``.

Counterpart of the reference package's ``models/lm.py``:
  dense  — qwen3-32b/4b, olmo-1b, starcoder2-7b
  vlm    — paligemma (stubbed patch-embedding prefix, prefix-LM mask)
  encdec — seamless-m4t (stubbed audio-frame encoder input)
  ssm    — mamba2-130m
  moe    — deepseek-v2/v3 (MLA attention + shared/routed experts; V3's
           MTP head runs in the loss only, as the reference's)
  hybrid — jamba (1 attn : 7 mamba interleave, MoE every other layer)
``ModelApi.loss(params, batch) -> (loss, metrics)`` is each family's
training loss with the reference's metrics: next-token cross entropy
over the padded vocabulary in sequence chunks (``chunked_ce``, whose
backward recomputes each chunk's logits, so no (B, S, V) tensor is
kept), plus the MoE load-balance aux and V3's MTP term.  With
``remat="block"`` (the default, the reference's) each layer, or each
hybrid group, is checkpointed (``torch.utils.checkpoint``): the backward
recomputes it from its input.

The parameters are an ``nn.Module`` tree (``DenseLM``, ``EncDecLM``,
``SSMLM``, ``MoELM``, ``HybridLM``: the embedding, ``ModuleList``s of
blocks, the final norm and an optional ``lm_head``), passed as ``params``
to the same call shapes as the reference's: ``decode_step(params, cache,
token, cur_len)``.  Serving holds every matmul weight and the embedding
once in bf16, the norm gains (and the Mamba-2 mixer's conv, decay and
skip parameters, and the MoE router) in f32: the reference keeps f32
weights and casts them to bf16 at each use, which gives the same numbers.
Training (``repro_torch.train``) holds f32 masters and runs the loss on a
copy of the module whose every parameter is their bf16 cast, as the
reference's train step casts every f32 leaf.  Layers run
in a Python loop, eagerly; the KV cache is one preallocated (L, B, Smax,
Hkv, hd) bf16 tensor pair (MLA: the latent ``c_kv`` and ``k_rope``), and
the SSM state an (L, ...) pair, all written in place.

On a ``DeviceMesh`` (``build_model(cfg, mesh=mesh)``, one process a
rank) every parameter is a ``DTensor`` in its ``configs.sharding``
placement and each block computes on its weights gathered just before
use (``models.placement``).  A call takes the global batch on every
rank; a rank computes its DP share of the rows (all of them when the DP
ranks do not divide the batch), ranks along ``"model"`` the same rows.
``loss`` is the global batch's (the local sums and the mask counts
summed over the DP ranks); ``prefill`` and ``decode_step`` return the
logits and the caches as ``DTensor``s of the global batch, placed by
``cache_specs``: the batch over DP, or, for a batch the DP ranks do not
divide, the sequence axis over DP (long-context decode: each rank holds
a range of positions, writes a slot's K/V when its range holds the
position, attends over its range, and the ranks' softmax terms are
merged, ``placement.SeqShard``); MoE layers take
``models.moe``'s expert-parallel branch.

``decode_step`` refuses a ``cur_len`` outside [1, Smax] by default.  The
serving engine feeds a prompt of Smax tokens or more through it, as the
reference's does, and passes ``past_cache="drop"``: the step then
computes what the reference computes there (RoPE at the true position,
the K/V write dropped, attention over all Smax positions).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.api.backends import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.sharding import param_specs
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import placement as P
from repro_torch.models.layers import CDTYPE, _weight, make_constrainer


@dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable                    # (generator) -> params
    loss: Callable                    # (params, batch) -> (loss, metrics)
    prefill: Callable                 # (params, batch) -> (logits, cache)
    decode_step: Callable             # (params, cache, token, cur_len, *,
                                      #  past_cache) -> (logits, cache)
    init_cache: Callable              # (batch, max_len) -> cache
    mesh: object = None               # the DeviceMesh the model is placed on
    dp_axes: tuple = ("data",)        # its data-parallel dims


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _on(x, device) -> torch.Tensor:
    """A tensor, numpy array or sequence as a tensor on ``device``."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           device=device)


def _embed_init(gen, cfg, *, device=None):
    """``N(0, 1) * 0.02`` over ``vocab_padded`` rows, held in bf16 (f32 in
    ``layers.master_init``)."""
    shape = (cfg.vocab_padded, cfg.d_model)
    if gen is None:
        return torch.empty(shape, dtype=L.weight_dtype(), device=device)
    e = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (e * 0.02).to(L.weight_dtype())


def _head_weight(params, cfg):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _head(params, cfg, h):
    return (h.to(CDTYPE) @ _head_weight(params, cfg)).to(torch.float32)


def _masked_logits(hs, w, vocab):
    """The head's f32 logits of hs (B, c, D) (a bf16 product, as
    ``_head``), the padded vocabulary's columns at -1e30."""
    logits = (hs.to(CDTYPE) @ w).to(torch.float32)
    pad = torch.arange(w.shape[1], device=hs.device) >= vocab
    return logits.masked_fill_(pad, -1e30)


class _ChunkedCE(torch.autograd.Function):
    """Sum over chunks of c positions of (logsumexp - gold logit) * mask,
    over the sum of the mask (at least 1).  The forward keeps each
    position's logsumexp, not its logits; the backward recomputes a
    chunk's logits, forms (softmax - one_hot) * mask * g / denominator,
    rounds it to the head's dtype (the cotangent of the bf16 product's
    cast to f32) and multiplies it into both operands, one chunk at a
    time: the head's gradient is summed in f32 and rounded once."""

    @staticmethod
    def forward(ctx, h, w, targets, mask, vocab, chunk, count):
        B, S, _ = h.shape
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for c0 in range(0, S, chunk):
            logits = _masked_logits(h[:, c0:c0 + chunk], w, vocab)
            lse = torch.logsumexp(logits, -1)
            gold = logits.gather(-1, targets[:, c0:c0 + chunk, None])[..., 0]
            tot = tot + ((lse - gold) * mask[:, c0:c0 + chunk]).sum()
            lses.append(lse)
        denom = torch.clamp(mask.sum() if count is None else count, min=1.0)
        ctx.save_for_backward(h, w, targets, mask, torch.cat(lses, 1), denom)
        ctx.vocab, ctx.chunk = vocab, chunk
        return tot / denom

    @staticmethod
    def backward(ctx, g):
        h, w, targets, mask, lse, denom = ctx.saved_tensors
        S, chunk = h.shape[1], ctx.chunk
        scale = g / denom
        dh = [] if ctx.needs_input_grad[0] else None
        dw = (torch.zeros(w.shape, dtype=torch.float32, device=w.device)
              if ctx.needs_input_grad[1] else None)
        for c0 in range(0, S, chunk):
            hs = h[:, c0:c0 + chunk]
            p = _masked_logits(hs, w, ctx.vocab)
            p.sub_(lse[:, c0:c0 + chunk, None]).exp_()
            p.scatter_add_(-1, targets[:, c0:c0 + chunk, None],
                           torch.full(p.shape[:2] + (1,), -1.0,
                                      device=p.device))
            p.mul_((mask[:, c0:c0 + chunk] * scale)[..., None])
            dl = p.to(w.dtype)
            if dh is not None:
                dh.append((dl @ w.T).to(h.dtype))
            if dw is not None:
                dw += (hs.to(CDTYPE).reshape(-1, hs.shape[-1]).T
                       @ dl.reshape(-1, dl.shape[-1])).to(torch.float32)
        return (None if dh is None else torch.cat(dh, 1),
                None if dw is None else dw.to(w.dtype),
                None, None, None, None, None)


def chunked_ce(params, cfg, h, targets, mask, *, chunk=512, count=None):
    """Cross entropy over the padded vocabulary without materializing the
    (B, S, Vp) logits, the reference's ``chunked_ce``: h (B, S, D),
    targets (B, S) ints, mask (B, S) f32; the padded vocabulary's logits
    at -1e30; the masked sum over ``max(mask.sum(), 1)``.  S must be a
    multiple of ``min(chunk, S)``.  Neither pass keeps more than one
    chunk's (B, chunk, Vp) logits (``_ChunkedCE``).  ``count``, if given,
    replaces the mask's sum (a mesh's count over every rank's rows)."""
    S = h.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"the sequence ({S}) is not a multiple of the CE "
                         f"chunk ({chunk})")
    return _ChunkedCE.apply(h, _head_weight(params, cfg), targets.long(),
                            mask.to(torch.float32), cfg.vocab, chunk, count)


def _shifted(tok, n):
    """The targets n positions ahead, zero-padded at the end, and their
    mask (ones, zeros over the padding): the reference's ``jnp.pad``."""
    tgt = F.pad(tok[:, n:], (0, n))
    mask = F.pad(torch.ones(tok[:, n:].shape, dtype=torch.float32,
                            device=tok.device), (0, n))
    return tgt, mask


def _remat(fn, remat):
    """``fn`` checkpointed when autograd records (``remat="block"``): its
    backward recomputes it from its inputs, once (``L.remat_region``);
    ``"none"`` keeps it as is."""
    if remat == "none":
        return fn

    def region(*args):
        with L.remat_region():
            return fn(*args)

    def run(*args):
        if torch.is_grad_enabled():
            return checkpoint(region, *args, use_reentrant=False)
        return fn(*args)
    return run


def _step_lengths(cur_len, smax, past_cache, device):
    """A decode step's ``cur_len`` (a scalar or (B,)) as a long tensor on
    ``device``, and whether the step must guard its K/V write.  Host
    lengths are checked: at least 1, and with ``past_cache="refuse"`` at
    most ``smax``.  ``"drop"`` lets a length run past the cache; the
    guard (the write dropped there) runs only when a host length does,
    or when the lengths are a tensor and cannot be read without a sync,
    so a step inside the cache is the plain in-place write."""
    if past_cache not in ("refuse", "drop"):
        raise ValueError(f"past_cache must be 'refuse' or 'drop', not "
                         f"{past_cache!r}")
    drop = past_cache == "drop"
    if not torch.is_tensor(cur_len):
        n = np.asarray(cur_len)
        top = np.inf if drop else smax
        if n.size and (n.min() < 1 or n.max() > top):
            raise ValueError(f"cur_len must lie in [1, {top}]: {n}")
        drop = drop and bool(n.size) and int(n.max()) > smax
    return _on(cur_len, device).long(), drop


def _final_norm(params, cfg, h):
    return (L.rms_norm(h, params.final_norm) if not cfg.nonparam_ln
            else L.nonparam_layer_norm(h))


# ---------------------------------------------------------------------------
# a mesh: placed parameters, a call's rows
# ---------------------------------------------------------------------------


def _gatherer(mesh):
    """``placement.gathered`` on a mesh; a context that does nothing
    without one."""
    if mesh is None:
        return lambda module, recurse=True: contextlib.nullcontext(module)
    return P.gathered


def _placed(model, mesh, dp_axes):
    """``model`` with every parameter placed by ``param_specs`` on
    ``mesh`` (the DP dims as FSDP's), or as it is without a mesh."""
    if mesh is None:
        return model
    return P.place_module(model, mesh, param_specs(model, mesh,
                                                   fsdp=tuple(dp_axes)))


def _rows(mesh, dp_axes, batch):
    """A call's ``placement.Rows`` over ``batch`` rows (a count, or an
    array of the rows), None without a mesh."""
    if mesh is None:
        return None
    return P.Rows(mesh, dp_axes, batch if isinstance(batch, int)
                  else len(batch))


def _take(rows, x, device):
    """This rank's rows of ``x`` (the global batch's) on ``device``."""
    x = _on(x, device)
    return x if rows is None else rows.take(x)


def _lens(rows, cur_len):
    """This rank's entries of a decode step's ``cur_len`` (a scalar, or
    one a row), left on the host if it is there."""
    return cur_len if rows is None else rows.take(cur_len)


def _local_batch(rows, batch: int) -> int:
    return batch if rows is None or not rows.split else batch // rows.dp


def _out(rows, x):
    return x if rows is None else rows.out(x)


def _place_cache(rows, cache, **kw):
    return cache if rows is None else rows.cache(cache, **kw)


def _zeros(rows, shape, device, **kw):
    """A zero bf16 cache leaf of the global ``shape``: on a mesh this
    rank's part, placed by ``cache_specs``."""
    if rows is None:
        return torch.zeros(shape, dtype=CDTYPE, device=device)
    return rows.zeros(shape, CDTYPE, device, **kw)


def _local(mesh, cache):
    return cache if mesh is None else P.local_tree(cache)


def _moe_kw(rows) -> dict:
    if rows is None:
        return {}
    return dict(mesh=rows.mesh, dp_axes=rows.dp_axes, global_batch=rows.batch)


def _ce(params, cfg, h, targets, mask, rows):
    """``chunked_ce`` of this rank's rows as its term of the global
    batch's mean: the masked sum over the mask counted on every rank,
    summed over the DP ranks."""
    if rows is None:
        return chunked_ce(params, cfg, h, targets, mask)
    count = rows.count(mask.sum())
    return rows.total(chunked_ce(params, cfg, h, targets, mask, count=count))


# ---------------------------------------------------------------------------
# the dense block
# ---------------------------------------------------------------------------


class DenseBlock(torch.nn.Module):
    """``attn``, ``mlp``, and the gains ``n1``, ``n2`` (None for the
    non-parametric norm)."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        init_n, _ = L.make_norm(cfg)
        self.attn = A.Attention(cfg, gen, device=device)
        self.mlp = L.MLP(cfg, gen, device=device)
        for name in ("n1", "n2"):
            g = init_n(cfg.d_model, device)
            self.register_parameter(name, None if g is None else _weight(g))


def _dense_block(p, cfg, h, *, kind="causal", prefix_len=0):
    _, apply_n = L.make_norm(cfg)
    h = h + A.attention_forward(p.attn, cfg, apply_n(p.n1, h),
                                kind=kind, prefix_len=prefix_len)
    h = h + L.mlp(p.mlp, cfg, apply_n(p.n2, h))
    return h


def _dense_block_decode(p, cfg, h, cache, cur_len, *, drop=False, seq=None):
    _, apply_n = L.make_norm(cfg)
    a, cache = A.attention_decode(p.attn, cfg, apply_n(p.n1, h),
                                  cache, cur_len, drop=drop, seq=seq)
    h = h + a
    h = h + L.mlp(p.mlp, cfg, apply_n(p.n2, h))
    return h, cache


class DenseLM(torch.nn.Module):
    """The dense (and VLM) decoder's parameters: ``embed`` (vocab_padded,
    d) bf16, ``layers``, ``final_norm`` (d,) f32 and, untied, ``lm_head``
    (d, vocab_padded) bf16.  ``gen=None`` allocates them uninitialised."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            DenseBlock(cfg, gen, device=device) for _ in range(cfg.n_layers))
        self.embed = _weight(_embed_init(gen, cfg, device=device))
        self.final_norm = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                             device=device))
        if not cfg.tie_embeddings:
            self.lm_head = _weight(L.dense_init(
                gen, cfg.d_model, cfg.vocab_padded, device=device))


# ---------------------------------------------------------------------------
# family: dense decoder (also vlm via prefix mask)
# ---------------------------------------------------------------------------


def build_dense(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                remat: str = "block", *, device=None) -> ModelApi:
    prefix = cfg.prefix_len
    kind = "prefix" if prefix else "causal"
    _c = make_constrainer(mesh, dp_axes)
    G = _gatherer(mesh)
    dev = resolve_device(device, mesh)

    def _block(lp, h):
        with G(lp):
            return _c(_dense_block(lp, cfg, h, kind=kind, prefix_len=prefix))

    block = _remat(_block, remat)

    def init(generator):
        """Random parameters drawn on ``generator`` (a ``torch.Generator``
        on the model's device), one tensor at a time."""
        return _placed(DenseLM(cfg, generator, device=dev), mesh, dp_axes)

    def _inputs_to_h(params, batch, rows):
        h = params.embed[_take(rows, batch["tokens"], dev).long()]
        if prefix and "patches" in batch:
            h = torch.cat([_take(rows, batch["patches"], dev).to(h.dtype),
                           h], 1)
        return _c(h)

    def loss(params, batch):
        """Next-token CE over ``batch["tokens"]`` (the VLM's prefix
        positions dropped first): ``(ce, {"ce": ce})``."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        with G(params, recurse=False):
            h = _inputs_to_h(params, batch, rows)
            for lp in params.layers:
                h = block(lp, h)
            h = _final_norm(params, cfg, h)
            tgt, mask = _shifted(_take(rows, batch["tokens"], dev).long(), 1)
            if prefix and "patches" in batch:
                h = h[:, prefix:]
            ce = _ce(params, cfg, h, tgt, mask, rows)
        return ce, {"ce": ce}

    def prefill(params, batch):
        """The full forward pass over ``batch["tokens"]`` (B, S) (after
        ``batch["patches"]`` (B, prefix_len, d) for the VLM): the last
        position's logits and the cache of all S positions."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        _, apply_n = L.make_norm(cfg)
        ks, vs = [], []
        with G(params, recurse=False):
            h = _inputs_to_h(params, batch, rows)
            S = h.shape[1]
            for lp in params.layers:
                with G(lp):
                    a, (k, v) = A.attention_forward(
                        lp.attn, cfg, apply_n(lp.n1, h),
                        kind=kind, prefix_len=prefix, return_kv=True)
                    h = h + a
                    h = _c(h + L.mlp(lp.mlp, cfg, apply_n(lp.n2, h)))
                ks.append(k)
                vs.append(v)
            h = _final_norm(params, cfg, h)
            logits = _head(params, cfg, h[:, -1:])[:, 0]
        return _out(rows, logits), _place_cache(
            rows, {"k": torch.stack(ks), "v": torch.stack(vs), "len": S})

    def init_cache(batch, max_len):
        rows = _rows(mesh, dp_axes, batch)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": _zeros(rows, shape, dev), "v": _zeros(rows, shape, dev)}

    def decode_step(params, cache, token, cur_len, *, past_cache="refuse"):
        """One token a slot: ``token`` (B,), ``cur_len`` a scalar or (B,)
        of lengths including it (the token goes to ``cur_len - 1``).
        Writes ``cache`` in place and returns it with the (B, Vp) f32
        logits.  ``past_cache="drop"`` serves a length past the cache as
        the reference does (module docstring)."""
        rows = _rows(mesh, dp_axes, token)
        c, seq = _local(mesh, cache), P.seq_shard(cache["k"])
        cl, drop = _step_lengths(_lens(rows, cur_len), cache["k"].shape[2],
                                 past_cache, dev)
        with G(params, recurse=False):
            h = params.embed[_take(rows, token, dev).long()][:, None, :]
            for i, lp in enumerate(params.layers):
                with G(lp):
                    h, _ = _dense_block_decode(
                        lp, cfg, h, {"k": c["k"][i], "v": c["v"][i]}, cl,
                        drop=drop, seq=seq)
                h = _c(h)
            h = _final_norm(params, cfg, h)
            logits = _head(params, cfg, h)[:, 0]
        return _out(rows, logits), cache

    return ModelApi(cfg, init, loss, prefill, decode_step, init_cache, mesh,
                    tuple(dp_axes))


# ---------------------------------------------------------------------------
# family: ssm (mamba2)
# ---------------------------------------------------------------------------


class MambaBlock(torch.nn.Module):
    """``mixer`` (``Mamba2Mixer``) and the gain ``n1`` (d,) f32."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.mixer = M.Mamba2Mixer(cfg, gen, device=device)
        self.n1 = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                     device=device))


class SSMLM(torch.nn.Module):
    """The state-space LM's parameters: ``embed`` (vocab_padded, d) bf16,
    tied to the head as in the reference's, ``layers`` and ``final_norm``
    (d,) f32."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            MambaBlock(cfg, gen, device=device) for _ in range(cfg.n_layers))
        self.embed = _weight(_embed_init(gen, cfg, device=device))
        self.final_norm = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                             device=device))


def build_ssm(cfg: ArchConfig, mesh=None, dp_axes=("data",),
              remat: str = "block", *, device=None) -> ModelApi:
    _c = make_constrainer(mesh, dp_axes)
    G = _gatherer(mesh)
    dev = resolve_device(device, mesh)

    def _block(lp, h):
        with G(lp):
            return _c(h + M.mamba_forward(lp.mixer, cfg, L.rms_norm(h, lp.n1)))

    block = _remat(_block, remat)

    def init(generator):
        return _placed(SSMLM(cfg, generator, device=dev), mesh, dp_axes)

    def loss(params, batch):
        """Next-token CE over ``batch["tokens"]``: ``(ce, {"ce": ce})``."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        tok = _take(rows, batch["tokens"], dev).long()
        with G(params, recurse=False):
            h = _c(params.embed[tok])
            for lp in params.layers:
                h = block(lp, h)
            h = L.rms_norm(h, params.final_norm)
            ce = _ce(params, cfg, h, *_shifted(tok, 1), rows)
        return ce, {"ce": ce}

    def prefill(params, batch):
        """The full forward pass over ``batch["tokens"]`` (B, S): the last
        position's logits and each layer's final (h, conv) state, stacked
        over the layers ((L, B, H, P, N) f32, (L, B, d_conv - 1, C) bf16)."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        hs, convs = [], []
        with G(params, recurse=False):
            h = _c(params.embed[_take(rows, batch["tokens"], dev).long()])
            for lp in params.layers:
                with G(lp):
                    y, (st_h, st_c) = M.mamba_forward(
                        lp.mixer, cfg, L.rms_norm(h, lp.n1),
                        return_state=True)
                h = _c(h + y)
                hs.append(st_h)
                convs.append(st_c)
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h[:, -1:])[:, 0]
        return _out(rows, logits), _place_cache(
            rows, (torch.stack(hs), torch.stack(convs)), seq_axis=None)

    def init_cache(batch, max_len):
        """Zero states: h f32 and conv bf16, over the layers; ``max_len``
        does not size them (a state holds no positions)."""
        rows = _rows(mesh, dp_axes, batch)
        h0, c0 = M.init_mamba_state(cfg, _local_batch(rows, batch), CDTYPE,
                                    device=dev)
        return _place_cache(rows, (
            h0.expand((cfg.n_layers,) + h0.shape).clone(),
            c0.expand((cfg.n_layers,) + c0.shape).clone()), seq_axis=None)

    def decode_step(params, cache, token, cur_len, *, past_cache="refuse"):
        """One token a slot: updates the (h, conv) state in place and
        returns it with the (B, Vp) f32 logits.  ``cur_len`` and
        ``past_cache`` are ignored, as the reference ignores ``cur_len``:
        a slot's state runs on from whatever it held (ROADMAP C10)."""
        rows = _rows(mesh, dp_axes, token)
        hs, convs = _local(mesh, cache)
        with G(params, recurse=False):
            h = params.embed[_take(rows, token, dev).long()][:, None, :]
            for i, lp in enumerate(params.layers):
                with G(lp):
                    y, (st_h, st_c) = M.mamba_decode(
                        lp.mixer, cfg, L.rms_norm(h, lp.n1),
                        (hs[i], convs[i]))
                h = _c(h + y)
                hs[i].copy_(st_h)
                convs[i].copy_(st_c)
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h)[:, 0]
        return _out(rows, logits), cache

    return ModelApi(cfg, init, loss, prefill, decode_step, init_cache, mesh,
                    tuple(dp_axes))


# ---------------------------------------------------------------------------
# family: encdec (seamless)
# ---------------------------------------------------------------------------


class DecBlock(torch.nn.Module):
    """``attn``, ``xattn`` (cross attention), ``mlp`` and the gains
    ``n1``, ``nx``, ``n2``."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        init_n, _ = L.make_norm(cfg)
        self.attn = A.Attention(cfg, gen, device=device)
        self.xattn = A.Attention(cfg, gen, device=device)
        self.mlp = L.MLP(cfg, gen, device=device)
        for name in ("n1", "nx", "n2"):
            g = init_n(cfg.d_model, device)
            self.register_parameter(name, None if g is None else _weight(g))


class EncDecLM(torch.nn.Module):
    """The encoder-decoder's parameters: ``embed`` (vocab_padded, d)
    bf16, ``enc`` (dense blocks), ``dec`` (``DecBlock``s), ``enc_norm`` and
    ``final_norm`` (d,) f32 and ``lm_head`` (d, vocab_padded) bf16, which
    the reference always gives this family."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.enc = torch.nn.ModuleList(
            DenseBlock(cfg, gen, device=device)
            for _ in range(cfg.enc_layers))
        self.dec = torch.nn.ModuleList(
            DecBlock(cfg, gen, device=device) for _ in range(cfg.n_layers))
        self.embed = _weight(_embed_init(gen, cfg, device=device))
        ones = dict(dtype=torch.float32, device=device)
        self.enc_norm = _weight(torch.ones(cfg.d_model, **ones))
        self.final_norm = _weight(torch.ones(cfg.d_model, **ones))
        self.lm_head = _weight(L.dense_init(gen, cfg.d_model,
                                            cfg.vocab_padded, device=device))


def build_encdec(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                 remat: str = "block", *, device=None) -> ModelApi:
    _c = make_constrainer(mesh, dp_axes)
    G = _gatherer(mesh)
    dev = resolve_device(device, mesh)

    def _enc_block(lp, h):
        with G(lp):
            return _c(_dense_block(lp, cfg, h, kind="full"))

    def _dec_block(lp, h, mem):
        with G(lp):
            h = h + A.attention_forward(lp.attn, cfg, L.rms_norm(h, lp.n1),
                                        kind="causal")
            h = h + A.attention_forward(lp.xattn, cfg, L.rms_norm(h, lp.nx),
                                        memory=mem)
            return _c(h + L.mlp(lp.mlp, cfg, L.rms_norm(h, lp.n2)))

    enc_block = _remat(_enc_block, remat)
    dec_block = _remat(_dec_block, remat)

    def init(generator):
        return _placed(EncDecLM(cfg, generator, device=dev), mesh, dp_axes)

    def encode(params, src, rows=None):
        """The encoder over ``src`` (B, S_enc, d): bidirectional dense
        blocks, RoPE on q and k, then ``enc_norm`` (its gain gathered by
        the caller on a mesh)."""
        h = _take(rows, src, dev).to(CDTYPE)
        for lp in params.enc:
            h = enc_block(lp, h)
        return L.rms_norm(h, params.enc_norm)

    def loss(params, batch):
        """Encode ``batch["src_embeds"]``, then next-token CE of the
        decoder over ``batch["tokens"]``: ``(ce, {"ce": ce})``."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        tok = _take(rows, batch["tokens"], dev).long()
        with G(params, recurse=False):
            mem = encode(params, batch["src_embeds"], rows)
            h = params.embed[tok]
            for lp in params.dec:
                h = dec_block(lp, h, mem)
            h = L.rms_norm(h, params.final_norm)
            ce = _ce(params, cfg, h, *_shifted(tok, 1), rows)
        return ce, {"ce": ce}

    def prefill(params, batch):
        """Encode ``batch["src_embeds"]`` and run the decoder over
        ``batch["tokens"]``: the last position's logits and the cache,
        ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each (L, B, S, Hkv,
        hd) bf16; the cross K/V are ``xattn``'s over the encoder memory."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        sk, sv, ck, cv = [], [], [], []
        with G(params, recurse=False):
            mem = encode(params, batch["src_embeds"], rows)
            h = params.embed[_take(rows, batch["tokens"], dev).long()]
            for lp in params.dec:
                with G(lp):
                    a, (k, v) = A.attention_forward(
                        lp.attn, cfg, L.rms_norm(h, lp.n1), kind="causal",
                        return_kv=True)
                    h = h + a
                    x, (xk, xv) = A.attention_forward(
                        lp.xattn, cfg, L.rms_norm(h, lp.nx), memory=mem,
                        return_kv=True)
                    h = h + x
                    h = h + L.mlp(lp.mlp, cfg, L.rms_norm(h, lp.n2))
                for acc, t in ((sk, k), (sv, v), (ck, xk), (cv, xv)):
                    acc.append(t)
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h[:, -1:])[:, 0]
        return _out(rows, logits), _place_cache(rows, {
            "self": {"k": torch.stack(sk), "v": torch.stack(sv)},
            "cross": {"k": torch.stack(ck), "v": torch.stack(cv)}})

    def init_cache(batch, max_len, enc_len=1024):
        """Zero self K/V over ``max_len`` positions and zero cross K/V
        over ``enc_len``: the engine never runs the encoder, so its
        decode reads ``enc_len`` zero cross positions, as the
        reference's does."""
        rows = _rows(mesh, dp_axes, batch)

        def zeros(n):
            return _zeros(rows, (cfg.n_layers, batch, n, cfg.n_kv_heads,
                                 cfg.hd), dev)
        return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
                "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}

    def decode_step(params, cache, token, cur_len, *, past_cache="refuse"):
        """One token a slot, as the dense ``decode_step``: the self cache
        written in place, the cross cache read whole."""
        rows = _rows(mesh, dp_axes, token)
        c = _local(mesh, cache)
        sc, xc = c["self"], c["cross"]
        seq = P.seq_shard(cache["self"]["k"])
        xseq = P.seq_shard(cache["cross"]["k"])
        cl, drop = _step_lengths(_lens(rows, cur_len),
                                 cache["self"]["k"].shape[2], past_cache, dev)
        with G(params, recurse=False):
            h = params.embed[_take(rows, token, dev).long()][:, None, :]
            for i, lp in enumerate(params.dec):
                with G(lp):
                    a, _ = A.attention_decode(
                        lp.attn, cfg, L.rms_norm(h, lp.n1),
                        {"k": sc["k"][i], "v": sc["v"][i]}, cl,
                        drop=drop, seq=seq)
                    h = h + a
                    x, _ = A.attention_decode(
                        lp.xattn, cfg, L.rms_norm(h, lp.nx),
                        {"k": xc["k"][i], "v": xc["v"][i]}, cl, cross=True,
                        seq=xseq)
                    h = h + x
                    h = h + L.mlp(lp.mlp, cfg, L.rms_norm(h, lp.n2))
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h)[:, 0]
        return _out(rows, logits), cache

    return ModelApi(cfg, init, loss, prefill, decode_step, init_cache, mesh,
                    tuple(dp_axes))

# ---------------------------------------------------------------------------
# family: deepseek MoE (MLA + experts + optional MTP)
# ---------------------------------------------------------------------------


class MLABlock(torch.nn.Module):
    """``attn`` (``MLA``), the gains ``n1``, ``n2`` (d,) f32, and ``moe``
    (``MoE``) or ``mlp``."""

    def __init__(self, cfg, gen=None, *, use_moe, device=None):
        super().__init__()
        self.attn = MLA.MLA(cfg, gen, device=device)
        ones = dict(dtype=torch.float32, device=device)
        self.n1 = _weight(torch.ones(cfg.d_model, **ones))
        self.n2 = _weight(torch.ones(cfg.d_model, **ones))
        if use_moe:
            self.moe = MOE.MoE(cfg, gen, device=device)
        else:
            self.mlp = L.MLP(cfg, gen, device=device)


def _mla_ffn(p, cfg, h, rows=None):
    """The block's feed-forward on ``n2``'s norm of h: (out, aux)."""
    hn = L.rms_norm(h, p.n2)
    if hasattr(p, "moe"):
        return MOE.moe_forward(p.moe, cfg, hn, **_moe_kw(rows))
    return L.mlp(p.mlp, cfg, hn), 0.0


def _mla_block(p, cfg, h, rows=None):
    a, kv = MLA.mla_forward(p.attn, cfg, L.rms_norm(h, p.n1))
    h = h + a
    f, aux = _mla_ffn(p, cfg, h, rows)
    return h + f, aux, kv


def _mla_block_decode(p, cfg, h, cache, cur_len, *, drop=False, rows=None,
                      seq=None):
    a, _ = MLA.mla_decode(p.attn, cfg, L.rms_norm(h, p.n1), cache, cur_len,
                          drop=drop, seq=seq)
    h = h + a
    f, _ = _mla_ffn(p, cfg, h, rows)
    return h + f


class MTPHead(torch.nn.Module):
    """DeepSeek-V3's multi-token prediction head: ``proj`` (2 d, d) bf16,
    a dense ``MLABlock`` and the gain ``norm``.  Only the loss runs it,
    as the reference's does."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.proj = _weight(L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                         device=device))
        self.block = MLABlock(cfg, gen, use_moe=False, device=device)
        self.norm = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                       device=device))


class MoELM(torch.nn.Module):
    """The DeepSeek LM's parameters: ``embed`` (vocab_padded, d) bf16,
    ``dense_layers`` (``first_dense`` MLA blocks with a dense MLP),
    ``moe_layers`` (the rest, with ``MoE``), ``final_norm`` (d,) f32,
    ``lm_head`` (d, vocab_padded) bf16, which the reference always gives
    this family, and with ``cfg.mtp`` the ``mtp`` head."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        nd = cfg.moe.first_dense
        self.dense_layers = torch.nn.ModuleList(
            MLABlock(cfg, gen, use_moe=False, device=device)
            for _ in range(nd))
        self.moe_layers = torch.nn.ModuleList(
            MLABlock(cfg, gen, use_moe=True, device=device)
            for _ in range(cfg.n_layers - nd))
        self.embed = _weight(_embed_init(gen, cfg, device=device))
        self.final_norm = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                             device=device))
        self.lm_head = _weight(L.dense_init(gen, cfg.d_model,
                                            cfg.vocab_padded, device=device))
        if cfg.mtp:
            self.mtp = MTPHead(cfg, gen, device=device)


def build_moe(cfg: ArchConfig, mesh=None, dp_axes=("data",),
              remat: str = "block", *, device=None) -> ModelApi:
    nd = cfg.moe.first_dense
    nm = cfg.n_layers - nd
    _c = make_constrainer(mesh, dp_axes)
    G = _gatherer(mesh)
    dev = resolve_device(device, mesh)

    def _block(lp, h, rows):
        with G(lp):
            return _mla_block(lp, cfg, h, rows)[:2]

    block = _remat(_block, remat)

    def init(generator):
        return _placed(MoELM(cfg, generator, device=dev), mesh, dp_axes)

    def loss(params, batch):
        """Next-token CE plus the layers' load-balance aux and, with
        ``cfg.mtp``, 0.3 x the MTP head's CE of the token two ahead
        (from [h_t ; emb_{t+1}]): ``(total, {"ce", "aux"[, "mtp_ce"]})``."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        tok = _take(rows, batch["tokens"], dev).long()
        with G(params, recurse=False):
            h = _c(params.embed[tok])
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for lp in [*params.dense_layers, *params.moe_layers]:
                h, a = block(lp, h, rows)
                h, aux = _c(h), aux + a
            ce = _ce(params, cfg, L.rms_norm(h, params.final_norm),
                     *_shifted(tok, 1), rows)
            metrics = {"ce": ce, "aux": aux}
            total = ce + aux
            if cfg.mtp:
                with G(params.mtp) as mtp:
                    emb_next = F.pad(params.embed[tok][:, 1:], (0, 0, 0, 1))
                    hm = torch.cat([h, emb_next], -1).to(CDTYPE) @ mtp.proj
                    hm, _, _ = _mla_block(mtp.block, cfg, hm, rows)
                    mtp_ce = _ce(params, cfg, L.rms_norm(hm, mtp.norm),
                                 *_shifted(tok, 2), rows)
                metrics["mtp_ce"] = mtp_ce
                total = total + 0.3 * mtp_ce
        return total, metrics

    def _latent_zeros(rows, batch, max_len):
        m = cfg.mla

        def mk(n):
            return {"c_kv": _zeros(rows, (n, batch, max_len, m.kv_lora), dev),
                    "k_rope": _zeros(rows, (n, batch, max_len, m.rope_dim),
                                     dev)}
        return {"dense": mk(nd), "moe": mk(nm)}

    def init_cache(batch, max_len):
        """Zero latent caches of both stacks: ``{"dense": {"c_kv",
        "k_rope"}, "moe": {...}}``, each (n, B, max_len, ·) bf16."""
        return _latent_zeros(_rows(mesh, dp_axes, batch), batch, max_len)

    def prefill(params, batch):
        """The full forward pass over ``batch["tokens"]`` (B, S): the last
        position's logits and the latent caches of all S positions.  Its
        MoE layers take the dropless path at B x S <= 32 tokens and the
        capacity path above, as the reference's do."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        with G(params, recurse=False):
            h = params.embed[_take(rows, batch["tokens"], dev).long()]
            cache = _latent_zeros(None, h.shape[0], h.shape[1])
            for name, layers in (("dense", params.dense_layers),
                                 ("moe", params.moe_layers)):
                for i, lp in enumerate(layers):
                    with G(lp):
                        h, _, (c_kv, k_rope) = _mla_block(lp, cfg, h, rows)
                    h = _c(h)
                    cache[name]["c_kv"][i].copy_(c_kv)
                    cache[name]["k_rope"][i].copy_(k_rope)
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h[:, -1:])[:, 0]
        return _out(rows, logits), _place_cache(rows, cache)

    def decode_step(params, cache, token, cur_len, *, past_cache="refuse"):
        """One token a slot, as the dense ``decode_step``: the absorbed
        MLA decode writes each layer's latent cache in place."""
        rows = _rows(mesh, dp_axes, token)
        lc = _local(mesh, cache)
        seq = P.seq_shard(cache["moe"]["c_kv"])
        cl, drop = _step_lengths(_lens(rows, cur_len),
                                 cache["moe"]["c_kv"].shape[2], past_cache,
                                 dev)
        with G(params, recurse=False):
            h = params.embed[_take(rows, token, dev).long()][:, None, :]
            for name, layers in (("dense", params.dense_layers),
                                 ("moe", params.moe_layers)):
                c = lc[name]
                for i, lp in enumerate(layers):
                    with G(lp):
                        h = _c(_mla_block_decode(
                            lp, cfg, h, {"c_kv": c["c_kv"][i],
                                         "k_rope": c["k_rope"][i]}, cl,
                            drop=drop, rows=rows, seq=seq))
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h)[:, 0]
        return _out(rows, logits), cache

    return ModelApi(cfg, init, loss, prefill, decode_step, init_cache, mesh,
                    tuple(dp_axes))


# ---------------------------------------------------------------------------
# family: hybrid (jamba)
# ---------------------------------------------------------------------------


def _hybrid_positions(cfg):
    """(moe_pos, mlp_pos): the group positions whose feed-forward is an
    MoE (the odd ones with ``every_other``) and a dense MLP."""
    per = cfg.attn_every
    moe_pos = [i for i in range(per) if i % 2 == 1] \
        if cfg.moe.every_other else list(range(per))
    return moe_pos, [i for i in range(per) if i not in moe_pos]


class AttnLayer(torch.nn.Module):
    """A hybrid group's attention layer: ``attn`` and its gain ``n1``."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.attn = A.Attention(cfg, gen, device=device)
        self.n1 = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                     device=device))


class HybridGroup(torch.nn.Module):
    """One group of ``attn_every`` layers: ``mamba`` (``attn_every - 1``
    ``MambaBlock``s), ``attn`` (``AttnLayer``, at ``attn_offset``), the
    feed-forwards ``moe`` (``MoE``s at the MoE positions) and ``mlp``
    (``MLP``s at the others), and ``ffn_norms`` (attn_every, d) f32."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        moe_pos, mlp_pos = _hybrid_positions(cfg)
        self.mamba = torch.nn.ModuleList(
            MambaBlock(cfg, gen, device=device)
            for _ in range(cfg.attn_every - 1))
        self.attn = AttnLayer(cfg, gen, device=device)
        self.moe = torch.nn.ModuleList(MOE.MoE(cfg, gen, device=device)
                                       for _ in moe_pos)
        self.mlp = torch.nn.ModuleList(L.MLP(cfg, gen, device=device)
                                       for _ in mlp_pos)
        self.ffn_norms = _weight(torch.ones((cfg.attn_every, cfg.d_model),
                                            dtype=torch.float32,
                                            device=device))


class HybridLM(torch.nn.Module):
    """The hybrid LM's parameters: ``groups`` (``n_layers / attn_every``
    ``HybridGroup``s), ``embed`` (vocab_padded, d) bf16, ``final_norm``
    (d,) f32 and, untied, ``lm_head`` (d, vocab_padded) bf16."""

    def __init__(self, cfg, gen=None, *, device=None):
        super().__init__()
        self.groups = torch.nn.ModuleList(
            HybridGroup(cfg, gen, device=device)
            for _ in range(cfg.n_layers // cfg.attn_every))
        self.embed = _weight(_embed_init(gen, cfg, device=device))
        self.final_norm = _weight(torch.ones(cfg.d_model, dtype=torch.float32,
                                             device=device))
        if not cfg.tie_embeddings:
            self.lm_head = _weight(L.dense_init(
                gen, cfg.d_model, cfg.vocab_padded, device=device))


def _mamba_index(cfg, i):
    """The Mamba-2 block of group position i (every position but the
    attention layer's)."""
    return i if i < cfg.attn_offset else i - 1


def _hybrid_ffn(gp, cfg, h, i, rows=None):
    """Group position i's feed-forward on its norm of h: (out, aux), an
    MoE with its load-balance aux (which only the loss reads) or a dense
    MLP with 0."""
    moe_pos, _ = _hybrid_positions(cfg)
    hn = L.rms_norm(h, gp.ffn_norms[i])
    if i in moe_pos:
        return MOE.moe_forward(gp.moe[moe_pos.index(i)], cfg, hn,
                               **_moe_kw(rows))
    return L.mlp(gp.mlp[i - sum(j < i for j in moe_pos)], cfg, hn), 0.0


def _hybrid_mixer(gp, cfg, h, i, *, return_state):
    """Group position i's attention or Mamba-2 mixer on its norm of h;
    with ``return_state`` (out, its cache): the attention layer's (k, v)
    or the Mamba-2 block's final (h, conv) state."""
    if i == cfg.attn_offset:
        return A.attention_forward(gp.attn.attn, cfg,
                                   L.rms_norm(h, gp.attn.n1),
                                   kind="causal", return_kv=return_state)
    lp = gp.mamba[_mamba_index(cfg, i)]
    return M.mamba_forward(lp.mixer, cfg, L.rms_norm(h, lp.n1),
                           return_state=return_state)


def _hybrid_layer(gp, cfg, h, i, rows=None):
    """Group position i over the whole sequence: (h, its cache)."""
    a, st = _hybrid_mixer(gp, cfg, h, i, return_state=True)
    h = h + a
    return h + _hybrid_ffn(gp, cfg, h, i, rows)[0], st


def _hybrid_group_loss(gp, cfg, h, rows=None):
    """One group over the whole sequence, as the reference's loss runs
    it: (h, the group's summed MoE aux)."""
    aux = 0.0
    for i in range(cfg.attn_every):
        h = h + _hybrid_mixer(gp, cfg, h, i, return_state=False)
        f, a = _hybrid_ffn(gp, cfg, h, i, rows)
        h, aux = h + f, aux + a
    return h, aux


def build_hybrid(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                 remat: str = "block", *, device=None) -> ModelApi:
    G = cfg.n_layers // cfg.attn_every          # groups
    per, off = cfg.attn_every, cfg.attn_offset
    n_mamba = per - 1
    _c = make_constrainer(mesh, dp_axes)
    gather = _gatherer(mesh)
    dev = resolve_device(device, mesh)

    def _group(gp, h, rows):
        with gather(gp):
            return _hybrid_group_loss(gp, cfg, h, rows)

    group = _remat(_group, remat)

    def init(generator):
        return _placed(HybridLM(cfg, generator, device=dev), mesh, dp_axes)

    def loss(params, batch):
        """Next-token CE plus the MoE layers' load-balance aux:
        ``(ce + aux, {"ce", "aux"})``."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        tok = _take(rows, batch["tokens"], dev).long()
        with gather(params, recurse=False):
            h = _c(params.embed[tok])
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for gp in params.groups:
                h, a = group(gp, h, rows)
                h, aux = _c(h), aux + a
            ce = _ce(params, cfg, L.rms_norm(h, params.final_norm),
                     *_shifted(tok, 1), rows)
        return ce + aux, {"ce": ce, "aux": aux}

    def _place(rows, kv, ssm):
        return {"kv": _place_cache(rows, kv),
                "ssm": _place_cache(rows, ssm, batch_axis=2, seq_axis=None)}

    def prefill(params, batch):
        """The full forward pass over ``batch["tokens"]`` (B, S): the last
        position's logits and ``{"kv": {"k", "v"}, "ssm": (h, conv)}``,
        the attention layers' K/V (G, B, S, Hkv, hd) bf16 and the Mamba-2
        layers' final states (G, n_mamba, B, ...), h f32 and conv bf16."""
        rows = _rows(mesh, dp_axes, batch["tokens"])
        kvs, hs, convs = [], [], []
        with gather(params, recurse=False):
            h = params.embed[_take(rows, batch["tokens"], dev).long()]
            for gp in params.groups:
                states = []
                with gather(gp):
                    for i in range(per):
                        h, st = _hybrid_layer(gp, cfg, h, i, rows)
                        h = _c(h)
                        (kvs if i == off else states).append(st)
                hs.append(torch.stack([st[0] for st in states]))
                convs.append(torch.stack([st[1] for st in states]))
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h[:, -1:])[:, 0]
        return _out(rows, logits), _place(
            rows, {"k": torch.stack([kv[0] for kv in kvs]),
                   "v": torch.stack([kv[1] for kv in kvs])},
            (torch.stack(hs), torch.stack(convs)))

    def init_cache(batch, max_len):
        """Zero K/V (G, B, max_len, Hkv, hd) bf16 and zero states (G,
        n_mamba, B, ...), h f32 and conv bf16."""
        rows = _rows(mesh, dp_axes, batch)
        b = _local_batch(rows, batch)
        kv = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
        h0, c0 = M.init_mamba_state(cfg, b, CDTYPE, device=dev)
        return {"kv": {"k": _zeros(rows, kv, dev), "v": _zeros(rows, kv, dev)},
                "ssm": _place_cache(rows, (
                    h0.expand((G, n_mamba) + h0.shape).clone(),
                    c0.expand((G, n_mamba) + c0.shape).clone()),
                    batch_axis=2, seq_axis=None)}

    def decode_step(params, cache, token, cur_len, *, past_cache="refuse"):
        """One token a slot: the attention layers write their K/V in place
        at ``cur_len - 1`` (``past_cache`` as the dense ``decode_step``),
        the Mamba-2 layers update their states in place and ignore
        ``cur_len``, as the reference's: a slot's state runs on from
        whatever it held (ROADMAP C10)."""
        rows = _rows(mesh, dp_axes, token)
        lc = _local(mesh, cache)
        kc, vc = lc["kv"]["k"], lc["kv"]["v"]
        hs, convs = lc["ssm"]
        seq = P.seq_shard(cache["kv"]["k"])
        cl, drop = _step_lengths(_lens(rows, cur_len),
                                 cache["kv"]["k"].shape[2], past_cache, dev)
        with gather(params, recurse=False):
            h = params.embed[_take(rows, token, dev).long()][:, None, :]
            for g, gp in enumerate(params.groups):
                with gather(gp):
                    for i in range(per):
                        if i == off:
                            a, _ = A.attention_decode(
                                gp.attn.attn, cfg, L.rms_norm(h, gp.attn.n1),
                                {"k": kc[g], "v": vc[g]}, cl, drop=drop,
                                seq=seq)
                        else:
                            mi = _mamba_index(cfg, i)
                            lp = gp.mamba[mi]
                            a, (sh, sc) = M.mamba_decode(
                                lp.mixer, cfg, L.rms_norm(h, lp.n1),
                                (hs[g, mi], convs[g, mi]))
                            hs[g, mi].copy_(sh)
                            convs[g, mi].copy_(sc)
                        h = h + a
                        h = h + _hybrid_ffn(gp, cfg, h, i, rows)[0]
                h = _c(h)
            h = L.rms_norm(h, params.final_norm)
            logits = _head(params, cfg, h)[:, 0]
        return _out(rows, logits), cache

    return ModelApi(cfg, init, loss, prefill, decode_step, init_cache, mesh,
                    tuple(dp_axes))


# ---------------------------------------------------------------------------


def build_model(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                remat: str = "block", *, device=None) -> ModelApi:
    """The ``ModelApi`` of ``cfg``'s family on ``device`` (default: the
    CUDA card; without one this raises ``RuntimeError``).  ``remat`` is
    the loss's activation checkpointing: ``"block"`` (each layer, or each
    hybrid group) or ``"none"``.  A family the reference does not have,
    or another ``remat``, raises ``ValueError``."""
    fam = {"dense": build_dense, "vlm": build_dense, "moe": build_moe,
           "ssm": build_ssm, "hybrid": build_hybrid, "encdec": build_encdec}
    if cfg.family not in fam:
        raise ValueError(f"unknown model family {cfg.family!r}; the "
                         f"families are {sorted(fam)}")
    if remat not in ("block", "none"):
        raise ValueError(f"remat must be 'block' or 'none', not {remat!r}")
    return fam[cfg.family](cfg, mesh=mesh, dp_axes=dp_axes, remat=remat,
                           device=device)

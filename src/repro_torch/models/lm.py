"""Model assembly behind one ``ModelApi``: the dense and VLM decoders.

Counterpart of the reference package's ``models/lm.py`` for the families
the port serves so far:
  dense  — qwen3-32b/4b, olmo-1b, starcoder2-7b
  vlm    — paligemma (stubbed patch-embedding prefix, prefix-LM mask)
The other families (moe, ssm, hybrid, encdec) raise
``NotImplementedError`` naming their ROADMAP item (A9 (b)), and so does
``ModelApi.loss`` (training, A9 (c)).

The parameters are an ``nn.Module`` tree (``DenseLM``: the embedding, a
``ModuleList`` of blocks, the final norm and an optional ``lm_head``),
passed as ``params`` to the same call shapes as the reference's:
``decode_step(params, cache, token, cur_len)``.  Serving holds every
matmul weight and the embedding once in bf16, the norm gains in f32:
the reference keeps f32 weights and casts them to bf16 at each use,
which gives the same numbers; the training slice will add f32 master
weights beside them.  Layers run in a Python loop, eagerly; the KV cache
is one preallocated (L, B, Smax, Hkv, hd) bf16 tensor pair written in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.api.backends import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.layers import CDTYPE, _weight


@dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable                    # (generator) -> params
    loss: Callable                    # (params, batch) -> (loss, metrics)
    prefill: Callable                 # (params, batch) -> (logits, cache)
    decode_step: Callable             # (params, cache, token, cur_len) -> (logits, cache)
    init_cache: Callable              # (batch, max_len) -> cache


def make_constrainer(mesh, dp_axes):
    """Activation sharding constraint: the identity without a mesh (the
    mesh placements are ROADMAP A9 (d))."""
    if mesh is not None:
        raise NotImplementedError(
            "models on a mesh are not ported yet (ROADMAP A9 (d))")
    return lambda x: x


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _on(x, device) -> torch.Tensor:
    """A tensor, numpy array or sequence as a tensor on ``device``."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           device=device)


def _embed_init(gen, cfg, *, device=None):
    """``N(0, 1) * 0.02`` over ``vocab_padded`` rows, held in bf16."""
    shape = (cfg.vocab_padded, cfg.d_model)
    if gen is None:
        return torch.empty(shape, dtype=CDTYPE, device=device)
    e = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (e * 0.02).to(CDTYPE)


def _head(params, cfg, h):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (h.to(CDTYPE) @ w).to(torch.float32)


def _final_norm(params, cfg, h):
    return (L.rms_norm(h, params.final_norm) if not cfg.nonparam_ln
            else L.nonparam_layer_norm(h))


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


def _dense_block_decode(p, cfg, h, cache, cur_len):
    _, apply_n = L.make_norm(cfg)
    a, cache = A.attention_decode(p.attn, cfg, apply_n(p.n1, h),
                                  cache, cur_len)
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


def build_dense(cfg: ArchConfig, mesh=None, dp_axes=("data",), *,
                device=None) -> ModelApi:
    prefix = cfg.prefix_len
    _c = make_constrainer(mesh, dp_axes)
    dev = resolve_device(device)

    def init(generator):
        """Random parameters drawn on ``generator`` (a ``torch.Generator``
        on the model's device), one tensor at a time."""
        return DenseLM(cfg, generator, device=dev)

    def loss(params, batch):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP A9 (c)): the loss needs "
            "chunked_ce and f32 master weights")

    def _inputs_to_h(params, batch):
        h = params.embed[_on(batch["tokens"], dev).long()]
        if prefix and "patches" in batch:
            h = torch.cat([_on(batch["patches"], dev).to(h.dtype), h], 1)
        return _c(h)

    def prefill(params, batch):
        """The full forward pass over ``batch["tokens"]`` (B, S) (after
        ``batch["patches"]`` (B, prefix_len, d) for the VLM): the last
        position's logits and the cache of all S positions."""
        h = _inputs_to_h(params, batch)
        kind = "prefix" if prefix else "causal"
        S = h.shape[1]
        _, apply_n = L.make_norm(cfg)
        ks, vs = [], []
        for lp in params.layers:
            a, (k, v) = A.attention_forward(
                lp.attn, cfg, apply_n(lp.n1, h),
                kind=kind, prefix_len=prefix, return_kv=True)
            h = h + a
            h = _c(h + L.mlp(lp.mlp, cfg, apply_n(lp.n2, h)))
            ks.append(k)
            vs.append(v)
        h = _final_norm(params, cfg, h)
        logits = _head(params, cfg, h[:, -1:])[:, 0]
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "len": S}

    def init_cache(batch, max_len):
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=CDTYPE, device=dev),
                "v": torch.zeros(shape, dtype=CDTYPE, device=dev)}

    def decode_step(params, cache, token, cur_len):
        """One token a slot: ``token`` (B,), ``cur_len`` a scalar or (B,)
        of lengths including it (the token goes to ``cur_len - 1``).
        Writes ``cache`` in place and returns it with the (B, Vp) f32
        logits."""
        smax = cache["k"].shape[2]
        if not torch.is_tensor(cur_len):
            n = np.asarray(cur_len)
            if n.size and (n.min() < 1 or n.max() > smax):
                raise ValueError(f"cur_len must lie in [1, {smax}]: {n}")
        cl = _on(cur_len, dev).long()
        h = params.embed[_on(token, dev).long()][:, None, :]
        for i, lp in enumerate(params.layers):
            h, _ = _dense_block_decode(
                lp, cfg, h, {"k": cache["k"][i], "v": cache["v"][i]}, cl)
            h = _c(h)
        h = _final_norm(params, cfg, h)
        logits = _head(params, cfg, h)[:, 0]
        return logits, cache

    return ModelApi(cfg, init, loss, prefill, decode_step, init_cache)


# ---------------------------------------------------------------------------


_NOT_PORTED = {"moe": "build_moe", "ssm": "build_ssm",
               "hybrid": "build_hybrid", "encdec": "build_encdec"}


def build_model(cfg: ArchConfig, mesh=None, dp_axes=("data",), *,
                device=None) -> ModelApi:
    """The ``ModelApi`` of ``cfg``'s family on ``device`` (default: the
    CUDA card; without one this raises ``RuntimeError``)."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({_NOT_PORTED[cfg.family]}) is not "
            "ported yet (ROADMAP A9 (b))")
    fam = {"dense": build_dense, "vlm": build_dense}
    return fam[cfg.family](cfg, mesh=mesh, dp_axes=dp_axes, device=device)

"""Config registry: ``--arch <id>`` resolves through ``get_arch``.

A copy of the reference's registry and dataclasses (``base``), every
architecture included, so the port imports nothing of the reference;
``sharding`` holds the mesh placements (the reference's
``configs/sharding.py``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MLAConfig, MoEConfig, RunShape, SSMConfig, SHAPES,
    applicable_shapes,
)

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "olmo-1b": "olmo_1b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-130m": "mamba2_130m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (brief: small layers,
    few experts, tiny vocab)."""
    import dataclasses
    cfg = get_arch(name)
    kw = dict(n_layers=min(cfg.n_layers, 4), d_model=64, d_ff=128,
              vocab=512, head_dim=16, vocab_pad_mult=64)
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0
        if cfg.n_kv_heads == 1:
            kw["n_kv_heads"] = 1
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=32,
            first_dense=min(cfg.moe.first_dense, 1))
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora=32, q_lora=48, rope_dim=8, nope_dim=16, v_dim=16)
        kw["head_dim"] = 24
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.enc_layers:
        kw["enc_layers"] = min(cfg.enc_layers, 2)
    if cfg.attn_every:
        kw["n_layers"] = cfg.attn_every          # one hybrid group
    if cfg.prefix_len:
        kw["prefix_len"] = 8
    return cfg.scaled(**kw)

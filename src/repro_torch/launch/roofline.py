"""Roofline terms of a step from its op counts.

The port's counterpart of the reference package's ``launch/roofline.py``
on the NVIDIA H100 80GB HBM3 (SXM5, 700 W), by its spec sheet:

    compute    = flops             / 989e12 FLOP/s   (dense bf16)
    memory     = bytes             / 3.35e12 B/s     (HBM3)
    collective = collective_bytes  / 450e9 B/s       (NVLink, a direction)

The counts are a rank's, from ``launch.hlo_cost``'s ``CostCounter`` over
the ATen ops the step dispatches (the reference reads a compiled
executable's HLO; there is none here), so each term is one card's.
``memory`` reports ``torch.cuda.max_memory_allocated`` where a card ran
the step, and the bytes of the rank's placed state (parameters, cache,
optimizer state) on ``meta`` tensors, which allocate nothing.
``active_params`` and ``model_flops_estimate`` are the reference's,
unchanged.
"""
from __future__ import annotations

from repro_torch.launch.hlo_cost import analyze_counts

PEAK_FLOPS = 989e12          # dense bf16 per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, a direction


def terms(tot: dict) -> dict:
    """The three roofline terms (seconds) of a count table's totals."""
    return {"compute_s": tot["flops"] / PEAK_FLOPS,
            "memory_s": tot["bytes"] / HBM_BW,
            "collective_s": tot["collective_bytes"] / NVLINK_BW}


def analyze(table: dict, *, chips: int, model_flops: float | None = None,
            memory: dict | None = None) -> dict:
    """The roofline record of one rank's count table
    (``CostCounter.table``): its totals, ``terms_s``, the ``dominant``
    term and, with ``model_flops``, ``useful_ratio`` (the model's flops
    over every rank's counted ones).  The keys are the reference's: its
    ``hlo_*_per_device`` hold the counted ops of one rank."""
    tot = analyze_counts(table)
    t = terms(tot)
    result = {
        "chips": chips,
        "hlo_flops_per_device": tot["flops"],
        "hlo_bytes_per_device": tot["bytes"],
        "hlo_bytes_upper_per_device": tot["bytes_upper"],
        "matmul_flops_per_device": tot["matmul_flops"],
        "collective_bytes_per_device": tot["collective_bytes"],
        "collectives": tot["collectives"],
        "terms_s": t,
        "dominant": max(t, key=t.get),
        "memory": dict(memory or {}),
    }
    if model_flops is not None:
        result["model_flops"] = model_flops
        dev_total = tot["flops"] * chips
        result["useful_ratio"] = model_flops / dev_total if dev_total else 0.0
    return result


def memory(device, state_bytes: int | None = None) -> dict:
    """What ``analyze`` reports as memory: the card's peak allocation
    where ``device`` is a CUDA card, else (``meta``, the CPU) the bytes
    of the rank's placed state."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return {"peak_bytes": torch.cuda.max_memory_allocated(device),
                "argument_bytes": state_bytes}
    return {"peak_bytes": None, "argument_bytes": state_bytes}


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for dense, 6*N_active*D for MoE (training); forward-only /3 for
    serving steps; decode counts a single new token per sequence."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence (attention over the cache adds the
    # S-dependent term: 2 * layers * cache_dim work — folded into n_active
    # approximation)
    return 2.0 * n_active * shape.global_batch


def active_params(cfg) -> float:
    """Parameter count active per token (MoE counts top_k+shared experts)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_padded
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        sc = cfg.ssm
        di = sc.expand * d
        H = di // sc.head_dim
        per = d * (2 * di + 2 * sc.d_state + H) + di * d
        return emb + L * per
    # attention per layer
    if cfg.mla is not None:
        m = cfg.mla
        attn = (d * m.q_lora + m.q_lora * cfg.n_heads * (m.nope_dim + m.rope_dim)
                + d * (m.kv_lora + m.rope_dim)
                + m.kv_lora * cfg.n_heads * (m.nope_dim + m.v_dim)
                + cfg.n_heads * m.v_dim * d)
    elif cfg.n_heads:
        attn = d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd \
            + cfg.n_heads * cfg.hd * d
    else:
        attn = 0
    glu = 3 if cfg.act in ("swiglu", "geglu") else 2
    dense_ffn = glu * d * cfg.d_ff
    if cfg.family == "moe":
        mc = cfg.moe
        moe_ffn = glu * d * mc.d_expert * (mc.top_k + mc.n_shared) + d * mc.n_experts
        total = emb + mc.first_dense * (attn + dense_ffn) \
            + (L - mc.first_dense) * (attn + moe_ffn)
        return total
    if cfg.family == "hybrid":
        sc = cfg.ssm
        di = sc.expand * d
        H = di // sc.head_dim
        mamba = d * (2 * di + 2 * sc.d_state + H) + di * d
        n_attn = L // cfg.attn_every
        n_mamba = L - n_attn
        mc = cfg.moe
        n_moe = L // 2 if mc.every_other else L
        n_mlp = L - n_moe
        moe_ffn = glu * d * mc.d_expert * mc.top_k + d * mc.n_experts
        return emb + n_attn * attn + n_mamba * mamba \
            + n_moe * moe_ffn + n_mlp * dense_ffn
    if cfg.family == "encdec":
        enc = cfg.enc_layers * (attn + dense_ffn)
        dec = L * (2 * attn + dense_ffn)
        return emb + enc + dec
    return emb + L * (attn + dense_ffn)

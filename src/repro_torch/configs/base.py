"""Architecture + run-shape configuration dataclasses."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # always-on shared experts
    first_dense: int = 0          # leading layers use dense FFN
    every_other: bool = False     # MoE on odd layers only (jamba)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    nonparam_ln: bool = False     # olmo: non-parametric LayerNorm
    rope_theta: float = 10_000.0
    act: str = "swiglu"           # swiglu | gelu | geglu
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0           # hybrid: 1 attn per this many layers
    attn_offset: int = 4          # hybrid: position of attn inside group
    enc_layers: int = 0           # encdec
    prefix_len: int = 0           # vlm/audio stub frontend tokens
    mtp: bool = False             # deepseek-v3 multi-token prediction head
    attn_block_q: int = 512       # blockwise-attention tile sizes (perf knob)
    attn_block_kv: int = 1024
    vocab_pad_mult: int = 256
    sub_quadratic: bool = False   # eligible for long_500k
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_mult
        return (self.vocab + m - 1) // m * m

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced copy for CPU smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k":    RunShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  RunShape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   RunShape("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list:
    """long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out

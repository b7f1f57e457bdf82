"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MLA kv_lora=512, MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                    # dense-FFN layers (first_dense)
    vocab=102400, head_dim=192,    # nope 128 + rope 64
    act="swiglu",
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128, v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1),
)

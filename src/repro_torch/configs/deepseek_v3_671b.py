"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MLA, MoE 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                    # dense-FFN layers (first_dense)
    vocab=129280, head_dim=192,
    act="swiglu", mtp=True,
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128, v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  first_dense=3),
)

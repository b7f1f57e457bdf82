"""mamba2-130m [ssm]: 24L d_model=768 attn-free, vocab=50280, ssm_state=128,
SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True, tie_embeddings=True,
)

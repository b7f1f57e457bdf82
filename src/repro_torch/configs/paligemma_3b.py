"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384
vocab=257216.  SigLIP frontend is a STUB: input_specs() provides precomputed
patch embeddings as a 256-token prefix (prefix-LM mask). [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256,
    act="geglu", prefix_len=256, tie_embeddings=True,
)

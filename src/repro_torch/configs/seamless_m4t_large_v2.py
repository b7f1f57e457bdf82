"""seamless-m4t-large-v2 [audio]: enc-dec, 24L each, d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  Modality frontend is a STUB: input_specs() provides
precomputed audio-frame embeddings (B, S_enc, d_model). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    act="gelu",
)

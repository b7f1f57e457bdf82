"""``repro_torch.models`` — the LM stack: every family's model
(``lm.build_model``: dense, VLM, encoder-decoder, Mamba-2 SSM, DeepSeek
MoE with MLA, Jamba hybrid), its serving calls and training loss, and
its layers."""
from repro_torch.models.lm import build_model  # noqa: F401

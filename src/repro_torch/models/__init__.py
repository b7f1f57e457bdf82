"""``repro_torch.models`` — the LM stack's serving path: every family's
model (``lm.build_model``: dense, VLM, encoder-decoder, Mamba-2 SSM,
DeepSeek MoE with MLA, Jamba hybrid) and its layers."""
from repro_torch.models.lm import build_model  # noqa: F401

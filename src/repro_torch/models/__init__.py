"""``repro_torch.models`` — the LM stack's serving path: the dense and
VLM decoders (``lm.build_model``), their attention and layers."""
from repro_torch.models.lm import build_model  # noqa: F401

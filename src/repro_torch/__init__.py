"""PyTorch/CUDA port of the DCO vector-search system.

The streaming DCO search over a flat or IVF-probed corpus, fixed or under
the adaptive policy, with anytime deadlines, the guardrail breaker and
its delta write path, runs on one NVIDIA H100 through hand-written CUDA
kernels (``kernels/csrc``); every other module is plain PyTorch or numpy,
the serving front and replica tier (``serving``) and crash-safe snapshots
with the delta WAL (``api.persistence``) included.  Entry point:
``repro_torch.api.open_index``.
"""

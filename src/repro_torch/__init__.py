"""PyTorch/CUDA port of the DCO vector-search system.

The flat-corpus streaming DCO search runs on one NVIDIA H100 through
hand-written CUDA kernels (``kernels/csrc``); every other module is plain
PyTorch or numpy.  Entry point: ``repro_torch.api.open_index``.
"""

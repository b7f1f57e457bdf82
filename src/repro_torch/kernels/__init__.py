"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the padding/dispatch wrappers (``ops``)."""

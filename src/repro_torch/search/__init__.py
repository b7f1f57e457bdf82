"""Indexes of the port: the IVF partitioned index and the HNSW graph, both
on the host (numpy)."""
from repro_torch.search.hnsw import HNSWIndex  # noqa: F401
from repro_torch.search.ivf import IVFIndex  # noqa: F401

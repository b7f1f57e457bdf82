"""Indexes of the port: the IVF partitioned index (HNSW is ROADMAP A4)."""
from repro_torch.search.ivf import IVFIndex  # noqa: F401

"""The paper's own workload as a config: the distributed DCO retrieval engine.

This is the (arch, shape) cell "most representative of the paper's technique"
for the §Perf hillclimb: a production-scale vector corpus sharded over the
mesh, served with the two-stage DCO engine.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class RetrievalConfig:
    name: str = "dco-retrieval"
    dim: int = 768                  # wikipedia-like embeddings
    n_total: int = 100_000_000      # paper's max cardinality (Deep: 100M)
    d1: int = 128                   # stage-1 dims
    k: int = 100
    query_batch: int = 1024
    capacity: int = 4096            # stage-2 survivors per shard per query
    kind: str = "lb"                # PDScanning+ style certified lower bound


CONFIG = RetrievalConfig()

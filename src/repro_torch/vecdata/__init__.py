"""Seeded synthetic dataset families (copy of the reference's vecdata)."""
from repro_torch.vecdata.synthetic import (DATASETS,  # noqa: F401
                                           VectorDataset, load_dataset,
                                           recall_at_k)

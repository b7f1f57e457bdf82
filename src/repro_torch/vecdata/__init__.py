"""Seeded synthetic dataset families (copy of the reference's vecdata)."""
from repro_torch.vecdata.synthetic import (DATASETS,  # noqa: F401
                                           DRIFT_SCENARIOS, VectorDataset,
                                           load_dataset, make_drift_scenario,
                                           make_ood_queries, recall_at_k)

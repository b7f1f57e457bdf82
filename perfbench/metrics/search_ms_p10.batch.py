"""Facade and backend: the 10th percentile of the window's batch walls
(host clock, each from the last batch's return to its own).  Batches run
at two speeds on the card's host (PERF.md section 2); this reads the fast
one, steadier from run to run than ``qps``, which counts both."""
import numpy as np


def read(run):
    ends = run.result.get("batch_ends_s")
    if not ends:
        return None
    return float(np.percentile(np.diff([0.0, *ends]), 10) * 1e3)

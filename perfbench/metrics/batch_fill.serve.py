"""Serving front: real requests a step over the step's slots, averaged
over the steps that served the window's requests (the tickets'
``batch_size``)."""
import numpy as np

from perfbench import latency


def read(run):
    done = latency.served(run)
    if not done:
        return None
    # a step of b requests holds b tickets: weigh each by 1/b to count steps
    steps = (1.0 / np.array([r["batch_size"] for r in done], np.float64)).sum()
    return float(len(done) / steps / int(run.traffic["slots"]))

"""Serving front: median wait of a request before its step, from the
tickets' ``t_done`` and ``service_s`` and the request's due time."""
import numpy as np

from perfbench import latency


def read(run):
    done = latency.served(run)
    if not done:
        return None
    return float(np.median([latency.queue_wait_s(r) for r in done]) * 1e3)

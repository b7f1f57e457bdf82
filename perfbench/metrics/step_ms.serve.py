"""Facade and backend: median wall of the step that served a window
request (the tickets' ``service_s``: host preparation, the device walk
and the copy back)."""
import numpy as np

from perfbench import latency


def read(run):
    done = latency.served(run)
    if not done:
        return None
    return float(np.median([r["service_s"] for r in done]) * 1e3)

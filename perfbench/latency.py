"""Latency arithmetic of an open loop: every request due in the window,
timed from its due time."""
from __future__ import annotations

import numpy as np


def window_requests(requests: list, window_s: float) -> list:
    """The requests due before the window closed."""
    return [r for r in requests if r["due_s"] < window_s]


def latencies_s(requests: list) -> np.ndarray:
    """Each request's latency from its due time; a request that was never
    answered counts as infinitely late (it misses every limit)."""
    return np.array([r["latency_s"] if r["status"] == "done" else np.inf
                     for r in requests], np.float64)


def percentile_ms(requests: list, q: float) -> float | None:
    """The ``q``-th percentile of the latencies in ms (linear between the
    two nearest ranks, as numpy's default; infinite where either rank is
    a request never answered), or ``None`` without requests."""
    lat = np.sort(latencies_s(requests))
    if lat.size == 0:
        return None
    pos = q / 100.0 * (lat.size - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if np.isinf(lat[hi]):
        return float("inf")
    return float((lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)) * 1e3)


def queue_wait_s(r: dict) -> float:
    """Time a served request spent before its step began: from its due
    time to its step's end, less the step's wall."""
    return r["latency_s"] - r["service_s"]


def served(run) -> list | None:
    """The answered requests that fell due in the run's window, or
    ``None`` where the run served no requests."""
    reqs = run.result.get("requests")
    if reqs is None:
        return None
    return [r for r in window_requests(reqs, run.result["window_s"])
            if r["status"] == "done"]

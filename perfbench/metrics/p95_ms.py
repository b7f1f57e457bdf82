"""Served latency tail: the 95th percentile over every request due in the
window, from its due time (host clock)."""
from perfbench import latency


def read(run):
    reqs = run.result.get("requests")
    if reqs is None:
        return None
    return latency.percentile_ms(
        latency.window_requests(reqs, run.result["window_s"]), 95)

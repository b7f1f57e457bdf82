"""The open loop's latency arithmetic: every request due in the window,
timed from its due time."""
import math

import numpy as np

from perfbench import latency


def _req(due, lat, status="done", service=0.05, b=4):
    return {"due_s": due, "latency_s": lat, "status": status,
            "service_s": service, "batch_size": b}


def test_window_takes_requests_by_due_time():
    reqs = [_req(0.1, 0.2), _req(9.99, 3.0), _req(10.0, 0.1)]
    assert [r["due_s"] for r in latency.window_requests(reqs, 10.0)] == [0.1, 9.99]


def test_percentiles_from_due_times_and_unanswered_as_late():
    reqs = [_req(i * 0.01, 0.01 * (i + 1)) for i in range(19)]
    reqs.append(_req(0.5, None, status="failed"))
    finite = [0.01 * (i + 1) for i in range(19)]
    assert latency.percentile_ms(reqs, 50) == np.percentile(finite + [1e9], 50) * 1e3
    assert latency.percentile_ms(reqs[:19], 95) == np.percentile(finite, 95) * 1e3
    assert latency.percentile_ms(reqs, 100) == math.inf
    assert latency.percentile_ms([], 95) is None


def test_queue_wait_is_latency_less_the_step():
    assert latency.queue_wait_s(_req(1.0, 0.3, service=0.05)) == 0.3 - 0.05


def test_batch_wall_p10_from_batch_ends():
    """``search_ms_p10.batch``: the 10th percentile of the walls between
    consecutive batch returns, the first timed from the window's start."""
    from perfbench import harness

    class _Run:
        result = {"batch_ends_s": [0.3, 0.7, 1.0, 1.5, 1.8]}
    reader = harness.Cell("gist1m.batch100").reader("search_ms_p10.batch")
    walls = np.diff([0.0, 0.3, 0.7, 1.0, 1.5, 1.8])
    assert reader.read(_Run()) == np.percentile(walls, 10) * 1e3
    _Run.result = {"requests": []}
    assert reader.read(_Run()) is None

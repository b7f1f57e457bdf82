"""The reading of a traced window: the device's busy union, its idle
gaps named by the benchmark's spans, and the kernels counted."""
import pytest

from perfbench.devtrace import Trace

NS = 1_000_000_000


def _trace():
    return Trace(
        ops=[("k1", 10, 30), ("k2", 20, 45), ("Memcpy DtoH", 60, 70),
             ("dco_scan_flat_kernel", 80, 90)],
        spans=[("search", 0, 100), ("step", 45, 55)],
        window=(0, 100))


def test_busy_union_and_window():
    t = _trace()
    assert t.busy() == [[10, 45], [60, 70], [80, 90]]
    assert t.busy_s() == pytest.approx(55 / NS)
    assert t.window_s == pytest.approx(100 / NS)


def test_kernels_leave_out_memory_copies():
    assert [n for n, _, _ in _trace().kernels()] == [
        "k1", "k2", "dco_scan_flat_kernel"]
    assert _trace().device_seconds("dco_scan") == pytest.approx(10 / NS)


def test_breakdown_names_gaps_by_the_innermost_span():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["k2", 25 / NS]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["step", 15 / NS]          # 45-60, inside "step"
    assert sorted(g[1] for g in gaps) == sorted(
        x / NS for x in (10, 15, 10, 10))
    assert {g[0] for g in gaps[1:]} == {"search"}


def test_ops_outside_the_window_are_clipped():
    t = Trace(ops=[("k", -50, 20), ("k", 90, 150)], window=(0, 100))
    assert t.busy() == [[0, 20], [90, 100]]

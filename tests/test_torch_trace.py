"""The port's span recorder (``repro_torch.utils.trace``) and the spans the
search path, the serving step and set-up record, on the CPU."""
from __future__ import annotations

import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import open_index
from repro_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
#: what one search on the CPU records below ``session.search``
SEARCH_CHILDREN = {"backend.prep", "backend.walk", "backend.readback",
                   "backend.stats"}


@pytest.fixture(scope="module")
def session():
    X = np.random.default_rng(3).standard_normal((3000, 192)).astype(
        np.float32)
    sess = open_index(X, method="PDScanning+", device="cpu")
    sess.search(X[:4], 10)          # the layout, once
    return sess, X


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_by_parent_and_share_the_step_request_ids(session):
    """A served step records ``service.step`` with its request ids; the
    search under it and the backend's layers reach it through the parent
    link, and every counter lands on ``session.search``."""
    sess, X = session
    svc = sess.serve(slots=4, k=10)
    tickets = [svc.submit(q) for q in X[:6]]
    with trace.recording():
        svc.drain()
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    steps = _by_name(spans)["service.step"]
    assert [s.attrs["rids"] for s in steps] == [
        [t.rid for t in tickets[:4]], [t.rid for t in tickets[4:]]]
    assert [s.attrs["batch_size"] for s in steps] == [4, 2]

    def root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s
    for s in spans:
        assert root(s).name == "service.step"
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    searches = _by_name(spans)["session.search"]
    assert [by_id[s.parent].name for s in searches] == ["service.step"] * 2
    for s in searches:
        assert {c.name for c in spans if c.parent == s.id} == SEARCH_CHILDREN
        assert set(s.counters) == {"dims_read", "dims_total"}
        assert 0 < s.counters["dims_read"] <= s.counters["dims_total"]


def test_the_ring_keeps_the_newest_and_counts_what_it_dropped():
    rec = trace.Recorder(capacity=4)
    for j in range(10):
        with rec.setup_span("s", j=j):
            rec.count("n", j)
    assert [s.attrs["j"] for s in rec.spans()] == [6, 7, 8, 9]
    assert [s.counters["n"] for s in rec.spans()] == [6, 7, 8, 9]
    assert rec.dropped() == 6
    rec.clear()
    assert rec.spans() == [] and rec.dropped() == 0


def test_set_up_spans_are_recorded_always_and_hot_spans_not():
    X = np.random.default_rng(4).standard_normal((2000, 64)).astype(
        np.float32)
    sess = open_index(X, method="PDScanning+", device="cpu")
    sess.search(X[:3], 5)
    names = [s.name for s in trace.spans()]
    assert names == ["open.fit", "backend.layout"]
    fit = trace.spans()[0]
    assert fit.attrs == {"method": "PDScanning+", "rows": 2000}
    sess.add(X[:16] + 1.0)
    sess.search(X[:3], 5)
    assert [s.name for s in trace.spans()][2:] == ["backend.delta_build"]


def test_recording_off_reads_no_clock(session, monkeypatch):
    """With recording off and no profiler, a search's span sites read no
    clock: ``time.time_ns`` raising changes nothing."""
    sess, X = session

    def no_clock():
        raise AssertionError("a span site read the clock")
    monkeypatch.setattr(time, "time_ns", no_clock)
    res = sess.search(X[:5], 10)
    assert res.ids.shape == (5, 10)
    svc = sess.serve(slots=2, k=10)
    svc.submit(X[0])
    assert svc.drain()[0].status == "done"
    assert trace.spans() == []


def test_a_running_profiler_records_the_hot_path(session):
    sess, X = session
    with profile(activities=[ProfilerActivity.CPU]):
        sess.search(X[:5], 10)
    names = {s.name for s in trace.spans()}
    assert names == SEARCH_CHILDREN | {"session.search"}
    trace.clear()
    sess.search(X[:5], 10)
    assert trace.spans() == []


def test_spans_share_the_profiler_clock(session, monkeypatch):
    """Every ``aten::`` event the profiler stamps inside the engine's walk
    (marked by a profiler range around the engine call, on the
    profiler's own clock) lies inside the ``backend.walk`` span to within
    20 us."""
    import repro_torch.api.backends as B
    sess, X = session
    walk = B.stream_topk

    def marked(*a, **kw):
        with torch.profiler.record_function("test.walk"):
            return walk(*a, **kw)
    monkeypatch.setattr(B, "stream_topk", marked)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.search(X[:8], 10)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    (lo, hi), = [(s, e) for n, s, e in events if n == "test.walk"]
    inside = [(s, e) for n, s, e in events
              if n.startswith("aten::") and lo <= s and e <= hi]
    assert len(inside) > 20
    (span,) = _by_name(trace.spans())["backend.walk"]
    slack = 20_000
    assert span.start_ns - slack <= min(s for s, _ in inside)
    assert max(e for _, e in inside) <= span.end_ns + slack


def test_count_goes_to_the_innermost_span_and_errors_are_kept():
    with trace.recording():
        with trace.span("outer") as outer:
            trace.count("a", 1)
            with trace.span("inner", k=3) as inner:
                trace.count("a", 2)
                trace.count("a", 3)
            with pytest.raises(ValueError):
                with trace.span("failing"):
                    raise ValueError("planted")
        with trace.recording():         # nested: still on inside
            assert trace.span("x")
    assert not trace.span("x")          # off again
    trace.count("a", 9)                 # no span open: nothing
    assert outer.counters == {"a": 1} and inner.counters == {"a": 5}
    assert inner.parent == outer.id and inner.attrs == {"k": 3}
    (failing,) = _by_name(trace.spans())["failing"]
    assert failing.attrs == {"error": "ValueError"}
    assert failing.parent == outer.id


def _calls_record_function(path: Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute) and node.attr == "record_function":
            return True
        if isinstance(node, ast.Name) and node.id == "record_function":
            return True
        if isinstance(node, ast.alias) and node.name.endswith(
                "record_function"):
            return True
    return False


def test_no_module_of_the_port_emits_record_function():
    """No ``torch.profiler.record_function`` in ``repro_torch``: kineto
    mirrors each such range onto the device's timeline as a CUDA-typed
    event, which the benchmark's reading of the device trace counts as
    device work (it would fill the idle gaps it measures), and each call
    costs ~14 us even with no profiler running.  The program's spans are
    ``utils.trace``'s, on the same clock."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 50
    assert not [f for f in files if _calls_record_function(f)]
    probe = ROOT / "tests" / "test_torch_trace.py"
    assert _calls_record_function(probe)    # the check sees a call

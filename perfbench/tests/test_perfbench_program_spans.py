"""The readers of the program's own spans (``program_spans.py`` and its
metrics): a small traced run of each cell on the CPU, the arithmetic on
planted spans and device operations, and a program without the
recorder."""
import math
import sys
from types import SimpleNamespace

import pytest

from perfbench import harness, program_spans
from perfbench.devtrace import Trace

BENCH = harness.load_benchmark()
SMALL = {"n": 6000, "queries": 120}
SEED = 2 ** 31 + 13
SERVE = {"rate_per_s": 400.0, "drain_s": 30.0}
NEW = ("dims_read_share.batch", "fit_s", "layout_s", "capture_s")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _measure(name, trace, warm=None):
    from repro_torch.utils import trace as rec
    rec.clear()
    cell = harness.Cell(name)
    if "slots" in cell.traffic:
        cell.traffic = cell.traffic | SERVE
    if warm is not None:
        cell.driver.warm = warm(cell.driver.warm)
    run, _, _ = harness.measure(cell, SEED, 0.4, trace, device="cpu",
                                config_override=SMALL)
    return cell, run


def _planted_capture(warm):
    """The cell's warm-up inside a planted ``engine.warmup`` span that
    holds a ``kernels.build`` span, then an ``engine.capture`` span (the
    CPU captures no graph)."""
    from repro_torch.utils import trace

    def wrapped(run):
        with trace.setup_span("engine.warmup"):
            with trace.setup_span("kernels.build"):
                warm(run)
        with trace.setup_span("engine.capture"):
            pass
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_new_readers_read_a_traced_run_and_nothing_untraced(cell):
    c, run = _measure(cell, True, _planted_capture)
    mine = [m["name"] for m in c.per_layer if m["name"] in NEW]
    assert "capture_s" in mine and "fit_s" in mine
    for name in mine:
        value = c.reader(name).read(run)
        assert value is not None and math.isfinite(value), name
        assert value >= 0, name
    spans = program_spans.recorded()
    kids = program_spans.children(spans)
    warmup = program_spans.setup(run, ("engine.warmup",))[0]
    build = kids[warmup.id][0]
    capture = program_spans.setup(run, ("engine.capture",))[0]
    assert c.reader("capture_s").read(run) == pytest.approx(
        (warmup.duration_ns - build.duration_ns + capture.duration_ns) / 1e9)
    if "dims_read_share.batch" in mine:
        assert 0 < c.reader("dims_read_share.batch").read(run) <= 100
    c, run = _measure(cell, False)
    for name in NEW:
        assert c.reader(name).read(run) is None, name


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """The parent of the recorder has no ``repro_torch.utils.trace``: every
    reader returns ``None`` and raises nothing."""
    import repro_torch.utils
    run = SimpleNamespace(trace=Trace(window=(0, 100)))
    monkeypatch.delattr(repro_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    assert program_spans.recorded() is None
    cell = harness.Cell("gist1m.serve")
    for name in NEW:
        assert cell.reader(name).read(run) is None


def _span(i, name, s, e, parent=None, **counters):
    return SimpleNamespace(id=i, name=name, start_ns=s, end_ns=e,
                           duration_ns=e - s, parent=parent, attrs={},
                           counters=counters)


#: window 0-1000; the device busy 100-200, 400-500 and 700-705
PLANTED = [
    _span(1, "open.fit", -900, -500),
    _span(2, "backend.layout", -400, -300),
    _span(3, "service.step", 60, 900),
    _span(4, "session.search", 80, 880, 3, dims_read=30, dims_total=120),
    _span(5, "backend.prep", 90, 150, 4),
    _span(6, "backend.walk", 150, 600, 4),
    _span(7, "engine.replay", 160, 300, 6),
    _span(8, "backend.readback", 600, 706, 4),
    _span(9, "backend.stats", 706, 860, 4),
]


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(PLANTED))
    trace = Trace(ops=[("k", 100, 200), ("k", 400, 500), ("Memcpy", 700, 705)],
                  spans=[("step", 50, 950), ("submit", 960, 990)],
                  window=(0, 1000))
    return SimpleNamespace(trace=trace)


def test_idle_is_split_by_the_innermost_span(planted):
    """Idle 795 ns of the 1,000: each span's share is its interval's
    idle time less its children's."""
    split = program_spans.idle_by_span(planted)
    assert split == pytest.approx({
        "between spans": 70e-6, "perfbench.step": 60e-6,
        "perfbench.submit": 30e-6, "service.step": 40e-6,
        "session.search": 30e-6, "backend.prep": 10e-6,
        "backend.walk": 200e-6, "engine.replay": 100e-6,
        "backend.readback": 101e-6, "backend.stats": 154e-6})
    assert sum(split.values()) == pytest.approx(795e-6)
    assert list(split)[0] == "backend.walk"     # largest first
    # inside the benchmark's step: 695 ns, of which the layers below
    # session.search hold 565
    assert program_spans.resolved_share(planted) == pytest.approx(565 / 695)


def test_each_readback_ends_after_the_copy_inside_it(planted):
    assert program_spans.readback_lags_us(planted) == pytest.approx([1e-3])


@pytest.mark.parametrize("metric, value", [
    ("dims_read_share.batch", 25.0), ("fit_s", 400e-9),
    ("layout_s", 100e-9), ("capture_s", None)])
def test_each_reader_on_planted_spans(planted, metric, value):
    """Counters summed over the window's searches; set-up spans from the
    run's fit to the window (no ``engine.*`` span planted: ``None``)."""
    got = harness.Cell("gist1m.batch100").reader(metric).read(planted)
    if value is None:
        assert got is None
    else:
        assert got == pytest.approx(value)

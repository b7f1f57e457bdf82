"""The program's own spans in one run of a cell, and the device's idle
time split by them.

The port records spans at its layer boundaries (``repro_torch.utils.
trace``), on the clock of the profiler's events.  Its hot-path spans are
recorded while a profiler runs, so a traced run holds those of its traced
part; its set-up spans (fit, layout, capture) are recorded always.  The
readers of ``metrics/`` take them from here, and every function returns
``None`` where the run holds none (an untraced run, or a program without
the recorder):

- :func:`hot`: the spans that start inside the traced window;
- :func:`setup`: the spans that start between the run's last ``open.fit``
  and the window;
- :func:`idle_by_span`: the device's idle time in the window, split by
  the innermost span, the program's or the benchmark's, the host was in.

Run as a script, it makes one traced run of a cell as the benchmark does
and prints that split, the readers' values and the shared clock's check
(every ``backend.readback`` against the last device operation that starts
inside it), as one JSON line::

    python3 perfbench/program_spans.py --workload gist1m.serve --seed 5 --seconds 20

The line also holds the window's end-to-end metrics but recall (the run
is not judged).
"""
from __future__ import annotations

import bisect

#: the host waiting for the device's results
READBACK = "backend.readback"
#: benchmark spans (``devtrace.span``) the idle split descends from
BENCH_SPANS = ("step", "search")


def recorded() -> list | None:
    """Every span the program's recorder holds, or ``None`` without one."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    return trace.spans()


def hot(run, name: str | None = None) -> list | None:
    """The program's spans (named ``name``) that start inside the traced
    window, or ``None`` where there are none."""
    spans = recorded()
    if run.trace is None or not spans:
        return None
    lo, hi = run.trace.window
    out = [s for s in spans if lo <= s.start_ns <= hi
           and (name is None or s.name == name)]
    return out or None


def setup(run, names: tuple) -> list | None:
    """The set-up spans named in ``names`` that start between the start
    of the run's last ``open.fit`` and the traced window, or ``None``."""
    spans = recorded()
    if run.trace is None or not spans:
        return None
    lo = fit_span(run, spans)
    if lo is None:
        return None
    out = [s for s in spans if s.name in names
           and lo.start_ns <= s.start_ns < run.trace.window[0]]
    return out or None


def fit_span(run, spans: list):
    """The run's ``open.fit``: the last one to start before the window."""
    fits = [s for s in spans if s.name == "open.fit"
            and s.start_ns < run.trace.window[0]]
    return max(fits, key=lambda s: s.start_ns) if fits else None


def children(spans: list) -> dict:
    """Span id -> the spans whose parent it is."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def self_ns(span, kids: dict) -> int:
    """A span's duration less the part its children cover (children of
    one thread nest, so they do not overlap)."""
    return span.duration_ns - sum(c.duration_ns
                                  for c in kids.get(span.id, ()))


class _Idle:
    """The device's idle time in the window, as a function of time."""

    def __init__(self, trace):
        lo, hi = trace.window
        gaps, t = [], lo
        for s, e in trace.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        self.starts = [g[0] for g in gaps]
        self.gaps = gaps
        self.cum = [0]
        for s, e in gaps:
            self.cum.append(self.cum[-1] + e - s)
        self.lo, self.hi = lo, hi

    def before(self, t: int) -> int:
        """Idle ns in [window start, t]."""
        t = min(max(t, self.lo), self.hi)
        j = bisect.bisect_right(self.starts, t)
        if j == 0:
            return 0
        s, e = self.gaps[j - 1]
        return self.cum[j - 1] + min(t, e) - s

    def within(self, s: int, e: int) -> int:
        return self.before(e) - self.before(s)


def _own_idle(run) -> list | None:
    """(name, idle ns the span holds less its children's, the benchmark
    span it lies in or ``None``) for every program and benchmark span of
    the window, and ``("between spans", ns, None)``.  A span's idle time is
    the intersection of its interval with the device's idle intervals."""
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    idle = _Idle(t)
    prog = hot(run) or []
    by_id = {s.id: s for s in prog}
    bench = [("perfbench." + n, b, e) for n, b, e in t.spans]
    held = {s.id: idle.within(s.start_ns, s.end_ns) for s in prog}
    below: dict = {}            # node -> idle ns its children hold
    root: dict = {}             # program span id -> benchmark span index
    for s in sorted(prog, key=lambda x: x.start_ns):
        if s.parent in by_id:
            key = ("p", s.parent)
            root[s.id] = root.get(s.parent)
        else:
            # a span with no parent in the window hangs from the shortest
            # benchmark span that holds its start
            holders = [(e - b, i) for i, (_, b, e) in enumerate(bench)
                       if b <= s.start_ns <= e]
            root[s.id] = min(holders)[1] if holders else None
            key = None if root[s.id] is None else ("b", root[s.id])
        below[key] = below.get(key, 0) + held[s.id]
    out = [(s.name, held[s.id] - below.get(("p", s.id), 0),
            None if root[s.id] is None else bench[root[s.id]][0])
           for s in prog]
    top = 0
    for i, (n, b, e) in enumerate(bench):
        inner = idle.within(b, e)
        top += inner
        out.append((n, inner - below.get(("b", i), 0), n))
    out.append(("between spans", idle.cum[-1] - top - below.get(None, 0),
                None))
    return out


def idle_by_span(run) -> dict | None:
    """The device's idle ms in the traced window by the innermost span
    the host was in: a program span under its name, a benchmark span as
    ``perfbench.<name>``, and ``between spans``."""
    own = _own_idle(run)
    if own is None:
        return None
    out: dict = {}
    for name, ns, _ in own:
        out[name] = out.get(name, 0) + ns
    return {n: v / 1e6 for n, v in sorted(out.items(), key=lambda kv: -kv[1])}


def resolved_share(run) -> float | None:
    """The share of the idle time inside the benchmark's ``step`` and
    ``search`` spans that a program span other than ``service.step`` and
    ``session.search`` holds (their self time is the unresolved part)."""
    own = _own_idle(run)
    if own is None:
        return None
    bench = {"perfbench." + n for n in BENCH_SPANS}
    inside = [(name, ns) for name, ns, root in own if root in bench]
    total = sum(ns for _, ns in inside)
    held = sum(ns for name, ns in inside if not name.startswith(
        "perfbench.") and name not in ("service.step", "session.search"))
    return held / total if total > 0 else None


def readback_lags_us(run) -> list | None:
    """For each ``backend.readback`` in the window: its end less the end
    of the last device operation that starts inside it, in us (the
    shared clock puts it at or just above 0)."""
    rb = hot(run, READBACK)
    if not rb:
        return None
    ops = run.trace.ops
    starts = [o[1] for o in ops]
    out = []
    for s in rb:
        j = bisect.bisect_right(starts, s.end_ns)
        inside = ops[bisect.bisect_left(starts, s.start_ns):j]
        if inside:
            out.append((s.end_ns - max(o[2] for o in inside)) / 1e3)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench.run import _caches, _paths
    _paths()
    _caches()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    from repro_torch.utils import trace
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    run, _, _ = harness.measure(cell, args.seed, args.seconds, True)
    split = idle_by_span(run)
    lags = readback_lags_us(run)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0),
           "per_layer": {m["name"]: cell.reader(m["name"]).read(run)
                         for m in cell.per_layer},
           "idle_ms_by_span": split,
           "resolved_share": resolved_share(run),
           "window_ms": run.trace.window_s * 1e3,
           "readback_lag_us": None if not lags else
           {"min": min(lags), "max": max(lags), "n": len(lags)},
           "end_to_end": {m["name"]: cell.reader(m["name"]).read(run)
                          for m in cell.end_to_end
                          if m["name"] != "recall_at_10"},
           "dropped": trace.dropped()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Spans around the calls into the program, and the reading of a device
trace taken with ``torch.profiler``.

The benchmark's own spans (``span("search")`` etc.) are profiler
annotations: they cost nothing measurable when no profiler runs, and in
a traced run they label what the host was doing in each idle gap of the
device.  ``Trace.read`` sums the profiler's raw events directly (the
Python event tree of ``key_averages()`` costs about 80 us an event).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

SPAN_PREFIX = "perfbench."
WINDOW = SPAN_PREFIX + "traced_window"
#: entries of each list of the breakdown
TOP = 10


def span(name: str):
    """A span named ``perfbench.<name>`` around a call into the program."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Trace:
    """What a traced window held: each device operation's name and
    interval, the benchmark's spans, and the window's bounds (ns)."""

    ops: list = field(default_factory=list)      # (name, start, end)
    spans: list = field(default_factory=list)    # (name, start, end)
    window: tuple = (0, 0)

    @classmethod
    def read(cls, prof) -> "Trace":
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        t = cls()
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.name().startswith(SPAN_PREFIX):
                # the spans show on the device's timeline too: not work
                if e.device_type() == cuda:
                    continue
                if e.name() == WINDOW:
                    t.window = (start, end)
                else:
                    t.spans.append((e.name()[len(SPAN_PREFIX):], start, end))
            elif e.device_type() == cuda:
                t.ops.append((e.name(), start, end))
        t.ops.sort(key=lambda o: o[1])
        return t

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window: sorted, disjoint (start, end) pairs."""
        lo, hi = self.window
        out: list = []
        for _, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernels(self) -> list:
        """Device operations other than copies and fills of memory."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset"))]

    def device_seconds(self, substring: str) -> float:
        """Summed device time of the operations whose name holds
        ``substring``."""
        return sum(e - s for n, s, e in self.ops if substring in n) / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time, summed by name, and
        the longest idle gaps of the device, each named by the innermost
        benchmark span the host was in at the gap's middle."""
        by_name: dict = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        edges = [self.window[0]]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window[1])
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:TOP]
        return {
            "device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[self.host_at((s + e) // 2), ns / 1e9]
                          for ns, s, e in gaps],
        }

    def host_at(self, t: int) -> str:
        inside = [(e - s, n) for n, s, e in self.spans if s <= t <= e]
        return min(inside)[1] if inside else "between spans"


@contextlib.contextmanager
def traced(out: list, device):
    """Run the body under torch.profiler inside the window span, the
    device's operations traced when ``device`` is a CUDA card; append the
    read ``Trace`` to ``out`` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
    out.append(Trace.read(prof))

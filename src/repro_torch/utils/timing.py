"""Tiny wall-clock measurement helpers shared by benchmarks.

The port's own copy of the reference package's ``utils/timing.py``: the
same API on the host clock (``time.perf_counter``).  A call that
launches work on a CUDA card returns before the card has done it, so a
caller that times one synchronises inside ``fn`` (or times with CUDA
events instead).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Accumulating named timer: ``with timer('phase'): ...``."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_us(self, name: str) -> float:
        return 1e6 * self.totals.get(name, 0.0) / max(1, self.counts.get(name, 0))


def bench_call(fn, *args, warmup: int = 2, iters: int = 5, **kwargs):
    """Return (mean_seconds, last_result) for ``fn(*args, **kwargs)``."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters, result

"""The program's spans and counters, in memory, on the profiler's clock.

A span is one call across a layer boundary: its name, its start and end
in ``time.time_ns()`` (the Unix-epoch nanoseconds that ``torch.profiler``
stamps its events with, so spans and device operations share one clock),
its id, the id of its parent (the innermost span open on the same thread
when it began), its attributes and the counters added to it::

    from repro_torch.utils import trace

    with trace.span("session.search") as sp:     # the hot path
        ...
        if sp:                                   # recorded: count
            trace.count("dims_read", n)          # to the innermost span
    with trace.setup_span("backend.layout"):     # recorded always
        ...
    with trace.recording():                      # record the hot path
        sess.search(Q, k=10)
    trace.spans()                                # the closed spans

Hot-path spans (:func:`span`) are recorded only inside :func:`recording`
or while a torch profiler runs (``torch.autograd.profiler.
_is_profiler_enabled``, read at each call).  Otherwise a span site reads
that flag and returns one shared no-op context: it reads no clock and
records nothing.  Set-up spans (:func:`setup_span`) mark work done once
per index, write or shape, and are recorded always.  The store keeps the
last ``CAPACITY`` closed spans; :func:`dropped` counts those it lost.

Nothing here opens a ``torch.profiler`` range: kineto mirrors each such
range onto the device's timeline as a CUDA-typed event, which a reader of
the device trace counts as device work, and each costs ~14 us even with
no profiler running.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch.autograd.profiler as _profiler

#: closed spans the store keeps
CAPACITY = 65_536


class Span:
    """One recorded span; a context manager that opens and closes it.
    ``end_ns`` is ``None`` while it is open."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs",
                 "counters", "_rec")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.counters: dict = {}
        self.id = self.parent = self.start_ns = self.end_ns = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        self._rec._open(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        self.end_ns = time.time_ns()
        if kind is not None:
            self.attrs["error"] = kind.__name__
        self._rec._close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"start_ns={self.start_ns}, end_ns={self.end_ns})")


class _Off:
    """The shared context of a span site that records nothing; false."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


OFF = _Off()


class Recorder:
    """A bounded store of closed spans, the stack of open ones on each
    thread, and the switch of :meth:`recording`."""

    def __init__(self, capacity: int = CAPACITY):
        self._store: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._on = 0
        self._dropped = 0

    def span(self, name: str, **attrs):
        """A hot-path span: recorded inside :meth:`recording` or while a
        torch profiler runs, else the shared no-op context ``OFF``."""
        if not (self._on or _profiler._is_profiler_enabled):
            return OFF
        return Span(self, name, attrs)

    def setup_span(self, name: str, **attrs) -> Span:
        """A set-up span, recorded always."""
        return Span(self, name, attrs)

    def count(self, name: str, n) -> None:
        """Add ``n`` to the counter ``name`` of the innermost span open on
        this thread (nothing when none is)."""
        stack = getattr(self._local, "stack", None)
        if stack:
            counters = stack[-1].counters
            counters[name] = counters.get(name, 0) + n

    @contextmanager
    def recording(self):
        """Record hot-path spans for the body (nestable)."""
        with self._lock:
            self._on += 1
        try:
            yield
        finally:
            with self._lock:
                self._on -= 1

    def spans(self) -> list:
        """The closed spans the store holds, oldest first."""
        with self._lock:
            return list(self._store)

    def dropped(self) -> int:
        """Closed spans the full store let go since the last clear."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._dropped = 0

    def _open(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        span.id = next(self._ids)
        span.parent = stack[-1].id if stack else None
        stack.append(span)

    def _close(self, span: Span) -> None:
        self._local.stack.pop()
        with self._lock:
            if len(self._store) == self._store.maxlen:
                self._dropped += 1
            self._store.append(span)


#: the process's recorder, which the functions below use
RECORDER = Recorder()
span = RECORDER.span
setup_span = RECORDER.setup_span
count = RECORDER.count
recording = RECORDER.recording
spans = RECORDER.spans
dropped = RECORDER.dropped
clear = RECORDER.clear

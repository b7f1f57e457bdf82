"""An open loop of single queries through the serving front, on the real
clock.

Requests are due at Poisson arrival times of a fixed rate, whatever the
service does: independent users of a search front.  The gaps between
arrivals are one fixed set drawn from the mix's ``arrival_seed``; the
run's seed shuffles their order and picks each request's query from the
pool.  Each request is submitted as soon as the loop gets control after
it is due and is stamped with its due time, so its latency, ``t_done``
minus the due time, counts every wait a stall imposes.  Mix parameters:
``rate_per_s``, ``slots``, ``k``, ``arrival_seed``, ``trace_s``,
``drain_s`` (how long past the window's close the loop waits for the
last answers).  The service takes the configuration's ``search``
keywords (``nprobe``).
"""
from __future__ import annotations

import math
import time

import numpy as np

from perfbench.devtrace import span


def _arrivals(run, seconds: float) -> np.ndarray:
    p = run.traffic
    rate = float(p["rate_per_s"])
    span_s = seconds + float(p["trace_s"])
    m = int(math.ceil(rate * span_s * 1.25)) + 64
    gaps = np.random.default_rng(int(p["arrival_seed"])).exponential(
        1.0 / rate, m)
    gaps = np.random.default_rng([run.seed, 19]).permutation(gaps)
    return np.cumsum(gaps)


def warm(run) -> None:
    """Two full steps of the service's one shape (``slots`` queries,
    padded): the first lays the corpus out and captures the graphs."""
    p = run.traffic
    run.service = run.session.serve(slots=int(p["slots"]), k=run.k,
                                    **run.search)
    rng = np.random.default_rng([run.seed, 18])
    for _ in range(2):
        for i in rng.integers(0, run.pool.shape[0], int(p["slots"])):
            run.service.submit(run.pool[i])
        with span("warm"):
            run.service.step()
    run.tickets = []      # (ticket, pool row, due offset, due clock time)


def _serve(run, due: np.ndarray, qidx: np.ndarray, t0: float,
           start: int, until: float) -> int:
    """Submit every request due before ``until`` (seconds after ``t0``)
    and step the service meanwhile; returns the next request's index.
    Requests that fell due during the last step are submitted before it
    returns, so every request due before ``until`` is offered."""
    svc, i = run.service, start
    while True:
        now = time.perf_counter() - t0
        while i < len(due) and due[i] <= min(now, until):
            with span("submit"):
                t = svc.submit(run.pool[qidx[i]], now=t0 + due[i])
            run.tickets.append((t, int(qidx[i]), float(due[i]), t0 + due[i]))
            i += 1
        if now >= until:
            return i
        if svc.pending:
            with span("step"):
                svc.step()
        else:
            time.sleep(max(0.0, min(due[i] if i < len(due) else until,
                                    until) - now))


def window(run, seconds: float) -> None:
    due = _arrivals(run, seconds)
    run.qidx = np.random.default_rng([run.seed, 20]).integers(
        0, run.pool.shape[0], len(due))
    run.due = due
    run.t0 = time.perf_counter()
    run.next_i = _serve(run, due, run.qidx, run.t0, 0, seconds)
    run.result.update(window_s=seconds, offered=int((due < seconds).sum()),
                      backlog_at_close=run.service.pending)


def traced(run) -> None:
    """The same arrivals, on past the window's close, for ``trace_s``.
    They resume when the profiler has started, so the requests that fell
    due while it started do not arrive as one burst."""
    start = run.next_i
    t0 = time.perf_counter() - run.due[start]
    until = run.due[start] + float(run.traffic["trace_s"])
    run.next_i = _serve(run, run.due, run.qidx, t0, start, until)
    run.traced_work.update(queries=run.next_i - start)


def finish(run) -> None:
    """Serve what is still queued (no new arrivals), at most ``drain_s``
    past the close, then hand every answered ticket to the check.  A
    request that never ended answered (shed, timed out, failed, or still
    queued) counts in ``not_done``; an answer whose certificate was
    withdrawn or never given, in ``uncertified``."""
    svc = run.service
    t_end = time.perf_counter() + float(run.traffic["drain_s"])
    while svc.pending and time.perf_counter() < t_end:
        with span("step"):
            svc.step()
    for t, qi, _, _ in run.tickets:
        if t.status == "done":
            run.answer(np.array([qi]), t.ids[None, :], t.dists[None, :],
                       None if t.certified is None
                       else np.array([not t.certified]))
        else:
            run.not_done += 1
    run.result["requests"] = [
        {"due_s": due, "status": t.status,
         "latency_s": None if t.t_done is None else t.t_done - at,
         "service_s": t.service_s, "batch_size": t.batch_size}
        for t, _, due, at in run.tickets]

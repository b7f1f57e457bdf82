"""A closed loop of one client sending batches of queries.

The client sends its next batch of ``batch`` queries only when the last
one has come back, as a caller that waits for its reply does (the ANN
field's batch protocol).  Batches are consecutive slices of a permutation
of the pool drawn from the seed, reshuffled at each pass, so every seed
sends the same sizes in another order.  Mix parameters: ``batch``, ``k``,
``pool`` (``"in_distribution"`` or ``"ood"``), ``ood_severity``,
``trace_s`` (the least time traced; whole batches).  Every search takes
the configuration's ``search`` keywords.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.devtrace import span


class _Order:
    def __init__(self, n_pool: int, batch: int, rng):
        self.n, self.batch, self.rng = n_pool, batch, rng
        self.perm, self.at = rng.permutation(n_pool), 0

    def next(self) -> np.ndarray:
        out = []
        need = self.batch
        while need:
            if self.at == self.n:
                self.perm, self.at = self.rng.permutation(self.n), 0
            take = min(need, self.n - self.at)
            out.append(self.perm[self.at:self.at + take])
            self.at += take
            need -= take
        return np.concatenate(out)


def _search(run, idx, label):
    with span(label):
        res = run.session.search(run.pool[idx], run.k, **run.search)
    run.answer(idx, res.ids, res.dists,
               res.stats.extra.get("uncertified_mask"))


def warm(run) -> None:
    """Two batches of the cell's own shape: the first lays the corpus out
    and captures the block walk's graphs, the second replays them."""
    run.order = _Order(run.pool.shape[0], int(run.traffic["batch"]),
                       np.random.default_rng([run.seed, 17]))
    warm_order = _Order(run.pool.shape[0], int(run.traffic["batch"]),
                        np.random.default_rng([run.seed, 18]))
    for _ in range(2):
        with span("warm"):
            run.session.search(run.pool[warm_order.next()], run.k,
                               **run.search)


def window(run, seconds: float) -> None:
    """Batches back to back until ``seconds`` have passed; the last batch
    ends the window."""
    t0 = time.perf_counter()
    n, ends = 0, []
    while True:
        idx = run.order.next()
        _search(run, idx, "search")
        n += len(idx)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    run.result.update(queries=n, batches=len(ends), elapsed_s=ends[-1],
                      batch_ends_s=ends)


def traced(run) -> None:
    """Whole batches until ``trace_s`` have passed (at least one)."""
    t0 = time.perf_counter()
    n = batches = 0
    while not batches or time.perf_counter() - t0 < float(run.traffic["trace_s"]):
        idx = run.order.next()
        _search(run, idx, "search")
        n += len(idx)
        batches += 1
    run.traced_work.update(queries=n, batches=batches,
                           batch=int(run.traffic["batch"]))


def finish(run) -> None:
    """Nothing is left in flight in a closed loop."""

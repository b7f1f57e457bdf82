"""HNSW with pluggable DCO methods (paper §IV-C: HNSW on CPUs).

A numpy copy of the reference package's ``search/hnsw.py``: the same seed
gives the same graph in both packages.  Host-side implementation (graph
walks run no kernel — DESIGN.md §3);
distance comparisons are routed through the method's staged screening in
*neighbor batches* (a node's adjacency list is screened as one block, which
is the batched analogue of per-edge DCOs and what a SIMD CPU build does too).

The DCO contract during search: a neighbor whose distance is proven > tau
(the current worst of the ef result set) is discarded WITHOUT an exact
distance — that is exactly where the paper's methods save time, and where
approximate methods may lose recall.

All entry points take a ``QueryBatch`` (prepped ctx + schedule + stats), so
there is no hidden schedule state on the index: build/insert/search each
carry their own batch and the graph object holds only the graph.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.engine import QueryBatch, ScanStats


class HNSWIndex:
    def __init__(self, m: int = 16, ef_construction: int = 100, *, seed: int = 0):
        self.m = m
        self.m0 = 2 * m
        self.efc = ef_construction
        self.rng = np.random.default_rng(seed)
        self.levels: list[int] = []
        self.links: list[list[np.ndarray]] = []   # node -> per-level neighbor ids
        self.entry = -1
        self.max_level = -1
        self.ml = 1.0 / np.log(m)

    # ------------------------------------------------------------------
    def _screen_batch(self, method, batch, qi, ids, tau_sq):
        """Staged screening + exact completion for a neighbor batch.
        Returns (surviving ids, exact squared distances)."""
        ids = np.asarray(ids, np.int64)
        D = method.state["D"]
        stats = batch.stats
        if stats is not None:
            stats.n_dco += len(ids)
            stats.dims_total += len(ids) * D
        alive = ids
        if np.isfinite(tau_sq):
            for d in method.stage_dims(batch.schedule):
                if len(alive) == 0:
                    break
                keep, charged = method.screen(alive, batch.ctx, qi, max(d, 1), tau_sq)
                if stats is not None:
                    stats.dims_scanned += len(alive) * charged
                alive = alive[keep]
        if len(alive) == 0:
            return alive, np.empty(0, np.float32)
        if stats is not None:
            stats.dims_scanned += len(alive) * D
        return alive, method.exact_sq(alive, batch.ctx, qi)

    def _search_layer(self, method, batch, qi, entry_ids, entry_ds, level, ef):
        """Classic ef-bounded best-first search on one layer."""
        visited = set(int(i) for i in entry_ids)
        cand = [(float(d), int(i)) for d, i in zip(entry_ds, entry_ids)]
        heapq.heapify(cand)
        result = [(-float(d), int(i)) for d, i in zip(entry_ds, entry_ids)]
        heapq.heapify(result)
        while cand:
            d, u = heapq.heappop(cand)
            if len(result) >= ef and d > -result[0][0]:
                break
            nbrs = [v for v in self.links[u][level] if v not in visited]
            if not nbrs:
                continue
            visited.update(int(v) for v in nbrs)
            tau = -result[0][0] if len(result) >= ef else np.inf
            alive, ex = self._screen_batch(method, batch, qi, nbrs, tau)
            for dv, v in zip(ex, alive):
                dv, v = float(dv), int(v)
                if len(result) < ef or dv < -result[0][0]:
                    heapq.heappush(cand, (dv, v))
                    heapq.heappush(result, (-dv, v))
                    if len(result) > ef:
                        heapq.heappop(result)
        out = sorted(((-nd, i) for nd, i in result))
        return ([d for d, _ in out], [i for _, i in out])

    # ------------------------------------------------------------------
    def build(self, X: np.ndarray, *, method, schedule=None,
              stats: ScanStats | None = None) -> "HNSWIndex":
        """Incremental construction; ``method`` must already be fitted on X
        (or be fitted-and-appended in lockstep for the dynamic scenario)."""
        X = np.asarray(X, np.float32)
        sched = schedule if schedule is not None else []
        batch = QueryBatch.create(method, X, sched, stats)  # nodes double as queries
        for i in range(X.shape[0]):
            self._insert_one(method, batch, i)
        return self

    def insert_batch(self, method, Xnew: np.ndarray, stats=None, schedule=None):
        """Dynamic insertion (paper §V-E): append to method state, then link."""
        start = method.state["N"]
        method.append(Xnew)
        sched = schedule if schedule is not None else []
        batch = QueryBatch.create(method, Xnew, sched, stats)
        for j in range(Xnew.shape[0]):
            self._insert_one(method, batch, j, node_id=start + j)

    def _insert_one(self, method, batch, qi, node_id=None):
        node = len(self.levels) if node_id is None else node_id
        level = int(-np.log(max(self.rng.random(), 1e-12)) * self.ml)
        while len(self.levels) <= node:
            self.levels.append(0)
            self.links.append([])
        self.levels[node] = level
        self.links[node] = [np.empty(0, np.int64) for _ in range(level + 1)]
        if self.entry < 0:
            self.entry, self.max_level = node, level
            return
        eps = [self.entry]
        epd = [float(method.exact_sq(np.array([self.entry]), batch.ctx, qi)[0])]
        for lv in range(self.max_level, level, -1):
            epd, eps = self._search_layer(method, batch, qi, eps, epd, lv, 1)
        for lv in range(min(level, self.max_level), -1, -1):
            ds, ids = self._search_layer(method, batch, qi, eps, epd, lv, self.efc)
            mmax = self.m0 if lv == 0 else self.m
            nbrs = np.asarray(ids[: self.m], np.int64)
            self.links[node][lv] = nbrs
            for v in nbrs:                         # bidirectional + degree cap
                lk = self.links[v][lv]
                lk = np.append(lk, node)
                if len(lk) > mmax:
                    dd = method.exact_sq(lk, batch.ctx, qi)   # prune farthest from new node's view
                    lk = lk[np.argsort(dd)[:mmax]]
                self.links[v][lv] = lk
            eps, epd = ids, ds
        if level > self.max_level:
            self.entry, self.max_level = node, level

    # ------------------------------------------------------------------
    def search(self, method, batch: QueryBatch, qi: int, k: int, ef: int):
        eps = [self.entry]
        epd = [float(method.exact_sq(np.array([self.entry]), batch.ctx, qi)[0])]
        for lv in range(self.max_level, 0, -1):
            epd, eps = self._search_layer(method, batch, qi, eps, epd, lv, 1)
        ds, ids = self._search_layer(method, batch, qi, eps, epd, 0, max(ef, k))
        return np.asarray(ds[:k], np.float32), np.asarray(ids[:k], np.int64)

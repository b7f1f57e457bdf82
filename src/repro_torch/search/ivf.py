"""IVF index with pluggable DCO methods (paper §IV-C: IVF on accelerators).

A numpy copy of the reference package's ``search/ivf.py``: the same seed
gives the same centroids and lists in both packages.

Build: batched-Lloyd k-means over the base vectors -> ``n_list`` partitions.
Search: rank partitions by centroid distance, take ``nprobe``, run the DCO
engine over their concatenated candidate lists.

Construction itself can be DCO-accelerated (paper §V-D): the assignment step
is a top-1 search over centroids, which we route through the same staged
screening when a method is supplied.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.engine import QueryBatch, scan_topk
from repro_torch.core.transforms import cluster_sums


def _kmeans_assign(X, cent, *, method=None, schedule=None, stats=None, block=8192):
    """Nearest-centroid assignment; optionally DCO-screened (top-1 search)."""
    n = X.shape[0]
    out = np.empty(n, np.int64)
    if method is None:
        cn = (cent ** 2).sum(1)
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            d2 = cn[None] - 2.0 * X[lo:hi] @ cent.T
            out[lo:hi] = d2.argmin(1)
        return out
    batch = QueryBatch.create(method, X, schedule, stats)  # base rows as queries
    ids = np.arange(cent.shape[0])
    for i in range(n):
        # small blocks so the running top-1 threshold starts pruning early
        _, bi = scan_topk(method, batch, i, ids, 1, block=32)
        out[i] = bi[0]
    return out


class IVFIndex:
    def __init__(self, n_list: int = 256, *, seed: int = 0, kmeans_iters: int = 10):
        self.n_list = n_list
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.centroids: np.ndarray | None = None
        self.lists: list | None = None          # list of np.int64 arrays
        self.n = 0
        self.build_seconds: dict = {}   # host wall of Lloyd / assignment

    # -- construction --------------------------------------------------------
    def build(self, X: np.ndarray, *, method=None, schedule=None) -> "IVFIndex":
        """K-means + partition fill.  ``method`` accelerates the assignment
        DCOs during construction (Fig. 9 scenario); the final layout is
        identical for all methods (paper App. A: fixed data layout)."""
        X = np.asarray(X, np.float32)
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        k = min(self.n_list, max(1, n // 8))
        cent = X[rng.choice(n, k, replace=False)].copy()
        sub = X[rng.choice(n, min(n, 50_000), replace=False)]
        for _ in range(self.kmeans_iters):           # Lloyd on a training slice
            a = _kmeans_assign(sub, cent)
            sums, cnt = cluster_sums(sub, a, k)
            cnt = cnt.astype(np.float64)
            upd = cnt > 0
            cent[upd] = (sums[upd] / cnt[upd, None]).astype(np.float32)
        t1 = time.perf_counter()
        # final assignment pass is where DCO acceleration bites (n x k DCOs)
        assign = _kmeans_assign(X, cent, method=method, schedule=schedule)
        self.centroids = cent
        # each partition's rows in ascending order, as np.where gives them
        order = np.argsort(assign, kind="stable").astype(np.int64)
        self.lists = np.split(order, np.cumsum(np.bincount(
            assign, minlength=k))[:-1])
        self.build_seconds = {"lloyd": t1 - t0,
                              "assign": time.perf_counter() - t1}
        self.n = n
        return self

    def insert(self, new_ids: np.ndarray, Xnew: np.ndarray,
               *, method=None, schedule=None) -> np.ndarray:
        """Dynamic inserts (paper §V-E): assign new vectors to partitions;
        DCO screening accelerates the assignment.  Returns the per-row
        partition assignment (the jax backend's delta segment needs it to
        probe delta rows without re-deriving the layout)."""
        a = _kmeans_assign(np.asarray(Xnew, np.float32), self.centroids,
                           method=method, schedule=schedule)
        for j, gid in zip(a, new_ids):
            self.lists[j] = np.append(self.lists[j], gid)
        self.n += len(new_ids)
        return a

    # -- search ---------------------------------------------------------------
    def probe_ids(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        d2 = ((self.centroids - q) ** 2).sum(1)
        order = np.argsort(d2)[:nprobe]
        lists = [self.lists[j] for j in order]
        return np.concatenate(lists) if lists else np.empty(0, np.int64)

    def search(self, method, batch: QueryBatch, qi: int, k: int, nprobe: int,
               *, policy=None, deadline_ts=None):
        """Probe ``nprobe`` partitions and run the staged DCO scan over their
        concatenated candidates; ``policy`` threads the adaptive fdscan
        fallback (core.policy) into the scan and ``deadline_ts`` its anytime
        deadline (DESIGN.md §7; coverage is over probed candidates)."""
        cands = self.probe_ids(batch.Q[qi], nprobe)
        return scan_topk(method, batch, qi, cands, k, policy=policy,
                         deadline_ts=deadline_ts)

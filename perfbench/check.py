"""The comparison that decides ``correct``.

Every answer the timed path returned (its ids and squared distances, as
the facade handed them back) is held against the float64 reference over
the same corpus and queries.  Two numbers are compared, each as a share
of the query's k-th reference distance, worst answer first:

- ``rank_gap``: how far the returned j-th row lies beyond the true j-th
  nearest distance (0 when the answer is the exact top-k in order; a
  missing neighbour, a wrong or repeated id, or a wrong order shows here);
- ``dist_err``: how far each returned distance lies from the float64
  distance of the row it names.

Two more hold the configuration's guarantee, each at 0: ``not_done``, the
requests that never ended answered (shed, timed out, failed, or still
queued after the drain), and ``uncertified``, the answers served without
the program's exactness certificate (a set bit of the result's
``uncertified_mask``, or no mask at all).

``recall_at_10`` (the share of the reference's ids found) is reported
beside them and is not a limit.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

#: queries handed to the reference at a time
QUERY_BLOCK = 1024


def compare(X: torch.Tensor, pool: torch.Tensor, qidx: np.ndarray,
            ids: np.ndarray, dists: np.ndarray, *, k: int) -> dict:
    """Judge answers: ``qidx`` (A,) rows of ``pool`` that were asked,
    ``ids`` (A, k) and ``dists`` (A, k) what came back.  ``X`` and
    ``pool`` are the benchmark's own corpus and queries, on the device
    the reference runs on.  Returns the numbers compared, the recall and
    the count of answers judged."""
    dev = pool.device
    qidx = np.asarray(qidx, np.int64)
    uniq, inv = np.unique(qidx, return_inverse=True)
    ref_d = torch.empty(len(uniq), k, dtype=torch.float64, device=dev)
    ref_i = torch.empty(len(uniq), k, dtype=torch.int64, device=dev)
    for lo in range(0, len(uniq), QUERY_BLOCK):
        sel = torch.as_tensor(uniq[lo:lo + QUERY_BLOCK], device=dev)
        d, i = reference.topk(X, pool[sel], k)
        ref_d[lo:lo + len(sel)], ref_i[lo:lo + len(sel)] = d, i
    inv_t = torch.as_tensor(inv, device=dev)
    got_i = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    got_d = torch.as_tensor(np.asarray(dists, np.float64), device=dev)
    valid = ((got_i >= 0) & (got_i < X.shape[0])).all(1)
    dup = (got_i.sort(1).values.diff(dim=1) == 0).any(1)
    scale = ref_d[inv_t, -1].clamp_min(1e-30)[:, None]
    true_d = torch.empty_like(got_d)
    for lo in range(0, len(qidx), QUERY_BLOCK):
        sl = slice(lo, lo + QUERY_BLOCK)
        true_d[sl] = reference.distances(
            X, pool[torch.as_tensor(qidx[sl], device=dev)],
            got_i[sl].clamp(0, X.shape[0] - 1))
    gap = ((true_d - ref_d[inv_t]) / scale).amax(1)
    err = ((got_d - true_d).abs() / scale).amax(1)
    bad = ~valid | dup
    gap[bad] = float("inf")
    err[bad] = float("inf")
    hits = (got_i[:, :, None] == ref_i[inv_t][:, None, :]).any(2).sum(1)
    return {
        "rank_gap": float(gap.max()) if len(qidx) else float("inf"),
        "dist_err": float(err.max()) if len(qidx) else float("inf"),
        "recall_at_10": float(hits.double().mean() / k) if len(qidx) else 0.0,
        "answers_checked": int(len(qidx)),
    }


def delivery(not_done: int, uncertified: int) -> dict:
    """The guarantee's two counts, under the names the limits use."""
    return {"not_done": int(not_done), "uncertified": int(uncertified)}


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number compared is at or under its limit."""
    return all(numbers[name] <= float(limit) for name, limit in limits.items())

#!/usr/bin/env python3
"""The IVF path's exactness certificate against its completion budget.

    PYTHONPATH=src python scripts/ivf_budget.py [--n 100000] \
        [--n-list 410] [--nprobe 6 64] [--budgets 128 512 4096] \
        [--nq 32] [--device cpu]

Draws the GIST-shaped synthetic corpus (960 dims) at ``--n`` rows, fits
PDScanning+ and builds an ``IVFIndex`` (seed 0) with the port, then
searches the first ``--nq`` queries at k = 10 through the device IVF probe
under each ``SchedulePolicy(block_capacity=...)`` and probe width, and
prints one JSON line each: the share of queries whose certificate failed,
the mean survivors, and how many queries return the exact IVF answer (the
port's host IVF, ``IVFIndex.search`` through ``scan_topk``).  A query's
first probed row block screens at tau = inf and its probed rows are near
neighbours, so a small budget drops rows whose lower bounds sit under the
final k-th distance.  The default n_list = 410 gives about 244 rows a
list, as n_list = 4096 does at 1M rows.  Runs on the CPU by default (the
plain versions of the kernels); ``--device cuda`` runs the kernels.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

K = 10


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--n-list", type=int, default=410)
    ap.add_argument("--nprobe", type=int, nargs="+", default=[6, 64])
    ap.add_argument("--budgets", type=int, nargs="+",
                    default=[128, 512, 4096])
    ap.add_argument("--nq", type=int, default=32)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    from repro_torch.core.engine import QueryBatch
    from repro_torch.search.ivf import IVFIndex
    from repro_torch.vecdata import load_dataset

    ds = load_dataset("gist", scale=args.n / 30_000)
    X, Q = ds.X, ds.Q[:args.nq]
    t0 = time.perf_counter()
    method = open_index(X, method="PDScanning+", device="cpu").method
    ivf = IVFIndex(n_list=args.n_list, seed=0).build(X)
    build_s = time.perf_counter() - t0
    batch = QueryBatch.create(method, Q)
    for nprobe in args.nprobe:
        host = np.stack([ivf.search(method, batch, qi, K, nprobe)[1]
                         for qi in range(Q.shape[0])])
        for budget in args.budgets:
            sess = SearchSession(method,
                                 SchedulePolicy(block_capacity=budget),
                                 index_kind="ivf", index=ivf,
                                 device=args.device)
            res = sess.search(Q, K, nprobe=nprobe)
            exact = (np.sort(res.ids, 1) == np.sort(host, 1)).all(1)
            print(json.dumps({
                "n": int(X.shape[0]), "n_list": args.n_list,
                "nprobe": nprobe, "block_capacity": budget,
                "nq": int(Q.shape[0]), "device": args.device,
                "uncertified_queries":
                    res.stats.extra["uncertified_queries"],
                "survivors_mean": res.stats.extra["survivors_mean"],
                "host_ivf_ids_equal": int(exact.sum()),
                "fit_and_build_s": build_s}), flush=True)


if __name__ == "__main__":
    main()

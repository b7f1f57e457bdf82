#!/usr/bin/env python3
"""QPS of the PDX layout's two stage-1 paths against the flat layout on one
CUDA card, batch for batch in turns.

    python3 scripts/pdx_ab.py [--n 1000000] [--pairs 10]

Fits PDScanning+ once on the GIST-shaped synthetic corpus (N x 960, 100
queries, k = 10) and serves it from three sessions held side by side: the
default flat layout ("flat"), ``SchedulePolicy(dim_groups=4)`` through the
``dco_scan_grouped`` kernel ("pdx") and the same layout through the
inline R-cut path, ``use_kernel=False`` ("rcut").  It times ``pairs``
rounds of 100-query batches, one batch per session a round, the order
reversed every other round (flat, pdx, rcut, rcut, pdx, flat, ...).  Each
wall ends in the device-to-host copy of the result; no profiler session
or CUDA graph runs in the process, since either leaves every later launch
slower on the host.  Prints one JSON line with every wall, the medians,
the quartiles, how many rounds the kernel path beat each other session,
and the card's name and power limit.  Needs a CUDA card; the flat and PDX
kernel paths must return the same ids, and the R-cut path the same ids on
every query it certifies.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pdx_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    from repro_torch.vecdata import load_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = load_dataset("gist", scale=args.n / 30_000)
    X, Q = ds.X, ds.Q
    flat = open_index(X, method="PDScanning+")
    sessions = {
        "flat": flat,
        "pdx": SearchSession(flat.method, SchedulePolicy(dim_groups=4)),
        "rcut": SearchSession(flat.method, SchedulePolicy(
            dim_groups=4, use_kernel=False)),
    }
    res = {key: s.search(Q, 10) for key, s in sessions.items()}  # warm
    if not np.array_equal(np.sort(res["flat"].ids, 1),
                          np.sort(res["pdx"].ids, 1)):
        raise AssertionError("the flat and PDX layouts return other ids")
    ok = ~res["rcut"].stats.extra["uncertified_mask"]
    if not np.array_equal(np.sort(res["rcut"].ids[ok], 1),
                          np.sort(res["pdx"].ids[ok], 1)):
        raise AssertionError("the R-cut path returns other ids on certified "
                             "queries")

    def pairs():
        walls = {key: [] for key in sessions}
        wins = {"pdx_over_flat": 0, "pdx_over_rcut": 0}
        for i in range(args.pairs):
            order = list(sessions) if i % 2 == 0 else list(sessions)[::-1]
            rnd = {}
            for key in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sessions[key].search(Q, 10)
                rnd[key] = time.perf_counter() - t0
                walls[key].append(rnd[key])
            wins["pdx_over_flat"] += rnd["pdx"] < rnd["flat"]
            wins["pdx_over_rcut"] += rnd["pdx"] < rnd["rcut"]
        return {"walls_s": walls,
                **{key: stats(w) for key, w in walls.items()},
                "wins": {key: int(v) for key, v in wins.items()},
                "rcut_certified_share": float(ok.mean()),
                "dims_read_mean": {
                    key: r.stats.extra["dims_read_mean"]
                    for key, r in res.items()}}

    def stats(w):
        q1, med, q3 = np.percentile(w, [25, 50, 75])
        return {"median_s": med, "q1_s": q1, "q3_s": q3,
                "qps_at_median": Q.shape[0] / med}

    result = pairs()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    print(json.dumps({
        "n": int(X.shape[0]), "dim": int(X.shape[1]), "nq": int(Q.shape[0]),
        "pairs": args.pairs, **result,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

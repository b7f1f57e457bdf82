#!/usr/bin/env python3
"""DDCopq recall against corpus size: the reference package and the port,
each fitted on its own, on the same corpus and queries.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ddcopq_recall_scaling.py \
        [--sizes 50000 100000 200000 300000] [--seeds 0 1]

For each size and dataset seed it draws the GIST-shaped synthetic corpus
(960 dims, 100 queries), fits DDCopq with ``repro.api.open_index`` (JAX
backend) and with ``repro_torch.api.open_index`` (torch backend on the
CPU), searches the queries at k = 10 with the default schedule, and prints
one JSON line: each side's recall@10, calibrated threshold and mean
survivors, and the overlap of the two sides' top-k sets.  Both packages
run on the CPU, so this needs no GPU; memory grows with the size (about
4 KB per row for each copy of the corpus).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

K = 10


def run(n: int, seed: int) -> dict:
    from repro.api import open_index as ref_open_index
    from repro_torch.api import open_index
    from repro_torch.vecdata import load_dataset, recall_at_k

    ds = load_dataset("gist", scale=n / 30_000, seed=seed)
    gt, _ = ds.ground_truth(K)
    out = {"n": int(ds.X.shape[0]), "dim": int(ds.X.shape[1]),
           "nq": int(ds.Q.shape[0]), "dataset_seed": seed}
    ids = {}
    for side, make in (("reference", lambda: ref_open_index(
            ds.X, method="DDCopq", backend="jax")),
                       ("port", lambda: open_index(
            ds.X, method="DDCopq", backend="torch", device="cpu"))):
        t0 = time.perf_counter()
        sess = make()
        res = sess.search(ds.Q, K)
        m = sess.method
        out[side] = {
            "recall_at_10": recall_at_k(res.ids, gt),
            "theta": float(m.state["models"][m.state["trained_k"]]),
            "survivors_mean": float(res.stats.extra["survivors_mean"]),
            "seconds": time.perf_counter() - t0,
        }
        ids[side] = np.asarray(res.ids)
        del sess, res
    out["id_overlap"] = recall_at_k(ids["port"], ids["reference"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[50_000, 100_000, 200_000, 300_000])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    for seed in args.seeds:
        for n in args.sizes:
            print(json.dumps(run(n, seed)), flush=True)


if __name__ == "__main__":
    main()

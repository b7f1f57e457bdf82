"""The readings that the limits of ``checks/<cell>.json`` are set from.

    python3 perfbench/readings.py --workload gist1m.batch100 \
        --seeds 11,12,13 --seconds 20 [--out readings.jsonl]

In one process, for each seed: one run of the cell as the benchmark runs
it (set-up, the window, the program's answers judged against the float64
reference), then the control: the reference computed in TF32 (the
precision below the configuration's float32) put in the program's place
for the same queries, judged the same way.  Prints one JSON line a seed
with both sets of numbers.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_answers(run, X, pool_dev) -> tuple:
    """The control in the program's place: for every query the program
    answered, the top-k of the TF32 search."""
    import numpy as np
    import torch
    from perfbench import check, reference
    qidx = run.answers()[0]
    uniq, inv = np.unique(qidx, return_inverse=True)
    ids, dists = [], []
    for lo in range(0, len(uniq), check.QUERY_BLOCK):
        sel = torch.as_tensor(uniq[lo:lo + check.QUERY_BLOCK],
                              device=pool_dev.device)
        d, i = reference.topk(X, pool_dev[sel], run.k, precision="tf32")
        ids.append(i.cpu().numpy())
        dists.append(d.float().cpu().numpy())
    return qidx, np.concatenate(ids)[inv], np.concatenate(dists)[inv]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import check, harness
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(args.workload)
        t0 = time.perf_counter()
        run, X, peak = harness.measure(cell, seed, args.seconds, False,
                                       device="cuda")
        t_ref = time.perf_counter()
        program = harness.compare(run, X)
        ref_s = time.perf_counter() - t_ref
        Xd = torch.as_tensor(X).to("cuda")
        pool = torch.as_tensor(run.pool).to("cuda")
        control = harness.compare(run, X,
                                answers=control_answers(run, Xd, pool))
        rec = {"workload": args.workload, "seed": seed,
               "program": program, "control": control,
               "program_correct": check.judge(program, cell.limits),
               "control_correct": check.judge(control, cell.limits),
               "setup_s": run.setup_s, "parts": run.parts,
               "window": {k: v for k, v in run.result.items()
                          if k != "requests"},
               "reference_s": ref_s, "memory_peak_bytes": peak,
               "run_s": time.perf_counter() - t0}
        del Xd, pool, run, X
        torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

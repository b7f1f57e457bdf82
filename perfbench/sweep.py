"""The one-time rate sweep of a serving cell, to find its knee.

    python3 perfbench/sweep.py --workload gist1m.serve --seed 5 \
        --rates 150,200,250,280,300 --seconds 15

One set-up, then for each rate the cell's open loop on the real clock for
``--seconds`` (the rate replaces the mix's), then a drain.  Prints one
JSON line a rate: offered and completed requests, the backlog when the
window closed, and the cell's own readers' p50, p95, median step and
batch fill.
The knee is the highest rate whose backlog does not grow; the cell's mix
offers a fixed share of it.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness, latency
    cell = harness.Cell(args.workload)
    t0 = time.perf_counter()
    run, X, peak = harness.measure(cell, args.seed, 1.0, False,
                                   device="cuda")
    print(json.dumps({"setup_s": run.setup_s, "parts": run.parts,
                      "first_window_s": time.perf_counter() - t0}), flush=True)
    # measure() freed the session; open one and keep it for every rate
    run.session = harness.open_session(run, X)
    cell.driver.warm(run)
    for rate in (float(r) for r in args.rates.split(",")):
        run.traffic = cell.traffic | {"rate_per_s": rate, "trace_s": 0.0}
        run.result, run._answers = {}, []
        run.tickets = []
        cell.driver.window(run, args.seconds)
        cell.driver.finish(run)
        reqs = latency.window_requests(run.result["requests"], args.seconds)
        print(json.dumps({
            "rate_per_s": rate, "offered": len(reqs),
            "done": len(latency.served(run)),
            "backlog_at_close": run.result["backlog_at_close"]}
            | {name: cell.reader(name).read(run) for name in
               ("p50_ms", "p95_ms", "step_ms.serve", "batch_fill.serve")}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

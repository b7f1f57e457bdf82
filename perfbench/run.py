"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload gist1m.batch100 --seed 7 \
        --seconds 20 --trace 0

Run from the root of a checkout that holds the port (``src/repro_torch``)
on a machine with a CUDA card.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` (with ``--trace 1`` also the traced window's ``busy_s`` and
``window_s``, and a ``breakdown``), and last ``checks``, each number
compared beside its limit; the same numbers end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """Import the benchmark as the package ``perfbench`` and the port from
    ``src``, never a sibling of this file as a top-level module."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there builds (the port builds its CUDA kernels under
    ``build/torch_ext``)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port under {ROOT / 'src' / 'repro_torch'}: run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    _paths()
    _caches()
    import torch
    from perfbench import harness
    cell = harness.Cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = harness.execute(cell, args.seed, args.seconds,
                                     bool(args.trace), device="cuda",
                                     t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

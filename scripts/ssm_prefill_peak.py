#!/usr/bin/env python3
"""Peak device memory and time of the SSM serving prefill at its
long-context shape, for one tree of the port, on one CUDA card.

    python3 scripts/ssm_prefill_peak.py [--src SRC_DIR]

mamba2-130m at its published widths and depth (random weights from
chip_smoke's SSM seed), ``prefill`` over 4 x 32,768 seeded tokens
(``prefill_32k`` cut from batch 32, as chip_smoke.py's ``ssm`` phase runs
it): ``torch.cuda.max_memory_allocated`` after a reset, and the wall of a
second prefill on the same inputs.  ``--src`` names the ``src`` directory
whose ``repro_torch`` is imported (default: this repository's), so two
trees compare in turns in one call on one card:

    python3 scripts/ssm_prefill_peak.py --src /tmp/parent/src
    python3 scripts/ssm_prefill_peak.py

Prints one JSON line.  Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

B, S, SEED = 4, 32_768, 22


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ssm_prefill_peak: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    api = build_model(get_arch("mamba2-130m"), device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    tokens = np.random.default_rng(SEED).integers(
        0, api.cfg.vocab, (B, S)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    logits, _ = api.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del logits
    t0 = time.perf_counter()
    logits, _ = api.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    print(json.dumps({"src": args.src, "batch": B, "seq": S,
                      "device_bytes_before": before,
                      "peak_device_bytes": peak,
                      "second_prefill_ms": (time.perf_counter() - t0) * 1e3,
                      "finite": bool(torch.isfinite(logits).all()),
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: continuous batching over a reduced or full config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --requests 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --full

The model runs on the CUDA card unless ``--device cpu`` is given; its
weights are random, drawn from ``--seed`` (no download).  ``--full``
serves the published widths and depth, else the family's reduced smoke
config.  Every family runs: the dense and VLM decoders,
seamless-m4t-large-v2 (its engine decodes against zero cross K/V, as the
reference's does), mamba2-130m, DeepSeek-V2/V3 and Jamba-v0.1 (whose
full configs, 236 B, 671 B and 52 B parameters, do not fit one card:
``chip_smoke.py`` serves them at a cut depth).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.backends import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # bf16 GEMMs accumulate in f32, as the reference's dots do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_arch(args.arch) if args.full else smoke_config(args.arch)
    api = build_model(cfg, device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, rng.integers(3, 10)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    eng = ServingEngine(api, slots=args.slots, max_len=128)
    t0 = time.perf_counter()
    out = eng.run(params, reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {total} tokens in {dt:.1f}s "
          f"({total/dt:.1f} tok/s) on {dev}")
    for rid in sorted(out):
        print(f"  req {rid}: {out[rid]}")
    return out


if __name__ == "__main__":
    main()

"""Training launcher: the end-to-end driver.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 50 \
      --smoke --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --batch 8 --seq 4096 --microbatches 2

The model trains on the CUDA card unless ``--device cpu`` is given, from
random masters drawn from seed 0.  ``--smoke`` swaps in the family's
reduced config; without it the published config is built, which for
OLMo-1B fits one card (f32 masters and moments, bf16 weights and grads:
about 19 GB before activations) and for the larger ones does not: this
launcher runs on one device, and a mesh's train step is
``make_train_step`` on ``build_model(cfg, mesh=...)`` in each rank
(``models.placement``).  ``--ckpt-dir`` runs the
checkpoint/restart driver (``--fail-at`` injects a crash at a step; a
second run with the same directory resumes from the newest checkpoint).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api.backends import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import RunShape
from repro_torch.data import TokenPipeline, make_batch_fn
from repro_torch.models import build_model
from repro_torch.train.fault import StepMonitor, run_resumable
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # bf16 GEMMs accumulate in f32, as the reference's dots do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    shape = RunShape("cli", args.seq, args.batch, "train")
    api = build_model(cfg, remat="block", device=dev)
    step_fn = make_train_step(api, microbatches=args.microbatches)
    state = init_state(api, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in state.params.values())
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M steps={args.steps} "
          f"device={dev}")
    batch_fn = make_batch_fn(cfg, shape)

    if args.ckpt_dir:
        mon = StepMonitor()
        state, last = run_resumable(step_fn, state, batch_fn,
                                    steps=args.steps, ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every,
                                    monitor=mon, fail_at=args.fail_at)
        print(f"finished at step {last}; stragglers={len(mon.stragglers)}")
        return state

    pipe = TokenPipeline(batch_fn)
    t0 = time.perf_counter()
    for step, batch in pipe.iter(0, args.steps):
        state, metrics = step_fn(state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:4d} loss {loss:.4f} "
                  f"({time.perf_counter()-t0:.1f}s)")
    return state


if __name__ == "__main__":
    main()

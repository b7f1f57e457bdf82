#!/usr/bin/env python3
"""What a launch of the port's scan and PQ kernels costs apart from its
work, on one CUDA card.

    python3 scripts/kernel_floor.py

At the PDX main path's launch shape (4 groups x 4096 rows x 32 dims, 16
queries; Gaussian data, each query's tau at the 0.5 % quantile of its
group-0 partials, so that about 300 of the 4096 rows keep a live pair
after group 0, as at 1M x 960) it times, each as device time per call in
a replayed CUDA graph (chip_smoke.cuda_ms):

  tiny_fill             a one-element fill: the floor of a graph node;
  zero_fill             the counts/dims zeroing every dco_scan* op issues;
  grouped_op            dco_scan_grouped_op (zero fill + kernel);
  grouped_kernel        the kernel alone, on pre-zeroed outputs;
  grouped_kernel_no_live  the same with every tau = -1 (no pair alive:
                        staging, gating and the writes only);
  grouped_kernel_g1     group 0 only;
  grouped_kernel_all_alive  tau = 1e9 (every pair alive in every group);
  tiled_kernel          the earlier grouped design on the same inputs;
  flat_op               dco_scan_op on the same rows and queries, laid out
                        flat (4096 x 128, the flat main path's launch
                        shape, block_n 256): the kernel alone, no fill;
  flat_kernel_no_live   the flat kernel with every tau = -1 (staging,
                        norms, the writes and the cluster's sums only);
  flat_kernel_atomic    the same body at block_n = 512, which takes no
                        cluster and adds its sums with atomics to
                        outputs zeroed beforehand (the fill not timed):
                        what the cluster costs;
  flat_kernel_atomic_no_live  the same with every tau = -1;
  flat_tiled            the earlier flat design (zero fill + kernel, as
                        its op issued it);
  pq_op                 pq_lookup_op at 4096 x 16 uint8 codes, K = 256.

Prints one JSON line with the times in us and the card's name and power
limit.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_floor: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dco_scan as dco_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G, n, dg, nq, nb = 4, 4096, 32, 16, 16
    x = torch.randn(G, n, dg, device=dev, generator=gen)
    q = torch.randn(G, nq, dg, device=dev, generator=gen)
    c0 = ((x[0][:, None, :] - q[0][None]) ** 2).sum(-1)
    tau = torch.quantile(c0, 0.005, dim=0).contiguous()
    sc = torch.ones(G, device=dev)
    widths = torch.full((G,), float(dg), device=dev)
    nr = torch.tensor([n], dtype=torch.int32, device=dev)
    lib = _build.load_library()
    partial = torch.empty((n, nq), device=dev)
    keep = torch.empty((n, nq), dtype=torch.int8, device=dev)
    zeros = torch.zeros((2, nb, nq), dtype=torch.int32, device=dev)

    def kernel(entry, t=tau, xx=x, qq=q, layout=(G, dg), block_n=256):
        def launch():
            _build.check(lib, getattr(lib, entry)(
                xx.data_ptr(), qq.data_ptr(), t.data_ptr(), sc.data_ptr(),
                widths.data_ptr(), nr.data_ptr(), partial.data_ptr(),
                keep.data_ptr(), zeros[0].data_ptr(), zeros[1].data_ptr(),
                n, nq, *layout, block_n,
                torch.cuda.current_stream().cuda_stream), entry)
        return launch

    xf = x.transpose(0, 1).reshape(n, G * dg).contiguous()
    qf = q.transpose(0, 1).reshape(nq, G * dg).contiguous()
    sc1 = torch.ones(1, device=dev)
    w1 = torch.full((1,), float(G * dg), device=dev)
    codes = torch.randint(0, 256, (n, 16), device=dev, dtype=torch.uint8,
                          generator=gen)
    lut = torch.rand(nq, 16, 256, device=dev, generator=gen)
    one = torch.empty(1, device=dev)
    p0 = ops.dco_scan_grouped_op(x[:1], q[:1], tau, sc[:1], widths[:1])[0]
    timers = {
        "tiny_fill": lambda: one.fill_(0.0),
        "zero_fill": lambda: torch.zeros((2, nb, nq), dtype=torch.int32,
                                         device=dev),
        "grouped_op": lambda: ops.dco_scan_grouped_op(x, q, tau, sc, widths,
                                                      nr),
        "grouped_kernel": kernel("dco_scan_grouped_launch"),
        "grouped_kernel_no_live": kernel("dco_scan_grouped_launch",
                                         t=torch.full_like(tau, -1.0)),
        "grouped_kernel_g1": kernel("dco_scan_grouped_launch",
                                    layout=(1, dg)),
        "grouped_kernel_all_alive": kernel("dco_scan_grouped_launch",
                                           t=torch.full_like(tau, 1e9)),
        "tiled_kernel": kernel("dco_scan_grouped_tiled_launch"),
        "flat_op": lambda: ops.dco_scan_op(xf, qf, tau, sc1, nr, block_n=256,
                                           block_d=128),
        "flat_kernel_no_live": kernel("dco_scan_launch", xx=xf, qq=qf,
                                      t=torch.full_like(tau, -1.0),
                                      layout=(G * dg, G * dg)),
        "flat_kernel_atomic": kernel("dco_scan_launch", xx=xf, qq=qf,
                                     layout=(G * dg, G * dg), block_n=512),
        "flat_kernel_atomic_no_live": kernel(
            "dco_scan_launch", xx=xf, qq=qf, t=torch.full_like(tau, -1.0),
            layout=(G * dg, G * dg), block_n=512),
        "flat_tiled": lambda: dco_mod._launch(
            "dco_scan_tiled_launch", xf, qf, tau, sc1, w1, nr, n, nq,
            (G * dg, G * dg), 256),
        "pq_op": lambda: ops.pq_lookup_op(codes, lut),
    }
    us = {key: cuda_ms(fn) * 1e3 for key, fn in timers.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "us": us,
        "rows_live_after_group0": int((p0 <= tau[None]).any(1).sum()),
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

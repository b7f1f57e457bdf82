"""The control, kept at a size a test run holds: the reference computed
in TF32 (the precision below the configurations' float32) and put in
the program's place has to fail the cell's limits, while the float64
reference itself passes them."""
import numpy as np
import pytest
import torch

from perfbench import check, data, harness, reference

BENCH = harness.load_benchmark()
SMALL = {"n": 20_000, "queries": 200}


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_tf32_control_fails_and_reference_passes(cell, seed):
    c = harness.Cell(cell)
    cfg, p = c.config | SMALL, c.traffic
    X, Q = data.make(cfg, seed, "cpu", pool=p.get("pool", "in_distribution"),
                     severity=float(p.get("ood_severity", 1.0)))
    qidx = np.arange(Q.shape[0])
    for precision, want in (("tf32", False), ("float64", True)):
        d, i = reference.topk(X, Q, c.traffic["k"], precision=precision)
        numbers = check.compare(X, Q, qidx, i.numpy(),
                                d.to(torch.float32).numpy(),
                                k=c.traffic["k"]) | check.delivery(0, 0)
        assert check.judge(numbers, c.limits) is want, (precision, numbers)

"""Per-source-line attribution of a call's flops and bytes (the dry run's
'profiler').

The port's counterpart of the reference package's
``launch/attribution.py``.  The reference joins each HLO op's
``stack_frame_id`` with the stack tables XLA emits; here
``launch.hlo_cost``'s ``CostCounter`` keys every ATen op the call
dispatches by its innermost ``src/repro_torch`` stack frame
(``file:function:line``), as a profiler's source view would.  ``flops``
are the products' (the reference's dot flops), ``bytes`` every op's
operands plus its result (its charge-everything count).
"""
from __future__ import annotations

from repro_torch.launch.hlo_cost import CostCounter


def attribute(fn, *args, top: int = 20, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under the counter; returns ``{"flops":
    [(src, v), ...], "bytes": [...]}``, each the ``top`` largest."""
    with CostCounter(by_source=True) as c:
        fn(*args, **kwargs)

    def rank(key):
        items = [(s, v[key]) for s, v in c.by_source.items() if v[key]]
        return sorted(items, key=lambda kv: -kv[1])[:top]
    return {"flops": rank("flops"), "bytes": rank("bytes")}


def print_report(fn, *args, top: int = 20, **kwargs):
    rep = attribute(fn, *args, top=top, **kwargs)
    print("== matmul flops by source ==")
    for s, v in rep["flops"]:
        print(f"  {s:56s} {v:.3e}")
    print("== bytes by source ==")
    for s, v in rep["bytes"]:
        print(f"  {s:56s} {v:.3e}")
    return rep

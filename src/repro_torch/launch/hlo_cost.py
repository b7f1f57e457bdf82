"""Op-count cost model of a PyTorch call.

The port's counterpart of the reference package's ``launch/hlo_cost.py``.
The reference parses post-SPMD HLO and weights every while-loop body by
its trip count.  Here there is no HLO and no loop to weight: the port's
layer loop is Python, so each layer's ATen ops dispatch one by one, as
often as they run.  ``CostCounter`` (a ``TorchDispatchMode``) sees every
op a call dispatches — on a card, on the CPU, or on ``meta`` tensors,
which allocate nothing — and accumulates, PER RANK (this process's share
of the work, as the reference's numbers are per device):

    flops  — the products by ``torch.utils.flop_counter``'s formulas
             (mm, bmm, addmm, baddbmm, convolution, attention:
             2 * M * N * K), their ``.dtype`` overloads (the f32-result
             bf16 GEMM, ``torch.bmm(..., out_dtype=)``, whose call the
             registry's formula cannot take) by the same formula with the
             dtype dropped, plus 1 flop a result element for the
             elementwise and reduction ops that match the reference's
             ``_ARITH_FLOP_OPS``
    bytes_upper — every op's tensor operands plus its result (views and
             ``empty`` move nothing and are charged 0)
    bytes  — the fused estimate below
    collective bytes — by kind, the bytes of every ``torch.distributed``
             collective the call makes (``c10d`` ops: ``models.placement``'s
             all-gathers and all-reduces, gloo's host-staged ones too, and
             the ``_c10d_functional`` ops that DTensor makes)

Byte model ("fused", the primary estimate).  Eager torch fuses nothing:
every op reads its operands from HBM and writes its result there, which
is ``bytes_upper``.  ``bytes`` is what an implementation that fused each
elementwise chain into its neighbours would still move, by the
reference's VMEM rule with the H100's 50 MiB L2 in place of the TPU's
64 MiB of VMEM: a product reads its operands and writes its result; any
other op is charged only for an operand or a result larger than
``CACHE_CAP``, which cannot stay on chip; an indexed read (``index``,
``embedding``, ``gather``, ``index_select``) of a large source is charged
the window it reads (its result), an indexed write (``index_put_``,
``scatter``, ``index_add_``) into a large buffer twice its values.  The
reference also charges the small operands that come from parameters or
loop carries; here every product's operands are charged, and small
elementwise operands are free.

Ops on ``DTensor``s (placement bookkeeping: ``from_local``, views of a
placed cache) are counted as nothing: the port computes on plain local
tensors, whose ops are all seen.
"""
from __future__ import annotations

import gzip
import json
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

CACHE_CAP = 50 * 2**20          # the H100's L2

_COLL_KINDS = {"allreduce": "all-reduce", "all_reduce": "all-reduce",
               "allgather": "all-gather", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter",
               "alltoall": "all-to-all", "all_to_all": "all-to-all",
               "broadcast": "broadcast", "send": "collective-permute",
               "recv": "collective-permute"}

#: ATen ops that match the reference's ``_ARITH_FLOP_OPS`` (add, subtract,
#: multiply, divide, negate, select, maximum, minimum, compare, exponential,
#: log, rsqrt, sqrt, tanh, clamp, power, and, or, convert, reduce)
_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "where", "maximum",
          "minimum", "eq", "ne", "lt", "le", "gt", "ge", "exp", "log",
          "rsqrt", "sqrt", "tanh", "clamp", "clamp_min", "clamp_max", "pow",
          "logical_and", "logical_or", "bitwise_and", "bitwise_or",
          "_to_copy", "sum", "amax", "amin", "max", "min", "mean", "prod",
          "any", "all", "reciprocal", "softmax", "_softmax", "cumsum"}

#: ops that move nothing: metadata, allocation without a write
_FREE = {"empty", "empty_like", "empty_strided", "detach", "alias",
         "lift_fresh", "_local_scalar_dense", "resize_", "set_",
         "wait_tensor"}

_INDEX_READ = {"index", "embedding", "gather", "index_select", "take"}
_INDEX_WRITE = {"index_put", "index_put_", "_index_put_impl_", "scatter",
                "scatter_", "index_add", "index_add_", "scatter_add",
                "scatter_add_", "index_copy", "index_copy_"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else 0


def _tensors(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return _tensors(list(tree.values()))
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)] \
        if tree is not None and not isinstance(tree, (int, float, bool,
                                                      str, torch.dtype)) \
        else []


class _Op:
    """What the counter needs to know of one op overload, worked out once:
    its table key, its collective kind (or None), whether it moves
    nothing, its product formula (or None) and whether it counts a flop a
    result element."""

    def __init__(self, func):
        from torch.utils.flop_counter import flop_registry
        ns, name = func.namespace, func._overloadpacket.__name__
        self.key = f"{ns}.{name}.{func._overloadname}"
        self.name = name
        self.coll = next((k for key, k in _COLL_KINDS.items()
                          if name.startswith(key)), None) \
            if ns in ("c10d", "_c10d_functional") else None
        self.c10d = ns == "c10d"
        self.free = (ns in ("c10d", "_c10d_functional")
                     or getattr(func, "is_view", False) or name in _FREE)
        self.formula = flop_registry.get(func._overloadpacket)
        self.dtype_arg = func._overloadname in ("dtype", "dtype_out")
        self.arith = name in _ARITH

    def flops(self, args, kwargs, out) -> float:
        """The product formula's flops; an overload with a dtype argument
        (``bmm.dtype``) passes its tensors only."""
        if self.dtype_arg:
            args = tuple(a for a in args if not isinstance(a, torch.dtype))
            kwargs = {k: v for k, v in kwargs.items() if k != "out_dtype"}
        return float(self.formula(*args, **kwargs, out_val=out))


def _frame(skip: str) -> str:
    """``file:function:line`` of the innermost stack frame under
    ``src/repro_torch`` outside ``skip`` (this module and its callers),
    as the reference's attribution names a source line."""
    root = str(Path(__file__).resolve().parents[1])
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(root) and not name.startswith(skip):
            return (f"{Path(name).name}:{f.f_code.co_qualname}:"
                    f"{f.f_lineno}")
        f = f.f_back
    return "untagged"


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: fn(...)``, then ``c.totals()`` (the
    reference's keys) and ``c.table()`` (the per-op counts, what
    ``analyze_counts`` reads back).  With ``by_source=True`` each op is
    also keyed by its innermost ``src/repro_torch`` frame
    (``c.by_source``, for ``launch.attribution``).  ``weights`` (tensors
    with storage: a model's parameters) marks the products with an
    operand that is one of them or a view of one: their flops are also
    counted as ``weight_matmul``."""

    def __init__(self, *, by_source: bool = False, weights=()):
        super().__init__()
        self.ops = defaultdict(lambda: {"n": 0, "flops": 0.0, "bytes": 0.0,
                                        "bytes_upper": 0.0, "matmul": 0.0,
                                        "weight_matmul": 0.0})
        self._weights = {w.untyped_storage().data_ptr() for w in weights}
        self.collectives = defaultdict(float)
        self.by_source = defaultdict(lambda: {"flops": 0.0, "bytes": 0.0})
        self._by_source = by_source
        self._skip = str(Path(__file__).resolve().parent)
        self._info = {}
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._dtensor in types:
            return out
        op = self._info.get(func)
        if op is None:
            op = self._info[func] = _Op(func)
        self._count(op, args, kwargs, out)
        return out

    def _count(self, op, args, kwargs, out):
        if op.coll is not None:
            moved = _tensors(args[0] if op.c10d else out)
            self.collectives[op.coll] += sum(_nbytes(t) for t in moved)
            return
        if op.free:
            return
        ins = _tensors(args) + (_tensors(kwargs) if kwargs else [])
        res = _tensors(out)
        rb = sum(_nbytes(t) for t in res)
        upper = rb + sum(_nbytes(t) for t in ins)
        mm = op.flops(args, kwargs, out) if op.formula is not None else None
        if mm is not None:
            flops, fused = mm, upper
        else:
            flops = float(sum(t.numel() for t in res)) if op.arith else 0.0
            fused = self._fused(op.name, ins, res, rb)
        rec = self.ops[op.key]
        rec["n"] += 1
        rec["flops"] += flops
        rec["matmul"] += mm or 0.0
        if mm and self._weights and any(
                t.untyped_storage().data_ptr() in self._weights for t in ins):
            rec["weight_matmul"] += mm
        rec["bytes"] += fused
        rec["bytes_upper"] += upper
        if self._by_source:
            src = self.by_source[_frame(self._skip)]
            src["flops"] += mm or 0.0
            src["bytes"] += upper

    @staticmethod
    def _fused(name, ins, res, rb) -> float:
        big = [_nbytes(t) > CACHE_CAP for t in ins]
        if name in _INDEX_READ:
            return rb if any(big) else 0.0
        if name in _INDEX_WRITE:
            vals = [_nbytes(t) for t, b in zip(ins, big) if not b]
            return 2.0 * max(vals, default=0) if any(big) else 0.0
        total = sum(_nbytes(t) for t, b in zip(ins, big) if b)
        return float(total + (rb if rb > CACHE_CAP else 0))

    def table(self) -> dict:
        """The per-op counts (plain dicts, JSON-ready): ``{"ops": {op:
        {n, flops, matmul, bytes, bytes_upper}}, "collectives": {kind:
        bytes}}``."""
        return {"ops": {k: dict(v) for k, v in sorted(self.ops.items())},
                "collectives": dict(self.collectives)}

    def totals(self) -> dict:
        return analyze_counts(self.table())


def analyze_counts(table: dict) -> dict:
    """The totals of a count table (``CostCounter.table``, or one read
    back by ``load_table``), with the reference's keys: ``flops``,
    ``bytes`` (fused), ``bytes_upper``, ``collectives``,
    ``collective_bytes``; and ``matmul_flops``, the products' share of
    ``flops``, and ``weight_matmul_flops``, the share of those with a
    weight operand."""
    ops = table["ops"].values()
    coll = dict(table["collectives"])
    return {"flops": sum(o["flops"] for o in ops),
            "bytes": sum(o["bytes"] for o in ops),
            "bytes_upper": sum(o["bytes_upper"] for o in ops),
            "matmul_flops": sum(o["matmul"] for o in ops),
            "weight_matmul_flops": sum(o.get("weight_matmul", 0.0)
                                       for o in ops),
            "collectives": coll,
            "collective_bytes": float(sum(coll.values()))}


#: the reference's name for the same job: it reads HLO text, this reads a
#: count table (there is no HLO here)
analyze_hlo = analyze_counts


def count(fn, *args, **kwargs) -> tuple:
    """(``fn(*args, **kwargs)``, its ``CostCounter``)."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return out, c


def save_table(table: dict, path) -> None:
    """A count table as gzip-compressed JSON (what the dry run saves in
    place of HLO)."""
    with gzip.open(path, "wt") as f:
        json.dump(table, f)


def load_table(path) -> dict:
    with gzip.open(path, "rt") as f:
        return json.load(f)

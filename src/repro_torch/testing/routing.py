"""Record, or impose, the experts each MoE layer routes its tokens to.

Routing is a top-k over router probabilities, so it is discontinuous: two
computations of the same token one bf16 ulp apart (decode against
prefill, the card against the CPU) may choose another expert at a
near-tie, and every later value of that token then moves by far more
than any tolerance.  A comparison of the rest of the path imposes one
side's choices on the other:

    with routing() as cpu:                 # record
        want = cpu_api.decode_step(...)
    with routing(cpu["calls"]) as card:    # impose, and count the moves
        got = card_api.decode_step(...)
    card["moved"]                          # tokens whose own choice differed

The hook replaces ``models.moe._top_k`` for the calls inside: each call
is a layer's router top-k on the dropless path (T <= 32 tokens), one a
MoE layer a forward pass or decode step.  The capacity path calls it
twice a layer, the router's top-k and then each expert's choice of
tokens: a forced entry of None leaves its call as it is, so a capacity
pass takes a dropless pass's routing as ``[r0, None, r1, None, ...]``.
"""
from __future__ import annotations

import contextlib

from repro_torch.models import moe as MOE


@contextlib.contextmanager
def routing(forced=None):
    """Yields ``{"calls": [...], "moved": n}``: each top-k call's (T, k)
    expert ids, in call order.  With ``forced`` (such a list), the i-th
    call takes the i-th entry's experts instead of its own (an entry of
    None: its own), their probabilities renormalised as its own would
    be, and ``moved`` counts the tokens whose own choice (as a set)
    differed."""
    inner, rec = MOE._top_k, {"calls": [], "moved": 0}

    def top_k(probs, k):
        vals, idx = inner(probs, k)
        want = None if forced is None else forced[len(rec["calls"])]
        if want is not None:
            want = want.to(idx.device)
            if want.shape != idx.shape:
                raise ValueError(f"a forced routing of {tuple(want.shape)} "
                                 f"for a call of {tuple(idx.shape)}")
            rec["moved"] += int((want.sort(-1).values
                                 != idx.sort(-1).values).any(-1).sum())
            vals, idx = probs.gather(1, want), want
        rec["calls"].append(idx)
        return vals, idx

    MOE._top_k = top_k
    try:
        yield rec
    finally:
        MOE._top_k = inner

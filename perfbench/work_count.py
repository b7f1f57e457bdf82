"""The benchmark's own count of the screen's work, and the chip's peaks.

The screen of an exact partial-distance method reads the lead block of
every corpus row (``min(d1, dim)`` dims after the method's rotation) for
each query of a batch, and decides for each (row, query) pair whether
the pair goes on.  The least work that needs, whatever implements it:
each input element read once a batch (the rows' lead blocks, the
queries' lead blocks, one threshold a query), one byte written for each
pair's decision, and two floating-point operations for each (row, query,
dim) of the lead block.  With ``d1`` = 128 the lead block is one
128-dim block, so every pair enters it and the count does not depend on
the data.  The count is computed from the configuration and the traffic
alone, never from what the program reports.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the
#: tensor cores (the screen's precision)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
F32 = 4


def screen_work(n: int, dim: int, d1: int, nq: int) -> tuple:
    """``(bytes, flops)`` the screen of one batch of ``nq`` queries over
    ``n`` rows needs, at a lead block of ``min(d1, dim)`` dims."""
    lead = min(int(d1), int(dim))
    nbytes = F32 * (n * lead + nq * lead + nq) + n * nq
    flops = 2.0 * n * nq * lead
    return float(nbytes), flops


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip needs for the work: bytes over the HBM
    bandwidth or operations over the float32 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)

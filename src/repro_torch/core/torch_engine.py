"""Device DCO engine: configuration and device state.

Counterpart of the reference package's ``core/jax_engine.py``: the engine
config, the dimension-blocked device state built from a fitted method's
``device_state()`` export, the per-rule replicated scalars and the batched
query rotation.  The legacy two-stage engine (``two_stage_topk``) and the
distributed wrapper are not ported yet (ROADMAP A1, A12); the streaming
engine (``core.stream_engine``) is the device path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DcoEngineConfig:
    kind: str = "lb"           # fdscan|lb|adsampling|dade|ddcres|ratio|opq
    d1: int = 128              # stage-1 dims
    k: int = 20
    capacity: int = 2048       # two-stage survivor capacity (not ported yet)
    eps0: float = 2.1          # adsampling
    z_alpha: float = 2.0       # dade
    m: float = 3.0             # ddcres
    theta: float = 1.0         # ratio (DDCpca) / opq (DDCopq) threshold
    tau_slack: float = 1.0     # extra slack on the certified tau
    query_chunk: int = 16      # queries per chunk of the block loop
    # --- streaming engine (core.stream_engine) knobs ---
    row_block: int = 4096      # candidate rows per block step
    block_capacity: int = 128  # survivors tail-completed per block per query
    use_kernel: bool | None = None  # CUDA kernels for stage 1 (None ->
                                    # only on a CUDA device)
    policy: object | None = None    # adaptive policy: not ported yet
    dim_groups: int = 1        # PDX layout: lead dim groups (1 = flat)
    group_capacity: int = 0    # PDX R-cut budget of the inline path
                               # (0 = max(4 * block_capacity, 512))


def build_device_state(method_or_arrays, d1: int, device) -> dict:
    """Dimension-blocked device tensors from a fitted host method's
    ``device_state()`` export (or a raw dict with 'Xrot').  The squared
    norms are computed in numpy, exactly as the reference does, and then
    moved to ``device``.  Requires a full-rank rotation so that lead + tail
    == exact."""
    if isinstance(method_or_arrays, dict):
        extras = method_or_arrays
    else:
        extras = method_or_arrays.device_state()
    xr = np.asarray(extras["Xrot"], np.float32)
    D = xr.shape[1]
    d1 = min(d1, D)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = {
        "x_lead": dev(xr[:, :d1]),
        "x_tail": dev(xr[:, d1:]),
        "lead_sq": dev((xr[:, :d1] ** 2).sum(1)),
        "tail_sq": dev((xr[:, d1:] ** 2).sum(1)),
    }
    state.update(rule_scalars(extras, d1, device))
    return state


def rule_scalars(extras: dict, d1: int, device) -> dict:
    """Per-rule scalars the engine needs beyond the blocked arrays (DADE
    eigen-mass and slack at d1), as float32 0-d tensors on ``device``."""
    out = {}
    if "mass" in extras:
        out["mass_d1"] = torch.tensor(
            max(float(extras["mass"][d1 - 1]), 1e-9), dtype=torch.float32,
            device=device)
        out["eps_d1"] = torch.tensor(float(extras["eps_d"][d1 - 1]),
                                     dtype=torch.float32, device=device)
    return out


def rotate_queries(W: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Batched online pre-processing: one matmul for the whole batch."""
    return Q @ W

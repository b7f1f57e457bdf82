"""Device DCO engine: configuration, device state and the two-stage engine.

Counterpart of the reference package's ``core/jax_engine.py``: the engine
config, the dimension-blocked device state built from a fitted method's
``device_state()`` export, the per-rule replicated scalars, the batched
query rotation and the legacy one-shot engine ``two_stage_topk``
(``SchedulePolicy(engine="two_stage")``), which forms a full
(query_chunk, N) estimate matrix per chunk with one ``torch.matmul`` and
runs no hand-written kernel, as the reference forms it outside any Pallas
kernel.  The streaming engine (``core.stream_engine``) is the default
device path; the distributed wrapper is not ported yet (ROADMAP A7).

Per query chunk the two-stage engine computes

  stage 1  partial squared distances over the leading ``d1`` rotated dims
           for every row, and the rule's estimate from them;
  anchor   exact distances for the k best rows BY ESTIMATE: their largest
           is a certified upper bound tau on the true k-th distance;
  stage 2  tail completion for at most ``capacity`` rows whose estimate
           passes tau, then the final top-k.

Every ``lax.top_k`` of the reference is ``stream_engine._smallest``, so
ties keep the lower index first.
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
    capacity: int = 2048       # two-stage survivor capacity per query
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
    policy: object | None = None    # core.policy.PolicyConfig: the
                                    # adaptive fdscan fallback
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


def _estimate(cfg: DcoEngineConfig, partial, D, state, q_extra):
    d1 = cfg.d1
    if cfg.kind in ("lb", "fdscan"):
        return partial
    if cfg.kind == "adsampling":
        return partial * (D / d1) / (1.0 + cfg.eps0 / np.sqrt(d1)) ** 2
    if cfg.kind == "dade":
        return partial / state["mass_d1"] / (1.0 + state["eps_d1"]) ** 2
    if cfg.kind == "ratio":
        return partial / cfg.theta
    if cfg.kind == "ddcres":
        # full-distance estimate: lead partial + exact tail norms, minus the
        # Gaussian slack on the unscanned cross term (core.methods Eq. 7)
        slack = 2.0 * cfg.m * torch.sqrt(torch.clamp_min(q_extra["var_d1"],
                                                         0.0))
        return (partial + state["tail_sq"][None, :]
                + q_extra["qtail_sq"][:, None] - slack[:, None])
    raise ValueError(cfg.kind)


def _two_stage_topk_padded(state: dict, q_lead, q_tail, q_extra: dict,
                           cfg: DcoEngineConfig):
    """Chunked two-stage top-k; requires nq to divide into query chunks."""
    from repro_torch.core.stream_engine import _smallest

    x_lead, x_tail = state["x_lead"], state["x_tail"]
    n, d1 = x_lead.shape
    D = d1 + x_tail.shape[1]
    k, C = cfg.k, min(cfg.capacity, n)
    nq = q_lead.shape[0]
    c = min(cfg.query_chunk, nq)

    def one_chunk(ql, qt, qe):
        rows = torch.arange(ql.shape[0], device=ql.device)[:, None]
        # ---- stage 1: one contiguous-stream matmul --------------------
        partial = torch.clamp_min(
            state["lead_sq"][None, :] - 2.0 * (ql @ x_lead.T)
            + (ql ** 2).sum(1)[:, None], 0.0)                 # (c, n)
        est = _estimate(cfg, partial, D, state, qe)
        if cfg.kind == "fdscan":
            exact = partial + (state["tail_sq"][None, :]
                               - 2.0 * (qt @ x_tail.T)
                               + (qt ** 2).sum(1)[:, None])
            dists, ids = _smallest(exact, k)
            return dists, ids, torch.full((ql.shape[0],), n,
                                          dtype=torch.int32, device=ql.device)
        # ---- anchor: certified tau from k exact completions -----------
        _, anchor = _smallest(est, k)                     # (c, k) by estimate
        a_tail = x_tail[anchor]                           # (c, k, Dt)
        a_exact = partial[rows, anchor] + torch.clamp_min(
            ((a_tail - qt[:, None, :]) ** 2).sum(-1), 0.0)
        tau = a_exact.max(-1).values * cfg.tau_slack      # (c,)
        # ---- screening + capacity selection ---------------------------
        score = torch.where(est <= tau[:, None], est, float("inf"))
        s, cand = _smallest(score, C)                     # (c, C) survivors
        alive = torch.isfinite(s)
        # ---- stage 2: tail completion only for survivors --------------
        c_tail = x_tail[cand]                             # (c, C, Dt)
        exact = partial[rows, cand] + torch.clamp_min(
            ((c_tail - qt[:, None, :]) ** 2).sum(-1), 0.0)
        exact = torch.where(alive, exact, float("inf"))
        dists, pos = _smallest(exact, k)
        return dists, torch.gather(cand, 1, pos), alive.sum(
            -1, dtype=torch.int32)

    outs = [one_chunk(q_lead[s:s + c], q_tail[s:s + c],
                      {key: v[s:s + c] for key, v in q_extra.items()})
            for s in range(0, nq, c)]
    d, i, surv = (torch.cat([o[j] for o in outs]) for j in range(3))
    return d, i.to(torch.int32), surv


def two_stage_topk(state: dict, q_lead, q_tail, cfg: DcoEngineConfig,
                   q_extra: dict | None = None):
    """Top-k over the corpus for a batch of (already rotated) queries.

    q_lead (Q, d1), q_tail (Q, D - d1) tensors on the state's device, a
    :func:`build_device_state` export with its per-row tensors.  Ragged
    batches (``nq`` not a multiple of ``cfg.query_chunk``) are zero-padded
    to a whole number of chunks and the padding rows sliced off the
    results.  ``q_extra`` carries optional per-query scalars (DDCres tail
    norms / variance suffix).  Returns (dists_sq (Q, k), ids (Q, k) int32,
    survivors (Q,) number of stage-2 rows actually alive)."""
    q_extra = dict(q_extra or {})
    nq = q_lead.shape[0]
    if nq == 0:
        raise ValueError("two_stage_topk needs at least one query")
    c = min(cfg.query_chunk, nq)
    pad = (-nq) % c
    if pad:
        def padq(v):
            return torch.nn.functional.pad(v, (0, 0) * (v.dim() - 1) + (0, pad))
        q_lead, q_tail = padq(q_lead), padq(q_tail)
        q_extra = {key: padq(v) for key, v in q_extra.items()}
    d, i, s = _two_stage_topk_padded(state, q_lead, q_tail, q_extra, cfg)
    return d[:nq], i[:nq], s[:nq]

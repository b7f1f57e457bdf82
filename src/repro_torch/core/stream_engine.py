"""Streaming device DCO engine: block-fused corpus scan with a running top-k.

Counterpart of the fixed (non-adaptive) path of the reference package's
``core/stream_engine.py``.  The rotated corpus is laid out once in row
blocks (:func:`build_stream_blocks`); each query chunk walks the blocks in
order:

  screen      stage-1 partial distances over the lead ``d1`` dims against
              the chunk's RUNNING tau — the ``dco_scan`` CUDA kernel (or
              ``pq_lookup`` for DDCopq's ``opq`` rule) when
              ``cfg.use_kernel``, else an inline torch block;
  compaction  survivors are compacted to ``block_capacity`` by estimate;
              one extra "observer" column records the best estimate that
              was dropped (the exactness certificate);
  completion  the tail dims of the survivors are completed exactly;
  merge       completed rows fold into a per-query top-k whose k-th
              distance tightens tau for every later block.

``lax.scan`` / ``lax.map`` of the reference become Python loops over the
cached blocks and the query chunks.  The block loop never synchronises
with the host: ``nrows`` reaches the kernel as a 1-element device tensor
and no value is read back per block.

Ties: XLA's ``top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order, so every ``top_k`` of the reference is a
stable ascending sort here (:func:`_smallest`).  A full sort of a
(chunk, row_block) tile costs more than a top-k selection; that cost is a
later performance item.

Not ported yet (each raises ``NotImplementedError``): IVF probing (ROADMAP
A5), anytime deadlines (A8), the adaptive policy (A7) and the PDX grouped
layout (A9).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.torch_engine import DcoEngineConfig
from repro_torch.kernels import ref
from repro_torch.kernels.ops import dco_scan_op, pq_lookup_op

_INF = float("inf")


def _round8(v: int) -> int:
    return max(8, -(-v // 8) * 8)


def _effective_groups(cfg: DcoEngineConfig) -> int:
    """PDX group count the engine would honor: ``fdscan`` has no screen to
    stage and ``opq`` screens on the PQ adist, so both force G=1."""
    if cfg.kind in ("fdscan", "opq"):
        return 1
    return max(1, int(cfg.dim_groups))


def _final_scale(cfg: DcoEngineConfig, state: dict, D: int, device):
    """Per-rule multiplier s (float32 0-d tensor) such that screening is
    ``partial * s <= tau``, used for every dim block of the kernel."""
    d1 = cfg.d1
    if cfg.kind in ("lb", "fdscan", "ddcres", "opq"):
        s = 1.0
    elif cfg.kind == "adsampling":
        s = (D / d1) / (1.0 + cfg.eps0 / np.sqrt(d1)) ** 2
    elif cfg.kind == "dade":
        return 1.0 / (state["mass_d1"] * (1.0 + state["eps_d1"]) ** 2)
    elif cfg.kind == "ratio":
        s = 1.0 / max(cfg.theta, 1e-9)
    else:
        raise ValueError(cfg.kind)
    return torch.tensor(s, dtype=torch.float32, device=device)


def _smallest(a, n: int):
    """The ``n`` smallest entries of each row, ascending, lower index first
    among ties — what the reference's ``lax.top_k(-a, n)`` selects."""
    vals, idx = torch.sort(a, dim=1, stable=True)
    return vals[:, :n], idx[:, :n]


def _merge_topk(best_d, best_i, new_d, new_i, k: int):
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    vals, pos = _smallest(d, k)
    return vals, torch.gather(i, 1, pos)


def build_stream_blocks(state: dict, row_block: int) -> dict:
    """Pad the corpus to a whole number of row blocks and reshape every
    per-row tensor to (n_blocks, block, ...).  Pad rows carry id -1.
    Callers that search repeatedly build this once per materialization.
    When the row count is already a whole number of blocks the layout is
    a view of ``state``'s tensors, so the corpus is not copied."""
    x_lead = state["x_lead"]
    n = x_lead.shape[0]
    B = min(row_block, n)
    nb = -(-n // B)
    pad = nb * B - n

    def rows(a, value=0):
        if pad:
            widths = (0, 0) * (a.dim() - 1) + (0, pad)
            a = torch.nn.functional.pad(a, widths, value=value)
        return a.reshape(nb, B, *a.shape[1:])

    ids = state.get("row_ids")
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=x_lead.device)
    xs = {
        "xl": rows(x_lead),
        "xt": rows(state["x_tail"]),
        "lsq": rows(state["lead_sq"]),
        "tsq": rows(state["tail_sq"]),
        "ids": rows(ids.to(torch.int32), value=-1),
    }
    if "codes" in state:        # PQ codes for the opq rule
        xs["codes"] = rows(state["codes"].to(torch.int32))
    return xs


def _scan_blocks(cfg: DcoEngineConfig, state, xs, ql, qt, qe, B, D):
    """Walk every corpus row block for one query chunk (the reference's
    ``lax.scan`` of the fixed ``step``).  Returns (dists (c, k), ids
    (c, k), survivors (c,), passed (c,), dropped_min_est (c,), dims (c,))."""
    dev = ql.device
    c = ql.shape[0]
    k = cfg.k
    C = min(cfg.block_capacity, B)
    Cp = min(C + 1, B)      # +1 slot observes the best DROPPED estimate
    d1 = ql.shape[1]
    block_d = min(128, _round8(d1))
    block_n = min(256, _round8(B))
    scale = _final_scale(cfg, state, D, dev)
    scales_arr = scale.reshape(1).expand(-(-d1 // block_d)).contiguous()
    ql_sq = (ql ** 2).sum(1)
    qt_sq = (qt ** 2).sum(1)
    if cfg.kind == "ddcres":
        slack = 2.0 * cfg.m * torch.sqrt(torch.clamp_min(qe["var_d1"], 0.0))
        tail_min = (state["tail_min"] if "tail_min" in state
                    else state["tail_sq"].min())
    rows = torch.arange(c, device=dev)[:, None]
    col = torch.arange(Cp, device=dev)[None, :]

    def complete_screened(best_d, best_i, tau, keep, est, partial, blk):
        # on-device compaction: top-C survivors by estimate; column C (when
        # present) is the best estimate the budget DROPPED — no true
        # neighbor was lost iff the final k-th distance stays below it
        score = torch.where(keep, est, _INF)
        s, cand = _smallest(score, Cp)                        # (c, C [+1])
        if Cp > C:
            dropped = s[:, C]
        else:
            dropped = torch.full((c,), _INF, device=dev)
        alive = (s < _INF) & (col < C)
        c_tail = blk["xt"][cand]                              # (c, Cp, Dt)
        tail = torch.clamp_min(((c_tail - qt[:, None, :]) ** 2).sum(-1), 0.0)
        if cfg.kind == "opq":
            c_lead = blk["xl"][cand]
            exact = torch.clamp_min(
                ((c_lead - ql[:, None, :]) ** 2).sum(-1), 0.0) + tail
        else:
            exact = partial[rows, cand] + tail
        exact = torch.where(alive, exact, _INF)
        new_d, new_i = _merge_topk(best_d, best_i, exact, blk["ids"][cand], k)
        new_tau = torch.minimum(tau, new_d[:, -1] * cfg.tau_slack)
        return (new_d, new_i, new_tau,
                alive.sum(-1, dtype=torch.int32), dropped)

    best_d = torch.full((c, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((c, k), -1, dtype=torch.int32, device=dev)
    tau = torch.full((c,), _INF, dtype=torch.float32, device=dev)
    surv = torch.zeros((c,), dtype=torch.int32, device=dev)
    passed = torch.zeros((c,), dtype=torch.int32, device=dev)
    dims = torch.zeros((c,), dtype=torch.float32, device=dev)
    dmin = torch.full((c,), _INF, dtype=torch.float32, device=dev)

    for b in range(xs["xl"].shape[0]):
        blk = {key: v[b] for key, v in xs.items()}
        valid = blk["ids"] >= 0                               # (B,)
        n_ok = valid.sum(dtype=torch.int32)
        n_okf = n_ok.to(torch.float32)
        tau_k = torch.full_like(tau, _INF) if cfg.kind == "fdscan" else tau
        if cfg.kind == "ddcres":
            # partial <= tau_k is implied by the Eq. 7 estimate test below
            tau_k = tau + slack - qe["qtail_sq"] - tail_min

        passed_b = None
        if cfg.kind == "opq":
            if cfg.use_kernel:
                adist = pq_lookup_op(blk["codes"], qe["lut"])
            else:
                adist = ref.pq_lookup_ref(blk["codes"], qe["lut"])
            est = adist.T / cfg.theta                         # (c, B)
            keep = (est <= tau[:, None]) & valid[None, :]
            partial = None
            dims_scr = n_okf * float(qe["lut"].shape[1])
        elif cfg.use_kernel:
            p, kp, cnt, ad = dco_scan_op(blk["xl"], ql, tau_k, scales_arr,
                                         n_ok, block_n=block_n,
                                         block_d=block_d)
            partial, keep = p.T, kp.T.bool()                  # (c, B)
            est = partial * scale
            passed_b = cnt.sum(0, dtype=torch.int32)  # kernel keep counts
            dims_scr = ad.sum(0)        # measured dims entered per query
        else:
            partial = torch.clamp_min(
                blk["lsq"][None, :] - 2.0 * (ql @ blk["xl"].T)
                + ql_sq[:, None], 0.0)                        # (c, B)
            est = partial * scale
            keep = (est <= tau_k[:, None]) & valid[None, :]
            # the flat screen reads all d1 lead dims of every valid row
            dims_scr = torch.where(tau_k >= 0.0, n_okf, 0.0) * float(d1)
        if cfg.kind == "ddcres":
            # full-distance estimate (core.methods Eq. 7) refines the
            # conservative partial screen and drives compaction
            est = (partial + blk["tsq"][None, :]
                   + qe["qtail_sq"][:, None] - slack[:, None])
            keep = keep & (est <= tau[:, None])
            passed_b = None
        if passed_b is None:
            passed_b = keep.sum(-1, dtype=torch.int32)

        if cfg.kind == "fdscan":
            exact = partial + torch.clamp_min(
                blk["tsq"][None, :] - 2.0 * (qt @ blk["xt"].T)
                + qt_sq[:, None], 0.0)
            exact = torch.where(valid[None, :], exact, _INF)
            best_d, best_i = _merge_topk(
                best_d, best_i, exact, blk["ids"][None, :].expand(c, B), k)
            surv = surv + n_ok
            passed = passed + n_ok
            dims = dims + n_okf * float(D)
            continue

        best_d, best_i, tau, completed, dropped = complete_screened(
            best_d, best_i, tau, keep, est, partial, blk)
        comp_w = float(D if cfg.kind == "opq" else D - d1)
        surv = surv + completed
        passed = passed + passed_b
        dims = dims + dims_scr + completed.to(torch.float32) * comp_w
        dmin = torch.minimum(dmin, dropped)
    return best_d, best_i, surv, passed, dmin, dims


def _stream_topk_padded(state: dict, xs: dict, q_lead, q_tail,
                        q_extra: dict, cfg: DcoEngineConfig):
    """All query chunks of a batch whose size is a whole number of
    chunks, concatenated (the reference's ``lax.map`` over chunks)."""
    D = q_lead.shape[1] + q_tail.shape[1]
    B = xs["xl"].shape[-2]
    nq = q_lead.shape[0]
    c = min(cfg.query_chunk, nq)
    outs = [
        _scan_blocks(cfg, state, xs, q_lead[s:s + c], q_tail[s:s + c],
                     {key: v[s:s + c] for key, v in q_extra.items()}, B, D)
        for s in range(0, nq, c)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(6))


def stream_topk(state: dict, q_lead, q_tail, cfg: DcoEngineConfig,
                q_extra: dict | None = None, probe=None, blocks=None,
                deadline_ts: float | None = None):
    """Streaming top-k over the corpus for a batch of rotated queries.

    q_lead (Q, d1), q_tail (Q, D - d1) tensors on the state's device.
    ``state`` is a ``torch_engine.build_device_state`` export, optionally
    with ``row_ids`` and (opq rule) ``codes``.  ``blocks`` is an optional
    pre-built :func:`build_stream_blocks` layout; with it, ``state`` needs
    only the per-rule scalars and, for ddcres, ``tail_min`` (the least
    tail energy of the real rows).  Ragged batches pad to a
    whole number of query chunks; N need not divide ``cfg.row_block``.

    Returns (dists_sq (Q, k), ids (Q, k) int32, survivors (Q,), passed
    (Q,), dropped_min_est (Q,), dims_read (Q,)).  ``dropped_min_est[q] >
    dists_sq[q, k-1]`` certifies exactness for lower-bound rules: every row
    a capacity cut dropped has a lower bound above the returned k-th
    distance."""
    if probe is not None:
        raise NotImplementedError(
            "IVF probing is not ported yet (ROADMAP A5)")
    if deadline_ts is not None:
        raise NotImplementedError(
            "anytime deadlines are not ported yet (ROADMAP A8)")
    if cfg.policy is not None and getattr(cfg.policy, "adaptive", False):
        raise NotImplementedError(
            "the adaptive policy is not ported yet (ROADMAP A7)")
    if _effective_groups(cfg) > 1:
        raise NotImplementedError(
            "the PDX grouped layout (dim_groups > 1) is not ported yet "
            "(ROADMAP A9)")
    q_extra = dict(q_extra or {})
    if cfg.use_kernel is None:
        cfg = dataclasses.replace(cfg, use_kernel=q_lead.is_cuda)
    if blocks is None:
        blocks = build_stream_blocks(state, cfg.row_block)
    nq = q_lead.shape[0]
    if nq == 0:
        raise ValueError("stream_topk needs at least one query")
    c = min(cfg.query_chunk, nq)
    pad = (-nq) % c
    if pad:
        def padq(v):
            return torch.nn.functional.pad(v, (0, 0) * (v.dim() - 1) + (0, pad))
        q_lead, q_tail = padq(q_lead), padq(q_tail)
        q_extra = {key: padq(v) for key, v in q_extra.items()}
    out = _stream_topk_padded(state, blocks, q_lead, q_tail, q_extra, cfg)
    return tuple(o[:nq] for o in out)

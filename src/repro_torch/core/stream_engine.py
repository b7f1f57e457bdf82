"""Streaming device DCO engine: block-fused corpus scan with a running top-k.

Counterpart of the reference package's ``core/stream_engine.py``.  The
rotated corpus is laid out once in row
blocks (:func:`build_stream_blocks`); each query chunk walks the blocks in
order:

  screen      stage-1 partial distances over the lead ``d1`` dims against
              the chunk's RUNNING tau — the ``dco_scan`` CUDA kernel (or
              ``pq_lookup`` for DDCopq's ``opq`` rule, or
              ``dco_scan_grouped`` on the PDX layout) when
              ``cfg.use_kernel``, else an inline torch block;
  compaction  survivors are compacted to ``block_capacity`` by estimate;
              one extra "observer" column records the best estimate that
              was dropped (the exactness certificate);
  completion  the tail dims of the survivors are completed exactly;
  merge       completed rows fold into a per-query top-k whose k-th
              distance tightens tau for every later block.

``lax.scan`` / ``lax.map`` of the reference become a Python loop over the
cached blocks (:func:`_scan_blocks`, one query chunk) and one over the
chunks.  The block loop never synchronises with the host: ``nrows``
reaches the kernel as a 1-element device tensor and no value is read back
per block.  On a CUDA device the block loop of a chunk is captured once
as a CUDA graph and replayed for every chunk (:class:`_ChunkGraph`), as
the reference compiles its ``lax.scan`` once; on the CPU it runs
eagerly.

Ties: XLA's ``top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order, so every ``top_k`` of the reference is
a ``torch.topk`` over a unique composite (value, column) key here
(:func:`_smallest`): a partial selection, not a sort of the row.

PDX vertical layout (``dim_groups`` > 1, DESIGN.md §8): the lead dims of a
block are split into contiguous dim groups, ``xl`` (n_blocks, G, block, dg)
with one unit-stride (block, dg) plane per group.  On the kernel path
``dco_scan_grouped`` freezes pairs group by group; on the inline path
group 0 prices every row, survivors compact to the per-query top-R (the
R-cut, with its own observer column in the certificate) and the later
groups refine only those candidates (:func:`_scan_blocks`).

IVF probing (``probe=``): rows are laid out partition-major (the
``row_part`` state sorted, ``row_ids`` the permutation, the ``part``
plane of the blocks); for each query chunk a block whose partition span
holds none of a query's probed partitions gets tau = -1 for that query,
which the kernels' liveness gate turns into skipped work, and rows of
unprobed partitions are masked out of the keep set.

LSM delta segment (:func:`append_stream_blocks`): a small segment of
appended rows is laid out at the main layout's block width and its blocks
concatenated after the main ones, so one running tau walks both.

Adaptive policy (``cfg.policy`` an adaptive ``core.policy.PolicyConfig``,
DESIGN.md §5): a pre-scan seed over a row sample (:func:`_seed_eval`)
gives each chunk a certified starting tau and a pass-fraction estimate,
and one host read a batch decides per chunk between the switching walk
and the dedicated full-scan body (``forced``, also the guardrail's
demoted path).  In the switching walk each block's screened completion
and its full completion (the ESCAPE, taken on a capacity spill or while
the cost model says screening loses) are both computed and one is kept by
``torch.where`` on a 0-d device predicate: the reference's ``lax.cond``
without a host read, so the walk stays one CUDA graph.  The policy state
(EWMA, observation count, mode, fallback blocks, saved flops) is part of
the carry.  Adaptive flat and PDX walks use the inline screen (a kernel
that freezes pruned rows leaves partials the escape cannot reuse); DDCopq
keeps ``pq_lookup``.

Anytime deadlines (``deadline_ts``, DESIGN.md §7): the fixed walk is
resumable over a range of blocks (``init_carry``/``return_carry``), and
:func:`_anytime_topk` walks ``block_group`` blocks at a time, with one
device synchronization and one wall-clock check a group.

Over a mesh each rank walks its own shard with :func:`stream_topk`, and
``torch_engine.make_distributed_topk`` merges the shards' top-k lists.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.policy import pass_threshold
from repro_torch.core.torch_engine import DcoEngineConfig
from repro_torch.kernels import dco_scan as _dco_mod
from repro_torch.kernels import pq_lookup as _pq_mod
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (_widths, dco_scan_grouped_op,
                                     dco_scan_op, pq_lookup_op)
from repro_torch.utils import trace

_INF = float("inf")


def _round8(v: int) -> int:
    return max(8, -(-v // 8) * 8)


def _group_plan(d1: int, groups: int):
    """Resolve a requested ``dim_groups`` against the screening width: the
    lead dims split into contiguous groups of ``ceil(d1/G)`` dims (the last
    group may be ragged; the layout zero-pads it, which adds 0 to every
    squared-distance partial).  Returns (G, dg, widths) with ``widths`` the
    logical dim count per group; idempotent, so a layout rebuilt from its
    own group count reproduces the same split."""
    G = max(1, min(int(groups), int(d1)))
    dg = -(-d1 // G)
    G = -(-d1 // dg)
    widths = tuple(min(dg, d1 - g * dg) for g in range(G))
    return G, dg, widths


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
    # a fill, not a copy from the host: the walk is captured in a CUDA graph
    return torch.full((), s, dtype=torch.float32, device=device)


def _smallest(a, n: int):
    """The ``n`` smallest entries of each float32 row, ascending, lower index
    first among ties — what the reference's ``lax.top_k(-a, n)`` selects —
    by a partial selection, not a sort of the row.

    Each entry becomes one int64 key: the high 32 bits the order-preserving
    int32 image of its float bits (as they are when non-negative, the low
    31 bits flipped when negative, so -0.0 falls just below +0.0 as in
    XLA's total order), the low 32 bits its column.  Keys are unique, so
    ``torch.topk`` has no tie to break and its order is the reference's."""
    bits = a.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    cols = torch.arange(a.shape[1], dtype=torch.int64, device=a.device)
    _, idx = torch.topk((ordered << 32) | cols, n, dim=1, largest=False,
                        sorted=True)
    return torch.gather(a, 1, idx), idx


def _merge_topk(best_d, best_i, new_d, new_i, k: int):
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    vals, pos = _smallest(d, k)
    return vals, torch.gather(i, 1, pos)


def build_stream_blocks(state: dict, row_block: int,
                        full_width: bool = False,
                        dim_groups: int = 1) -> dict:
    """Pad the corpus to a whole number of row blocks and reshape every
    per-row tensor to (n_blocks, block, ...).  Pad rows carry id -1 and,
    with ``row_part`` (the IVF layout), the last row's partition (the
    ``part`` plane, edge-padded so a block's partition span is that of
    its real rows).  Callers that search repeatedly build this once per
    materialization.  When the row count is already a whole number of
    blocks the layout is a view of ``state``'s tensors, so the corpus is
    not copied.

    ``full_width=True`` keeps the block width at ``row_block`` even when
    the segment has fewer rows, as a delta segment laid after a main
    layout of that width needs (:func:`append_stream_blocks`).

    ``dim_groups`` > 1 selects the PDX vertical layout: the lead dims split
    per :func:`_group_plan` and ``xl`` becomes (n_blocks, G, block, dg),
    dim-group-major and contiguous (a copy), with per-group squared norms
    under ``lsg`` (n_blocks, G, block).  A ragged last group is
    zero-padded."""
    x_lead = state["x_lead"]
    n = x_lead.shape[0]
    B = row_block if full_width else min(row_block, n)
    nb = -(-n // B)
    pad = nb * B - n

    def rows(a, value=0):
        if pad:
            widths = (0, 0) * (a.dim() - 1) + (0, pad)
            a = torch.nn.functional.pad(a, widths, value=value)
        return a.reshape(nb, B, *a.shape[1:])

    def rows_edge(a):
        if pad:
            a = torch.cat([a, a[-1:].expand(pad)])
        return a.reshape(nb, B)

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
    if "row_part" in state:     # partition-major layout for IVF probing
        xs["part"] = rows_edge(state["row_part"].to(torch.int32))
    if "codes" in state:        # PQ codes for the opq rule: uint8 as given
        codes = state["codes"]
        if codes.dtype != torch.uint8:
            codes = codes.to(torch.int32)
        xs["codes"] = rows(codes)
    if dim_groups > 1:
        d1 = x_lead.shape[1]
        G, dg, _ = _group_plan(d1, dim_groups)
        if G > 1:
            xl = xs["xl"]
            if G * dg > d1:
                xl = torch.nn.functional.pad(xl, (0, G * dg - d1))
            xg = xl.reshape(nb, B, G, dg).transpose(1, 2).contiguous()
            xs["xl"] = xg                                   # (nb, G, B, dg)
            xs["lsg"] = (xg ** 2).sum(-1)                   # (nb, G, B)
    return xs


def append_stream_blocks(main: dict, delta_state: dict) -> dict:
    """Concatenate a small delta segment's blocks after a main layout.

    The delta layout is built at the MAIN block width (``full_width``), so
    the result is one (nb_main + nb_delta, B, ...) stack the block loop
    walks end to end: the running tau tightened over the main segment
    carries into the delta blocks, and no cross-segment merge is needed at
    query time.  ``delta_state`` (on the main layout's device) must carry
    ``row_ids`` (global ids of the appended rows) and the same optional
    keys (``row_part``, ``codes``) as the main layout, and inherits its
    PDX group count.  The concatenation copies the main blocks."""
    B = main["xl"].shape[-2]
    G = main["xl"].shape[1] if main["xl"].dim() == 4 else 1
    delta = build_stream_blocks(delta_state, B, full_width=True, dim_groups=G)
    missing = set(main) ^ set(delta)
    if missing:
        raise ValueError(
            f"delta segment layout keys differ from main: {missing}")
    return {key: torch.cat([main[key], delta[key]]) for key in main}


def _adaptive(cfg: DcoEngineConfig) -> bool:
    """True when ``cfg`` carries an active adaptive policy
    (``core.policy``); the pure fdscan rule has nothing to fall back to."""
    return (cfg.policy is not None and getattr(cfg.policy, "adaptive", False)
            and cfg.kind != "fdscan")


def _policy_threshold(cfg: DcoEngineConfig, d1: int, D: int, qe: dict):
    """(d_screen, d_complete, threshold) of the adaptive cost model: opq
    screens n_sub LUT dims and completes all D dims; the partial rules
    screen d1 and complete the D - d1 tail.  Above the threshold a
    survivor fraction says screening is net-negative
    (``core.policy.pass_threshold``)."""
    if cfg.kind == "opq":
        d_screen, d_complete = float(qe["lut"].shape[1]), float(D)
    else:
        d_screen, d_complete = float(d1), float(D - d1)
    return d_screen, d_complete, pass_threshold(
        D, d_screen, d_complete, cfg.policy.fallback_margin,
        cfg.policy.overhead_dims)


def _scan_blocks(cfg: DcoEngineConfig, state, xs, ql, qt, qe, pr=None,
                 n_part: int = 0, q_ok=None, init_tau=None, init_ewma=None,
                 forced: bool = False, init_carry=None,
                 return_carry: bool = False):
    """Walk the corpus row blocks of ``xs`` for one query chunk (the
    reference's ``lax.scan`` over ``step``, ``step_adaptive`` or
    ``step_full``).  ``pr`` (c, nprobe) is the chunk's IVF probe and
    ``n_part`` the width of its probed-partition mask (:func:`_probe_width`).
    The same body runs eagerly on the CPU and is captured into a CUDA graph
    on the card (:class:`_ChunkGraph`), so it reads nothing back to the
    host and makes no host-to-device copy.

    Fixed walk: returns (dists (c, k), ids (c, k), survivors (c,), passed
    (c,), dropped_min_est (c,), dims (c,)).  ``init_carry`` (the 7-tuple
    ``(best_d, best_i, tau, surv, passed, dims, dropped_min)``) resumes it
    and ``return_carry=True`` returns that carry after the last block: the
    anytime driver walks the corpus in block groups this way, and the
    steps are those of the one-shot walk, in the same order.

    Adaptive walk (``cfg.policy`` adaptive, DESIGN.md §5): ``q_ok`` (c,)
    masks padding queries out of the chunk's decisions, ``init_tau`` and
    ``init_ewma`` are the seed (:func:`_seed_eval`), and ``forced=True``
    runs the full-scan body for a chunk the seed (or the guardrail's
    demotion) put in fallback.  Returns the six outputs and a report dict:
    ``fb`` (c,) fallback blocks, ``saved`` (c,) estimated flops saved and
    ``timeline`` (n_blocks,) 1.0 where the block escaped."""
    dev = ql.device
    c = ql.shape[0]
    B = xs["xl"].shape[-2]
    D = ql.shape[1] + qt.shape[1]
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
    iota = torch.arange(B, device=dev)[None, :]
    if pr is not None:
        # the probe gate, formed once per chunk: hits (c, nb) marks the
        # blocks whose partition span [pmin, pmax] holds a partition the
        # query probes, rowhits (c, nb, B) the rows of probed partitions
        # (a gather of the chunk's probed-partition mask), and the tau of
        # an unprobed block (a tensor, so the gate fills nothing a step);
        # a block's partition span is [pmin, pmax] of its part plane
        part = xs["part"]
        pmin, pmax = part.amin(1).long(), part.amax(1).long()
        part_flat = part.reshape(-1).long()
        tau_skip = torch.full((c,), -1.0, device=dev)
        prl = pr.long()
        hits = ((prl[:, None, :] >= pmin[None, :, None])
                & (prl[:, None, :] <= pmax[None, :, None])).any(-1)
        probed = torch.zeros((c, n_part), dtype=torch.bool, device=dev)
        probed.scatter_(1, prl, True)
        rowhits = probed[:, part_flat].reshape(c, -1, B)

    # ---- PDX vertical layout (DESIGN.md §8) -------------------------------
    grouped = xs["xl"].dim() == 4
    if grouped:
        Gr, dgp, gw = _group_plan(d1, xs["xl"].shape[1])    # gw: logical dims
        qlg = torch.nn.functional.pad(ql, (0, Gr * dgp - d1)).reshape(
            c, Gr, dgp).transpose(0, 1).contiguous()           # (Gr, c, dgp)
        qgsq = (qlg ** 2).sum(-1)                              # (Gr, c)
        # inline path: survivors of the group-0 screen compact to the
        # per-query top-R by estimate before the later groups are gathered;
        # R >= C, and the R-cut has its own observer slot (certificate)
        R = cfg.group_capacity if cfg.group_capacity > 0 else max(4 * C, 512)
        R = max(min(R, B), C)
        Rp = min(R + 1, B)
        # device tensors built once per chunk: the block loop copies nothing
        scales_g = scale.reshape(1).expand(Gr).contiguous()
        widths_g = _widths(d1, dgp, dev)

    def candidates(valid, rowhit, n_ok, n_okf):
        """The rows each query may complete, (c, B) or (1, B), and their
        count per query as int32 and float32: every valid row of the
        block, or with a probe those of probed partitions.  Formed only
        where a path needs them, so the kernel path pays no op for it."""
        if rowhit is None:
            return valid[None, :], n_ok, n_okf
        okm = valid[None, :] & rowhit
        n_done = okm.sum(-1, dtype=torch.int32)
        return okm, n_done, n_done.to(torch.float32)

    def observed(score, n_keep: int, width: int):
        """The ``width`` smallest scores, masked-observer style: returns
        (idx, alive, dropped) where ``alive`` marks the first ``n_keep``
        finite columns and ``dropped`` is column ``n_keep`` (the best
        estimate the cut dropped), +inf when there is no such column."""
        s, idx = _smallest(score, width)
        if width > n_keep:
            dropped = s[:, n_keep]
        else:
            dropped = torch.full((c,), _INF, device=dev)
        return idx, (s < _INF) & (iota[:, :width] < n_keep), dropped

    def complete_screened(best_d, best_i, tau, keep, est, partial, blk):
        # on-device compaction: top-C survivors by estimate; column C (when
        # present) is the best estimate the budget DROPPED — no true
        # neighbor was lost iff the final k-th distance stays below it
        cand, alive, dropped = observed(torch.where(keep, est, _INF), C, Cp)
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

    def pdx_screen(blk, tau, tau_k, ok):
        """Grouped progressive screen on the inline path (the reference's
        ``_pdx_screen``): group 0 prices every row, survivors compact to
        the per-query top-R with an observer of the best estimate the R-cut
        dropped, and the later groups refine only the candidates, freezing
        each whose running partial crosses tau.  A partial over any dim
        prefix is a lower bound, so a frozen row needs no certificate."""
        xg, lsg = blk["xl"], blk["lsg"]               # (G, B, dg), (G, B)
        enter = ok & (tau_k >= 0.0)[:, None]                  # (c, B)
        contrib0 = torch.clamp_min(
            lsg[0][None, :] - 2.0 * (qlg[0] @ xg[0].T)
            + qgsq[0][:, None], 0.0)                          # (c, B)
        dims_b = enter.sum(-1, dtype=torch.int32).to(torch.float32) * gw[0]
        if cfg.kind == "ddcres":
            rank = (contrib0 + blk["tsq"][None, :]
                    + qe["qtail_sq"][:, None] - slack[:, None])
            alive = (enter & (contrib0 <= tau_k[:, None])
                     & (rank <= tau[:, None]))
        else:
            rank = contrib0 * scale
            alive = enter & (rank <= tau_k[:, None])
        cand, aliveR, dropped0 = observed(
            torch.where(alive, rank, _INF), R, Rp)            # (c, Rp)
        acc = torch.gather(contrib0, 1, cand)
        for g in range(1, Gr):
            if g > 1:   # re-test the partial accumulated through group g-1
                est_g = acc if cfg.kind == "ddcres" else acc * scale
                aliveR = aliveR & (est_g <= tau_k[:, None])
            dims_b = dims_b + aliveR.sum(
                -1, dtype=torch.int32).to(torch.float32) * gw[g]
            xc = xg[g][cand]                                  # (c, Rp, dg)
            contrib = torch.clamp_min(
                lsg[g][cand] - 2.0 * torch.einsum("cd,crd->cr", qlg[g], xc)
                + qgsq[g][:, None], 0.0)
            acc = torch.where(aliveR, acc + contrib, acc)
        if cfg.kind == "ddcres":
            est = (acc + blk["tsq"][cand] + qe["qtail_sq"][:, None]
                   - slack[:, None])
            keep = aliveR & (acc <= tau_k[:, None]) & (est <= tau[:, None])
        else:
            est = acc * scale
            keep = aliveR & (est <= tau_k[:, None])
        return cand, acc, keep, est, dropped0, dims_b

    def complete_compacted(best_d, best_i, tau, keep, est, acc, cand,
                           dropped0, blk):
        """Exact tail completion over the R-cut's candidate axis: the same
        top-C observer compaction as ``complete_screened``, gathering block
        rows through ``cand``; the R-cut's drop folds into the returned
        certificate value."""
        sel, alive, droppedC = observed(torch.where(keep, est, _INF), C,
                                        min(C + 1, Rp))
        rsel = torch.gather(cand, 1, sel)                     # (c, C [+1])
        c_tail = blk["xt"][rsel]
        tail = torch.clamp_min(((c_tail - qt[:, None, :]) ** 2).sum(-1), 0.0)
        exact = torch.where(alive, torch.gather(acc, 1, sel) + tail, _INF)
        new_d, new_i = _merge_topk(best_d, best_i, exact, blk["ids"][rsel], k)
        new_tau = torch.minimum(tau, new_d[:, -1] * cfg.tau_slack)
        return (new_d, new_i, new_tau, alive.sum(-1, dtype=torch.int32),
                torch.minimum(dropped0, droppedC))

    best_d = torch.full((c, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((c, k), -1, dtype=torch.int32, device=dev)
    tau = torch.full((c,), _INF, dtype=torch.float32, device=dev)
    surv = torch.zeros((c,), dtype=torch.int32, device=dev)
    passed = torch.zeros((c,), dtype=torch.int32, device=dev)
    dims = torch.zeros((c,), dtype=torch.float32, device=dev)
    dmin = torch.full((c,), _INF, dtype=torch.float32, device=dev)
    nb = xs["xl"].shape[0]

    pol = cfg.policy if _adaptive(cfg) else None
    if pol is not None:
        # ---- adaptive serving (DESIGN.md §5) ------------------------------
        d_screen, d_complete, thr = _policy_threshold(cfg, d1, D, qe)
        q_okm = (torch.ones((c,), dtype=torch.bool, device=dev)
                 if q_ok is None else q_ok)
        if init_tau is not None:
            tau = init_tau
        ewma = torch.zeros((c,), dtype=torch.float32, device=dev)
        n_obs = torch.zeros((c,), dtype=torch.int32, device=dev)
        if init_ewma is not None and cfg.kind != "opq":
            # opq's seed evidence would need adist: it stays neutral
            ewma = init_ewma
            n_obs = torch.ones((c,), dtype=torch.int32, device=dev)

        def lead_partial(blk):
            """The lead partial of every row of the block over all d1 dims
            (the escape's and the full-scan body's; per group on PDX)."""
            xl = blk["xl"]
            if xl.dim() == 3:
                acc = torch.zeros((c, B), dtype=torch.float32, device=dev)
                for g in range(Gr):
                    acc = acc + torch.clamp_min(
                        blk["lsg"][g][None, :] - 2.0 * (qlg[g] @ xl[g].T)
                        + qgsq[g][:, None], 0.0)
                return acc
            return torch.clamp_min(blk["lsq"][None, :] - 2.0 * (ql @ xl.T)
                                   + ql_sq[:, None], 0.0)

        def row_ok(b, valid):
            """(c, B): the rows of block ``b`` each query may complete."""
            if pr is None:
                return valid[None, :].expand(c, B)
            return valid[None, :] & rowhits[:, b]

        def complete_all(best_d, best_i, tau, partial, ok, blk):
            # certified fallback: every candidate row completes exactly
            # over all D dims, so nothing is dropped (+inf)
            if partial is None:     # opq / PDX escape: the full lead anew
                partial = lead_partial(blk)
            exact = partial + torch.clamp_min(
                blk["tsq"][None, :] - 2.0 * (qt @ blk["xt"].T)
                + qt_sq[:, None], 0.0)
            exact = torch.where(ok, exact, _INF)
            new_d, new_i = _merge_topk(best_d, best_i, exact,
                                       blk["ids"][None, :].expand(c, B), k)
            new_tau = torch.minimum(tau, new_d[:, -1] * cfg.tau_slack)
            return (new_d, new_i, new_tau, ok.sum(-1, dtype=torch.int32),
                    torch.full((c,), _INF, device=dev))

        if forced:
            # the whole chunk serves in fallback (the seed, or the
            # guardrail's demotion, said screening loses): a dedicated body
            # without the switching machinery
            for b in range(nb):
                blk = {key: v[b] for key, v in xs.items()}
                ok = row_ok(b, blk["ids"] >= 0)
                best_d, best_i, tau, n_done, _ = complete_all(
                    best_d, best_i, tau, None, ok, blk)
                surv = surv + n_done
                passed = passed + n_done
                dims = dims + n_done.to(torch.float32) * float(D)
            report = {"fb": torch.full((c,), nb, dtype=torch.int32,
                                       device=dev),
                      "saved": torch.zeros((c,), device=dev),
                      "timeline": torch.ones((nb,), device=dev)}
            return best_d, best_i, surv, passed, dmin, dims, report

        # the EWMA's weights as float32 values, as the reference forms them
        alpha = float(np.float32(pol.ewma_alpha))
        keep_w = float(np.float32(1.0) - np.float32(pol.ewma_alpha))
        mode = torch.zeros((), dtype=torch.bool, device=dev)
        fb = torch.zeros((), dtype=torch.int32, device=dev)
        saved = torch.zeros((c,), dtype=torch.float32, device=dev)
        escapes = []
        for b in range(nb):
            # ONE choice a block: the screened completion, or the ESCAPE
            # (every row completes exactly) when the screen spilled its
            # completion budget (so screened blocks never drop a row: the
            # scan is certified by construction) or the mode says
            # screening is net-negative.  Both are computed and the 0-d
            # predicate keeps one, so nothing is read back to the host.
            blk = {key: v[b] for key, v in xs.items()}
            ok = row_ok(b, blk["ids"] >= 0)
            n_ok = ok.sum(-1, dtype=torch.int32)
            nokf = n_ok.to(torch.float32)
            if grouped:
                # the R-cut joins the spill gate: a cut that dropped any
                # alive row escapes too, so the walk stays certified per
                # dim group; the escape recomputes the full lead
                tau_ka = (tau + slack - qe["qtail_sq"] - tail_min
                          if cfg.kind == "ddcres" else tau)
                cand, acc, keep, est, dropped0, dims_scr = pdx_screen(
                    blk, tau, tau_ka, ok)
                passed_b = keep.sum(-1, dtype=torch.int32)
                spill = (q_okm & ((passed_b > C)
                                  | ~torch.isinf(dropped0))).any()
                esc = spill | mode
                full = complete_all(best_d, best_i, tau, None, ok, blk)
                screened = complete_compacted(best_d, best_i, tau, keep, est,
                                              acc, cand, dropped0, blk)
                new_d, new_i, new_tau, completed, dropped = (
                    torch.where(esc, f, s) for f, s in zip(full, screened))
                dims_b = torch.where(
                    esc, dims_scr + nokf * float(D),
                    dims_scr + completed.to(torch.float32) * float(D - d1))
            else:
                partial = None if cfg.kind == "opq" else lead_partial(blk)
                if cfg.kind == "opq":
                    if cfg.use_kernel:
                        adist = pq_lookup_op(blk["codes"], qe["lut"])
                    else:
                        adist = ref.pq_lookup_ref(blk["codes"], qe["lut"])
                    est = adist.T / cfg.theta
                elif cfg.kind == "ddcres":
                    est = (partial + blk["tsq"][None, :]
                           + qe["qtail_sq"][:, None] - slack[:, None])
                else:
                    est = partial * scale
                keep = (est <= tau[:, None]) & ok
                passed_b = keep.sum(-1, dtype=torch.int32)
                spill = (q_okm & (passed_b > C)).any()
                esc = spill | mode
                full = complete_all(best_d, best_i, tau, partial, ok, blk)
                screened = complete_screened(best_d, best_i, tau, keep, est,
                                             partial, blk)
                new_d, new_i, new_tau, completed, dropped = (
                    torch.where(esc, f, s) for f, s in zip(full, screened))
                dims_b = torch.where(
                    esc, nokf * (d_screen + d_complete),
                    nokf * d_screen
                    + completed.to(torch.float32) * d_complete)

            # policy evidence: a spill is full-strength evidence (screening
            # lost the block outright); other warm blocks give their screen
            # fraction; cold non-spill blocks (tau = inf) carry no signal
            frac = passed_b.to(torch.float32) / torch.clamp_min(n_ok, 1)
            warm = (n_ok > 0) & ~torch.isinf(tau)
            spill_evt = spill & ~mode
            obs = (warm | spill_evt) & (n_ok > 0)
            sig = torch.where(spill_evt, 1.0, frac)
            new_ewma = torch.where(obs & (n_obs > 0),
                                   alpha * sig + keep_w * ewma, ewma)
            ewma = torch.where(obs & (n_obs == 0), sig, new_ewma)
            n_obs = n_obs + obs.to(torch.int32)
            # the next block's mode: the chunk falls back when ANY member
            # query's model says screening loses, and recovers only once
            # every member is back under the hysteresis band
            live = q_okm & (n_obs > 0)
            want = (live & (ewma > thr)).any()
            stay = (live & (ewma > thr * pol.hysteresis)).any()
            # an escaped block paid the screen on top of the full
            # completion; a screened block saves the unscanned tail
            saved_blk = torch.where(
                esc, -(d_screen + pol.overhead_dims) * n_ok,
                (n_ok - completed) * d_complete - pol.overhead_dims * n_ok)
            fb = fb + esc.to(torch.int32)
            saved = saved + 2.0 * saved_blk
            escapes.append(esc)
            mode = torch.where(mode, stay, want)
            best_d, best_i, tau = new_d, new_i, new_tau
            surv = surv + completed
            passed = passed + passed_b
            dims = dims + dims_b
            dmin = torch.minimum(dmin, dropped)
        report = {"fb": fb.expand(c), "saved": saved,
                  "timeline": torch.stack(escapes).to(torch.float32)}
        return best_d, best_i, surv, passed, dmin, dims, report

    if init_carry is not None:
        best_d, best_i, tau, surv, passed, dims, dmin = init_carry
    for b in range(nb):
        blk = {key: v[b] for key, v in xs.items()}
        valid = blk["ids"] >= 0                               # (B,)
        n_ok = valid.sum(dtype=torch.int32)
        n_okf = n_ok.to(torch.float32)
        tau_k = torch.full_like(tau, _INF) if cfg.kind == "fdscan" else tau
        if cfg.kind == "ddcres":
            # partial <= tau_k is implied by the Eq. 7 estimate test below
            tau_k = tau + slack - qe["qtail_sq"] - tail_min
        rowhit = None
        if pr is not None:
            tau_k = torch.where(hits[:, b], tau_k, tau_skip)
            rowhit = rowhits[:, b]

        if grouped and not cfg.use_kernel:
            cand, acc, keep, est, dropped0, dims_scr = pdx_screen(
                blk, tau, tau_k, candidates(valid, rowhit, n_ok, n_okf)[0])
            passed = passed + keep.sum(-1, dtype=torch.int32)
            best_d, best_i, tau, completed, dropped = complete_compacted(
                best_d, best_i, tau, keep, est, acc, cand, dropped0, blk)
            surv = surv + completed
            dims = dims + dims_scr + completed.to(torch.float32) * (D - d1)
            dmin = torch.minimum(dmin, dropped)
            continue

        passed_b = None
        if cfg.kind == "opq":
            if cfg.use_kernel:
                adist = pq_lookup_op(blk["codes"], qe["lut"])
            else:
                adist = ref.pq_lookup_ref(blk["codes"], qe["lut"])
            est = adist.T / cfg.theta                         # (c, B)
            keep = (est <= tau[:, None]) & valid[None, :]
            partial = None
            dims_scr = candidates(valid, rowhit, n_ok, n_okf)[2] * float(
                qe["lut"].shape[1])
        elif cfg.use_kernel:
            if grouped:
                p, kp, cnt, ad = dco_scan_grouped_op(
                    blk["xl"], qlg, tau_k, scales_g, widths_g, n_ok,
                    block_n=block_n)
            else:
                p, kp, cnt, ad = dco_scan_op(blk["xl"], ql, tau_k, scales_arr,
                                             n_ok, block_n=block_n,
                                             block_d=block_d)
            partial, keep = p.T, kp.T.bool()                  # (c, B)
            est = partial * scale
            if rowhit is None:          # the kernel's keep counts
                passed_b = cnt.sum(0, dtype=torch.int32)
            dims_scr = ad.sum(0)        # measured dims entered per query
        else:
            partial = torch.clamp_min(
                blk["lsq"][None, :] - 2.0 * (ql @ blk["xl"].T)
                + ql_sq[:, None], 0.0)                        # (c, B)
            est = partial * scale
            keep = (est <= tau_k[:, None]) & valid[None, :]
            # the flat screen reads all d1 lead dims of every candidate
            # row of a probed block (tau_k < 0 marks a block the probe
            # skips)
            dims_scr = torch.where(
                tau_k >= 0.0, candidates(valid, rowhit, n_ok, n_okf)[2],
                0.0) * float(d1)
        if cfg.kind == "ddcres":
            # full-distance estimate (core.methods Eq. 7) refines the
            # conservative partial screen and drives compaction
            est = (partial + blk["tsq"][None, :]
                   + qe["qtail_sq"][:, None] - slack[:, None])
            keep = keep & (est <= tau[:, None])
            passed_b = None
        if rowhit is not None:
            keep = keep & rowhit
        if passed_b is None:
            passed_b = keep.sum(-1, dtype=torch.int32)

        if cfg.kind == "fdscan":
            exact = partial + torch.clamp_min(
                blk["tsq"][None, :] - 2.0 * (qt @ blk["xt"].T)
                + qt_sq[:, None], 0.0)
            okm, n_done, n_okq = candidates(valid, rowhit, n_ok, n_okf)
            exact = torch.where(okm, exact, _INF)
            best_d, best_i = _merge_topk(
                best_d, best_i, exact, blk["ids"][None, :].expand(c, B), k)
            surv = surv + n_done
            passed = passed + n_done
            dims = dims + n_okq * float(D)
            continue

        best_d, best_i, tau, completed, dropped = complete_screened(
            best_d, best_i, tau, keep, est, partial, blk)
        comp_w = float(D if cfg.kind == "opq" else D - d1)
        surv = surv + completed
        passed = passed + passed_b
        dims = dims + dims_scr + completed.to(torch.float32) * comp_w
        dmin = torch.minimum(dmin, dropped)
    if return_carry:
        return best_d, best_i, tau, surv, passed, dims, dmin
    return best_d, best_i, surv, passed, dmin, dims


def _probe_width(xs: dict, probe) -> int:
    """The width of a probed-partition mask over a partition-major layout:
    read back to the host, one sync per batch, before the block walk."""
    return int(torch.maximum(xs["part"].max(), probe.max())) + 1


def _chunk_inputs(q_lead, q_tail, q_extra: dict, probe, s: int, c: int,
                  **extra):
    """The per-chunk inputs of :func:`_scan_blocks`, rows [s, s + c) of
    the batch's queries, extras and probe, and of each tensor in
    ``extra`` (``qv``, ``tau0``, ``ew0``; the anytime carry), by name."""
    chunk = {"ql": q_lead[s:s + c], "qt": q_tail[s:s + c]}
    chunk.update({"qe." + key: v[s:s + c] for key, v in q_extra.items()})
    if probe is not None:
        chunk["pr"] = probe[s:s + c]
    chunk.update({key: v[s:s + c] for key, v in extra.items()
                  if v is not None})
    return chunk


def _span(xs: dict, span) -> dict:
    """The blocks [start, start + count) of a layout (views), or all."""
    if span is None:
        return xs
    start, count = span
    return {key: v[start:start + count] for key, v in xs.items()}


def _walk_chunk(cfg, state, xs, chunk: dict, n_part: int, forced=False):
    """One chunk's walk as a flat tuple of tensors: the six outputs of the
    fixed walk; the 7-tuple carry when the chunk carries one (``carry.0``
    ... ``carry.6``, the anytime path); the six outputs and the report's
    ``fb``, ``saved`` and ``timeline`` on the adaptive path."""
    qe = {key[3:]: v for key, v in chunk.items() if key.startswith("qe.")}
    carry = None
    if "carry.0" in chunk:
        carry = tuple(chunk[f"carry.{j}"] for j in range(7))
    out = _scan_blocks(cfg, state, xs, chunk["ql"], chunk["qt"], qe,
                       chunk.get("pr"), n_part, q_ok=chunk.get("qv"),
                       init_tau=chunk.get("tau0"),
                       init_ewma=chunk.get("ew0"), forced=forced,
                       init_carry=carry, return_carry=carry is not None)
    if isinstance(out[-1], dict):
        rep = out[-1]
        out = out[:-1] + (rep["fb"], rep["saved"], rep["timeline"])
    return out


#: the kernel launch counters a captured walk replays (module, attribute)
_COUNTERS = ((_dco_mod, "launches"), (_dco_mod, "grouped_launches"),
             (_pq_mod, "launches"))


def _launch_counts() -> tuple:
    return tuple(getattr(m, name) for m, name in _COUNTERS)


def _add_launches(counts) -> None:
    for (m, name), n in zip(_COUNTERS, counts):
        setattr(m, name, getattr(m, name) + n)


class _ChunkGraph:
    """One query chunk's walk over the layout's blocks, or over the blocks
    ``span`` = (start, count) of an anytime group (:func:`_walk_chunk`:
    every row block's screen, kernel launch, cut, completion and merge)
    captured once as a CUDA graph and replayed for each chunk of every
    batch, the port's counterpart of the reference's compiled ``lax.scan``.

    The chunk's inputs (queries, probe, and on the adaptive and anytime
    paths the valid-query mask, the seed and the carry) are copied into
    static input buffers before each replay; the outputs live in the
    graph's private memory pool and are cloned after it, as the next
    replay overwrites them.  The graph holds the addresses of the layout
    and state tensors, so it keeps both alive.  Capture follows
    ``torch.cuda.graph``'s rule: one eager walk of the chunk on the
    capture's side stream first (it builds the kernel library, fills the
    wrappers' caches and the cuBLAS workspaces), then the capture on that
    stream.  The set-up spans ``engine.warmup`` (the warm-up walk up to
    its end on the card; device work queued before it ends there too) and
    ``engine.capture`` (the capture and instantiation) carry the graph's
    ``id`` as ``graph``; each replay is the hot-path span
    ``engine.replay``.  The wrappers count a kernel where Python calls
    them, which during capture launches nothing, so the counts a capture
    took are taken back and added on every replay.  A failed capture or
    replay raises."""

    def __init__(self, cfg, state, xs, chunk: dict, n_part: int,
                 forced: bool = False, span=None):
        dev = chunk["ql"].device
        walk = _span(xs, span)
        self.inputs = {key: v.clone() for key, v in chunk.items()}
        with trace.setup_span("engine.warmup", graph=id(self)):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _walk_chunk(cfg, state, walk, self.inputs, n_part, forced)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)  # as torch.cuda.graph does on entry
        before = _launch_counts()
        with trace.setup_span("engine.capture", graph=id(self)):
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.graph, stream=side):
                self.outputs = _walk_chunk(cfg, state, walk, self.inputs,
                                           n_part, forced)
            self.graph.instantiate()
        self.launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        _add_launches(-n for n in self.launches)
        self.keep = (state, xs)
        self.replays = 0

    def run(self, chunk: dict) -> tuple:
        """Replay on ``chunk``; returns copies of the outputs."""
        for key, v in chunk.items():
            self.inputs[key].copy_(v)
        with trace.span("engine.replay"):
            self.graph.replay()
        self.replays += 1
        _add_launches(self.launches)
        return tuple(o.clone() for o in self.outputs)


def _walk(cfg, state, xs, chunk: dict, n_part: int, graphs, *,
          forced: bool = False, span=None) -> tuple:
    """One chunk's walk (:func:`_walk_chunk`) over ``xs`` or its blocks
    ``span``: eagerly without ``graphs`` (the CPU), else by replaying the
    graph cached there under (layout, state, cfg, mask width, forced,
    span, chunk input shapes), captured on first use."""
    if graphs is None:
        return _walk_chunk(cfg, state, _span(xs, span), chunk, n_part,
                           forced)
    key = (id(xs), id(state), cfg, n_part, forced, span,
           tuple((name, tuple(v.shape), v.dtype)
                 for name, v in chunk.items()))
    if key not in graphs:
        graphs[key] = _ChunkGraph(cfg, state, xs, chunk, n_part, forced,
                                  span)
    return graphs[key].run(chunk)


def _stream_topk_padded(state: dict, xs: dict, q_lead, q_tail,
                        q_extra: dict, probe, cfg: DcoEngineConfig,
                        graphs: dict | None = None):
    """All query chunks of a batch whose size is a whole number of
    chunks, concatenated (the reference's ``lax.map`` over chunks), on the
    fixed walk.  With ``graphs`` (a CUDA batch) each chunk replays the
    captured walk cached there; without, the chunks are walked eagerly."""
    nq = q_lead.shape[0]
    c = min(cfg.query_chunk, nq)
    n_part = 0 if probe is None else _probe_width(xs, probe)
    outs = [_walk(cfg, state, xs,
                  _chunk_inputs(q_lead, q_tail, q_extra, probe, s, c),
                  n_part, graphs) for s in range(0, nq, c)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(6))


def _seed_eval(state: dict, xs: dict, q_lead, q_tail, q_extra: dict,
               cfg: DcoEngineConfig):
    """Pre-scan seed for the adaptive policy, over the whole padded batch.

    The k-th exact distance over a row sample (the first block's first
    ``S = min(1024, B)`` rows) upper-bounds the true k-th, so screening
    against it never prunes a true neighbour under a lower-bound rule; the
    sample's pass fraction against that tau estimates the corpus survivor
    fraction before any block is scanned.  Returns (tau0 (nq,), ewma0
    (nq,)) on the device."""
    B = xs["xl"].shape[-2]
    D = q_lead.shape[1] + q_tail.shape[1]
    S = min(1024, B)
    ql, qt = q_lead, q_tail
    svalid = xs["ids"][0, :S][None, :] >= 0
    xl0 = xs["xl"][0]
    if xl0.dim() == 3:              # PDX grouped layout (DESIGN.md §8)
        Gg, dgp = xl0.shape[0], xl0.shape[2]
        d1 = ql.shape[1]
        qg = torch.nn.functional.pad(ql, (0, Gg * dgp - d1)).reshape(
            ql.shape[0], Gg, dgp).transpose(0, 1)
        lead_s = torch.zeros((ql.shape[0], S), dtype=torch.float32,
                             device=ql.device)
        for g in range(Gg):
            lead_s = lead_s + torch.clamp_min(
                xs["lsg"][0][g, :S][None, :] - 2.0 * (qg[g] @ xl0[g, :S].T)
                + (qg[g] ** 2).sum(1)[:, None], 0.0)
    else:
        lead_s = torch.clamp_min(
            xs["lsq"][0, :S][None, :] - 2.0 * (ql @ xl0[:S].T)
            + (ql ** 2).sum(1)[:, None], 0.0)
    ex = lead_s + torch.clamp_min(
        xs["tsq"][0, :S][None, :] - 2.0 * (qt @ xs["xt"][0, :S].T)
        + (qt ** 2).sum(1)[:, None], 0.0)
    ex = torch.where(svalid, ex, _INF)
    tau0 = _smallest(ex, min(cfg.k, S))[0][:, -1] * cfg.tau_slack
    if cfg.kind == "opq":           # opq evidence needs adist: stay neutral
        return tau0, torch.zeros_like(tau0)
    if cfg.kind == "ddcres":
        slack = 2.0 * cfg.m * torch.sqrt(
            torch.clamp_min(q_extra["var_d1"], 0.0))
        est_s = (lead_s + xs["tsq"][0, :S][None, :]
                 + q_extra["qtail_sq"][:, None] - slack[:, None])
    else:
        est_s = lead_s * _final_scale(cfg, state, D, ql.device)
    pass_s = ((est_s <= tau0[:, None]) & svalid).sum(-1, dtype=torch.int32)
    n_s = torch.clamp_min(svalid.sum(-1, dtype=torch.int32), 1)
    return tau0, pass_s.to(torch.float32) / n_s.to(torch.float32)


def _adaptive_topk(state: dict, xs: dict, q_lead, q_tail, q_extra: dict,
                   probe, cfg: DcoEngineConfig, nq: int, graphs):
    """The adaptive orchestration (DESIGN.md §5) of a padded batch: the
    seed's pass fraction decides per query chunk, before any block is
    scanned, between the switching walk and the full-scan body; the
    decision is the batch's one host read.  A ``force_fallback`` policy
    (the guardrail's demotion) sends every chunk to the full-scan body
    without a seed; IVF-probed batches get no seed (sampled rows may not
    be probe candidates), so their chunks all run the switching walk,
    whose spill gate keeps them certified."""
    nqp = q_lead.shape[0]
    c = min(cfg.query_chunk, nqp)
    nchunks = nqp // c
    q_valid = torch.arange(nqp, device=q_lead.device) < nq
    tau0 = ew0 = None
    if cfg.policy.force_fallback:
        chunk_full = np.ones(nchunks, bool)
    elif probe is None:
        tau0, ew0 = _seed_eval(state, xs, q_lead, q_tail, q_extra, cfg)
        thr = _policy_threshold(cfg, q_lead.shape[1],
                                q_lead.shape[1] + q_tail.shape[1],
                                q_extra)[2]
        chunk_full = ((ew0 > thr) & q_valid).reshape(nchunks, c).any(
            1).cpu().numpy()
    else:
        chunk_full = np.zeros(nchunks, bool)
    n_part = 0 if probe is None else _probe_width(xs, probe)
    outs = []
    for ci in range(nchunks):
        chunk = _chunk_inputs(q_lead, q_tail, q_extra, probe, ci * c, c,
                              qv=q_valid, tau0=tau0, ew0=ew0)
        outs.append(_walk(cfg, state, xs, chunk, n_part, graphs,
                          forced=bool(chunk_full[ci])))
    d, i, s, p, dm, dr, fb, saved = (torch.cat([o[j] for o in outs])
                                     for j in range(8))
    # the share of chunks that escaped each block (sum / n, not mean(), so
    # the quotient is the reference's to the last bit)
    timeline = torch.stack([o[8] for o in outs]).sum(0) / nchunks
    report = {"fallback_blocks": fb[:nq], "est_saved_flops": saved[:nq],
              "rule_timeline": timeline}
    return d[:nq], i[:nq], s[:nq], p[:nq], dm[:nq], dr[:nq], report


def _anytime_topk(state: dict, xs: dict, q_lead, q_tail, q_extra: dict,
                  probe, cfg: DcoEngineConfig, nq: int, deadline_ts: float,
                  block_group: int, graphs=None):
    """Deadline-aware anytime driver (DESIGN.md §7): a loop over groups of
    ``block_group`` row blocks; every chunk of the padded batch advances by
    the group from its carry (a replayed graph a group span, or eagerly
    without ``graphs``), then the device is synchronized once, the fault
    plan's ``sleep_block`` runs and the wall clock is checked; on expiry
    the running top-k is returned.  At least one group always runs.
    Returns the six outputs of :func:`stream_topk` and ``coverage``, the
    fraction of corpus blocks scanned."""
    from repro_torch.testing import faults

    fp = faults.active()
    nqp, k = q_lead.shape[0], cfg.k
    c = min(cfg.query_chunk, nqp)
    dev = q_lead.device
    carry = (torch.full((nqp, k), _INF, device=dev),
             torch.full((nqp, k), -1, dtype=torch.int32, device=dev),
             torch.full((nqp,), _INF, device=dev),
             torch.zeros((nqp,), dtype=torch.int32, device=dev),
             torch.zeros((nqp,), dtype=torch.int32, device=dev),
             torch.zeros((nqp,), device=dev),
             torch.full((nqp,), _INF, device=dev))
    n_part = 0 if probe is None else _probe_width(xs, probe)
    nb = xs["xl"].shape[0]
    G = max(1, int(block_group))
    done = 0
    while done < nb:
        g = min(G, nb - done)
        outs = [_walk(cfg, state, xs, _chunk_inputs(
                    q_lead, q_tail, q_extra, probe, s, c,
                    **{f"carry.{j}": v for j, v in enumerate(carry)}),
                      n_part, graphs, span=(done, g))
                for s in range(0, nqp, c)]
        carry = tuple(torch.cat([o[j] for o in outs]) for j in range(7))
        done += g
        # the sync that makes the wall check honest: without it the loop
        # races ahead of the device queue and the deadline only fires
        # after every group has been queued
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        faults.sleep_block(fp)
        if time.monotonic() > deadline_ts:
            break
    d, i, _, surv, passed, dims, dmin = carry
    return (d[:nq], i[:nq], surv[:nq], passed[:nq], dmin[:nq], dims[:nq],
            done / nb)


def stream_topk(state: dict, q_lead, q_tail, cfg: DcoEngineConfig,
                q_extra: dict | None = None, probe=None, blocks=None,
                deadline_ts: float | None = None, block_group: int = 8,
                graphs: dict | None = None):
    """Streaming top-k over the corpus for a batch of rotated queries.

    q_lead (Q, d1), q_tail (Q, D - d1) tensors on the state's device.
    ``state`` is a ``torch_engine.build_device_state`` export, optionally
    with ``row_ids`` (original ids when rows were permuted), ``row_part``
    with ``probe`` (Q, nprobe) partition ids for IVF probing, and (opq
    rule) ``codes``.  ``blocks`` is an optional
    pre-built :func:`build_stream_blocks` layout; with it, ``state`` needs
    only the per-rule scalars and, for ddcres, ``tail_min`` (the least
    tail energy of the real rows).  Ragged batches pad to a
    whole number of query chunks; N need not divide ``cfg.row_block``.

    Returns (dists_sq (Q, k), ids (Q, k) int32, survivors (Q,), passed
    (Q,), dropped_min_est (Q,), dims_read (Q,)).  ``dropped_min_est[q] >
    dists_sq[q, k-1]`` certifies exactness for lower-bound rules: every row
    a capacity cut dropped has a lower bound above the returned k-th
    distance.

    ``cfg.dim_groups`` > 1 serves the scan from the PDX layout, with the
    R-cut's observer folded into ``dropped_min_est``; fdscan and opq force
    G = 1.  Cached ``blocks`` must have the group count
    :func:`_effective_groups` resolves for ``cfg``, else ``ValueError``.

    With an adaptive ``cfg.policy`` (``core.policy.PolicyConfig``) the
    blocks are served adaptively (DESIGN.md §5) and a seventh value is
    returned, a report of per-query ``fallback_blocks`` and
    ``est_saved_flops`` and the per-block ``rule_timeline`` (the share of
    query chunks served by the full completion).  The adaptive walk uses
    the inline screen for every rule but opq (whose ``pq_lookup`` keeps
    its kernel): a kernel that freezes pruned rows leaves partials the
    escape cannot reuse.  ``force_fallback`` (the guardrail's demotion)
    serves every chunk by the full-scan body, without a seed.

    ``deadline_ts`` (a ``time.monotonic()`` timestamp) arms the anytime
    mode (DESIGN.md §7) on the fixed walk: ``block_group`` blocks at a
    time, one device synchronization and wall check a group, the running
    top-k returned on expiry; the seventh value is ``coverage``, the
    fraction of corpus blocks scanned (1.0: the outputs equal the
    non-deadline path's bit for bit).  Queries with coverage < 1 are
    uncertified whatever ``dropped_min_est`` says.  An adaptive policy
    with a deadline raises ``ValueError``: the backend strips it first.

    On a CUDA device each query chunk replays one CUDA graph of its walk
    (:class:`_ChunkGraph`; an anytime group replays one graph a group
    span).  ``graphs`` is the cache of those graphs that a caller keeps
    beside ``blocks`` and drops with them (a graph holds the layout's
    addresses); without it the graphs live for this call only.  On the
    CPU the chunks are walked eagerly."""
    q_extra = dict(q_extra or {})
    adaptive = _adaptive(cfg)
    # the adaptive walk screens inline but for opq, whose pq_lookup adist
    # is valid for every row and so keeps its kernel
    inline = adaptive and cfg.kind != "opq"
    if inline and cfg.use_kernel:
        cfg = dataclasses.replace(cfg, use_kernel=False)
    if cfg.use_kernel is None:
        cfg = dataclasses.replace(cfg, use_kernel=q_lead.is_cuda
                                  and not inline)
    ge = _effective_groups(cfg)
    if blocks is None:
        blocks = build_stream_blocks(state, cfg.row_block, dim_groups=ge)
    gb = blocks["xl"].shape[1] if blocks["xl"].dim() == 4 else 1
    gp = _group_plan(q_lead.shape[1], ge)[0] if ge > 1 else 1
    if gb != gp:
        raise ValueError(
            f"cached blocks layout has {gb} dim group(s) but cfg resolves "
            f"to {gp}: rebuild build_stream_blocks with dim_groups={ge}")
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
        if probe is not None:
            probe = padq(probe)
    if probe is not None and "part" not in blocks:
        raise ValueError("IVF probing needs a partition-major layout: "
                         "build the blocks from a state with row_part")
    if not q_lead.is_cuda:
        graphs = None
    elif graphs is None:
        graphs = {}
    if deadline_ts is not None:
        if adaptive:
            raise ValueError(
                "anytime deadlines run the fixed streaming scan: strip the "
                "adaptive policy from cfg before a deadline call "
                "(DESIGN.md §7)")
        return _anytime_topk(state, blocks, q_lead, q_tail, q_extra, probe,
                             cfg, nq, deadline_ts, block_group, graphs)
    if adaptive:
        return _adaptive_topk(state, blocks, q_lead, q_tail, q_extra, probe,
                              cfg, nq, graphs)
    out = _stream_topk_padded(state, blocks, q_lead, q_tail, q_extra, probe,
                              cfg, graphs)
    return tuple(o[:nq] for o in out)

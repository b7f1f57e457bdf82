#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device   the card, and its name and power limit from nvidia-smi;
  2. build    nvcc builds the kernels from src/repro_torch/kernels/csrc;
  3. parity   each kernel against its plain PyTorch version on the card,
              at the main path's launch shapes (and dco_scan at a mesh
              shard's 4,000-row block), and the grouped kernel at G = 1
              against the flat one;
  4. lm       the LM serving path (repro_torch.models, ServingEngine) on
              Qwen3-4B at its published widths and depth, random bf16
              weights from a seed (8.05 GB, made on the card a tensor at a
              time): decode token by token against the full forward pass
              (prefill) over every prefix of 2 x 24 tokens (logits, K/V,
              greedy ids where the margin is clear), the smoke config on
              the card against the same weights on the CPU, the engine
              (8 slots, max_len 1,024) over 16 seeded requests of 16-128
              prompt tokens and 64 new (walls, tokens/s, step ms from CUDA
              events, bytes a step and its bound), then decode
              steps over a 32,768-position cache at batch 8 (decode_32k
              cut from batch 128); it runs before any CUDA graph or
              profiler session of the process (both slow every later
              eager launch), and its profiled steps run last
              (lm_profile);
  5. encdec   the encoder-decoder serving path on seamless-m4t-large-v2 at
              its published widths and depth (24 + 24 layers, random bf16
              weights from a seed, made on the card): decode from the
              cross K/V of a prefill over 256 seeded source frames against
              the full forward pass over every prefix of 2 x 24 tokens,
              the smoke config on the card against the CPU, prompts of
              max_len - 1, max_len and max_len + 4 tokens through an engine
              (ROADMAP C8), and the lm phase's engine arm (walls, tokens/s,
              step ms, bytes a step and its bound);
  6. ssm      the Mamba-2 serving path on mamba2-130m at its published
              widths and depth (24 layers): the chunked SSD against the
              naive scan at full widths (B 2, S 1,024, a random initial
              state), decode from a prefill's states against the full
              forward pass over every prefix, the smoke config on the card
              against the CPU, the engine's state carried from one request
              to the next (ROADMAP C10) against the CPU engine's ids, the
              lm phase's engine arm, and a prefill of 32,768 tokens at
              batch 4 (prefill_32k cut from batch 32: time, peak memory);
  7. moe      the MoE serving path on DeepSeek-V2 at its published widths,
              cut from 60 to 6 layers (the dense first layer and 5 MoE
              layers, 42.50 GB of random bf16 weights from a seed, the
              router f32): decode from a prefill's latent cache against
              the full forward pass over every prefix of 1 x 32 tokens
              (the MoE's dropless path throughout), one MoE layer's
              capacity path without drops against its dropless path at
              256 tokens, the DeepSeek-V2 and V3 smoke configs on the card
              against the CPU, prompts past an engine's cache (C8), and
              the lm phase's engine arm (bytes a step counting the experts
              its tokens touch);
  8. hybrid   the hybrid serving path on Jamba-v0.1 at its published
              widths, cut from 4 groups to 1 (8 layers: 7 Mamba-2 blocks,
              one attention layer, MoE on the 4 odd layers; 26.54 GB):
              decode from a prefill's K/V and SSM states against the full
              forward pass over every prefix of 1 x 32 tokens, the smoke
              config on the card against the CPU, C8 prompts, the state
              carried across requests (C10) against the CPU engine's ids,
              and the engine arm;
  9. train    the training path (repro_torch.train, the data pipeline, the
              CLI's checkpoint/restart driver): each family's smoke config
              (OLMo, PaliGemma, seamless, mamba2, DeepSeek-V2 and V3,
              Jamba) two train steps on the card against the CPU from one
              state (loss, gnorm, f32 masters; the CPU's MoE routing
              imposed, the moves counted); OLMo-1B at its published widths
              and depth (1.18 B parameters, f32 masters and AdamW moments,
              bf16 weights and grads), remat="block" against "none" on 1 x
              4,096 tokens, then 8 x 4,096 (train_4k cut from batch 256)
              as 2 microbatches of 4: a warm-up and 4 timed steps on the
              pipeline's batches (step ms from CUDA events, tokens/s, peak
              bytes, flops by formula and their bound), 2 more steps on
              the last batch, whose loss must fall; mamba2-130m at full
              size, 2 steps at 4 x 4,096; the CLI crashed at step 5 and
              resumed, bit for bit an uninterrupted run; eager, before any
              CUDA graph or profiler session, its profiled step in
              lm_profile;
 10. placement the mesh placements (A9 (d)) as rank processes on this
              card, ``chip_smoke.py --placement-rank DIR BACKEND``: two
              gloo ranks and one NCCL rank started together.  EP arm:
              DeepSeek-V2 at its published widths cut to 2 layers (the
              dense first layer and one MoE layer of 160 experts, 10.72 GB
              of random bf16 weights from the moe phase's seed) on (data 1,
              model 2), each rank holding 80 experts: a prefill of 2 x 64
              tokens (the capacity path) against the same model on one
              card and on the (1, 1) NCCL mesh (routing counted), then 2
              decode steps against the (1, 1) mesh, and the bytes a rank
              holds against those param_specs gives.  FSDP arm: OLMo-1B at
              its published widths cut to 4 layers on (data 2, model 1), 2
              train steps of 2 x 4,096 tokens (one row a rank) against the
              (1, 1) mesh (loss, gnorm), masters and moments half a rank,
              the state saved on (2, 1) and restored onto (1, 1) (the
              masters bit-equal, shard for shard).  Meanwhile the host
              draws the 1M corpus and the guardrails' drift scenario and
              fits the main phase's DDCopq (A22); no number of the phase
              is a mesh's throughput (one card);
 11. graph    PDScanning+ fitted on the 1M corpus below: the engine's
              block walk run eagerly on the card (its walls taken first,
              before any CUDA graph of the process) against the walk
              captured once as a CUDA graph a query chunk and replayed
              (capture seconds, graph nodes, pool bytes, launches a
              replay), in five interleaved pairs, all six outputs equal;
              the session served by the same graph; an arm at
              query_chunk = 100; and the top-k selection against the
              stable sort it replaced, on the engine's real score rows;
 12. main     the flat streaming search at GIST1M shape (1M x 960 f32,
              100 queries, k = 10, the default SchedulePolicy) for
              PDScanning+ (dco_scan) and DDCopq (pq_lookup), with the
              kernels' launch counts over one batch, QPS, recall against a
              float64 brute-force ground truth and the device memory held;
              every stream session from here on: its timed batches replay
              the graph captured by its first batch, and no batch
              captures another;
 13. pdx      the same PDScanning+ method, unrefitted, served from the PDX
              layout (SchedulePolicy(dim_groups=4), dco_scan_grouped) with
              the same record, its ids held against the flat path's;
 14. ivf      an IVF index over the 1M corpus (n_list = 4096, the 4 sqrt(N)
              rule of Faiss's wiki for about 1M vectors; nprobe = 64) built
              on the host, served on the card by the same fitted
              PDScanning+ (flat: dco_scan; PDX: dco_scan_grouped) and
              DDCopq (pq_lookup) with a completion budget of a whole row
              block (IVF_BLOCK_CAPACITY), and the flat PDScanning+ again at
              the default budget: build seconds, QPS, recall, candidates
              and row blocks hit per query chunk, launches; PDScanning+'s
              ids held against the port's host IVF (IVFIndex.search through
              scan_topk) for every query, and 0 uncertified at the row
              block's budget;
 15. delta    the LSM write path: PDScanning+ fitted on 1M - 4,096 rows
              with the graph phase's PCA (fitted on all 1M rows, the delta
              included, so its QPS is not that of a main-rows fit; the ids
              check does not depend on the fit), the last 4,096 added (the
              "delta" mode), its ids held against
              a freshly materialized session on the same method, the next
              add a "merge"; then an IVF delta at 100k rows (n_list = 64,
              nprobe = n_list) held against the host IVF;
 16. two_stage the 1M PDScanning+ on engine="two_stage" (no kernel): QPS,
              recall, per-query survivors against its capacity, ids held
              against the streaming engine's where nothing was cut;
 17. adaptive SchedulePolicy(adaptive=True) at 1M on the fitted
              PDScanning+: the dataset's queries flat and PDX (ids held
              against the fixed session's, no dco_scan launch), 100 OOD
              queries (make_ood_queries, severity 1.0; ids held against an
              FDScanning session's, beside the fixed screen's record), and
              DDCopq (pq_lookup launches in the graph); each batch's six
              outputs and report held against the eager walk of the same
              chunks, fallback blocks, forced chunks, QPS;
 18. anytime  the flat PDScanning+ at anytime_block_group = 8: the grouped
              walk eagerly and as a graph a group span, a 60 s deadline
              (outputs equal to the non-deadline batch, coverage 1.0,
              launches, syncs) and a 10 ms one (coverage in (0, 1), every
              query uncertified, within the full wall plus one group);
              one 60 s batch on the PDX layout;
 19. host     backend="host" (the numpy scan) over the first 100k rows
              with 10 queries, its ids held against the torch backend's;
              HNSW built on the first 2,000 rows with FDScanning and
              PDScanning+ (build seconds, DCOs and dims scanned), recall@10
              of its walk;
 20. guardrails an 18-batch "recovering" drift scenario at 100k through a
              guarded PDScanning+ session: the breaker opens during the
              drift, every demoted batch gives an FDScanning session's
              ids, and it closes again after;
 21. serving  the serving front (SearchService(slots=16, k=10)) over a
              fixed PDScanning+ session on the first 994,880 rows, with the
              fitted PCA: its capacity calibrated on the session itself
              (steady step, one 1,024-row add and the stall of the step
              after it, split into the delta build and the capture), then
              250 Poisson arrivals at 0.7 of that capacity in simulated
              time (the measured walls of the real steps), one 1,024-row
              insert every 50 requests (5 inserts in all, the 5th a
              merge): every ticket served, certified and exact against the
              rows visible when it was served; latency percentiles,
              sustained QPS, graphs captured (one, and one a write),
              dco_scan launches a step, device bytes after the last write;
 22. serving_overload the grown session at 2x its steady capacity,
              max_queue 64, shed_oldest, a deadline of 4 steady steps (the
              anytime spans captured first): every ticket done, shed or
              timed out, partial answers uncertified, full certified ones
              exact;
 23. serving_ood the adaptive PDScanning+ session at 1M behind the service,
              a 50/50 interleave of the dataset's and OOD queries at 0.7 of
              its own capacity: per class p50/p99, fallback blocks, every
              answer exact and certified, no dco_scan launch;
 24. replica  shard mode over the 1M corpus in 3 sessions (healthy: the flat
              session's ids; shard 1 dead: coverage 2/3, uncertified, the
              live shards' top-10; revived: full answers again), then
              replicate mode over 3 sessions of the first 100k rows (a slow
              replica hedged; replica 0 killed after 5 dispatches,
              ejected, revived through half-open), virtual and real walls
              and the tier's counters;
 25. persist  a card session at 95,904 rows saved, three 1,024-row adds in
              the WAL, a fourth torn mid-frame, the session dropped and
              loaded back onto the card (the frames replayed "cold", no
              device work before the first search; the live ids, exact), a
              bit-flipped snapshot refused;
 26. rules    all 8 methods at 100k x 960 with the same queries, and each
              method that groups again at dim_groups = 4 (and PDScanning+
              on the inline R-cut path);
 27. mesh     the sharded global top-k as rank processes on this card,
              each rank ``chip_smoke.py --mesh-rank DIR BACKEND`` (file
              rendezvous, a deadline, killed past it): an NCCL group of
              two on one card refused before its initialisation; two gloo
              ranks, each holding half of the 1M corpus for PDScanning+
              (the flat session's ids 100 of 100, 0 uncertified, the ranks
              bit-equal, a 4,000-row shard block, 875 dco_scan launches a
              rank and batch, half the flat session's device bytes; QPS
              and the exchange's share of the wall), then at 100k DDCres,
              DADE, the two-stage engine, a ragged 13-query batch,
              DDCopq's lower-bound fallback and an add() that rebuilds;
              one NCCL rank at 100k (PDScanning+, DDCres, DADE) with the
              exchange on device tensors; every arm held against the same
              method on one card at the shard's row block, the exact rules
              against FDScanning's ids; then the mesh behind the serving
              front (rank 0 drives SearchService, rank 1 follows): the 1M
              session under 100 Poisson requests, at 100k an add, a
              budget and a fault on rank 1 alone; then the replica tier
              over mesh sessions: replicate mode over two 1M sessions (a
              slow replica hedged, replica 0 killed, ejected, revived and
              readmitted; every done ticket the flat session's ids, rank
              1 searching once per rank-0 device dispatch, 125 dco_scan
              launches a rank and dispatch), shard mode over 3 mesh
              sessions at 100k (healthy, shard 1 dead, revived, an add to
              the tail shard), and a tier on the NCCL world of one;
 28. attention DCO-screened decode attention at Qwen3-4B's decode shapes
              (B 8, 32 heads, 8 KV heads, head_dim 128, a 32,768-position
              bf16 cache, ragged cur_len): cap = S against exact
              attention, one sequence on the CPU against the card, CUDA-
              event walls of the screened and the exact version and of
              torch's scaled_dot_product_attention (the library
              yardstick), the error, the softmax mass the top-C keeps, the
              bytes each reads by formula and the screened call's device
              operations under torch.profiler;
 29. profile  for each 1M session (flat, PDX, DDCopq), the main phase's
              own, kept alive until here (about 32 GB of the card with
              the others below) rather than built again: one more batch
              under torch.profiler (device
              operations, zero fills, CUDA runtime calls, device-busy share
              against the phase's unprofiled wall), then its kernel's time
              at the main path's real inputs beside its bound, its plain
              version and, where one exists, a single PyTorch call
              computing the same function (dco_scan_grouped beside
              dco_scan on the same rows and queries; beside dco_scan, an
              fp32 torch.addmm forming the same (N, Q) contrib from
              precomputed norms, the product only), and for the three
              kernels that were redesigned (dco_scan, dco_scan_grouped,
              pq_lookup) the earlier design, kept in the kernel library
              for this, on the same inputs (its time is the kernel line's
              `earlier_ms`).  dco_scan at the main shape must be one device
              operation (no zero fill).  This comes last because a
              profiler session and CUDA graphs leave every later launch
              slower on the host for the rest of the process
              (scripts/pdx_ab.py measures it), which would bias the QPS of
              later phases.  The IVF flat sessions (at both completion
              budgets), the two-stage session and the adaptive arms (in
              distribution, OOD beside the fixed screen, DDCopq), each
              kept from its phase, are profiled too, without a kernel
              timing;
 30. lm_profile the lm, encdec, ssm, moe and hybrid phases' steps under
              torch.profiler on the same seeded weights and depths (and
              one train step of check (c) from the same masters), with
              past_cache="drop" as the
              engine passes it: three engine-shaped steps of each, three
              of Qwen3-4B with one slot past the cache (the C8 guard on),
              and one of Qwen3-4B over the 32,768-position cache
              (launches a step, device ms, busy share against the phase's
              unprofiled step, top ops).
Then the kernel table (with each kernel's launches a batch on the main,
IVF, adaptive and anytime paths, a 16-query step of the serving arm and,
for dco_scan, a rank's batch on the 2-rank mesh and a rank's 16-query
dispatch of the replica tier over it),
the nvidia-smi line and the result line.  Every
check raises on failure, so the script exits nonzero; without a CUDA card,
or without the repo beside it, it prints no result and exits nonzero.
"""
from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

K = 10
N_MAIN = 1_000_000
N_RULES = 100_000
N_LIST = 4096                    # 4 sqrt(N) at N = 1M (Faiss's wiki)
NPROBE = 64
N_LIST_RULES = 64                # the facade's default n_list
DELTA_ROWS = 4096                # SchedulePolicy.delta_merge_threshold
#: the IVF sessions' completion budget a query and row block, the row
#: block itself: every row that passes the screen completes, so the
#: certificate holds by construction (the reference's certified
#: configuration).  A query's first probed block screens at tau = inf and
#: its probed rows are near neighbours, so a smaller budget drops rows
#: whose lower bounds fall under the final k-th distance: the default 128
#: left about half the queries uncertified at 100k rows on the CPU, and
#: 512 left some uncertified at 1M on the card (lists of up to 1,026
#: rows).  The default budget's share is logged beside it.
IVF_BLOCK_CAPACITY = 4096
#: the IVF sessions the profile phase profiles (phase_ivf label -> row)
KEPT_IVF = {"flat": "ivf", "flat_default_budget": "ivf_default_budget"}
HOST_QUERIES = 10                # the numpy scan takes about 1 s a query
#: a graph built row by row in Python (3,000 rows before the lm phase
#: came; cut for the run's time limit)
HNSW_ROWS = 2000
HNSW_PARAMS = {"m": 16, "ef_construction": 100}
HNSW_EF = 64
GRAPH_PAIRS = 5                  # interleaved eager / graph batches
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM data sheet, fp32 outside the TCs
ANYTIME_GROUP = 8                # SchedulePolicy.anytime_block_group
GENEROUS_S = 60.0                # a deadline no batch reaches
TIGHT_S = 0.010                  # a deadline the first group already passes
DRIFT_BATCHES = 18               # thirds: in distribution, OOD, back
#: breaker pacing for an 18-batch scenario: two drifted batches with
#: evidence trip it, two clean canaries re-promote it, and every flip
#: waits two batches; a quarter of the queries audited, four at a time
DRIFT_GUARDRAIL = dict(min_dwell=2, trip_after=2, promote_after=2,
                       audit_rate=0.25, audit_batch=4)
SERVE_SLOTS = 16                 # SearchService(slots=16): one query chunk
#: 400 requests and 8 inserts before the lm phase came; cut for the
#: run's time limit, keeping an insert every 50 requests and the merge at
#: the 5th insert
SERVE_REQUESTS = 250
SERVE_INSERT_EVERY = 50          # an insert every 50 requests
SERVE_INSERT_ROWS = 1024
LAMBDA_FRACTION = 0.7            # offered load / calibrated capacity
OVERLOAD_FACTOR = 2.0
OVERLOAD_QUEUE = 64
OOD_REQUESTS = 200
SERVE_SEED = 11
REPLICAS = 3
SLOW_REPLICA_S = 0.05            # FaultPlan(slow_replica_s=): virtual
PERSIST_ADDS = 3
PERSIST_ROWS = 1024


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 50) -> float:
    """Device time per call: ``reps`` calls captured in a CUDA graph and
    replayed between CUDA events, so host launch overhead is excluded."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def eager_ms(fn, iters: int = 200) -> float:
    """Wall per call issued from the host, as the engine's block loop
    issues it (host launch overhead included)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(nbytes: float, flops: float):
    """Least time for the work: bytes over HBM bandwidth or flops over the
    fp32 peak, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def distances64(X, Q, dev):
    """Squared distances of every query to every row, (nq, N) float64,
    formed on ``dev`` in float64 in row chunks: the ground truth of any
    visible prefix or subset of the rows is a selection over them."""
    import numpy as np
    import torch
    q = torch.as_tensor(Q, device=dev, dtype=torch.float64)
    qn = (q ** 2).sum(1)[:, None]
    out = np.empty((Q.shape[0], X.shape[0]), np.float64)
    for s in range(0, X.shape[0], 50_000):
        x = torch.as_tensor(X[s:s + 50_000], device=dev).double()
        d = (x ** 2).sum(1)[None, :] - 2.0 * q @ x.T + qn
        out[:, s:s + x.shape[0]] = d.cpu().numpy()
    return out


def nearest(d2, k: int = K):
    """Exact top-k column ids of each row of a distance matrix, nearest
    first (a column set to +inf is never picked before a finite one)."""
    import numpy as np
    part = np.argpartition(d2, k - 1, axis=1)[:, :k]
    order = np.argsort(np.take_along_axis(d2, part, 1), axis=1)
    return np.take_along_axis(part, order, 1)


def _near_a_gate(x, q, tau, sc, block_d: int, partial):
    """Pairs whose estimate lies within rounding of tau (1e-4 of it) at
    some gate of the staged scan: after each dim block the gate decides
    whether the pair's next block is summed at all, so a pair within
    rounding of tau at an early gate may end on either side of the last
    one.  ``partial`` (the plain version's) gives the last gate."""
    import torch
    tol = 1e-4 * tau.abs()[None, :]
    near = (partial * sc[-1] - tau[None, :]).abs() <= tol
    for di, hi in enumerate(range(block_d, x.shape[1], block_d)):
        prefix = torch.cdist(x[:, :hi], q[:, :hi]) ** 2
        near |= (prefix * sc[di] - tau[None, :]).abs() <= tol
    return near


def phase_parity(dev):
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dco_scan import dco_scan_plain
    from repro_torch.kernels.pq_lookup import pq_lookup_plain

    rng = np.random.default_rng(11)
    n, n_valid = 4096, 4096 - 333             # ragged last block
    cases = 0
    for nq in (16, 128):
        for d1 in (48, 128, 130, 256):
            block_d = min(128, max(8, -(-d1 // 8) * 8))
            for kind in ("lb", "adsampling", "ratio"):
                sc = ref.make_dco_scales(kind, d1, block_d, D=2 * d1,
                                         theta=0.8, device=dev)
                nr = torch.tensor([n_valid], dtype=torch.int32, device=dev)
                widths = ops._widths(d1, block_d, dev)
                # (a) integer-valued inputs: every float32 sum is exact in
                # any order, so all four outputs must agree bit for bit
                x = torch.as_tensor(rng.integers(-4, 5, (n, d1)),
                                    dtype=torch.float32, device=dev)
                q = torch.as_tensor(rng.integers(-4, 5, (nq, d1)),
                                    dtype=torch.float32, device=dev)
                tau = torch.as_tensor(rng.uniform(2 * d1, 10 * d1, nq),
                                      dtype=torch.float32, device=dev)
                tau[::5] = -1.0               # padded queries prune all
                # block_n 256 stores counts and dims by cluster, 40 adds
                # them to a zero fill
                for block_n in (256, 40):
                    got = ops.dco_scan_op(x, q, tau, sc, nr, block_n=block_n,
                                          block_d=block_d)
                    want = dco_scan_plain(x, q, tau, sc, widths, nr,
                                          block_n=block_n, block_d=block_d)
                    for name, g, w in zip(("partial", "keep", "counts",
                                           "dims"), got, want):
                        check(torch.equal(g, w), f"dco_scan {name} differs "
                              f"(nq={nq} d1={d1} {kind} block_n={block_n})")
                # (b) Gaussian inputs: summation order moves the last bits,
                # so keep may differ only for pairs within rounding of tau
                x = torch.randn(n, d1, device=dev)
                q = torch.randn(nq, d1, device=dev)
                tau = torch.as_tensor(rng.uniform(0.5 * d1, 2.5 * d1, nq),
                                      dtype=torch.float32, device=dev)
                gp, gk, _, _ = ops.dco_scan_op(x, q, tau, sc, nr,
                                               block_n=256, block_d=block_d)
                wp, wk, _, _ = dco_scan_plain(x, q, tau, sc, widths, nr,
                                              block_n=256, block_d=block_d)
                near = _near_a_gate(x, q, tau, sc, block_d, wp)
                check(not bool(((gk != wk) & ~near).any()),
                      f"dco_scan keep differs away from tau (d1={d1} {kind})")
                both = (gk == 1) & (wk == 1)
                check(torch.allclose(gp[both], wp[both], rtol=1e-4, atol=1e-3),
                      f"dco_scan partial differs (nq={nq} d1={d1} {kind})")
                cases += 1
    # the row block of a 500,000-row mesh shard (the mesh phase): 4,000
    # rows at the engine's block_n = 256, the last tile 160 rows
    shard_block = 0
    for kind in ("lb", "adsampling"):
        d1, nq, n_shard = 128, 16, 4000
        sc = ref.make_dco_scales(kind, d1, 128, D=2 * d1, device=dev)
        x = torch.as_tensor(rng.integers(-4, 5, (n_shard, d1)),
                            dtype=torch.float32, device=dev)
        q = torch.as_tensor(rng.integers(-4, 5, (nq, d1)),
                            dtype=torch.float32, device=dev)
        tau = torch.as_tensor(rng.uniform(2 * d1, 10 * d1, nq),
                              dtype=torch.float32, device=dev)
        nr = torch.tensor([n_shard], dtype=torch.int32, device=dev)
        got = ops.dco_scan_op(x, q, tau, sc, nr, block_n=256, block_d=128)
        want = dco_scan_plain(x, q, tau, sc, ops._widths(d1, 128, dev), nr,
                              block_n=256, block_d=128)
        for name, g, w in zip(("partial", "keep", "counts", "dims"), got,
                              want):
            check(torch.equal(g, w), f"dco_scan {name} differs at the "
                  f"4,000-row shard block ({kind})")
        shard_block += 1
    unprobed = parity_unprobed(rng, dev)
    grouped = 0
    for nq in (16, 128):
        for G in (1, 4, 5):
            for dg in (32, 10, 33):
                grouped += parity_grouped(rng, dev, n, n_valid, nq, G, dg)
    pq_err = 0.0
    # the main path's shape with the engine's uint8 codes and with int32,
    # a ragged one whose blocks stage several queries, and K = 512 (int32)
    pq_cases = ((16, 16, 256, torch.uint8), (16, 16, 256, torch.int32),
                (21, 4, 16, torch.uint8), (21, 4, 16, torch.int32),
                (16, 16, 512, torch.int32))
    for nq, m, k, dtype in pq_cases:
        codes = torch.as_tensor(rng.integers(0, k, (n, m)), dtype=dtype,
                                device=dev)
        lut = torch.rand(nq, m, k, device=dev) * 10
        got, want = ops.pq_lookup_op(codes, lut), pq_lookup_plain(codes, lut)
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-3),
              f"pq_lookup differs from its plain version (nq={nq} m={m} "
              f"k={k} {dtype})")
        pq_err = max(pq_err, float((got - want).abs().max()))
    torch.cuda.synchronize()
    log("parity", dco_scan_cases=cases,
        dco_scan_shard_block_cases=shard_block,
        dco_scan_grouped_cases=grouped,
        pq_lookup_cases=len(pq_cases), pq_lookup_max_abs_err=pq_err,
        all_unprobed_cases=unprobed)


def parity_unprobed(rng, dev) -> int:
    """A launch no query of the chunk probes (every tau -1, as the IVF gate
    sets a block outside each query's probe), flat and grouped at the main
    path's shapes: bit for bit against the plain version, with keep,
    counts and dims all zero.  Returns the number of cases checked."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.dco_scan import (dco_scan_grouped_plain,
                                              dco_scan_plain)
    n, nq, d1, G, dg = 4096, 16, 128, 4, 32
    tau = torch.full((nq,), -1.0, device=dev)
    nr = torch.tensor([n], dtype=torch.int32, device=dev)
    x = torch.as_tensor(rng.integers(-4, 5, (n, d1)), dtype=torch.float32,
                        device=dev)
    q = torch.as_tensor(rng.integers(-4, 5, (nq, d1)), dtype=torch.float32,
                        device=dev)
    sc = torch.ones(1, device=dev)
    flat = (ops.dco_scan_op(x, q, tau, sc, nr, block_n=256, block_d=128),
            dco_scan_plain(x, q, tau, sc, ops._widths(d1, 128, dev), nr,
                           block_n=256, block_d=128))
    xg = x.reshape(n, G, dg).transpose(0, 1).contiguous()
    qg = q.reshape(nq, G, dg).transpose(0, 1).contiguous()
    scg, widths = torch.ones(G, device=dev), ops._widths(d1, dg, dev)
    grouped = (ops.dco_scan_grouped_op(xg, qg, tau, scg, widths, nr),
               dco_scan_grouped_plain(xg, qg, tau, scg, widths, nr,
                                      block_n=256))
    for kernel, (got, want) in (("dco_scan", flat),
                                ("dco_scan_grouped", grouped)):
        for name, g, w in zip(("partial", "keep", "counts", "dims"), got,
                              want):
            check(torch.equal(g, w), f"{kernel} with every tau -1 differs "
                  f"from its plain version in {name}")
        check(not (got[1].any() or got[2].any() or got[3].any()),
              f"{kernel} with every tau -1 kept or counted a pair")
    return 2


def parity_grouped(rng, dev, n, n_valid, nq, G, dg) -> int:
    """dco_scan_grouped against its plain version on x (G, n, dg), with a
    ragged last group when G > 1; at G = 1 also against the flat kernel
    with block_d == dg.  Returns the number of cases checked."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.dco_scan import dco_scan_grouped_plain

    d1 = G * dg - (dg // 3 if G > 1 else 0)
    widths = torch.tensor([min(dg, d1 - g * dg) for g in range(G)],
                          dtype=torch.float32, device=dev)
    pad = (torch.arange(G * dg, device=dev) >= d1).reshape(G, 1, dg)
    sc = torch.ones(G, device=dev)
    nr = torch.tensor([n_valid], dtype=torch.int32, device=dev)
    # (a) integer-valued inputs: all four outputs must agree bit for bit
    x = torch.as_tensor(rng.integers(-4, 5, (G, n, dg)), dtype=torch.float32,
                        device=dev).masked_fill(pad, 0.0)
    q = torch.as_tensor(rng.integers(-4, 5, (G, nq, dg)), dtype=torch.float32,
                        device=dev).masked_fill(pad, 0.0)
    tau = torch.as_tensor(rng.uniform(2 * d1, 10 * d1, nq),
                          dtype=torch.float32, device=dev)
    tau[::5] = -1.0                           # padded queries prune all
    got = ops.dco_scan_grouped_op(x, q, tau, sc, widths, nr)
    want = dco_scan_grouped_plain(x, q, tau, sc, widths, nr, block_n=256)
    for name, g, w in zip(("partial", "keep", "counts", "dims"), got, want):
        check(torch.equal(g, w), f"dco_scan_grouped {name} differs "
              f"(nq={nq} G={G} dg={dg})")
    # (b) Gaussian inputs: keep exact away from tau, partials allclose
    x = torch.randn(G, n, dg, device=dev).masked_fill(pad, 0.0)
    q = torch.randn(G, nq, dg, device=dev).masked_fill(pad, 0.0)
    tau = torch.as_tensor(rng.uniform(0.5 * d1, 2.5 * d1, nq),
                          dtype=torch.float32, device=dev)
    gout = ops.dco_scan_grouped_op(x, q, tau, sc, widths, nr)
    gp, gk = gout[0], gout[1]
    wp, wk, _, _ = dco_scan_grouped_plain(x, q, tau, sc, widths, nr,
                                          block_n=256)
    near = (wp - tau[None, :]).abs() <= 1e-4 * tau.abs()[None, :]
    check(not bool(((gk != wk) & ~near).any()),
          f"dco_scan_grouped keep differs away from tau (G={G} dg={dg})")
    both = (gk == 1) & (wk == 1)
    check(torch.allclose(gp[both], wp[both], rtol=1e-4, atol=1e-3),
          f"dco_scan_grouped partial differs (nq={nq} G={G} dg={dg})")
    if G > 1:
        return 2
    # (c) one group of width block_d is the flat kernel, bit for bit
    flat = ops.dco_scan_op(x[0], q[0], tau, sc, nr, block_n=256, block_d=dg)
    for name, f, g in zip(("partial", "keep", "counts", "dims"), flat, gout):
        check(torch.equal(f, g), f"dco_scan_grouped at G = 1 differs from "
              f"dco_scan in {name} (nq={nq} dg={dg})")
    return 3


def check_rule(method, res, rec, fd_ids, gt) -> None:
    """Exact methods return FDScanning's ids and the ground truth;
    estimators reach recall@10 0.9; every result is well formed."""
    import numpy as np
    from repro_torch.vecdata import recall_at_k
    name = f"{rec['method']} (dim_groups={rec['dim_groups']})"
    if method.exact:
        check(np.array_equal(np.sort(res.ids, 1), fd_ids),
              f"{name} ids differ from FDScanning")
        check(recall_at_k(res.ids, gt) == 1.0,
              f"{name} ids differ from the ground truth")
    else:
        check(rec["recall_at_10"] >= 0.9, f"{name} recall below 0.9")
    check(np.isfinite(res.dists).all() and res.ids.shape == (
        gt.shape[0], K), f"{name} returned malformed results")


def run_method(X, Q, gt, method, dev, *, fitted=None, schedule=None,
               index_kind="flat", index=None, nprobe=NPROBE):
    """Fit ``method`` on the host (or serve the already ``fitted`` one
    under ``schedule``, over ``index`` when ``index_kind`` is "ivf"), then
    search Q on the card: a first (materializing) batch and three timed
    batches, the first of which counts each kernel's launches.  Returns
    the session, last result and a record of the run."""
    import numpy as np
    import torch
    from repro_torch.api import SearchSession, open_index
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels import pq_lookup as pq_mod
    from repro_torch.vecdata import recall_at_k

    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    if fitted is None:
        sess = open_index(X, method=method, device=dev, schedule=schedule)
    else:
        sess = SearchSession(fitted, schedule, index_kind=index_kind,
                             index=index, device=dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.search(Q, K, nprobe=nprobe)            # materializes the layout
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    graphs = sess.backend._graphs
    captured = set(map(id, graphs.values()))
    replays = sum(g.replays for g in graphs.values())
    dco_mod.launches = dco_mod.grouped_launches = pq_mod.launches = 0
    t0 = time.perf_counter()
    res = sess.search(Q, K, nprobe=nprobe)      # ends in a device->host copy
    walls = [time.perf_counter() - t0]
    launches = {"dco_scan": dco_mod.launches,
                "dco_scan_grouped": dco_mod.grouped_launches,
                "pq_lookup": pq_mod.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        res = sess.search(Q, K, nprobe=nprobe)
        walls.append(time.perf_counter() - t0)
    if sess.backend._resolved_engine() == "stream":
        # the timed batches replay the graph the first batch captured
        chunks = -(-Q.shape[0] // min(sess.policy.query_chunk, Q.shape[0]))
        check(set(map(id, graphs.values())) == captured
              and sum(g.replays for g in graphs.values()) - replays
              == 3 * chunks, f"{method}: a timed batch did not replay the "
              "captured block walk")
    ex = res.stats.extra
    rec = {
        "method": method, "dim_groups": sess.policy.dim_groups,
        "use_kernel": sess.policy.use_kernel,
        "n": int(X.shape[0]), "dim": int(X.shape[1]),
        "nq": int(Q.shape[0]), "fit_s": fit_s, "first_search_s": first_s,
        "search_walls_s": walls,
        "qps": float(Q.shape[0] / np.median(walls)),
        "recall_at_10": recall_at_k(res.ids, gt),
        "dims_read_mean": ex["dims_read_mean"],
        "survivors_mean": ex.get("survivors_mean"),
        "uncertified_queries": ex.get("uncertified_queries"),
        # the corpus layout's footprint on the card (its tensors alone, and
        # all that is allocated), what was allocated before the session
        # (leftovers of earlier phases), and the peak while it was built
        # and searched
        "layout_bytes": sum(v.nbytes for t in (sess.backend._blocks,
                                               sess.backend._state)
                            if t is not None for v in t.values()),
        "device_bytes_held": torch.cuda.memory_allocated(dev),
        "device_bytes_before": before,
        "device_bytes_peak": torch.cuda.max_memory_allocated(dev),
        "launches_per_batch": launches,
        "graphs": [graph_record(g) for g in graphs.values()],
    }
    codes = (sess.backend._blocks or {}).get("codes")
    if codes is not None:           # DDCopq: the PQ codes' share of it
        rec["codes_dtype"] = str(codes.dtype)
        rec["codes_bytes"] = codes.nbytes
        rec["codes_bytes_at_int32"] = codes.numel() * 4
    return sess, res, rec


def device_events(prof):
    """A finished torch.profiler session's events summed by name, read
    from its kineto results: ({name: (count, device us)} of the device's
    kernels, copies and fills, {name: count} of the host's events, CUDA
    runtime calls among them).  The same sums as ``key_averages()``'s
    device and runtime rows, without the Python event tree it builds
    first (about 80 us an event: 20 s for a 250,000-kernel batch)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            count, us = device.get(name, (0, 0.0))
            device[name] = (count + 1, us + e.duration_ns() / 1e3)
        else:
            host[name] = host.get(name, 0) + 1
    return device, host


def profile_batch(sess, Q, wall_s: float, nprobe: int = NPROBE) -> dict:
    """One more batch under torch.profiler: the device operations it ran
    (kernels apart from copies and fills), the CUDA runtime calls the host
    made, and the device time.  The busy share divides the device time by
    ``wall_s``, the median wall of the unprofiled batches, since the
    profiler's own overhead stretches the profiled batch's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.search(Q, K, nprobe=nprobe)
        torch.cuda.synchronize()
        profiled_wall_s = time.perf_counter() - t0
    device, host = device_events(prof)
    kernels = memops = fills = 0
    dev_us = 0.0
    top = []
    for name, (count, us) in device.items():
        dev_us += us
        if name.startswith(("Memcpy", "Memset")):
            memops += count
        else:
            kernels += count
            fills += count if "FillFunctor" in name else 0
        top.append((us, count, name[:60]))
    runtime = sum(c for name, c in host.items() if name.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
         "cudaMemcpy", "cudaMemset")))
    top.sort(reverse=True)
    return {
        "device_kernels": kernels, "device_copies_fills": memops,
        "fill_kernels": fills,
        "runtime_launch_calls": runtime, "device_ms": dev_us / 1e3,
        "unprofiled_wall_ms": wall_s * 1e3,
        "profiled_wall_ms": profiled_wall_s * 1e3,
        "device_busy_share": (dev_us / 1e6) / wall_s if dev_us > 0 else None,
        "host_us_per_device_op": (wall_s * 1e6 / (kernels + memops)
                                  if kernels + memops else None),
        "top_device_ops": [{"name": n, "count": c, "ms": us / 1e3}
                           for us, c, n in top[:12]],
    }


def inline_agreement(sess, Q, res, dev):
    """Serve the same fitted method over the same index, under the same
    policy, through the engine's inline torch screen (no kernel); return
    the overlap of its top-k sets with the kernel path's (1.0 = the same
    neighbours) and its ids."""
    import dataclasses
    from repro_torch.api import SearchSession
    from repro_torch.vecdata import recall_at_k
    inline = SearchSession(sess.method,
                           dataclasses.replace(sess.policy, use_kernel=False),
                           index_kind=sess.index_kind, index=sess.index,
                           device=dev)
    other = inline.search(Q, K, nprobe=NPROBE)
    agree = recall_at_k(other.ids, res.ids)
    del inline
    return agree, other.ids


def device_ops(fn) -> int:
    """The device operations one call of ``fn`` issues: the nodes of a CUDA
    graph that captures it (``fn`` warmed up first).  A graph, unlike a
    profiler session, sees every operation whatever ran before it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return graph_nodes(graph)


def graph_nodes(graph) -> int:
    """The nodes of a CUDA graph captured with ``keep_graph=True``."""
    import ctypes
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    count = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                  ctypes.byref(count))
    check(err == 0, f"cuGraphGetNodes failed ({err})")
    return count.value


def graph_pool_bytes(graph):
    """Device bytes reserved by a CUDA graph's private memory pool (the
    segments the caching allocator tags with its pool id), or None when
    this PyTorch's memory snapshot has no pool ids."""
    import torch
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == pool)


def span_seconds(name: str, since_ns: int = 0, **attrs) -> list:
    """Durations (s) of the program's recorded spans named ``name``
    (``repro_torch.utils.trace``) that started at or after ``since_ns``
    (a ``time.time_ns()`` mark) with the given attributes, oldest first."""
    from repro_torch.utils import trace
    return [sp.duration_ns / 1e9 for sp in trace.spans()
            if sp.name == name and sp.start_ns >= since_ns
            and all(sp.attrs.get(key) == v for key, v in attrs.items())]


def graph_seconds(g, name: str) -> float:
    """A captured walk's ``engine.warmup`` or ``engine.capture`` span."""
    return span_seconds(name, graph=id(g))[-1]


def graph_record(g) -> dict:
    """What one captured block walk (stream_engine._ChunkGraph) holds."""
    return {"warmup_s": graph_seconds(g, "engine.warmup"),
            "capture_s": graph_seconds(g, "engine.capture"),
            "nodes": graph_nodes(g.graph),
            "pool_bytes": graph_pool_bytes(g.graph),
            "launches_per_replay": list(g.launches), "replays": g.replays,
            "chunk": int(g.inputs["ql"].shape[0])}


def time_dco_scan(sess, Q, res, dev):
    """dco_scan at the main path's real inputs: the first row block of the
    corpus, the first query chunk, and the tau the scan ends with; beside
    it, in the same call, the earlier design on the same inputs and the
    product alone as one fp32 torch.addmm."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels.dco_scan import dco_scan_plain

    be = sess.backend
    cfg = be._config(K)
    ql, _, _ = be._prep_queries(Q[:cfg.query_chunk])
    x = be._blocks["xl"][0]
    q = torch.as_tensor(np.ascontiguousarray(ql), device=dev)
    tau = torch.as_tensor(res.dists[:cfg.query_chunk, -1], device=dev)
    n, d1 = x.shape
    nq = q.shape[0]
    block_d = min(128, max(8, -(-d1 // 8) * 8))
    nd = -(-d1 // block_d)
    sc = torch.ones(nd, device=dev)
    nr = torch.tensor([n], dtype=torch.int32, device=dev)
    widths = ops._widths(d1, block_d, dev)

    def op():
        return ops.dco_scan_op(x, q, tau, sc, nr, block_n=256,
                               block_d=block_d)

    def tiled():                # the earlier design: 32 x 16 tiles, a fill
        return dco_mod._launch("dco_scan_tiled_launch", x, q, tau, sc,
                               widths, nr, n, nq, (d1, block_d), 256)

    got = op()
    want = dco_scan_plain(x, q, tau, sc, widths, nr, block_n=256,
                          block_d=block_d)
    near = (want[0] - tau[None, :]).abs() <= 1e-4 * tau.abs()[None, :]
    check(not bool(((got[1] != want[1]) & ~near).any()),
          "dco_scan keep differs at the main path's inputs")
    err = float((got[0] - want[0]).abs().max())
    # both designs sum each pair in the same order: equal bit for bit
    for name, o, g in zip(("partial", "keep", "counts", "dims"), tiled(),
                          got):
        check(torch.equal(o, g), f"the earlier dco_scan design differs in "
              f"{name} at the main path's inputs")
    nodes = device_ops(op)
    check(nodes == 1, f"dco_scan_op at the main shape is {nodes} device "
          "operations, not the kernel alone")
    clusters = _build.load_library().dco_scan_max_active_clusters(block_d,
                                                                  256)
    # the product only, not the function: no gating, no clamp, no outputs
    # but the (N, Q) contrib of one dim block
    base = ((x * x).sum(1)[:, None] + (q * q).sum(1)[None, :]).contiguous()
    qt = q.T

    def product():
        return torch.addmm(base, x, qt, beta=1.0, alpha=-2.0)

    entered = float(got[3].sum())               # (row, query, dim) triples
    nb = -(-n // 256)
    nbytes = 4 * (n * d1 + nq * d1 + nq + 2 * nd + 1) \
        + n * nq * (4 + 1) + nb * nq * (4 + 4)
    flops = 2.0 * entered + 2.0 * (n + nq) * d1
    bms, by = bound_ms(nbytes, flops)
    ms = cuda_ms(op)
    earlier = cuda_ms(tiled)
    product_ms = cuda_ms(product)
    plain = cuda_ms(lambda: dco_scan_plain(x, q, tau, sc, widths, nr,
                                           block_n=256, block_d=block_d))
    call = eager_ms(op)
    log("kernel_timing", kernel="dco_scan", shape=[n, nq, d1], ms=ms,
        earlier_design_ms=earlier, product_only_addmm_ms=product_ms,
        plain_ms=plain, eager_call_ms=call, bound_ms=bms, bound_by=by,
        bytes=nbytes, flops=flops, max_abs_err=err, device_ops=nodes,
        max_active_clusters=clusters, clusters_launched=nb)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "redesigned": True, "earlier_ms": earlier,
            "product_only_addmm_ms": product_ms}


def grouped_planes_needed(xg, qg, tau, sc, widths, nr):
    """Rows and queries whose group-g slice the grouped scan must read, for
    each group g: those with a (row, query) pair still alive when group g
    starts, as the plain version's partial over groups 0..g-1 says (the
    same pairs the dims-entered count charges)."""
    import torch
    from repro_torch.kernels.dco_scan import dco_scan_grouped_plain

    G, n, _ = xg.shape
    valid = (torch.arange(n, device=xg.device) < nr)[:, None]
    acc = torch.zeros((n, tau.shape[0]), device=xg.device)
    rows, queries = [], []
    for g in range(G):
        if g:
            acc = dco_scan_grouped_plain(xg[:g], qg[:g], tau, sc[:g],
                                         widths[:g], nr, block_n=256)[0]
        alive = (acc * sc[max(g - 1, 0)] <= tau[None, :]) & valid
        rows.append(int(alive.any(1).sum()))
        queries.append(int(alive.any(0).sum()))
    return rows, queries


def time_dco_scan_grouped(sess, Q, res, dev):
    """dco_scan_grouped at the PDX path's real inputs: the first row block
    (G, 4096, dg), the first query chunk split the same way and the tau
    the scan ends with; beside it, in the same call, the flat dco_scan on
    the same rows and queries."""
    import numpy as np
    import torch
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.dco_scan import dco_scan_grouped_plain

    be = sess.backend
    cfg = be._config(K)
    ql, _, _ = be._prep_queries(Q[:cfg.query_chunk])
    xg = be._blocks["xl"][0]                            # (G, B, dg)
    G, n, dg = xg.shape
    nq, d1 = ql.shape
    q = torch.as_tensor(np.ascontiguousarray(ql), device=dev)
    qg = torch.nn.functional.pad(q, (0, G * dg - d1)).reshape(
        nq, G, dg).transpose(0, 1).contiguous()
    tau = torch.as_tensor(res.dists[:cfg.query_chunk, -1], device=dev)
    sc = torch.ones(G, device=dev)
    widths = ops._widths(d1, dg, dev)
    nr = torch.tensor([n], dtype=torch.int32, device=dev)

    def grouped():
        return ops.dco_scan_grouped_op(xg, qg, tau, sc, widths, nr,
                                       block_n=256)

    got = grouped()
    want = dco_scan_grouped_plain(xg, qg, tau, sc, widths, nr, block_n=256)
    near = (want[0] - tau[None, :]).abs() <= 1e-4 * tau.abs()[None, :]
    check(not bool(((got[1] != want[1]) & ~near).any()),
          "dco_scan_grouped keep differs at the PDX path's inputs")
    err = float((got[0] - want[0]).abs().max())
    # the same rows in the flat layout, for the flat kernel
    xf = xg.transpose(0, 1).reshape(n, G * dg)[:, :d1].contiguous()
    block_d = min(128, max(8, -(-d1 // 8) * 8))
    scf = torch.ones(-(-d1 // block_d), device=dev)

    def flat():
        return ops.dco_scan_op(xf, q, tau, scf, nr, block_n=256,
                               block_d=block_d)

    fl = flat()
    check(not bool(((fl[1] != got[1]) & ~near).any()),
          "dco_scan and dco_scan_grouped keep differ away from tau")
    entered = float(got[3].sum())               # (row, query, dim) triples
    rows_in, queries_in = grouped_planes_needed(xg, qg, tau, sc, widths, nr)
    nb = -(-n // 256)
    nbytes = 4 * (dg * (sum(rows_in) + sum(queries_in)) + nq + 2 * G + 1) \
        + n * nq * (4 + 1) + nb * nq * (4 + 4)
    flops = 2.0 * entered + 2.0 * (n + nq) * d1
    bms, by = bound_ms(nbytes, flops)
    def tiled():                # the earlier design: the flat body's tiles
        return dco_mod._launch("dco_scan_grouped_tiled_launch", xg, qg, tau,
                               sc, widths, nr, n, nq, (G, dg), 256)

    # both designs sum each group in the same order: equal bit for bit
    for name, o, g in zip(("partial", "keep", "counts", "dims"), tiled(),
                          got):
        check(torch.equal(o, g), f"the earlier grouped design differs in "
              f"{name} at the PDX path's inputs")
    # the product only, not the function: each group's (N, Q) contrib as
    # one fp32 torch.baddbmm over the G groups, no gating, no running sum
    base = ((xg * xg).sum(2)[:, :, None]
            + (qg * qg).sum(2)[:, None, :]).contiguous()
    qgt = qg.transpose(1, 2)

    def product():
        return torch.baddbmm(base, xg, qgt, beta=1.0, alpha=-2.0)

    ms = cuda_ms(grouped)
    earlier = cuda_ms(tiled)
    flat_ms = cuda_ms(flat)
    product_ms = cuda_ms(product)
    plain = cuda_ms(lambda: dco_scan_grouped_plain(
        xg, qg, tau, sc, widths, nr, block_n=256))
    call = eager_ms(grouped)
    log("kernel_timing", kernel="dco_scan_grouped", shape=[G, n, nq, dg],
        ms=ms, earlier_design_ms=earlier,
        product_only_baddbmm_ms=product_ms,
        flat_dco_scan_same_inputs_ms=flat_ms, plain_ms=plain,
        eager_call_ms=call, bound_ms=bms, bound_by=by, bytes=nbytes,
        flops=flops, max_abs_err=err, dims_entered=entered,
        flat_dims_entered=float(fl[3].sum()), rows_entering_group=rows_in,
        queries_entering_group=queries_in,
        keep_pairs=int(got[1].sum()))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "redesigned": True, "earlier_ms": earlier,
            "product_only_baddbmm_ms": product_ms}


def time_pq_lookup(sess, Q, dev):
    """pq_lookup at the main path's real inputs: the first row block's
    codes, as the engine stores them, and the first query chunk's LUTs;
    beside it, in the same call, the earlier design on int32 codes."""
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.pq_lookup import pq_lookup_plain

    be = sess.backend
    cfg = be._config(K)
    _, _, qe = be._prep_queries(Q[:cfg.query_chunk])
    codes = be._blocks["codes"][0]
    lut = torch.as_tensor(qe["lut"], device=dev)
    n, m = codes.shape
    nq, _, k = lut.shape
    got, want = ops.pq_lookup_op(codes, lut), pq_lookup_plain(codes, lut)
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-3),
          "pq_lookup differs at the main path's inputs")
    err = float((got - want).abs().max())
    # the library yardstick: one embedding_bag over (m, k)-offset codes
    flat = (codes.long() + torch.arange(m, device=dev)[None, :] * k)
    weight = lut.permute(1, 2, 0).reshape(m * k, nq).contiguous()
    lib_out = torch.nn.functional.embedding_bag(flat, weight, mode="sum")
    check(torch.allclose(lib_out, want, rtol=1e-4, atol=1e-3),
          "embedding_bag does not compute the same function")
    # the earlier design: int32 codes, the LUTs of up to 96 KB of queries
    # staged per block by scalar loads
    lib = _build.load_library()
    codes32 = codes.to(torch.int32)
    bq_staged = max(1, min(nq, 96 * 1024 // (m * k * 4)))

    def staged():
        out = torch.empty((n, nq), dtype=torch.float32, device=dev)
        _build.check(lib, lib.pq_lookup_staged_launch(
            codes32.data_ptr(), lut.data_ptr(), out.data_ptr(), n, nq, m, k,
            bq_staged, torch.cuda.current_stream(dev).cuda_stream),
            "pq_lookup_staged")
        return out

    check(torch.allclose(staged(), want, rtol=1e-4, atol=1e-3),
          "the earlier pq_lookup design differs at the main path's inputs")
    nbytes = codes.element_size() * n * m + 4 * (nq * m * k + n * nq)
    flops = float(n * nq * m)
    bms, by = bound_ms(nbytes, flops)
    ms = cuda_ms(lambda: ops.pq_lookup_op(codes, lut))
    earlier = cuda_ms(staged)
    plain = cuda_ms(lambda: pq_lookup_plain(codes, lut))
    lib_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        flat, weight, mode="sum"))
    call = eager_ms(lambda: ops.pq_lookup_op(codes, lut))
    log("kernel_timing", kernel="pq_lookup", shape=[n, nq, m, k],
        codes_dtype=str(codes.dtype), ms=ms, earlier_design_ms=earlier,
        plain_ms=plain, library_ms=lib_ms, eager_call_ms=call, bound_ms=bms,
        bound_by=by, bytes=nbytes, flops=flops, max_abs_err=err)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "redesigned": True, "earlier_ms": earlier}


def host_ivf_ids(method, index, Q, nprobe):
    """The port's host IVF, the oracle of the device probe: IVFIndex.search
    through the numpy scan_topk, query by query, on the same fitted
    method and index."""
    import numpy as np
    from repro_torch.core.engine import QueryBatch
    batch = QueryBatch.create(method, Q)
    return np.stack([index.search(method, batch, qi, K, nprobe)[1]
                     for qi in range(Q.shape[0])])


def same_sets(a, b):
    """Per query: do the two top-k lists hold the same ids?"""
    import numpy as np
    return (np.sort(a, 1) == np.sort(b, 1)).all(1)


def blocks_hit(sess, Q, nprobe):
    """Row blocks a query chunk hits (a block whose partition span holds a
    partition some query of the chunk probes), read on the host from the
    backend's probe and the blocks' partition spans."""
    import numpy as np
    be = sess.backend
    probed, _ = be._probe(Q, nprobe)
    part = be._blocks["part"]
    pmin = part.amin(1).cpu().numpy()
    pmax = part.amax(1).cpu().numpy()
    hit = ((probed[:, None, :] >= pmin[None, :, None])
           & (probed[:, None, :] <= pmax[None, :, None])).any(-1)
    c = be._config(K).query_chunk
    per_chunk = [int(hit[s:s + c].any(0).sum())
                 for s in range(0, Q.shape[0], c)]
    return {"row_blocks": int(part.shape[0]),
            "blocks_hit_per_chunk_mean": float(np.mean(per_chunk)),
            "blocks_hit_per_chunk_max": max(per_chunk),
            "blocks_hit_per_query_mean": float(hit.sum(1).mean())}


def phase_ivf(X, Q, gt, pdsp, opq, dev, kept, built=None):
    """The IVF probe path at 1M: one host-built index, four sessions on
    the fitted methods.  Returns the index and each session's record; the
    flat PDScanning+ sessions at both budgets stay in ``kept`` (as
    ``"ivf"`` and ``"ivf_default_budget"``) for the profile phase.
    ``built``: the index and its build's seconds, built beforehand
    (``draw_in_background``), or None to build it here."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy
    from repro_torch.search.ivf import IVFIndex

    if built is None:
        t0 = time.perf_counter()
        ivf = IVFIndex(n_list=N_LIST, seed=0).build(X)
        built = (ivf, time.perf_counter() - t0)
    ivf, build_s = built
    sizes = np.array([len(lst) for lst in ivf.lists])
    log("ivf_build", n=int(X.shape[0]), n_list=N_LIST,
        seconds=build_s,
        lloyd_s=ivf.build_seconds["lloyd"],
        assign_s=ivf.build_seconds["assign"],
        list_rows_min=int(sizes.min()), list_rows_max=int(sizes.max()),
        list_rows_mean=float(sizes.mean()))
    t0 = time.perf_counter()
    host_ids = host_ivf_ids(pdsp, ivf, Q, NPROBE)
    host_s = time.perf_counter() - t0
    recs = {}
    bc = IVF_BLOCK_CAPACITY
    for label, fitted, schedule, kernel in (
            ("flat", pdsp, SchedulePolicy(block_capacity=bc), "dco_scan"),
            ("pdx", pdsp, SchedulePolicy(block_capacity=bc, dim_groups=4),
             "dco_scan_grouped"),
            ("DDCopq", opq, SchedulePolicy(block_capacity=bc), "pq_lookup"),
            ("flat_default_budget", pdsp, SchedulePolicy(), "dco_scan")):
        t0 = time.perf_counter()
        sess, res, rec = run_method(X, Q, gt, fitted.name, dev,
                                    fitted=fitted, schedule=schedule,
                                    index_kind="ivf", index=ivf,
                                    nprobe=NPROBE)
        rec.update(label=label, n_list=N_LIST, nprobe=NPROBE,
                   block_capacity=schedule.block_capacity,
                   n_dco_per_query=res.stats.n_dco / Q.shape[0],
                   **blocks_hit(sess, Q, NPROBE))
        if fitted is pdsp:
            same = same_sets(res.ids, host_ids)
            rec.update(host_ivf_s=host_s,
                       host_ivf_ids_equal=int(same.sum()),
                       host_ivf_ids_equal_in_order=int(
                           (res.ids == host_ids).all(1).sum()))
        else:
            rec["inline_id_agreement"], _ = inline_agreement(sess, Q, res,
                                                             dev)
        log("ivf", **rec, phase_s=time.perf_counter() - t0)
        launches = rec["launches_per_batch"]
        check(launches[kernel] > 0 and sum(launches.values())
              == launches[kernel],
              f"the IVF {label} path did not run through {kernel} alone")
        if fitted is not pdsp:
            check(rec["inline_id_agreement"] >= 0.99, "IVF DDCopq results "
                  "differ between pq_lookup and the plain gather")
        elif label != "flat_default_budget":    # reported, not held
            check(bool(same.all()), f"IVF {label} PDScanning+ ids differ "
                  f"from the host IVF on {int((~same).sum())} queries")
            check(rec["uncertified_queries"] == 0.0,
                  f"IVF {label} PDScanning+ left queries uncertified")
        recs[label] = rec
        if label in KEPT_IVF:
            kept[KEPT_IVF[label]] = (sess, res)
        del sess, res
        torch.cuda.empty_cache()
    return ivf, recs


def phase_delta(X, Q, gt, Xr, gt_r, pdsp, dev):
    """The LSM write path: a 4,096-row delta after a 1M - 4,096 main layout
    (PDScanning+ with ``pdsp``'s PCA, fitted on every row, the delta's
    too, as the serving phase's is; the rest of the method is fitted on
    the main rows), then the merge; an IVF delta at the rules depth."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    from repro_torch.core.methods import make_method
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels import pq_lookup as pq_mod
    from repro_torch.vecdata import recall_at_k

    t_phase = time.perf_counter()
    n0 = N_MAIN - DELTA_ROWS
    t0 = time.perf_counter()
    sess = SearchSession(make_method("PDScanning+", pca=pdsp.state["pca"])
                         .fit(X[:n0]), SchedulePolicy(), device=dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sess.search(Q, K)                           # materializes the main layout
    first_s = time.perf_counter() - t0
    be = sess.backend
    n_main0, written0 = be._n_main, be.rows_written
    main_bytes = sum(v.nbytes for v in be._blocks.values())
    t0 = time.perf_counter()
    sess.add(X[n0:])
    add_s = time.perf_counter() - t0
    check(sess.last_write_mode == "delta",
          f"a {DELTA_ROWS}-row add took {sess.last_write_mode!r}, not delta")
    torch.cuda.synchronize()
    dco_mod.launches = dco_mod.grouped_launches = pq_mod.launches = 0
    t0 = time.perf_counter()
    res = sess.search(Q, K)                     # builds the delta segment
    after_add_s = time.perf_counter() - t0
    launches = {"dco_scan": dco_mod.launches,
                "dco_scan_grouped": dco_mod.grouped_launches,
                "pq_lookup": pq_mod.launches}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = sess.search(Q, K)
        walls.append(time.perf_counter() - t0)
    ex = res.stats.extra
    rec = {"method": "PDScanning+", "n_main": n0, "n_delta": DELTA_ROWS,
           "pca_fit_rows": N_MAIN,
           "fit_s": fit_s, "first_search_s": first_s, "add_s": add_s,
           "first_search_after_add_s": after_add_s, "search_walls_s": walls,
           "qps": float(Q.shape[0] / np.median(walls)),
           "recall_at_10": recall_at_k(res.ids, gt),
           "dims_read_mean": ex["dims_read_mean"],
           "uncertified_queries": ex["uncertified_queries"],
           "rows_written": be.rows_written, "merges": be.merges,
           "main_layout_bytes": main_bytes,
           "combined_layout_bytes": sum(
               v.nbytes for v in be._delta_blocks.values()),
           "device_bytes_held": torch.cuda.memory_allocated(dev),
           "launches_per_batch": launches}
    t0 = time.perf_counter()
    fresh = SearchSession(sess.method, SchedulePolicy(), device=dev)
    merged = fresh.search(Q, K)
    rec["rematerialize_first_search_s"] = time.perf_counter() - t0
    same = same_sets(res.ids, merged.ids)
    rec["merged_ids_equal"] = int(same.sum())
    rec["merged_ids_equal_in_order"] = int((res.ids == merged.ids).all(1).sum())
    del fresh, merged
    torch.cuda.empty_cache()
    n_main, rows_written, merges0 = be._n_main, be.rows_written, be.merges
    sess.add(X[n0:n0 + 1])
    rec["next_add_mode"] = sess.last_write_mode
    log("delta", **rec, phase_s=time.perf_counter() - t_phase)
    check(n_main == n_main0, "the delta add re-materialized the main "
          "layout")
    check(rows_written == written0 + DELTA_ROWS,
          f"rows_written rose by {rows_written - written0}, not "
          f"{DELTA_ROWS}")
    check(launches["dco_scan"] > 0, "the delta search launched no dco_scan")
    check(rec["recall_at_10"] == 1.0, "delta PDScanning+ recall@10 below 1.0")
    check(rec["uncertified_queries"] == 0.0,
          "delta PDScanning+ left queries uncertified")
    check(bool(same.all()), "delta ids differ from the merged session's")
    check(sess.last_write_mode == "merge" and be.merges == merges0 + 1,
          f"the add past the threshold took {sess.last_write_mode!r}")
    del sess, res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    n0r = N_RULES - DELTA_ROWS
    sess = open_index(Xr[:n0r], index="ivf", method="PDScanning+",
                      index_params={"n_list": N_LIST_RULES}, device=dev,
                      schedule=SchedulePolicy(
                          block_capacity=IVF_BLOCK_CAPACITY))
    sess.search(Q, K, nprobe=N_LIST_RULES)
    sess.add(Xr[n0r:])
    mode = sess.last_write_mode
    check(mode == "delta", f"the IVF add took {mode!r}, not delta")
    res = sess.search(Q, K, nprobe=N_LIST_RULES)
    host = host_ivf_ids(sess.method, sess.index, Q, N_LIST_RULES)
    same = same_sets(res.ids, host)
    log("delta_ivf", n_main=n0r, n_delta=DELTA_ROWS, n_list=N_LIST_RULES,
        nprobe=N_LIST_RULES, mode=mode, host_ivf_ids_equal=int(same.sum()),
        recall_at_10=recall_at_k(res.ids, gt_r),
        uncertified_queries=res.stats.extra["uncertified_queries"],
        phase_s=time.perf_counter() - t0)
    check(bool(same.all()), "the IVF delta's ids differ from the host IVF")
    check(recall_at_k(res.ids, gt_r) == 1.0,
          "the IVF delta at full probe is not exact")
    del sess, res
    torch.cuda.empty_cache()


def phase_two_stage(X, Q, gt, pdsp, flat_ids, dev, kept):
    """The 1M PDScanning+ on the two-stage engine; per-query survivors
    from one more direct call of two_stage_topk on the session's state.
    The session stays in ``kept["two_stage"]`` for the profile phase."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy
    from repro_torch.core.torch_engine import two_stage_topk

    t0 = time.perf_counter()
    sess, res, rec = run_method(X, Q, gt, "PDScanning+", dev, fitted=pdsp,
                                schedule=SchedulePolicy(engine="two_stage"))
    be = sess.backend
    cfg = be._config(K)
    ql, qt, _ = be._prep_queries(Q)
    _, ids, surv = two_stage_topk(
        be._state, torch.as_tensor(np.ascontiguousarray(ql), device=dev),
        torch.as_tensor(np.ascontiguousarray(qt), device=dev), cfg)
    surv, ids = surv.cpu().numpy(), ids.cpu().numpy()
    under = surv < cfg.capacity
    same = same_sets(res.ids, flat_ids)
    rec.update(capacity=cfg.capacity, survivors_min=int(surv.min()),
               survivors_median=float(np.median(surv)),
               survivors_max=int(surv.max()),
               queries_under_capacity=int(under.sum()),
               stream_ids_equal=int(same.sum()),
               stream_ids_equal_under_capacity=int(same[under].sum()),
               direct_call_ids_equal=bool(np.array_equal(ids, res.ids)))
    log("two_stage", **rec, phase_s=time.perf_counter() - t0)
    check(sum(rec["launches_per_batch"].values()) == 0,
          "the two-stage engine launched a kernel")
    check(bool(same[under].all()), "two-stage ids differ from the stream "
          "engine's on a query whose survivors fit the capacity")
    kept["two_stage"] = (sess, res)
    return rec


def selection_agreement(be, ql_t, tau, dev):
    """The top-k selection (stream_engine._smallest) against the stable
    sort it replaced, on the engine's real score rows of the 1M flat
    session: the masked estimates of the first query chunk over seven row
    blocks spread through the corpus (the completion cut, C + 1 of
    B columns), and the (chunk, N) estimate rows of the two-stage engine
    (its anchor and capacity cuts).  Equal columns are required where the
    rows hold no -0.0 (the sort put it beside +0.0, the reference's
    top_k below it); the times of both on the (chunk, N) rows too."""
    import torch
    from repro_torch.core.stream_engine import _smallest
    from repro_torch.kernels import ops
    blocks = be._blocks
    c = be._config(K).query_chunk
    q, tau = ql_t[:c], tau[:c]
    nb = blocks["xl"].shape[0]
    sc = torch.ones(1, device=dev)
    rows = []
    for b in range(0, nb, -(-nb // 7)):
        nr = (blocks["ids"][b] >= 0).sum(dtype=torch.int32)
        p, kp, _, _ = ops.dco_scan_op(blocks["xl"][b], q, tau, sc, nr,
                                      block_n=256, block_d=128)
        rows.append((torch.where(kp.T.bool(), p.T, float("inf")), 129))
    x = blocks["xl"].reshape(-1, blocks["xl"].shape[-1])
    est = torch.clamp_min(blocks["lsq"].reshape(1, -1) - 2.0 * (q @ x.T)
                          + (q * q).sum(1)[:, None], 0.0)
    est = torch.where(blocks["ids"].reshape(1, -1) >= 0, est, float("inf"))
    rows += [(est, K), (est, 2048)]
    out = {"rows": 0, "rows_equal": 0, "rows_with_negative_zero": 0}
    for score, n in rows:
        _, idx = _smallest(score, n)
        _, sidx = torch.sort(score, dim=1, stable=True)
        same = (idx == sidx[:, :n]).all(1)
        negz = ((score == 0) & torch.signbit(score)).any(1)
        out["rows"] += score.shape[0]
        out["rows_equal"] += int(same.sum())
        out["rows_with_negative_zero"] += int(negz.sum())
        check(bool(same[~negz].all()), f"the selection and the stable sort "
              f"disagree on a score row without -0.0 (width "
              f"{score.shape[1]}, n {n})")
    out["two_stage_row_width"] = int(est.shape[1])
    out["selection_ms_n2048"] = cuda_ms(lambda: _smallest(est, 2048), reps=10)
    out["stable_sort_ms"] = cuda_ms(
        lambda: torch.sort(est, dim=1, stable=True), reps=10)
    return out


def phase_graph(X, Q, gt, dev):
    """C1 on the card: the flat PDScanning+ session's block walk run eagerly
    (the eager chunks of stream_engine._stream_topk_padded) against the
    walk captured once as a CUDA graph and replayed per chunk
    (stream_topk with the backend's graph cache).  The eager walls come
    first: a capture slows every later eager launch of the process.
    Returns the fitted method."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    from repro_torch.core import stream_engine as se
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels import pq_lookup as pq_mod
    from repro_torch.vecdata import recall_at_k

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sess = open_index(X, method="PDScanning+", device=dev)
    fit_s = time.perf_counter() - t0
    be = sess.backend
    t0 = time.perf_counter()
    be._materialize()
    materialize_s = time.perf_counter() - t0
    cfg = be._config(K)
    check(cfg.use_kernel, "the session does not screen with the kernel")
    st, blocks = be._state, be._blocks
    ql, qt, _ = be._prep_queries(Q)
    ql_t = torch.as_tensor(np.ascontiguousarray(ql), device=dev)
    qt_t = torch.as_tensor(np.ascontiguousarray(qt), device=dev)
    nq, c = Q.shape[0], cfg.query_chunk
    pad = (-nq) % c
    qlp = torch.nn.functional.pad(ql_t, (0, 0, 0, pad))
    qtp = torch.nn.functional.pad(qt_t, (0, 0, 0, pad))

    def eager():
        out = se._stream_topk_padded(st, blocks, qlp, qtp, {}, None, cfg)
        torch.cuda.synchronize()
        return tuple(o[:nq] for o in out)

    def graphed():
        out = se.stream_topk(st, ql_t, qt_t, cfg, blocks=blocks,
                             graphs=be._graphs)
        torch.cuda.synchronize()
        return out

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out

    eager()                                     # the allocator's first pass
    eager_walls = []
    for _ in range(3):
        wall, want = timed(eager)
        eager_walls.append(wall)
    check(not be._graphs, "a graph was captured before the eager walls")
    first_s, got = timed(graphed)               # capture, then 7 replays
    (g,) = be._graphs.values()
    pairs = []
    for _ in range(GRAPH_PAIRS):
        e_wall, again = timed(eager)
        g_wall, got = timed(graphed)
        pairs.append([e_wall, g_wall])
        check(all(torch.equal(a, b) for a, b in zip(again, want)),
              "the eager walk is not deterministic")
    names = ("dists", "ids", "survivors", "passed", "dropped_min_est",
             "dims")
    equal = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, got, want)}
    dco_mod.launches = dco_mod.grouped_launches = pq_mod.launches = 0
    graphed()
    per_batch = {"dco_scan": dco_mod.launches,
                 "dco_scan_grouped": dco_mod.grouped_launches,
                 "pq_lookup": pq_mod.launches}
    n_blocks = int(blocks["xl"].shape[0])
    chunks = -(-nq // c)
    # the session replays the same graph (its search builds the same key)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = sess.search(Q, K)
        walls.append(time.perf_counter() - t0)
    want_np = [w.cpu().numpy() for w in want]
    cert = want_np[4] <= want_np[0][:, -1]
    rec = {
        "method": "PDScanning+", "n": int(X.shape[0]), "nq": nq,
        "fit_s": fit_s, "materialize_s": materialize_s,
        "row_blocks": n_blocks, "chunks": chunks,
        "eager_walls_first_s": eager_walls, "first_graph_batch_s": first_s,
        "pairs_eager_graph_s": pairs,
        "graph_wins": sum(gw < ew for ew, gw in pairs),
        "outputs_equal": equal, "graphs": len(be._graphs),
        **graph_record(g), "launches_per_batch": per_batch,
        "session_walls_s": walls,
        "session_qps": float(nq / np.median(walls)),
        "eager_qps_first": float(nq / np.median(eager_walls)),
        "recall_at_10": recall_at_k(res.ids, gt),
        "uncertified_queries": res.stats.extra["uncertified_queries"],
        "session_ids_equal_eager": bool(np.array_equal(res.ids,
                                                       want_np[1])),
        "session_certificate_equal_eager": bool(np.array_equal(
            res.stats.extra["uncertified_mask"], cert)),
        "device_bytes_held": torch.cuda.memory_allocated(dev),
    }
    # one chunk of 100 queries: one replay of the block walk a batch
    wide = SearchSession(sess.method, SchedulePolicy(query_chunk=100),
                         device=dev)
    t0 = time.perf_counter()
    wres = wide.search(Q, K)
    wide_first_s = time.perf_counter() - t0
    dco_mod.launches = 0
    wide_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        wres = wide.search(Q, K)
        wide_walls.append(time.perf_counter() - t0)
    (wg,) = wide.backend._graphs.values()
    stat_keys = ("survivors_mean", "screen_pass_mean", "dims_read_mean",
                 "uncertified_queries")
    rec["query_chunk_100"] = {
        "first_search_s": wide_first_s, "walls_s": wide_walls,
        "qps": float(nq / np.median(wide_walls)),
        "dco_scan_launches_3_batches": dco_mod.launches,
        "ids_equal": bool(np.array_equal(wres.ids, res.ids)),
        "stats_equal": all(wres.stats.extra[k] == res.stats.extra[k]
                           for k in stat_keys),
        **graph_record(wg)}
    del wide, wres
    rec["selection"] = selection_agreement(be, ql_t, got[0][:, -1], dev)
    log("graph", **rec, phase_s=time.perf_counter() - t_phase)
    check(all(equal.values()), f"the replayed walk differs from the eager "
          f"walk on the card: {equal}")
    check(rec["session_ids_equal_eager"]
          and rec["session_certificate_equal_eager"],
          "the session's ids or certificate differ from the eager walk")
    check(per_batch["dco_scan"] == chunks * n_blocks
          and sum(per_batch.values()) == per_batch["dco_scan"],
          f"a replayed batch counted {per_batch}, not {chunks * n_blocks} "
          "dco_scan launches")
    check(rec["graphs"] == 1, "the session captured more than one graph")
    check(rec["graph_wins"] >= GRAPH_PAIRS - 1, "the graph's wall was not "
          f"below the eager walk's in {GRAPH_PAIRS - 1} of {GRAPH_PAIRS} "
          "pairs")
    check(rec["recall_at_10"] == 1.0 and rec["uncertified_queries"] == 0.0,
          "the graphed session is not exact")
    q100 = rec["query_chunk_100"]
    check(q100["ids_equal"] and q100["stats_equal"]
          and q100["dco_scan_launches_3_batches"] == 3 * n_blocks,
          "query_chunk = 100 changed the result or its launches")
    check(SchedulePolicy().query_chunk == 16, "the default query chunk moved")
    method = sess.method
    del sess, res, be, st, blocks, want, got, again
    torch.cuda.empty_cache()
    return method


def phase_host(Xr, Q, gt_r, dev):
    """A1 on the chip machine's host: backend="host" over the first 100k
    rows against the torch backend on the same fitted method, and HNSW
    builds with FDScanning and PDScanning+ on the first HNSW_ROWS rows."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    from repro_torch.core.engine import ScanStats
    from repro_torch.core.methods import make_method
    from repro_torch.search.hnsw import HNSWIndex
    from repro_torch.vecdata import recall_at_k

    t_phase = time.perf_counter()
    Qh = Q[:HOST_QUERIES]
    t0 = time.perf_counter()
    sess = open_index(Xr, method="PDScanning+", backend="host")
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sess.search(Qh, K)
    host_s = time.perf_counter() - t0
    card = SearchSession(sess.method, SchedulePolicy(), device=dev)
    cres = card.search(Qh, K)
    same = same_sets(res.ids, cres.ids)
    rec = {"n": int(Xr.shape[0]), "nq": HOST_QUERIES, "fit_s": fit_s,
           "host_search_s": host_s, "host_qps": HOST_QUERIES / host_s,
           "torch_ids_equal": int(same.sum()),
           "torch_ids_equal_in_order": int((res.ids == cres.ids).all(1).sum()),
           "recall_at_10": recall_at_k(res.ids, gt_r[:HOST_QUERIES]),
           "dims_read_mean": res.stats.extra["dims_read_mean"],
           "uncertified_queries": res.stats.extra["uncertified_queries"]}
    del card, cres
    Xh = np.ascontiguousarray(Xr[:HNSW_ROWS])
    gt_h = nearest(distances64(Xh, Q, dev))
    sched = SchedulePolicy().stage_dims(Xh.shape[1])
    builds, links = {}, {}
    for name in ("FDScanning", "PDScanning+"):
        t0 = time.perf_counter()
        m = make_method(name).fit(Xh)
        method_fit_s = time.perf_counter() - t0
        stats = ScanStats()
        t0 = time.perf_counter()
        idx = HNSWIndex(**HNSW_PARAMS).build(Xh, method=m, schedule=sched,
                                             stats=stats)
        build_s = time.perf_counter() - t0
        hs = SearchSession(m, index_kind="hnsw", index=idx, backend="host")
        t0 = time.perf_counter()
        hres = hs.search(Q, K, ef=HNSW_EF)
        search_s = time.perf_counter() - t0
        links[name] = idx.links
        builds[name] = {
            "fit_s": method_fit_s, "build_s": build_s,
            "build_n_dco": stats.n_dco, "build_dims_scanned":
                stats.dims_scanned, "build_dims_total": stats.dims_total,
            "build_pruning_ratio": stats.pruning_ratio,
            "max_level": idx.max_level, "search_s": search_s,
            "qps": Q.shape[0] / search_s,
            "recall_at_10": recall_at_k(hres.ids, gt_h),
            "search_dims_read_mean": hres.stats.extra["dims_read_mean"]}
    same_links = sum(
        all(np.array_equal(a, b) for a, b in zip(la, lb))
        for la, lb in zip(links["FDScanning"], links["PDScanning+"]))
    log("host", **rec, hnsw_rows=HNSW_ROWS, hnsw_params=HNSW_PARAMS,
        hnsw_ef=HNSW_EF, hnsw=builds,
        hnsw_nodes_with_equal_links=int(same_links),
        phase_s=time.perf_counter() - t_phase)
    check(bool(same.all()), "the host backend's ids differ from the torch "
          f"backend's on {int((~same).sum())} queries")
    check(rec["recall_at_10"] == 1.0, "the host flat scan is not exact")
    for name, b in builds.items():
        check(b["recall_at_10"] >= 0.75, f"HNSW {name} recall@10 "
              f"{b['recall_at_10']} below 0.75")
    del sess, res
    torch.cuda.empty_cache()


def padded_inputs(sess, Q, dev, anytime=False):
    """The engine's inputs for ``Q`` as the backend hands them to
    stream_topk, padded to whole query chunks (what the engine's inner
    drivers take): (state, blocks, q_lead, q_tail, extras, cfg, nq)."""
    import numpy as np
    import torch
    be = sess.backend
    cfg = be._config(K, anytime=anytime)
    ql, qt, qe = be._prep_queries(Q)
    nq = ql.shape[0]
    pad = (-nq) % min(cfg.query_chunk, nq)

    def t(a):
        a = torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))
    return (be._state, be._blocks, t(ql), t(qt),
            {key: t(v) for key, v in qe.items()}, cfg, nq)


def adaptive_vs_eager(sess, Q, dev):
    """The adaptive batch replayed from the session's graphs against the
    same chunks walked eagerly on the card (stream_engine._adaptive_topk
    without a graph cache): which outputs are equal, the eager wall, and
    the chunks the seed sent to the full-scan body."""
    import torch
    from repro_torch.core import stream_engine as se
    st, blocks, ql, qt, qe, cfg, nq = padded_inputs(sess, Q, dev)
    be = sess.backend
    got = se._adaptive_topk(st, blocks, ql, qt, qe, None, cfg, nq,
                            be._graphs)
    t0 = time.perf_counter()
    want = se._adaptive_topk(st, blocks, ql, qt, qe, None, cfg, nq, None)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    names = ("dists", "ids", "survivors", "passed", "dropped_min_est",
             "dims")
    equal = {n: bool(torch.equal(a, b))
             for n, a, b in zip(names, got[:6], want[:6])}
    equal.update({key: bool(torch.equal(got[6][key], want[6][key]))
                  for key in want[6]})
    forced = sum(g.replays for key, g in be._graphs.items() if key[4])
    return {"equal_to_eager": equal, "eager_wall_s": eager_s,
            "forced_graphs": sum(1 for key in be._graphs if key[4]),
            "switching_graphs": sum(1 for key in be._graphs if not key[4]),
            "forced_replays": forced}


def adaptive_record(rec, res) -> dict:
    """The adaptive arm's record: run_method's plus the policy's report."""
    ex = res.stats.extra
    return dict(rec, fallback_blocks_mean=ex.get("fallback_blocks"),
                est_saved_flops=ex.get("est_saved_flops"),
                rule_timeline_mean=(
                    float(sum(ex["rule_timeline"]) / len(ex["rule_timeline"]))
                    if "rule_timeline" in ex else None))


def phase_adaptive(X, Q, gt, pdsp, opq, opq_ids, fixed, dev, kept):
    """A3 on the card at 1M x 960 (DESIGN.md §5), reusing the fitted
    PDScanning+ and DDCopq: in-distribution queries through the adaptive
    session against the fixed one (``fixed``: the main phase's flat ids,
    distances and record; flat and PDX), out-of-distribution
    queries (make_ood_queries, severity 1.0) through the adaptive, the
    fixed and an FDScanning session, and DDCopq adaptive (pq_lookup in
    the graph); each adaptive batch held against the eager walk of the
    same chunks on the card.  Returns the OOD queries, their distances to
    every row (distances64) and the records; the flat in-distribution and
    the DDCopq adaptive sessions stay in ``kept`` (``"adaptive"``,
    ``"adaptive_ddcopq"``) for the profile phase."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy
    from repro_torch.vecdata import make_ood_queries

    t_phase = time.perf_counter()
    ada = SchedulePolicy(adaptive=True)
    recs = {}
    # -- in distribution: adaptive against fixed, flat and PDX -----------
    fixed_ids, fixed_dists, frec = fixed
    for label, schedule in (("id", ada),
                            ("id_pdx", SchedulePolicy(adaptive=True,
                                                      dim_groups=4))):
        sess, res, rec = run_method(X, Q, gt, "PDScanning+", dev,
                                    fitted=pdsp, schedule=schedule)
        rec = adaptive_record(rec, res)
        rec.update(adaptive_vs_eager(sess, Q, dev),
                   ids_equal_fixed=bool(np.array_equal(res.ids, fixed_ids)),
                   dists_equal_fixed=bool(np.array_equal(res.dists,
                                                         fixed_dists)),
                   fixed_qps=frec["qps"])
        log("adaptive", arm=label, **rec)
        recs[label] = rec
        check(rec["ids_equal_fixed"], f"adaptive {label}: ids differ from "
              "the fixed session's")
        check(all(rec["equal_to_eager"].values()), f"adaptive {label}: the "
              f"graph differs from the eager walk: {rec['equal_to_eager']}")
        launches = rec["launches_per_batch"]
        check(launches["dco_scan"] == 0 == launches["dco_scan_grouped"],
              f"adaptive {label} launched a dco_scan kernel: {launches}")
        if label == "id":
            kept["adaptive"] = (sess, res)
        del sess, res
        torch.cuda.empty_cache()
    # -- out of distribution: adaptive, fixed and FDScanning -------------
    t0 = time.perf_counter()
    Qo = make_ood_queries(X, Q.shape[0], severity=1.0)
    gen_s = time.perf_counter() - t0
    d2o = distances64(X, Qo, dev)
    gt_o = nearest(d2o)
    sess, res, rec = run_method(X, Qo, gt_o, "FDScanning", dev)
    fd_ids, fd_rec = res.ids, rec
    del sess, res
    torch.cuda.empty_cache()
    sess, res, rec = run_method(X, Qo, gt_o, "PDScanning+", dev, fitted=pdsp)
    fixed_o = rec
    del sess, res
    torch.cuda.empty_cache()
    sess, res, rec = run_method(X, Qo, gt_o, "PDScanning+", dev, fitted=pdsp,
                                schedule=ada)
    rec = adaptive_record(rec, res)
    same = same_sets(res.ids, fd_ids)
    rec.update(adaptive_vs_eager(sess, Qo, dev), ood_gen_s=gen_s,
               ids_equal_fdscan=int(same.sum()),
               ids_equal_fdscan_in_order=int((res.ids == fd_ids).all(1).sum()),
               fixed=fixed_o, fdscan=fd_rec,
               full_scan_body_beats_screening=rec["qps"] > fixed_o["qps"])
    log("adaptive", arm="ood", **rec)
    recs["ood"] = rec
    check(bool(same.all()), f"adaptive OOD ids differ from FDScanning's on "
          f"{int((~same).sum())} queries")
    check(rec["recall_at_10"] == 1.0 and rec["uncertified_queries"] == 0.0,
          "adaptive OOD is not exact and certified")
    check(all(rec["equal_to_eager"].values()), "adaptive OOD: the graph "
          f"differs from the eager walk: {rec['equal_to_eager']}")
    del sess, res
    torch.cuda.empty_cache()
    # -- DDCopq adaptive: pq_lookup inside the graph ----------------------
    sess, res, rec = run_method(X, Q, gt, "DDCopq", dev, fitted=opq,
                                schedule=ada)
    rec = adaptive_record(rec, res)
    rec.update(adaptive_vs_eager(sess, Q, dev))
    from repro_torch.kernels import pq_lookup as pq_mod
    sess.search(Q, K, deadline_s=GENEROUS_S)    # captures a graph a span
    pq_mod.launches = 0
    anyt = sess.search(Q, K, deadline_s=GENEROUS_S)
    rec["anytime"] = {
        "pq_lookup_launches": pq_mod.launches,
        "coverage": float(anyt.stats.extra["coverage"].min()),
        "ids_equal_fixed": bool(np.array_equal(anyt.ids, opq_ids))}
    log("adaptive", arm="ddcopq", **rec)
    recs["ddcopq"] = rec
    check(rec["launches_per_batch"]["pq_lookup"] > 0, "adaptive DDCopq "
          "launched no pq_lookup kernel")
    check(all(rec["equal_to_eager"].values()), "adaptive DDCopq: the graph "
          f"differs from the eager walk: {rec['equal_to_eager']}")
    check(rec["anytime"]["ids_equal_fixed"]
          and rec["anytime"]["coverage"] == 1.0,
          "a generous deadline on DDCopq differs from the fixed batch")
    kept["adaptive_ddcopq"] = (sess, res)
    del sess, res, anyt
    torch.cuda.empty_cache()
    log("adaptive_done", seconds=time.perf_counter() - t_phase)
    return Qo, d2o, recs


def phase_anytime(X, Q, gt, pdsp, dev):
    """A4 on the card at 1M x 960: the flat PDScanning+ session with
    anytime_block_group = 8.  The grouped walk run eagerly (engine level)
    and replayed a graph a group span; a generous deadline against the
    non-deadline batch (ids, distances, coverage, launches); a tight one
    (coverage, certificate, wall); then one generous batch of the PDX
    layout for dco_scan_grouped's launches."""
    import numpy as np
    import torch
    from repro_torch.api import SchedulePolicy, SearchSession
    from repro_torch.core import stream_engine as se
    from repro_torch.kernels import dco_scan as dco_mod

    t_phase = time.perf_counter()
    pol = SchedulePolicy(anytime_block_group=ANYTIME_GROUP)
    sess = SearchSession(pdsp, pol, device=dev)
    base = sess.search(Q, K)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        base = sess.search(Q, K)
        walls.append(time.perf_counter() - t0)
    nb = int(sess.backend._blocks["xl"].shape[0])
    st, blocks, ql, qt, qe, cfg, nq = padded_inputs(sess, Q, dev,
                                                    anytime=True)
    eager_walls, eager_equal = [], True
    for _ in range(2):
        t0 = time.perf_counter()
        out = se._anytime_topk(st, blocks, ql, qt, qe, None, cfg, nq,
                               time.monotonic() + GENEROUS_S, ANYTIME_GROUP,
                               None)
        eager_walls.append(time.perf_counter() - t0)
        eager_equal &= (out[6] == 1.0 and np.array_equal(
            out[1].cpu().numpy(), base.ids))
    before = len(sess.backend._graphs)
    t0 = time.perf_counter()
    sess.search(Q, K, deadline_s=GENEROUS_S)   # captures a graph a span
    first_s = time.perf_counter() - t0
    spans = [g for key, g in sess.backend._graphs.items()
             if key[5] is not None]
    dco_mod.launches = 0
    gen_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        gen = sess.search(Q, K, deadline_s=GENEROUS_S)
        gen_walls.append(time.perf_counter() - t0)
    launches = dco_mod.launches // 3
    tight, tight_walls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        r = sess.search(Q, K, deadline_s=TIGHT_S)
        tight_walls.append(time.perf_counter() - t0)
        tight.append(r)
    full_wall = float(np.median(gen_walls))
    groups = -(-nb // ANYTIME_GROUP)
    cov = [float(r.stats.extra["coverage"][0]) for r in tight]
    rec = {
        "method": "PDScanning+", "n": int(X.shape[0]), "nq": int(nq),
        "block_group": ANYTIME_GROUP, "row_blocks": nb, "groups": groups,
        "plain_walls_s": walls,
        "plain_qps": float(nq / np.median(walls)),
        "eager_walls_s": eager_walls, "eager_equal_plain": bool(eager_equal),
        "graph_first_batch_s": first_s, "graphs_captured": len(spans),
        "graph_nodes_first_span": graph_nodes(spans[0].graph),
        "graph_pool_bytes_spans": sum(graph_pool_bytes(g.graph) or 0
                                      for g in spans),
        "generous_deadline_s": GENEROUS_S, "generous_walls_s": gen_walls,
        "generous_qps": float(nq / full_wall),
        "generous_syncs_per_batch": groups,
        "generous_ids_equal": bool(np.array_equal(gen.ids, base.ids)),
        "generous_dists_equal": bool(np.array_equal(gen.dists, base.dists)),
        "generous_coverage_min": float(gen.stats.extra["coverage"].min()),
        "generous_uncertified": gen.stats.extra["uncertified_queries"],
        "dco_scan_launches_per_batch": launches,
        "tight_deadline_s": TIGHT_S, "tight_walls_s": tight_walls,
        "tight_coverage": cov,
        "tight_syncs_per_batch": [round(c * nb / ANYTIME_GROUP) for c in cov],
        "tight_uncertified": [r.stats.extra["uncertified_queries"]
                              for r in tight],
        "graphs_before_deadline_batches": before,
    }
    del sess, base, gen, tight
    torch.cuda.empty_cache()
    # the PDX layout's anytime walk: dco_scan_grouped in every group
    psess = SearchSession(pdsp, SchedulePolicy(
        dim_groups=4, anytime_block_group=ANYTIME_GROUP), device=dev)
    pbase = psess.search(Q, K)
    psess.search(Q, K, deadline_s=GENEROUS_S)
    dco_mod.grouped_launches = 0
    pgen = psess.search(Q, K, deadline_s=GENEROUS_S)
    rec["pdx"] = {"dco_scan_grouped_launches_per_batch":
                  dco_mod.grouped_launches,
                  "ids_equal": bool(np.array_equal(pgen.ids, pbase.ids)),
                  "coverage_min": float(pgen.stats.extra["coverage"].min())}
    log("anytime", **rec, phase_s=time.perf_counter() - t_phase)
    check(rec["eager_equal_plain"], "the eager anytime walk differs from "
          "the non-deadline batch")
    check(rec["generous_ids_equal"] and rec["generous_dists_equal"]
          and rec["generous_coverage_min"] == 1.0,
          "a generous deadline differs from the non-deadline batch")
    check(launches == nb * (-(-nq // 16)), f"a generous anytime batch "
          f"launched {launches} dco_scan kernels")
    check(all(0.0 < c < 1.0 for c in cov), f"a tight deadline gave "
          f"coverage {cov}")
    check(all(u == 1.0 for u in rec["tight_uncertified"]),
          "a tight deadline left queries certified")
    check(max(tight_walls) < full_wall * (1 + 1 / groups),
          f"a tight deadline returned after {max(tight_walls)} s, not "
          f"within the full wall {full_wall} s plus one group")
    check(rec["pdx"]["ids_equal"] and rec["pdx"]["coverage_min"] == 1.0
          and rec["pdx"]["dco_scan_grouped_launches_per_batch"] > 0,
          "the PDX anytime walk differs or launched no dco_scan_grouped")
    del psess, pbase, pgen
    torch.cuda.empty_cache()
    return rec


def draw_in_background(dev) -> dict:
    """A thread that draws the main corpus (``load_dataset``, seeded, so
    the same rows as drawn in line), then on three threads of its own the
    guardrails phase's drift scenario on its first N_RULES rows, the main
    phase's DDCopq fit (``open_index``'s, whose session is not searched)
    and the ivf phase's index (``IVFIndex(n_list=N_LIST, seed=0)``).  It
    returns at once with the thread in ``["thread"]``; each result lands
    in the same dict with its seconds (``"<key>_s"``), or the first
    failure in ``["error"]``.  numpy's draws and products release the
    GIL, so this runs beside a phase whose parent only waits on rank
    processes; its seconds are host seconds shared with that phase's
    ranks and with each other."""
    import threading

    from repro_torch.api import open_index
    from repro_torch.search.ivf import IVFIndex
    from repro_torch.vecdata import load_dataset, make_drift_scenario
    drawn: dict = {}

    def timed(key, fn):
        try:
            t0 = time.perf_counter()
            drawn[key] = fn()
            drawn[key + "_s"] = time.perf_counter() - t0
        except Exception as exc:        # re-raised by the caller
            drawn.setdefault("error", exc)

    def draw():
        timed("ds", lambda: load_dataset("gist", scale=N_MAIN / 30_000))
        if "error" in drawn:
            return
        X = drawn["ds"].X
        jobs = [threading.Thread(target=timed, args=job) for job in (
            ("drift", lambda: make_drift_scenario(
                X[:N_RULES], 100, DRIFT_BATCHES, scenario="recovering",
                severity=1.0)),
            ("opq", lambda: open_index(X, method="DDCopq",
                                       device=dev).method),
            ("ivf", lambda: IVFIndex(n_list=N_LIST, seed=0).build(X)))]
        for t in jobs:
            t.start()
        for t in jobs:
            t.join()

    drawn["thread"] = threading.Thread(target=draw, daemon=True)
    drawn["thread"].start()
    return drawn


def phase_guardrails(Xr, dev, drift=None):
    """A5 on the card at 100k rows: a "recovering" drift scenario
    (make_drift_scenario, DRIFT_BATCHES batches of 100 queries) through a
    guarded PDScanning+ session; every batch the breaker served demoted is
    held against an FDScanning session; the breaker must trip during the
    drift and re-promote after it.  ``drift``: the scenario and its draw's
    seconds, drawn beforehand, or None to draw it here."""
    import numpy as np
    from repro_torch.api import GuardrailConfig, SchedulePolicy, open_index
    from repro_torch.vecdata import make_drift_scenario

    t_phase = time.perf_counter()
    if drift is None:
        t0 = time.perf_counter()
        stream = make_drift_scenario(Xr, 100, DRIFT_BATCHES,
                                     scenario="recovering", severity=1.0)
        gen_s = time.perf_counter() - t0
    else:                   # drawn beforehand (draw_in_background)
        stream, gen_s = drift
    t0 = time.perf_counter()
    sess = open_index(Xr, method="PDScanning+", device=dev,
                      schedule=SchedulePolicy(
                          guardrails=GuardrailConfig(**DRIFT_GUARDRAIL)))
    fit_s = time.perf_counter() - t0
    fd = open_index(Xr, method="FDScanning", device=dev)
    batches = []
    demoted_equal = True
    for b, Qb in enumerate(stream):
        t0 = time.perf_counter()
        res = sess.search(Qb, K)
        wall = time.perf_counter() - t0
        ex = res.stats.extra
        row = {"batch": b, "state": ex["breaker_state"], "wall_s": wall,
               "drift_score": ex["drift_score"],
               "audit_recall": ex["audit_recall"],
               "uncertified": ex.get("uncertified_queries")}
        if ex["breaker_state"] != "closed":
            ref = fd.search(Qb, K)
            same = same_sets(res.ids, ref.ids)
            row["fdscan_ids_equal"] = int(same.sum())
            row["fdscan_ids_equal_in_order"] = int(
                (res.ids == ref.ids).all(1).sum())
            demoted_equal &= bool(same.all())
        batches.append(row)
    report = sess.guardrails()
    states = [r["state"] for r in batches]
    seq = [(t["from"], t["to"]) for t in report["transitions"]]
    log("guardrails", n=int(Xr.shape[0]), nq=100, scenario="recovering",
        n_batches=DRIFT_BATCHES, config=DRIFT_GUARDRAIL, gen_s=gen_s,
        fit_s=fit_s, batches=batches, report=report,
        phase_s=time.perf_counter() - t_phase)
    check("open" in states, "the breaker never opened during the drift")
    check(demoted_equal, "a demoted batch's ids differ from FDScanning's")
    check(("half_open", "closed") in seq and report["state"] == "closed",
          f"the breaker did not re-promote after the drift: {seq}")
    return {"states": states, "transitions": report["transitions"]}


# ---------------------------------------------------------------- serving ---
def on_card(dev) -> bool:
    """The A6 phases also run on the CPU (a rehearsal at a tiny size),
    where nothing launches a kernel or captures a graph."""
    import torch
    return torch.device(dev).type == "cuda"


def sync(dev) -> None:
    import torch
    if on_card(dev):
        torch.cuda.synchronize(dev)


def held_bytes(dev) -> int:
    """Device bytes allocated (0 off the card)."""
    import torch
    return torch.cuda.memory_allocated(dev) if on_card(dev) else 0


def free_card(dev) -> None:
    import torch
    if on_card(dev):
        torch.cuda.empty_cache()


def percentiles_ms(samples_s) -> dict:
    """p50/p95/p99 of latencies given in seconds, in ms."""
    import numpy as np
    a = np.asarray(list(samples_s), np.float64)
    return {f"p{p}_ms": float(1e3 * np.quantile(a, p / 100.0))
            for p in (50, 95, 99)}


def new_graphs(be, seen) -> list:
    """The graphs cached on backend ``be`` that ``seen`` (a WeakSet) has
    not held yet; they are added to it."""
    fresh = [g for g in be._graphs.values() if g not in seen]
    for g in fresh:
        seen.add(g)
    return fresh


def served_only(resolved) -> list:
    return [r for r in resolved if r.status == "done"]


def simulate(svc, pool, qidx, arrivals, inserts, on_step=None):
    """A copy of benchmarks/bench_serving.py's discrete-event driver:
    Poisson arrivals replayed against measured step walls, ``inserts`` =
    [(request index, rows)] added the instant that request arrives, the
    add's wall blocking the loop.  Two changes: the clock advances to the
    batch's latest completion (a step that also expires queued requests
    lists them first), and each add's record gains the service wall of
    the step after it.  Returns (resolved requests, {rid: pool index},
    add records)."""
    events = [("q", arrivals[i], i) for i in range(len(arrivals))]
    events += [("w", arrivals[ridx] + 1e-9, chunk)
               for ridx, chunk in inserts]
    events.sort(key=lambda e: e[1])
    t, i, served, rid_to_q, adds, after = 0.0, 0, [], {}, [], None
    while i < len(events) or svc.pending:
        while i < len(events) and events[i][1] <= t:
            kind, te, payload = events[i]
            i += 1
            if kind == "q":
                req = svc.submit(pool[qidx[payload]], now=te)
                rid_to_q[req.rid] = qidx[payload]
            else:
                after = svc.add(payload, now=te)
                t += after["wall_s"]
                adds.append(after)
        if svc.pending:
            batch = svc.step(now=t)
            if on_step is not None:
                on_step(batch)
            walls = [r.service_s for r in batch if r.service_s is not None]
            if after is not None and walls:
                after["next_step_s"] = walls[0]
                after = None
            served += batch
            t = max([t] + [r.t_done for r in batch])
        elif i < len(events):
            t = max(t, events[i][1])
        else:
            break
    return served, rid_to_q, adds


def calibrate(svc, pool, chunk=None):
    """A copy of bench_serving.py's _calibrate on the service's own
    session: a first full step (it lays the corpus out and captures the
    walk), the steady full-step wall (best of 3), then, given ``chunk``,
    one add and the stall of the next full step over the steady wall.
    Returns (steady_s, stall_s, record)."""
    import weakref
    be = svc.session.backend
    seen = weakref.WeakSet()

    def full_step():
        for j in range(svc.slots):
            svc.submit(pool[j % len(pool)])
        wall = svc.step()[0].service_s
        svc.drain()
        return wall

    rec = {"first_step_s": full_step()}
    rec["graphs_first_step"] = len(new_graphs(be, seen))
    rec["steady_steps_s"] = [full_step() for _ in range(3)]
    rec["graphs_steady_steps"] = len(new_graphs(be, seen))
    steady = min(rec["steady_steps_s"])
    if chunk is None:
        return steady, 0.0, rec
    mark = time.time_ns()
    info = svc.add(chunk)
    post = full_step()
    fresh = new_graphs(be, seen)
    rec.update(add_rows=info["rows"], add_mode=info["mode"],
               add_wall_s=info["wall_s"], post_add_step_s=post,
               delta_build_s=span_seconds("backend.delta_build", mark),
               warmup_s=[graph_seconds(g, "engine.warmup") for g in fresh],
               capture_s=[graph_seconds(g, "engine.capture") for g in fresh],
               graphs_captured_after_add=len(fresh))
    return steady, max(post - steady, 0.0), rec


def phase_serving(X, Q, d2, pdsp, dev):
    """The serving front at 1M (A6): PDScanning+ (fixed policy) on the
    first N rows less the inserted ones (SERVE_INSERT_ROWS each), with
    the fitted PCA of ``pdsp``, SearchService(slots=16, k=10); capacity
    calibrated on the session with the first insert chunk, then
    SERVE_REQUESTS Poisson arrivals at LAMBDA_FRACTION of it with one
    insert every SERVE_INSERT_EVERY requests.  Every ticket must be
    served, certified and exact against the rows visible when it was
    served.  Returns the grown session and the record."""
    import weakref

    import numpy as np
    from repro_torch.api import SchedulePolicy, SearchSession
    from repro_torch.core.methods import make_method
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels import pq_lookup as pq_mod

    t_phase = time.perf_counter()
    n = X.shape[0]
    # one insert in the calibration, then one every SERVE_INSERT_EVERY
    # requests of the run
    insert_at = range(SERVE_INSERT_EVERY, SERVE_REQUESTS, SERVE_INSERT_EVERY)
    n_base = n - (len(insert_at) + 1) * SERVE_INSERT_ROWS
    chunks = [X[n_base + j * SERVE_INSERT_ROWS:
                n_base + (j + 1) * SERVE_INSERT_ROWS]
              for j in range(len(insert_at) + 1)]
    t0 = time.perf_counter()
    m = make_method("PDScanning+", pca=pdsp.state["pca"]).fit(X[:n_base])
    fit_s = time.perf_counter() - t0
    sess = SearchSession(m, SchedulePolicy(), device=dev)
    svc = sess.serve(slots=SERVE_SLOTS, k=K)
    be = sess.backend
    steady, stall, cal = calibrate(svc, Q, chunks[0])
    inserts = [(ridx, chunks[j + 1]) for j, ridx in enumerate(insert_at)]
    # the inserts whose delta passes the merge threshold: the step after
    # them lays the whole corpus out again, as the calibration's first
    # step did
    delta, n_merges = cal["add_rows"], 0
    for _ in inserts:
        delta += SERVE_INSERT_ROWS
        if delta > sess.policy.delta_merge_threshold:
            n_merges, delta = n_merges + 1, 0
    # the capacity of the mixed load: full steps at the steady wall, and
    # for every insert its add (a write blocks the serving loop) and the
    # stall of the step after it, or for a merge the first step's
    n_steps = SERVE_REQUESTS / SERVE_SLOTS
    busy_s = (n_steps * steady
              + len(inserts) * (cal["add_wall_s"] + stall)
              + n_merges * (cal["first_step_s"] - steady))
    lam = LAMBDA_FRACTION * SERVE_REQUESTS / busy_s
    rng = np.random.default_rng(SERVE_SEED)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, SERVE_REQUESTS))
    qidx = [i % Q.shape[0] for i in range(SERVE_REQUESTS)]
    seen = weakref.WeakSet(be._graphs.values())
    captures, warmups, step_launches, last = [], [], [], [(0, 0, 0)]
    mark = time.time_ns()

    def on_step(batch):
        now = (dco_mod.launches, dco_mod.grouped_launches, pq_mod.launches)
        step_launches.append([a - b for a, b in zip(now, last[0])])
        last[0] = now
        for g in new_graphs(be, seen):
            warmups.append(graph_seconds(g, "engine.warmup"))
            captures.append(graph_seconds(g, "engine.capture"))

    sync(dev)
    dco_mod.launches = dco_mod.grouped_launches = pq_mod.launches = 0
    t0 = time.perf_counter()
    served, rid_to_q, adds = simulate(svc, Q, qidx, arrivals, inserts,
                                      on_step)
    real_s = time.perf_counter() - t0
    launches = {"dco_scan": dco_mod.launches,
                "dco_scan_grouped": dco_mod.grouped_launches,
                "pq_lookup": pq_mod.launches}
    done = [r for r in served if r.status == "done"]
    gt = {v: nearest(d2[:, :v]) for v in sorted({r.n_visible
                                                 for r in done})}
    recall = [float(np.isin(r.ids, gt[r.n_visible][rid_to_q[r.rid]]).mean())
              for r in done]
    h = svc.health()
    lat = [r.latency_s for r in done]
    makespan = max(r.t_done for r in done) - min(r.t_submit for r in done)
    rec = {
        "method": "PDScanning+", "policy": "fixed", "n_base": n_base,
        "insert_rows": SERVE_INSERT_ROWS, "inserts_in_run": len(inserts),
        "n_final": int(sess.n), "slots": SERVE_SLOTS, "k": K,
        "n_requests": SERVE_REQUESTS, "fit_s": fit_s,
        "calibration": dict(cal, steady_step_s=steady, stall_s=stall,
                            stall_unattributed_s=stall
                            - sum(cal["delta_build_s"])
                            - sum(cal["warmup_s"]) - sum(cal["capture_s"])),
        "merges_expected": n_merges, "capacity_busy_s": busy_s,
        "lambda_fraction": LAMBDA_FRACTION, "offered_qps": lam,
        "sustained_qps": len(done) / makespan, "makespan_s": makespan,
        "real_s": real_s, **percentiles_ms(lat),
        "mean_latency_ms": float(1e3 * np.mean(lat)),
        "mean_batch_size": float(np.mean([r.batch_size for r in done])),
        "steps": h["steps"], "recall_min": min(recall),
        "certified_fraction": float(np.mean([r.certified is True
                                             for r in done])),
        "adds": [{key: a.get(key) for key in ("rows", "mode", "wall_s",
                                             "next_step_s")} for a in adds],
        # an add the loop met again before a step shares that step's
        # rebuild (next_step_s is None)
        "writes_before_a_step": sum(a.get("next_step_s") is not None
                                    for a in adds),
        "write_modes": dict(svc.write_modes), "merges": be.merges,
        "delta_build_s": span_seconds("backend.delta_build", mark),
        "materialize_s": span_seconds("backend.layout", mark),
        "graphs_captured_in_run": len(captures),
        "graphs_captured": cal["graphs_first_step"]
        + cal["graphs_steady_steps"] + cal["graphs_captured_after_add"]
        + len(captures), "warmup_s": warmups, "capture_s": captures,
        "launches": launches,
        # a steady step's launches: the median over the run's steps
        "launches_per_step": {
            name: float(np.median([s[j] for s in step_launches]))
            for j, name in enumerate(("dco_scan", "dco_scan_grouped",
                                      "pq_lookup"))},
        "row_blocks": int(be._blocks["xl"].shape[0]),
        "device_bytes_held": held_bytes(dev),
        "health": {key: h[key] for key in (
            "submitted", "completed", "shed", "timeouts", "failures",
            "partials", "uncertified", "rows_inserted")},
    }
    log("serving", **rec, phase_s=time.perf_counter() - t_phase)
    check(all(r.status == "done" for r in served)
          and len(served) == SERVE_REQUESTS and h["failures"] == 0,
          f"serving: not every ticket was served: {rec['health']}")
    check(rec["certified_fraction"] == 1.0, "serving: a request was "
          "uncertified")
    check(rec["recall_min"] == 1.0, "serving: a request's ids differ from "
          "the exact top-10 of the rows visible when it was served")
    if on_card(dev):                # kernels and graphs run on the card
        check(launches["dco_scan"] > 0, "serving launched no dco_scan")
        want = 2 + rec["writes_before_a_step"]    # first step, calibration
        check(rec["graphs_captured"] == want,
              f"serving captured {rec['graphs_captured']} graphs, not one "
              f"and one a rebuilt layout ({want})")
    check(sess.n == n, "serving: the corpus did not grow to every row")
    return sess, rec


def phase_serving_overload(sess, Q, d2, steady_s: float, dev):
    """The grown serving session with no writes at OVERLOAD_FACTOR x its
    steady capacity: bounded admission (shed_oldest), a deadline of 4
    steady step walls, every ticket accounted for."""
    import numpy as np

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sess.search(Q[:SERVE_SLOTS], K, deadline_s=GENEROUS_S)   # span graphs
    warm_s = time.perf_counter() - t0
    spans = [g for key, g in sess.backend._graphs.items()
             if key[5] is not None]
    svc = sess.serve(slots=SERVE_SLOTS, k=K, max_queue=OVERLOAD_QUEUE,
                     admission="shed_oldest", deadline_s=4 * steady_s)
    lam = OVERLOAD_FACTOR * SERVE_SLOTS / steady_s
    rng = np.random.default_rng(SERVE_SEED + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, SERVE_REQUESTS))
    qidx = [i % Q.shape[0] for i in range(SERVE_REQUESTS)]
    t0 = time.perf_counter()
    resolved, rid_to_q, _ = simulate(svc, Q, qidx, arrivals, [])
    real_s = time.perf_counter() - t0
    h = svc.health()
    done = served_only(resolved)
    gt = nearest(d2[:, :sess.n])
    full = [r for r in done if r.coverage == 1.0 and r.certified]
    partial = [r for r in done if r.coverage < 1.0]
    recall = [float(np.isin(r.ids, gt[rid_to_q[r.rid]]).mean())
              for r in full]
    timed = [r for r in resolved if r.t_done is not None]
    rec = {
        "n": int(sess.n), "offered_qps": lam,
        "overload_factor": OVERLOAD_FACTOR, "max_queue": OVERLOAD_QUEUE,
        "admission": "shed_oldest", "deadline_s": 4 * steady_s,
        "warm_deadline_search_s": warm_s, "span_graphs": len(spans),
        "span_pool_bytes": sum(graph_pool_bytes(g.graph) or 0
                               for g in spans) if spans else 0,
        "real_s": real_s,
        "health": {key: h[key] for key in (
            "submitted", "completed", "shed", "timeouts", "failures",
            "partials", "uncertified", "steps", "queue_depth")},
        "served": len(done), "partials": len(partial),
        "full_certified": len(full),
        "recall_min_full": min(recall) if recall else None,
        "served_latency": percentiles_ms(r.latency_s for r in done)
        if done else None,
        "resolved_latency": percentiles_ms(r.latency_s for r in timed),
        "coverage_min": min((r.coverage for r in done), default=None),
    }
    log("serving_overload", **rec, phase_s=time.perf_counter() - t_phase)
    check(h["submitted"] == SERVE_REQUESTS and h["submitted"] == (
        h["completed"] + h["shed"] + h["timeouts"] + h["failures"]
        + h["queue_depth"]) and h["failures"] == 0,
          f"overload: the tickets do not add up: {rec['health']}")
    check(all(r.status in ("done", "shed", "timeout") for r in resolved),
          "overload: a ticket resolved otherwise than done, shed or "
          "timeout")
    check(all(r.certified is False for r in partial),
          "overload: a partial answer kept its certificate")
    check(not recall or min(recall) == 1.0, "overload: a full, certified "
          "answer differs from the exact top-10")
    return rec


def phase_serving_ood(X, Q, Qo, d2, d2o, pdsp, dev):
    """The adaptive PDScanning+ session at 1M behind the service, on a
    50/50 interleave of the dataset's queries and OOD ones, at
    LAMBDA_FRACTION of its own calibrated capacity, no writes."""
    import numpy as np
    from repro_torch.api import SchedulePolicy, SearchSession
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.kernels import pq_lookup as pq_mod

    t_phase = time.perf_counter()
    nq = Q.shape[0]
    pool = np.concatenate([Q, Qo])
    qidx = [(i % nq) + (i % 2) * nq for i in range(OOD_REQUESTS)]
    sess = SearchSession(pdsp, SchedulePolicy(adaptive=True), device=dev)
    svc = sess.serve(slots=SERVE_SLOTS, k=K)
    # the seed sends a chunk to the switching walk or to step_full, one
    # graph each: capture both before the clock starts (a capture in the
    # timed run stalls every request queued behind it)
    t0 = time.perf_counter()
    for warm in (Q[:SERVE_SLOTS], Qo[:SERVE_SLOTS]):
        sess.search(warm, K)
    warm_s = time.perf_counter() - t0
    steady, _, cal = calibrate(svc, pool[qidx[:SERVE_SLOTS]])
    graphs = len(sess.backend._graphs)
    lam = LAMBDA_FRACTION * SERVE_SLOTS / steady
    rng = np.random.default_rng(SERVE_SEED + 2)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, OOD_REQUESTS))
    sync(dev)
    dco_mod.launches = dco_mod.grouped_launches = pq_mod.launches = 0
    t0 = time.perf_counter()
    served, rid_to_q, _ = simulate(svc, pool, qidx, arrivals, [])
    real_s = time.perf_counter() - t0
    launches = {"dco_scan": dco_mod.launches,
                "dco_scan_grouped": dco_mod.grouped_launches,
                "pq_lookup": pq_mod.launches}
    gt = np.concatenate([nearest(d2), nearest(d2o)])
    done = served_only(served)
    rows = {}
    for label, is_ood in (("id", False), ("ood", True)):
        mine = [r for r in done if (rid_to_q[r.rid] >= nq) == is_ood]
        rows[label] = {
            "n": len(mine), **percentiles_ms(r.latency_s for r in mine),
            "recall_min": min(float(np.isin(r.ids, gt[rid_to_q[r.rid]])
                                    .mean()) for r in mine),
            "certified_fraction": float(np.mean([r.certified is True
                                                 for r in mine])),
            "fallback_blocks_mean": float(np.mean(
                [r.stats.get("fallback_blocks", 0.0) for r in mine]))}
    h = svc.health()
    rec = {"method": "PDScanning+", "policy": "adaptive", "n": int(sess.n),
           "n_requests": OOD_REQUESTS, "calibration": dict(
               cal, steady_step_s=steady),
           "offered_qps": lam, "real_s": real_s,
           "sustained_qps": len(done) / (max(r.t_done for r in done)
                                         - min(r.t_submit for r in done)),
           **percentiles_ms(r.latency_s for r in done),
           "classes": rows, "launches": launches, "warm_s": warm_s,
           "graphs_warm": graphs,
           "graphs_captured_in_run": len(sess.backend._graphs) - graphs,
           "device_bytes_held": held_bytes(dev),
           "health": {key: h[key] for key in (
               "submitted", "completed", "failures", "uncertified")}}
    log("serving_ood", **rec, phase_s=time.perf_counter() - t_phase)
    check(len(done) == OOD_REQUESTS and h["failures"] == 0,
          f"serving_ood: not every ticket was served: {rec['health']}")
    check(all(rows[c]["recall_min"] == 1.0
              and rows[c]["certified_fraction"] == 1.0 for c in rows),
          f"serving_ood: an answer is not exact and certified: {rows}")
    check(launches["dco_scan"] == 0, "serving_ood launched dco_scan: the "
          "adaptive walk screens inline")
    check(rec["graphs_captured_in_run"] == 0, "serving_ood captured a graph "
          "after its warm-up")
    del svc, sess
    free_card(dev)
    return rec


def serve_pass(svc, Q, t0: float):
    """Submit every row of Q at simulated time ``t0`` and drain; returns
    the tickets in submission order, the real seconds the pass took and
    each step's virtual wall."""
    reqs = [svc.submit(q, now=t0 + 1e-6 * j) for j, q in enumerate(Q)]
    start = time.perf_counter()
    out = svc.drain(now=t0)
    real = time.perf_counter() - start
    walls = sorted({(r.t_done, r.service_s) for r in out
                    if r.service_s is not None})
    return reqs, real, [w for _, w in walls]


def tier_record(svc) -> dict:
    h = svc.health()
    return {key: h[key] for key in (
        "submitted", "completed", "failures", "retries", "hedges",
        "hedge_wins", "hedge_losses", "degraded")} | {
        "replicas": [{key: rs[key] for key in (
            "idx", "state", "rows", "dispatches", "served", "failures",
            "probes", "transitions")} for rs in h["replicas"]]}


def phase_replica(X, Q, d2, flat_ids, Xr, dev):
    """The replica tier: shard mode over the 1M corpus in REPLICAS
    contiguous shards (healthy, shard 1 dead, revived), then replicate
    mode over REPLICAS copies of the first N_RULES rows (a slow replica
    hedged; replica 0 killed after some dispatches, ejected, revived)."""
    import numpy as np
    from repro_torch.serving import open_replicated
    from repro_torch.testing import FaultPlan, faults

    t_phase = time.perf_counter()
    gt = nearest(d2)
    # -- shard mode, 1M ---------------------------------------------------
    t0 = time.perf_counter()
    svc = open_replicated(X, replicas=REPLICAS, mode="shard",
                          method="PDScanning+", device=dev,
                          slots=SERVE_SLOTS, k=K)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rs in svc.replicas:                 # lay out and capture each shard
        rs.session.search(Q[:SERVE_SLOTS], K)
    warm_s = time.perf_counter() - t0
    shard = {"rows": [rs.rows for rs in svc.replicas], "fit_s": fit_s,
             "warm_s": warm_s, "device_bytes_held": held_bytes(dev)}
    reqs, real, walls = serve_pass(svc, Q, 0.0)
    ids = np.stack([r.ids for r in reqs])
    shard["healthy"] = {
        "real_s": real, "virtual_step_s": walls,
        "ids_equal_flat": int(same_sets(ids, flat_ids).sum()),
        "ids_equal_flat_in_order": int((ids == flat_ids).all(1).sum()),
        "recall_at_10": float(np.mean([np.isin(a, b).mean()
                                       for a, b in zip(ids, gt)])),
        "certified": int(sum(r.certified is True for r in reqs))}
    check(all(r.done and r.coverage == 1.0 for r in reqs)
          and shard["healthy"]["ids_equal_flat"] == Q.shape[0]
          and shard["healthy"]["certified"] == Q.shape[0],
          f"shard tier: healthy answers differ: {shard['healthy']}")
    dead = svc.replicas[1]
    lo, hi = dead.id_offset, dead.id_offset + dead.rows
    live = d2.copy()
    live[:, lo:hi] = np.inf
    gt_live = nearest(live)
    del live
    prev = faults.install(FaultPlan(dead_replica=1))
    try:
        reqs, real, walls = serve_pass(svc, Q, 10.0)
    finally:
        faults.install(prev)
    ids = np.stack([r.ids for r in reqs])
    cov = (X.shape[0] - dead.rows) / X.shape[0]
    shard["dead_1"] = {
        "real_s": real, "virtual_step_s": walls,
        "coverage": sorted({float(r.coverage) for r in reqs}),
        "coverage_expected": cov,
        "uncertified": int(sum(r.certified is False for r in reqs)),
        "degraded": int(sum(r.stats.get("degraded") == 1.0 for r in reqs)),
        "ids_equal_live_shards": int(same_sets(ids, gt_live).sum()),
        "ids_equal_live_shards_in_order": int((ids == gt_live).all(1).sum()),
        "shard_1_state": dead.state}
    check(all(r.done for r in reqs)
          and all(abs(r.coverage - cov) < 1e-6 for r in reqs)
          and shard["dead_1"]["uncertified"] == Q.shape[0]
          and shard["dead_1"]["degraded"] == Q.shape[0]
          and shard["dead_1"]["ids_equal_live_shards"] == Q.shape[0],
          f"shard tier: a dead shard's batches are wrong: {shard['dead_1']}")
    passes = []
    for p in range(4):                      # revived: probe, then re-admit
        reqs, real, walls = serve_pass(svc, Q, 20.0 + 10 * p)
        passes.append({"real_s": real, "state": dead.state,
                       "full_coverage": int(sum(r.coverage == 1.0
                                                for r in reqs))})
        if dead.state == "closed" and passes[-1]["full_coverage"] == len(Q):
            break
    ids = np.stack([r.ids for r in reqs])
    shard["revived"] = {
        "passes": passes,
        "ids_equal_flat": int(same_sets(ids, flat_ids).sum()),
        "certified": int(sum(r.certified is True for r in reqs))}
    shard["tier"] = tier_record(svc)
    log("replica", mode="shard", n=int(X.shape[0]), replicas=REPLICAS,
        **shard)
    check(dead.state == "closed" and passes[-1]["full_coverage"] == len(Q)
          and shard["revived"]["ids_equal_flat"] == Q.shape[0]
          and shard["revived"]["certified"] == Q.shape[0]
          and shard["tier"]["failures"] == 0,
          f"shard tier: revival did not restore full answers: {shard}")
    del svc, reqs, dead, rs
    free_card(dev)
    # -- replicate mode, N_RULES rows ------------------------------------
    t0 = time.perf_counter()
    svc = open_replicated(Xr, replicas=REPLICAS, mode="replicate",
                          method="PDScanning+", device=dev,
                          slots=SERVE_SLOTS, k=K)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rs in svc.replicas:
        rs.session.search(Q[:SERVE_SLOTS], K)
    warm_s = time.perf_counter() - t0
    want = svc.replicas[0].session.search(Q, K).ids
    rep = {"rows": int(Xr.shape[0]), "fit_s": fit_s, "warm_s": warm_s,
           "device_bytes_held": held_bytes(dev)}
    reqs, real, walls = serve_pass(svc, Q, 0.0)
    rep["healthy"] = {"real_s": real, "virtual_step_s": walls}
    everything = list(reqs)
    prev = faults.install(FaultPlan(slow_replica=2,
                                    slow_replica_s=SLOW_REPLICA_S))
    try:
        reqs, real, walls = serve_pass(svc, Q, 10.0)
    finally:
        faults.install(prev)
    h = svc.health()
    everything += reqs
    rep["slow_2"] = {"real_s": real, "virtual_step_s": walls,
                     "hedges": h["hedges"], "hedge_wins": h["hedge_wins"],
                     "hedged_batches_won_by": sorted({
                         r.stats["replica"] for r in reqs
                         if r.stats.get("hedged") == 1.0})}
    check(h["hedges"] >= 1 and h["hedge_wins"] >= 1,
          f"replicate tier: no hedge fired and won: {rep['slow_2']}")
    r0 = svc.replicas[0]
    prev = faults.install(FaultPlan(dead_replica=0, fail_replica_after=5))
    passes = []
    try:
        for p in range(10):         # about two dispatches a pass each
            reqs, real, walls = serve_pass(svc, Q, 20.0 + 10 * p)
            everything += reqs
            passes.append({"real_s": real, "virtual_step_s": walls,
                           "state": r0.state})
            if r0.state == "open":
                break
    finally:
        faults.install(prev)
    rep["dead_0"] = {"passes": passes, "retries": svc.retries,
                     "failures": svc.failures}
    passes = []
    for p in range(10):
        reqs, real, walls = serve_pass(svc, Q, 200.0 + 10 * p)
        everything += reqs
        passes.append({"real_s": real, "state": r0.state})
        if r0.state == "closed":
            break
    rep["revived"] = passes
    rep["tier"] = tier_record(svc)
    moves = [(t["from"], t["to"]) for t in r0.breaker.transitions]
    same = [bool(np.array_equal(r.ids, want[j % Q.shape[0]]))
            for j, r in enumerate(everything) if r.done]
    rep["done_ids_equal_single"] = f"{sum(same)}/{len(same)}"
    gt_r = nearest(d2[:, :Xr.shape[0]])
    recall = [float(np.isin(r.ids, gt_r[j % Q.shape[0]]).mean())
              for j, r in enumerate(everything) if r.done]
    rep["done_recall_min"] = min(recall)
    log("replica", mode="replicate", n=int(Xr.shape[0]), replicas=REPLICAS,
        **rep)
    check(("closed", "open") in moves and ("open", "half_open") in moves
          and ("half_open", "closed") in moves and r0.state == "closed",
          f"replicate tier: replica 0 was not ejected and re-admitted: "
          f"{moves}")
    check(rep["dead_0"]["retries"] >= 1 and svc.failures == 0,
          "replicate tier: the dead replica's batch was not retried")
    check(all(r.done for r in everything) and all(same),
          "replicate tier: a ticket failed or differs from one session")
    check(rep["done_recall_min"] == 1.0,
          f"replicate tier: recall {rep['done_recall_min']} < 1 against "
          "the float64 ground truth")
    rec = {"shard": shard, "replicate": rep,
           "phase_s": time.perf_counter() - t_phase}
    del svc, reqs, everything
    free_card(dev)
    return rec


def phase_persist(Xr, Q, d2, dev):
    """A snapshot of a card session at N_RULES - 4 x PERSIST_ROWS rows,
    three logged adds, a fourth torn mid-frame, the session dropped, then
    loaded on the card: the WAL replayed (cold, no device work), the live
    session's ids, exact; a bit-flipped copy refused."""
    import os
    import tempfile
    import warnings

    import numpy as np
    from repro_torch.api import IndexLoadError, SearchSession, open_index
    from repro_torch.testing import SimulatedCrash, faults

    t_phase = time.perf_counter()
    n0 = Xr.shape[0] - (PERSIST_ADDS + 1) * PERSIST_ROWS
    rows = [Xr[n0 + j * PERSIST_ROWS:n0 + (j + 1) * PERSIST_ROWS]
            for j in range(PERSIST_ADDS + 1)]
    rec = {"n_base": n0, "add_rows": PERSIST_ROWS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "idx.bin")
        sess = open_index(Xr[:n0], method="PDScanning+", device=dev)
        sess.search(Q, K)
        t0 = time.perf_counter()
        sess.save(path)
        rec["save_s"] = time.perf_counter() - t0
        rec["snapshot_bytes"] = os.path.getsize(path)
        walls = []
        for chunk in rows[:PERSIST_ADDS]:
            t0 = time.perf_counter()
            sess.add(chunk)
            walls.append(time.perf_counter() - t0)
        rec["add_walls_s"] = walls
        crashed = False
        with faults.inject(torn_frame_keep=0.5):
            try:
                sess.add(rows[PERSIST_ADDS])
            except SimulatedCrash:
                crashed = True
        rec["torn_add_raised"] = crashed
        rec["wal_bytes"] = sess.wal.total_bytes()
        live = sess.search(Q, K)
        n_live = sess.n
        del sess
        free_card(dev)
        # the default device is the card; off it the load goes to ``dev``
        kw = {} if on_card(dev) else {"device": dev}
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loaded = SearchSession.load(path, **kw)
        rec["load_s"] = time.perf_counter() - t0
        rec["load_warnings"] = [str(w.message) for w in caught]
        be = loaded.backend
        rec.update(n_loaded=int(loaded.n), device=str(be.device),
                   replayed_rows=int(be.rows_inserted),
                   last_write_mode=loaded.last_write_mode,
                   rows_on_device_before_search=int(be.rows_written),
                   materialized_before_search=be._dstate is not None)
        t0 = time.perf_counter()
        res = loaded.search(Q, K)
        rec["first_search_after_load_s"] = time.perf_counter() - t0
        gt = nearest(d2[:, :n_live])
        rec.update(
            ids_equal_live=bool(np.array_equal(res.ids, live.ids)),
            dists_max_rel=float(np.max(np.abs(res.dists - live.dists)
                                       / np.maximum(np.abs(live.dists),
                                                    1e-30))),
            recall_at_10=float(np.mean([np.isin(a, b).mean()
                                        for a, b in zip(res.ids, gt)])),
            uncertified=res.stats.extra["uncertified_queries"])
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        bad = os.path.join(tmp, "flipped.bin")
        with open(bad, "wb") as f:
            f.write(raw)
        del raw
        try:
            SearchSession.load(bad, **kw)
            rec["bitflip_refused"] = False
        except IndexLoadError as exc:
            rec["bitflip_refused"] = "checksum mismatch" in exc.cause
        del loaded, res
        free_card(dev)
    log("persist", n=int(Xr.shape[0]), **rec,
        phase_s=time.perf_counter() - t_phase)
    check(crashed and any("torn" in w for w in rec["load_warnings"]),
          "persist: the torn add did not raise SimulatedCrash, or the load "
          "did not drop its frame")
    check(rec["n_loaded"] == n0 + PERSIST_ADDS * PERSIST_ROWS == n_live
          and rec["replayed_rows"] == PERSIST_ADDS * PERSIST_ROWS,
          f"persist: the WAL replay lost or added rows: {rec}")
    check(rec["last_write_mode"] == "cold"
          and not rec["materialized_before_search"]
          and rec["rows_on_device_before_search"] == 0,
          "persist: the WAL replay did device work before the first search")
    check(rec["ids_equal_live"] and rec["recall_at_10"] == 1.0,
          "persist: the loaded session's ids differ from the live one's")
    check(rec["bitflip_refused"], "persist: a bit-flipped snapshot loaded")
    return rec


# ------------------------------------------------------------------ mesh ---
MESH_ADD_ROWS = 1024             # rows a mesh session's add() appends
MESH_TIMEOUT_S = 420             # the ranks of one group are killed past it
MESH_BATCHES = 3
#: a served mesh step must stay this far under the group's 60 s timeout,
#: which a rank waiting for a failed rank's part would take whole
MESH_STEP_LIMIT_S = 10.0


def _mesh_session(X, Q, method, mesh, *, engine="stream", fitted=None):
    """A mesh session (fitting ``method`` unless ``fitted`` is given) and
    its first search: (session, result, fit seconds, first-search
    seconds: the shard's layout and capture)."""
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    policy = SchedulePolicy(engine=engine)
    t0 = time.perf_counter()
    if fitted is None:
        sess = open_index(X, method=method, mesh=mesh, schedule=policy)
    else:
        sess = SearchSession(fitted, policy, mesh=mesh)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sess.search(Q, K)
    return sess, res, fit_s, time.perf_counter() - t0


def _one_card(method, Q, *, engine="stream", row_block=4096):
    """ids and dists of a fitted ``method`` in a one-card session at the
    mesh shard's row block (the walk a one-shard mesh runs)."""
    from repro_torch.api import SchedulePolicy, SearchSession
    res = SearchSession(method, SchedulePolicy(
        engine=engine, row_block=row_block)).search(Q, K)
    return res.ids, res.dists


def serve_mesh_1m(sess, Q, rank: int):
    """The 1M served arm: the mesh session behind its SearchService.
    Rank 0 calibrates the service's capacity on its own steps
    (:func:`calibrate`), then submits the 100 queries as a Poisson stream
    at LAMBDA_FRACTION of it in simulated time; rank 1 follows.  Returns
    (record, rank 0's tickets' ids, dists and certificates in query
    order)."""
    import numpy as np
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.utils import trace

    t0 = time.perf_counter()
    svc = sess.serve(slots=SERVE_SLOTS, k=K)
    be = sess.backend
    graphs0 = len(be._graphs)
    if rank:
        return {"follow": svc.follow(),
                "seconds": time.perf_counter() - t0}, {}
    steady, _, cal = calibrate(svc, Q)
    lam = LAMBDA_FRACTION * SERVE_SLOTS / steady
    rng = np.random.default_rng(SERVE_SEED + 3)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, Q.shape[0]))
    walls = []

    def on_step(batch):
        walls.append(max(r.service_s for r in batch))

    dco_mod.launches = 0
    mark = time.time_ns()
    with trace.recording():
        served, rid_to_q, _ = simulate(svc, Q, list(range(Q.shape[0])),
                                       arrivals, [], on_step=on_step)
    launches = dco_mod.launches
    # one local walk and one exchange a step, in step order
    local = span_seconds("mesh.local", mark)
    exchange = span_seconds("mesh.exchange", mark)
    svc.close()
    done = sorted(served_only(served), key=lambda r: rid_to_q[r.rid])
    rec = {"slots": SERVE_SLOTS, "n_requests": int(Q.shape[0]),
           "calibration": dict(cal, steady_step_s=steady),
           "offered_qps": lam, "n_done": len(done), "steps": svc.steps,
           "run_steps": len(walls), "step_walls_s": walls,
           "step_wall_p50_ms": float(1e3 * np.median(walls)),
           "step_wall_p99_ms": float(1e3 * np.quantile(walls, 0.99)),
           "sustained_qps": len(done) / (max(r.t_done for r in done)
                                         - min(r.t_submit for r in done)),
           **percentiles_ms(r.latency_s for r in done),
           "local_s": local, "exchange_s": exchange,
           "local_share": float(np.median(local) / np.median(walls)),
           "exchange_share": float(np.median(exchange) / np.median(walls)),
           "dco_scan_launches": launches,
           "new_graphs": len(be._graphs) - graphs0,
           "seconds": time.perf_counter() - t0}
    arrays = {}
    if done:
        arrays = {"served_1m/ids": np.stack([r.ids for r in done]),
                  "served_1m/dists": np.stack([r.dists for r in done]),
                  "served_1m/certified": np.array([r.certified is True
                                                   for r in done])}
    return rec, arrays


def serve_mesh_100k(sess, Q, rows, rank: int, before_ids):
    """The 100k serve case on the add arm's session: one step whose
    tickets must carry the session's own ids (``before_ids``), an add of
    ``rows`` through the service (the first SERVE_SLOTS of them beside
    the queries, so the next tickets must find them), a request with a
    budget (the reference's ValueError on every rank), a step that fails
    on rank 1 alone (a fault plan armed in its process) and a step
    after it.  Rank 1 follows."""
    import numpy as np
    from repro_torch.testing import faults

    t0 = time.perf_counter()
    svc = sess.serve(slots=SERVE_SLOTS, k=K)
    if rank:
        with faults.inject(fail_search_after=3):    # its 4th search fails
            return {"follow": svc.follow(),
                    "seconds": time.perf_counter() - t0}
    n_before = sess.n

    def batch(qs, **kw):
        reqs = [svc.submit(q, **kw) for q in qs]
        svc.drain()
        return reqs

    first = batch(Q[:SERVE_SLOTS])
    info = svc.add(rows)
    after = batch(Q[:SERVE_SLOTS])
    budget = batch(Q[:1], deadline_s=60.0)
    fault = batch(Q[:SERVE_SLOTS])
    again = batch(Q[:SERVE_SLOTS])
    svc.close()
    tickets = first + after + budget + fault + again
    return {
        "steps": svc.steps, "add_mode": info["mode"],
        "add_wall_s": info["wall_s"],
        "first_same_ids": all(r.done for r in first) and bool(
            np.array_equal(np.stack([r.ids for r in first]), before_ids)),
        "after_done": all(r.done and r.certified for r in after),
        "after_finds_new_rows": all(
            r.done and int(r.ids[0]) == n_before + j
            for j, r in enumerate(after)),
        "budget": [budget[0].status, budget[0].error],
        "fault": sorted({(r.status, r.error) for r in fault}),
        "again_same_ids": all(r.done for r in again) and bool(
            np.array_equal(np.stack([r.ids for r in again]),
                           np.stack([r.ids for r in after]))),
        "step_walls_s": sorted({r.service_s for r in tickets}),
        "health": {key: svc.health()[key] for key in (
            "submitted", "completed", "failures", "steps")},
        "seconds": time.perf_counter() - t0}


#: the 1M tier's slow replica stalls this many calibrated steps (virtual)
TIER_SLOW_STEPS = 10.0
#: passes of one step each that the tier may take to readmit a replica
TIER_PROBE_PASSES = 16


def tier_mesh_1m(sess, Q, rank: int, mesh):
    """The replica tier over mesh sessions (A29) at 1M: replica 0 is the
    served arm's session, replica 1 a second session of the same fitted
    method.  Rank 0 calibrates the tier's capacity on its own steps, then
    submits the queries as a Poisson stream at LAMBDA_FRACTION of it in
    simulated time: replica 1 stalls TIER_SLOW_STEPS steps (virtual) for
    two steps, so a hedge fires, then replica 0 is killed until the tier
    ejects it and revived; one-step passes then probe it until it is
    readmitted.  Rank 1 follows.  Returns (record, rank 0's done
    tickets' ids and query indices)."""
    import gc

    import torch
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.serving import ReplicatedService

    t0 = time.perf_counter()
    second, _, _, first_s = _mesh_session(None, Q[:SERVE_SLOTS],
                                          "PDScanning+", mesh,
                                          fitted=sess.method)
    build_s = time.perf_counter() - t0
    dco_mod.launches = 0
    svc = ReplicatedService([sess, second], slots=SERVE_SLOTS, k=K)
    if rank:
        rec = {"follow": svc.follow(), "dco_scan_launches": dco_mod.launches}
    else:
        rec = _tier_1m_stream(svc, Q)
        rec["second_first_search_s"] = first_s
    rec.update(build_s=build_s, seconds=time.perf_counter() - t0)
    arrays = rec.pop("arrays", {})
    del svc, second
    gc.collect()
    torch.cuda.empty_cache()
    return rec, arrays


def _tier_1m_stream(svc, Q) -> dict:
    """Rank 0's side of :func:`tier_mesh_1m`."""
    import numpy as np
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.testing import FaultPlan, faults

    steady, _, cal = calibrate(svc, Q)
    lam = LAMBDA_FRACTION * SERVE_SLOTS / steady
    rng = np.random.default_rng(SERVE_SEED + 5)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, Q.shape[0]))
    r0, walls, events = svc.replicas[0], [], []
    slow = FaultPlan(slow_replica=1, slow_replica_s=TIER_SLOW_STEPS * steady)
    kill = FaultPlan(dead_replica=0, fail_replica_after=1)

    def revive(n):
        if faults.active() is kill and r0.state == "open":
            faults.install(None)    # ejected: revive it
            events.append((n, "revive"))

    def on_step(batch):
        walls.append(max(r.service_s for r in batch))
        n = len(walls)
        if n in (2, 4):             # slow for steps 3-4, then the kill
            faults.install(slow if n == 2 else kill)
            events.append((n, "slow" if n == 2 else "kill"))
        revive(n)

    prev = faults.install(None)
    try:
        served, rid_to_q, _ = simulate(svc, Q, list(range(Q.shape[0])),
                                       arrivals, [], on_step=on_step)
        done = served_only(served)
        qidx = [rid_to_q[r.rid] for r in done]
        t, passes = arrivals[-1] + 10.0, []
        for p in range(TIER_PROBE_PASSES):   # eject, then readmit it
            if faults.active() is None and r0.state == "closed":
                break
            qs = [(SERVE_SLOTS * p + j) % Q.shape[0]
                  for j in range(SERVE_SLOTS)]
            reqs, real, _ = serve_pass(svc, Q[qs], t + p)
            passes.append({"real_s": real, "state": r0.state})
            done += served_only(reqs)
            qidx += qs
            revive(len(walls) + len(passes))
    finally:
        faults.install(prev)
    svc.close()
    tier = tier_record(svc)
    searched = [rs["dispatches"] - rs["failures"] for rs in tier["replicas"]]
    t_done = [r.t_done for r in served if r.status == "done"]
    t_sub = [r.t_submit for r in served if r.status == "done"]
    return {
        "slots": SERVE_SLOTS, "n_requests": int(Q.shape[0]),
        "calibration": dict(cal, steady_step_s=steady), "offered_qps": lam,
        "n_stream_done": len(t_done),
        "stream_statuses": sorted({r.status for r in served}),
        "events": events, "probe_passes": passes, "steps": svc.steps,
        "step_walls_s": walls,
        "step_wall_p50_ms": float(1e3 * np.median(walls)),
        "step_wall_p99_ms": float(1e3 * np.quantile(walls, 0.99)),
        "sustained_qps": len(t_done) / (max(t_done) - min(t_sub)),
        **percentiles_ms(r.latency_s for r in served if r.status == "done"),
        "tier": tier, "device_searches": searched,
        "dco_scan_launches": dco_mod.launches,
        "dco_scan_launches_per_dispatch": dco_mod.launches / sum(searched),
        "arrays": {"tier_1m/ids": np.stack([r.ids for r in done]),
                   "tier_1m/qidx": np.asarray(qidx)}}


def tier_mesh_100k(X, Q, rows, rank: int, mesh, dev):
    """The replica tier over mesh sessions (A29) in shard mode: the
    N_RULES rows in REPLICAS contiguous mesh sessions; a pass healthy,
    one with shard 1 dead, passes until it is readmitted, then an add of
    ``rows`` (the first SERVE_SLOTS of them each a step off a query) to
    the tail shard and a pass over the first SERVE_SLOTS queries.  Rank
    1 follows.  Returns the record."""
    import numpy as np
    from repro_torch.serving import ReplicatedService
    from repro_torch.testing import FaultPlan, faults

    t0 = time.perf_counter()
    # each shard's rows a multiple of the world: a mesh shards evenly
    world = mesh.size()
    bounds = world * np.linspace(0, X.shape[0] // world,
                                 REPLICAS + 1).astype(int)
    shards = [_mesh_session(X[lo:hi], Q[:SERVE_SLOTS], "PDScanning+",
                            mesh)[0] for lo, hi in zip(bounds, bounds[1:])]
    svc = ReplicatedService(shards, mode="shard", slots=SERVE_SLOTS, k=K)
    build_s = time.perf_counter() - t0
    if rank:
        return {"follow": svc.follow(), "build_s": build_s,
                "seconds": time.perf_counter() - t0}
    d2 = distances64(X, Q, dev)
    full = nearest(d2)
    d2[:, bounds[1]:bounds[2]] = np.inf
    live = nearest(d2)
    del d2
    rec = {"build_s": build_s, "rows": [rs.rows for rs in svc.replicas],
           "id_offsets": [rs.id_offset for rs in svc.replicas]}

    def record(reqs, real, want):
        ids = np.stack([r.ids for r in reqs])
        return {"real_s": real,
                "statuses": sorted({r.status for r in reqs}),
                "coverage": sorted({float(r.coverage) for r in reqs}),
                # the shards' fractions sum in float32, as the reference's
                "full_coverage": int(sum(abs(r.coverage - 1.0) < 1e-6
                                         for r in reqs)),
                "certified": int(sum(r.certified is True for r in reqs)),
                "degraded": int(sum(r.stats.get("degraded") == 1.0
                                    for r in reqs)),
                "same_sets": int(same_sets(ids, want).sum()),
                "same_in_order": int((ids == want).all(1).sum())}

    reqs, real, _ = serve_pass(svc, Q, 0.0)
    rec["healthy"] = record(reqs, real, full)
    prev = faults.install(FaultPlan(dead_replica=1))
    try:
        reqs, real, _ = serve_pass(svc, Q, 10.0)
    finally:
        faults.install(prev)
    rec["dead_1"] = record(reqs, real, live)
    rec["coverage_expected"] = float(
        (X.shape[0] - svc.replicas[1].rows) / X.shape[0])
    rec["revived"] = []
    for p in range(4):
        reqs, real, _ = serve_pass(svc, Q, 20.0 + 10 * p)
        rec["revived"].append(dict(record(reqs, real, full),
                                   state=svc.replicas[1].state))
        if svc.replicas[1].state == "closed" \
                and rec["revived"][-1]["full_coverage"] == Q.shape[0]:
            break
    info = svc.add(rows)
    reqs, real, _ = serve_pass(svc, Q[:SERVE_SLOTS], 100.0)
    rec["add"] = {"mode": info["mode"], "wall_s": info["wall_s"],
                  "tail_rows": svc.replicas[-1].rows, "real_s": real,
                  "statuses": sorted({r.status for r in reqs}),
                  "first_ids": [int(r.ids[0]) for r in reqs],
                  "certified": int(sum(r.certified is True for r in reqs))}
    svc.close()
    rec["tier"] = tier_record(svc)
    rec["device_searches"] = [rs["dispatches"] - rs["failures"]
                              for rs in rec["tier"]["replicas"]]
    rec["seconds"] = time.perf_counter() - t0
    return rec


def mesh_rank(outdir: str, backend: str) -> int:
    """One rank of the ``mesh`` phase, started by :func:`phase_mesh` as
    ``chip_smoke.py --mesh-rank OUTDIR BACKEND``: with gloo (two ranks on
    one card) the 1M PDScanning+ arm, then the 100k arms; with nccl (one
    rank) the 100k arms on device-tensor collectives.  The corpus comes
    from OUTDIR/../corpus.npy (the parent's seeded dataset, mapped, not
    pickled through the arguments), the queries and the path of the rules
    phase's DDCopq snapshot from OUTDIR/../rows.npz; the rank writes its
    arrays and record to OUTDIR/rank{r}.npz."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import SearchSession, open_index
    from repro_torch.kernels import dco_scan as dco_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import join
    from repro_torch.serving import ReplicatedService
    from repro_torch.utils import trace
    from repro_torch.vecdata import recall_at_k

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = join(backend)
    mesh = make_host_mesh(world, 1, device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    rec, arrays = {"rank": rank, "world": world, "backend": backend}, {}
    with np.load(Path(outdir).parent / "rows.npz") as z:
        Q, opq_snapshot = z["queries"], str(z["opq_snapshot"])
    corpus = np.load(Path(outdir).parent / "corpus.npy", mmap_mode="r")
    # the add arm's rows, then the rows the serve case adds through the
    # service: the first SERVE_SLOTS of them each a step off a query
    Xr = np.array(corpus[:N_RULES + 2 * MESH_ADD_ROWS])
    off = np.random.default_rng(SERVE_SEED + 4).standard_normal(
        (SERVE_SLOTS, Q.shape[1])).astype(np.float32)
    Xr[N_RULES + MESH_ADD_ROWS:][:SERVE_SLOTS] = (
        Q[:SERVE_SLOTS] + 1e-3 * float(Xr.std()) * off)
    if backend == "gloo":
        # the 1M arm: PDScanning+, each rank's shard of 500,000 rows
        opened = time.time_ns()
        sess, res, fit_s, first_s = _mesh_session(corpus, Q, "PDScanning+",
                                                  mesh)
        be = sess.backend
        walls = []
        mark = time.time_ns()
        with trace.recording():
            for j in range(MESH_BATCHES):
                dist.barrier()
                dco_mod.launches = 0
                t0 = time.perf_counter()
                res = sess.search(Q, K)      # the merged result on the host
                walls.append(time.perf_counter() - t0)
                if j == 0:
                    launches = dco_mod.launches
        exchange = span_seconds("mesh.exchange", mark)
        local = span_seconds("mesh.local", mark)
        rec["flat_1m"] = {
            "fit_s": fit_s, "first_search_s": first_s,
            "materialize_s": span_seconds("backend.layout", opened)[0],
            "capture_s": sum(graph_seconds(g, "engine.capture")
                             for g in be._graphs.values()),
            "row_block": be._mesh_row_block,
            "search_walls_s": walls, "local_s": local,
            "exchange_s": exchange,
            "qps": float(Q.shape[0] / np.median(walls)),
            "exchange_share": float(np.median(exchange) / np.median(walls)),
            "uncertified_queries": res.stats.extra["uncertified_queries"],
            "dco_scan_launches_per_batch": launches,
            "graphs": len(be._graphs),
            "layout_bytes": sum(v.nbytes for v in be._state.values()),
            "device_bytes_held": torch.cuda.memory_allocated(dev)}
        arrays["flat_1m/ids"], arrays["flat_1m/dists"] = res.ids, res.dists
        # the same session behind the mesh service (A19)
        rec["served_1m"], served = serve_mesh_1m(sess, Q, rank)
        arrays.update(served)
        # and as replica 0 of a tier over two mesh sessions (A29)
        rec["tier_1m"], tier = tier_mesh_1m(sess, Q, rank, mesh)
        arrays.update(tier)
        del sess, res, be
        gc.collect()
        torch.cuda.empty_cache()
    # the 100k arms: the rule scalars and per-query extras (DDCres, DADE),
    # the two-stage engine, a ragged batch, DDCopq's lower-bound fallback
    # and a write; each method is fitted once, and rank 0 also serves it
    # on one card (and FDScanning) to hold the mesh to
    X = Xr[:N_RULES]
    cases = {"PDScanning+": ("PDScanning+", "stream", 100),
             "DDCres": ("DDCres", "stream", 100),
             "DADE": ("DADE", "stream", 100)}
    if backend == "gloo":
        cases.update({"two_stage": ("PDScanning+", "two_stage", 100),
                      "ragged": ("PDScanning+", "stream", 13),
                      "DDCopq": ("DDCopq", "stream", 100),
                      "add": ("PDScanning+", "stream", 100)})
    fd = None
    if rank == 0:
        fd = open_index(X, method="FDScanning").search(Q, K).ids
    fitted, rec["arms"] = {}, {}
    if backend == "gloo":       # DDCopq as the rules phase fitted it
        t0 = time.perf_counter()
        fitted["DDCopq"] = SearchSession.load(opq_snapshot, mesh=mesh).method
        rec["ddcopq_load_s"] = time.perf_counter() - t0
    for case, (method, engine, nq) in cases.items():
        sess, res, fit_s, first_s = _mesh_session(
            X, Q[:nq], method, mesh, engine=engine,
            fitted=fitted.get(method))
        fitted[method] = sess.method
        fn = next(iter(sess.backend._mesh_fns.values()))
        arm = {"method": method, "engine": engine, "nq": nq, "fit_s": fit_s,
               "first_search_s": first_s,
               "exchange_on_device": fn.on_device,
               "row_block": sess.backend._mesh_row_block,
               "uncertified_queries":
                   res.stats.extra.get("uncertified_queries")}
        if case == "add":       # last: the add grows the shared method
            sess.add(Xr[N_RULES:N_RULES + MESH_ADD_ROWS])
            arm["add_mode"] = sess.last_write_mode
            res = sess.search(Q, K)
            arm["row_block_after_add"] = sess.backend._mesh_row_block
        arrays[f"{case}/ids"] = res.ids
        if rank == 0 and method != "DDCopq":
            # DDCopq screens with pq_lookup on one card; its mesh fallback
            # is the exact lower-bound rule, held to FDScanning's ids
            ids, dists = _one_card(sess.method, Q[:nq], engine=engine,
                                   row_block=sess.backend._mesh_row_block)
            arm["one_card_same_ids"] = bool(np.array_equal(res.ids, ids))
            arm["one_card_max_rel_err"] = float(np.max(
                np.abs(res.dists - dists) / np.maximum(dists, 1e-30)))
        if backend == "nccl" and case == "PDScanning+":
            # a world of one behind the service: no follower, no broadcast
            svc = sess.serve(slots=SERVE_SLOTS, k=K)
            reqs = [svc.submit(q) for q in Q[:nq]]
            svc.drain()
            arm["served_one_card_same_ids"] = all(r.done for r in reqs) \
                and bool(np.array_equal(np.stack([r.ids for r in reqs]),
                                        ids))
            # a tier over two sessions of the world of one: no channel
            tier = ReplicatedService(
                [sess, SearchSession(sess.method, sess.policy, mesh=mesh)],
                slots=SERVE_SLOTS, k=K)
            reqs = [tier.submit(q) for q in Q[:nq]]
            tier.drain()
            arm["tier_one_rank"] = {
                "channel": tier._channel is not None,
                "replicas": sorted({r.stats["replica"] for r in reqs}),
                "same_ids": all(r.done for r in reqs) and bool(
                    np.array_equal(np.stack([r.ids for r in reqs]), ids))}
            del tier
        if rank == 0:
            want = fd[:nq]
            if case == "add":
                want = open_index(Xr[:N_RULES + MESH_ADD_ROWS],
                                  method="FDScanning").search(Q, K).ids
                arm["add_sees_new_rows"] = int((res.ids >= N_RULES).sum())
            arm["recall_vs_fdscanning"] = recall_at_k(res.ids, want)
            arm["fdscanning_same_ids"] = bool(np.array_equal(res.ids, want))
        rec["arms"][case] = arm
        if case == "add":       # the service over the grown session
            rec["serve_100k"] = serve_mesh_100k(
                sess, Q, Xr[N_RULES + MESH_ADD_ROWS:], rank,
                res.ids[:SERVE_SLOTS])
        del sess, res, fn
        gc.collect()
        torch.cuda.empty_cache()
    if backend == "gloo":       # the replica tier in shard mode (A29)
        rec["tier_100k"] = tier_mesh_100k(
            X, Q, Xr[N_RULES + MESH_ADD_ROWS:], rank, mesh, dev)
    arrays["rec"] = np.asarray(json.dumps(rec))
    np.savez(Path(outdir) / f"rank{rank}.npz", **arrays)
    dist.destroy_process_group()
    return 0


def _run_mesh_group(outdir, world: int, backend: str) -> list:
    import numpy as np
    from repro_torch.launch.ranks import run_ranks

    run_ranks([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
               str(outdir), backend], world, workdir=outdir,
              timeout_s=MESH_TIMEOUT_S)
    outs = []
    for r in range(world):
        with np.load(Path(outdir) / f"rank{r}.npz") as z:
            out = dict(z)
        out["rec"] = json.loads(str(out["rec"]))
        outs.append(out)
    return outs


def phase_mesh(X, Q, opq_snapshot, flat_ids, flat_dists, flat_rec, dev):
    """The sharded global top-k (launch.mesh, make_distributed_topk, the
    backend's mesh path) as rank processes on this card: the NCCL group of
    two on one card refused; two gloo ranks (1M PDScanning+: the flat
    session's ids, 0 uncertified, the ranks bit-equal, a 4,000-row shard
    block, 875 dco_scan launches a rank and batch, half the flat
    session's device bytes; then the 100k arms); one NCCL rank (the 100k
    arms on device-tensor collectives).  ``opq_snapshot`` is the rules
    phase's 100k DDCopq session, saved, which the ranks load onto the
    mesh (``SearchSession.load(path, mesh=)``) instead of fitting it."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    try:
        make_host_mesh(2, 1, device_type="cuda")
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    check("gloo" in refused and not dist.is_initialized(),
          "mesh: an NCCL group of 2 on one card was not refused before "
          "its initialisation")
    rec = {"nccl_two_on_one_card_refused": refused}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        t0 = time.perf_counter()
        np.save(Path(tmp) / "corpus.npy", X)
        rec["corpus_save_s"] = time.perf_counter() - t0
        np.savez(Path(tmp) / "rows.npz", queries=Q,
                 opq_snapshot=np.asarray(str(opq_snapshot)))
        t0 = time.perf_counter()
        gloo = _run_mesh_group(Path(tmp) / "gloo", 2, "gloo")
        rec["gloo_group_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = _run_mesh_group(Path(tmp) / "nccl", 1, "nccl")
        rec["nccl_group_s"] = time.perf_counter() - t0
    r0, r1 = gloo[0], gloo[1]
    flat = [g["rec"]["flat_1m"] for g in gloo]
    served = [g["rec"]["served_1m"] for g in gloo]
    serve_100k = [g["rec"]["serve_100k"] for g in gloo]
    rec.update(gloo_1m=flat, gloo_100k=r0["rec"]["arms"],
               nccl_100k=nccl[0]["rec"]["arms"], served_1m=served,
               serve_100k=serve_100k,
               tier_1m=[g["rec"]["tier_1m"] for g in gloo],
               tier_100k=[g["rec"]["tier_100k"] for g in gloo],
               phase_s=time.perf_counter() - t_phase)
    log("mesh", **rec)
    for key in r0:
        if key != "rec" and not key.startswith(("served_1m/", "tier_1m/")):
            check(np.array_equal(r0[key], r1[key]),
                  f"mesh: the two ranks' {key} differ")
    check(np.array_equal(r0["flat_1m/ids"], flat_ids),
          "mesh: the 2-rank 1M ids differ from the flat session's")
    check(np.allclose(r0["flat_1m/dists"], flat_dists, rtol=1e-4),
          "mesh: the 2-rank 1M distances differ from the flat session's")
    for f in flat:
        check(f["uncertified_queries"] == 0.0, "mesh: uncertified queries")
        check(f["row_block"] == 4000, "mesh: the shard row block is not 4000")
        check(f["dco_scan_launches_per_batch"] == 875,
              "mesh: not 875 dco_scan launches a rank and batch")
        ratio = f["device_bytes_held"] / flat_rec["device_bytes_held"]
        check(0.45 <= ratio <= 0.55,
              f"mesh: a rank holds {ratio:.3f} of the flat session's bytes")
    for case, arm in r0["rec"]["arms"].items():
        if arm["method"] in ("DDCres", "DADE"):
            # estimators: each shard screens under its own running tau
            # (and DDCres its own least tail energy, as the reference's
            # shards do), so a shard may prune what one card keeps; the
            # bar is the reference test's recall against the exact ids,
            # and the one-card agreement is reported
            check(arm["recall_vs_fdscanning"] >= 0.95,
                  f"mesh: gloo {case} recall below 0.95")
        else:
            check(arm["fdscanning_same_ids"], f"mesh: gloo {case} ids "
                  "differ from FDScanning's")
        if arm["method"] == "PDScanning+":
            # (the lower-bound fallback on DDCopq's raw dims certifies
            # no query at 100k, as PDScanning does on one card: C4)
            check(arm["uncertified_queries"] == 0.0,
                  f"mesh: gloo {case} left queries uncertified")
    add = r0["rec"]["arms"]["add"]
    check(add["add_mode"] == "rebuild" and add["add_sees_new_rows"] > 0,
          "mesh: add() did not rebuild or the next search missed its rows")
    check(not any(a["exchange_on_device"] for a in r0["rec"]["arms"].values())
          and all(a["exchange_on_device"]
                  for a in nccl[0]["rec"]["arms"].values()),
          "mesh: gloo exchanged device tensors or nccl host ones")
    for case, arm in nccl[0]["rec"]["arms"].items():
        # one shard is the whole corpus: the one-card walk at its row block
        check(arm["one_card_same_ids"] and arm["one_card_max_rel_err"]
              <= 1e-4, f"mesh: nccl {case} differs from the one-card "
              "session")
    # the mesh service (A19): rank 0 serves, rank 1 follows
    s0, s1 = served
    check(s0["n_done"] == Q.shape[0]
          and bool(r0["served_1m/certified"].all()),
          "mesh: a served 1M ticket was not done and certified")
    check(np.array_equal(r0["served_1m/ids"], flat_ids),
          "mesh: the served 1M ids differ from the flat session's")
    check(np.allclose(r0["served_1m/dists"], flat_dists, rtol=1e-4),
          "mesh: the served 1M distances differ from the flat session's")
    check(s1["follow"] == {"searches": s0["steps"], "adds": 0,
                           "failures": 0},
          f"mesh: rank 1 did not search once per rank-0 step: "
          f"{s1['follow']}, {s0['steps']} steps")
    check(s0["new_graphs"] <= 1, "mesh: the served (16, D) walk was "
          f"captured {s0['new_graphs']} times")
    check(s0["dco_scan_launches"] > 0,
          "mesh: the served 1M arm launched no dco_scan")
    v0, v1 = serve_100k
    check(v0["first_same_ids"], "mesh: the 100k service's tickets differ "
          "from the session's ids")
    check(v0["add_mode"] == "rebuild" and v0["after_done"]
          and v0["after_finds_new_rows"], "mesh: the service's add did "
          "not rebuild or the next tickets missed its rows")
    check(v0["budget"][0] == "failed" and v0["budget"][1].startswith(
        "ValueError: anytime deadlines are single-device"),
        f"mesh: the budget batch did not fail as the reference's: "
        f"{v0['budget']}")
    check(len(v0["fault"]) == 1 and v0["fault"][0][0] == "failed"
          and v0["fault"][0][1].startswith(
              "MeshSearchError: the mesh search failed on rank 1: "
              "FaultError"),
          f"mesh: rank 1's fault did not fail its batch: {v0['fault']}")
    check(v0["again_same_ids"], "mesh: the step after the fault differs")
    check(max(v0["step_walls_s"]) < MESH_STEP_LIMIT_S,
          "mesh: a served step waited for the group's timeout")
    check(v0["steps"] == 5 and v1["follow"] == {
        "searches": 5, "adds": 1, "failures": 2},
        f"mesh: rank 1 did not follow the 100k service: {v1['follow']}")
    check(nccl[0]["rec"]["arms"]["PDScanning+"]["served_one_card_same_ids"],
          "mesh: the nccl world of one's service differs from the "
          "one-card session")
    check_mesh_tiers(r0, r1, nccl[0], flat_ids, Q.shape[0])
    return rec


def check_mesh_tiers(r0, r1, one, flat_ids, nq: int) -> None:
    """The replica tier over mesh sessions (A29): the gloo pair's 1M
    replicate arm and 100k shard arm, and the NCCL world of one."""
    import numpy as np
    t0, t1 = r0["rec"]["tier_1m"], r1["rec"]["tier_1m"]
    tier, rep0 = t0["tier"], t0["tier"]["replicas"][0]
    check(t0["stream_statuses"] == ["done"] and tier["failures"] == 0,
          f"mesh tier: a 1M ticket was not done: {t0['stream_statuses']}")
    check(np.array_equal(r0["tier_1m/ids"], flat_ids[r0["tier_1m/qidx"]]),
          "mesh tier: a 1M ticket's ids differ from the flat session's")
    check(tier["hedges"] >= 1 and tier["hedge_wins"] >= 1,
          f"mesh tier: the slow replica was not hedged: {t0['events']}")
    moves = [(m["from"], m["to"]) for m in rep0["transitions"]]
    check(("closed", "open") in moves and ("half_open", "closed") in moves
          and rep0["state"] == "closed" and tier["retries"] >= 1,
          f"mesh tier: replica 0 was not ejected and readmitted: {moves}")
    follow = t1["follow"]
    check([f["searches"] for f in follow["replicas"]]
          == t0["device_searches"] and follow["failures"] == 0
          and follow["adds"] == 0,
          f"mesh tier: rank 1 did not search once per rank-0 device "
          f"dispatch: {follow}, {t0['device_searches']}")
    check(t0["dco_scan_launches_per_dispatch"] == 125
          and t1["dco_scan_launches"] == 125 * sum(t0["device_searches"]),
          "mesh tier: not 125 dco_scan launches a rank and dispatch: "
          f"{t0['dco_scan_launches']}, {t1['dco_scan_launches']}")
    v, f = r0["rec"]["tier_100k"], r1["rec"]["tier_100k"]
    healthy, dead, last = v["healthy"], v["dead_1"], v["revived"][-1]
    check(healthy["statuses"] == ["done"] and healthy["same_sets"] == nq
          and healthy["certified"] == nq and healthy["full_coverage"] == nq,
          f"mesh shard tier: healthy answers differ: {healthy}")
    check(dead["statuses"] == ["done"] and dead["degraded"] == nq
          and dead["certified"] == 0 and dead["same_sets"] == nq
          and all(abs(c - v["coverage_expected"]) < 1e-6
                  for c in dead["coverage"]),
          f"mesh shard tier: a dead shard's batches are wrong: {dead}")
    check(last["state"] == "closed" and last["full_coverage"] == nq
          and last["same_sets"] == nq and last["certified"] == nq,
          f"mesh shard tier: revival did not restore full answers: {last}")
    add = v["add"]
    check(add["mode"] == "rebuild" and add["statuses"] == ["done"]
          and add["first_ids"] == [N_RULES + j for j in range(SERVE_SLOTS)],
          f"mesh shard tier: the add's rows were not found: {add}")
    check([x["searches"] for x in f["follow"]["replicas"]]
          == v["device_searches"]
          and [x["adds"] for x in f["follow"]["replicas"]] == [0, 0, 1]
          and f["follow"]["failures"] == 0 and v["tier"]["failures"] == 0,
          f"mesh shard tier: rank 1 did not follow: {f['follow']}")
    one = one["rec"]["arms"]["PDScanning+"]["tier_one_rank"]
    check(not one["channel"] and one["same_ids"]
          and one["replicas"] == [0.0, 1.0],
          f"mesh tier: the nccl world of one's tier is wrong: {one}")


# ------------------------------------------------------------- attention ---
ATT_B, ATT_S, ATT_HKV, ATT_G, ATT_HD = 8, 32_768, 8, 4, 128   # Qwen3-4B
ATT_D1, ATT_CAP = 32, 512
ATT_REPS = 20
BF16_FLOP_PER_S = 989e12         # H100 SXM data sheet, dense bf16


def event_ms(fn, reps: int = ATT_REPS) -> float:
    """Median of ``reps`` calls, each between two CUDA events."""
    import numpy as np
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_attention(dev):
    """DCO-screened decode attention at Qwen3-4B's decode shapes (32 heads,
    8 KV heads, head_dim 128), B = 8, a 32,768-position bf16 cache with
    ragged cur_len: cap = S against exact attention, the card against the
    CPU on one sequence, walls against exact attention and SDPA, the
    error and the softmax mass the top-C keeps, the bytes each reads."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.serving import (dco_decode_attention,
                                     exact_decode_attention, fit_key_rotation)
    from repro_torch.serving.dco_attention import _top_c, _valid

    t_phase = time.perf_counter()
    B, S, Hkv, G, hd = ATT_B, ATT_S, ATT_HKV, ATT_G, ATT_HD
    H = Hkv * G
    gen = torch.Generator(device=dev).manual_seed(19)
    spec = torch.arange(1, hd + 1, device=dev, dtype=torch.float32) ** -0.7
    k = torch.randn(B, S, Hkv, hd, device=dev, generator=gen) * spec
    v = torch.randn(B, S, Hkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    q = (torch.randn(B, H, hd, device=dev, generator=gen) * spec).to(
        torch.bfloat16)
    cur = np.random.default_rng(19).integers(30_000, S + 1, B).astype(np.int32)
    sample = torch.randint(0, B * S * Hkv, (4096,), device=dev, generator=gen)
    rot = torch.from_numpy(fit_key_rotation(
        k.reshape(-1, hd)[sample].cpu().numpy())).to(dev)
    k_rot = torch.einsum("bshd,de->bshe", k, rot).to(torch.bfloat16)
    k = k.to(torch.bfloat16)
    torch.cuda.synchronize()

    def screened(cap=ATT_CAP):
        return dco_decode_attention(q, k_rot, v, rot, cur, d1=ATT_D1, cap=cap)

    def exact():
        return exact_decode_attention(q, k, v, cur)

    out, ex = screened(), exact()
    full = screened(cap=S)
    full_err = float((full.float() - ex.float()).abs().max())
    check(torch.allclose(full.float(), ex.float(), rtol=2e-2, atol=2e-2),
          f"attention: cap = S differs from exact attention ({full_err})")
    cpu = dco_decode_attention(q[:1].cpu(), k_rot[:1].cpu(), v[:1].cpu(),
                               rot.cpu(), cur[:1], d1=ATT_D1, cap=ATT_CAP)
    cpu_err = float((cpu.float() - out[:1].float().cpu()).abs().max())
    check(torch.allclose(cpu.float(), out[:1].float().cpu(), rtol=2e-2,
                         atol=2e-2),
          f"attention: the card differs from the CPU ({cpu_err})")
    err = float((out.float() - ex.float()).abs().max())
    # the share of the exact softmax's mass on the top-C positions
    q_rot = (q.float() @ rot).reshape(B, Hkv, G, hd)
    valid = _valid(cur, B, S, dev)
    s1 = torch.einsum("bhgd,bshd->bhgs", q_rot[..., :ATT_D1],
                      k_rot[..., :ATT_D1].float())
    idx = _top_c(torch.where(valid, s1, -torch.inf), ATT_CAP)
    s = torch.einsum("bhgd,bshd->bhgs", q.float().reshape(B, Hkv, G, hd),
                     k.float()) / np.sqrt(hd)
    p = torch.softmax(torch.where(valid, s, -torch.inf), dim=-1)
    kept = float(torch.gather(p, -1, idx).sum(-1).mean())
    del s1, s, p
    # the library yardstick: one SDPA call, GQA, the ragged lengths as a
    # mask; it computes nothing on the port's path
    qs = q[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)      # (B, Hkv, S, hd)
    mask = valid.reshape(B, 1, 1, S)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    sdpa_err = float((sdpa()[:, :, 0].float() - ex.float()).abs().max())
    walls = {"dco_decode_attention_ms": event_ms(screened),
             "exact_decode_attention_ms": event_ms(exact),
             "sdpa_ms": event_ms(sdpa)}
    # keys and values read per step, by formula (bf16): the screen reads
    # S * d1 + C * hd of K and C * hd of V a KV head, exact S * hd of each
    heads = B * Hkv
    reads = {"screened_bytes": 2 * heads * (S * ATT_D1 + 2 * ATT_CAP * hd),
             "exact_bytes": 2 * heads * 2 * S * hd}
    exact_flops = 2 * 2 * B * H * S * hd
    bound = {"exact_bound_ms": max(reads["exact_bytes"] / HBM_BYTES_PER_S,
                                   exact_flops / BF16_FLOP_PER_S) * 1e3,
             "screened_bound_ms": reads["screened_bytes"]
             / HBM_BYTES_PER_S * 1e3}
    # what one screened call runs on the card (is K copied whole?)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        screened()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted(((e.key[:70], getattr(e, "self_device_time_total", 0)
                   / 1e3, e.count) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == cuda),
                 key=lambda t: -t[1])
    rec = {"shape": {"B": B, "S": S, "Hkv": Hkv, "H": H, "hd": hd,
                     "d1": ATT_D1, "cap": ATT_CAP, "cur_len": cur.tolist(),
                     "dtype": "bfloat16"},
           "cap_S_max_abs_err_vs_exact": full_err,
           "card_vs_cpu_max_abs_err": cpu_err,
           "max_abs_err_vs_exact": err, "sdpa_max_abs_err_vs_exact": sdpa_err,
           "kept_softmax_mass_mean": kept, **walls, **reads, **bound,
           "screen_beats_exact": walls["dco_decode_attention_ms"]
           < walls["exact_decode_attention_ms"],
           "profile_top_ops_ms": [[n, t, c] for n, t, c in ops[:10]],
           "phase_s": time.perf_counter() - t_phase}
    log("attention", **rec)
    return rec


# -------------------------------------------------------------------- lm ---
LM_ARCH = "qwen3-4b"
LM_SEED = 20
#: the engine arm (every LM phase's: 16 requests, 32 before the train
#: phase came; cut for the run's time limit) and the long-cache arm
#: (Qwen3-4B's decode_32k shape, SHAPES in configs/base.py, cut from
#: batch 128 to 8 to fit one card); the CPU rehearsal runs the same code
#: at the smoke config and toy sizes
LM_SIZES = {
    "card": dict(slots=8, max_len=1024, requests=16, max_new=64,
                 prompt=(16, 128), long_b=8, long_len=32_768,
                 long_min=30_000, long_steps=5),
    "cpu": dict(slots=4, max_len=64, requests=6, max_new=8, prompt=(4, 16),
                long_b=2, long_len=256, long_min=200, long_steps=2),
}
LM_CHECK_B, LM_CHECK_S = 2, 24   # decode against prefill at full width
LM_SMOKE_STEPS = 12              # the card against the CPU
LM_PAST_STEPS = 6                # ... and past the cache (C8)
#: the reference's own prefill-against-decode tolerance
#: (tests/test_models.py), loose; the measured gap is logged beside it
LM_RTOL, LM_ATOL = 0.15, 0.2
#: tests/test_torch_models.py's tolerance (port against reference on the
#: CPU), relative to max |logits| or max |K|
LM_TOL = 4e-2
LM_PROFILE_STEPS = 3


def rel_gap(ref, got) -> float:
    """max |got - ref| over max |ref|, both widened to f32 on the host
    (max |got| where ``ref`` is all zero, as the engine's cross K/V are)."""
    ref, got = ref.float().cpu(), got.float().cpu()
    top = ref.abs().max()
    return float((got - ref).abs().max() / top if top else got.abs().max())


def device_profile(prof, steps: int) -> dict:
    """Per step: device kernels (apart from copies and fills), copies and
    fills, CUDA runtime launch calls, device ms; the top 5 device ops."""
    device, host = device_events(prof)
    kernels = memops = 0
    dev_us = 0.0
    top = []
    for name, (count, us) in device.items():
        dev_us += us
        if name.startswith(("Memcpy", "Memset")):
            memops += count
        else:
            kernels += count
        top.append((us, count, name[:70]))
    runtime = sum(c for name, c in host.items() if name.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")))
    top.sort(reverse=True)
    return {"device_kernels_per_step": kernels / steps,
            "device_copies_fills_per_step": memops / steps,
            "runtime_launch_calls_per_step": runtime / steps,
            "device_ms_per_step": dev_us / 1e3 / steps,
            "top_device_ops": [{"name": n, "count": c, "ms": us / 1e3}
                               for us, c, n in top[:5]]}


@contextlib.contextmanager
def f32_accumulation():
    """bf16 GEMMs accumulate in f32, as the reference's dots do; the
    setting is restored after."""
    import torch
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


def fill_long_cache(cfg, size, dev):
    """The long-cache arm's (L, B, S, Hkv, hd) bf16 K and V, seeded
    normal contents drawn on the card a layer at a time."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    shape = (cfg.n_layers, size["long_b"], size["long_len"],
             cfg.n_kv_heads, cfg.hd)
    cache = {key: torch.empty(shape, dtype=torch.bfloat16, device=dev)
             for key in ("k", "v")}
    for key in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[key][layer].copy_(torch.randn(shape[1:], generator=gen,
                                                device=dev))
    return cache


def cache_leaves(cache) -> dict:
    """A cache's tensors by name: ``k``/``v``, ``self.k`` ... ``cross.v``
    (encoder-decoder), the SSM's ``h``/``conv``, the MoE's ``dense.c_kv``
    ... ``moe.k_rope`` or the hybrid's ``kv.k`` ... ``ssm.conv``."""
    if isinstance(cache, tuple):
        return {"h": cache[0], "conv": cache[1]}
    out = {}
    for key, v in cache.items():
        if isinstance(v, tuple):
            v = {"h": v[0], "conv": v[1]}
        if isinstance(v, dict):
            out.update({f"{key}.{k}": x for k, x in v.items()})
        elif key != "len":
            out[key] = v
    return out


def on_device(dev, params, cache) -> bool:
    """(e): every parameter, buffer and cache tensor on ``dev``'s kind."""
    import torch
    kind = torch.device(dev).type
    tensors = (list(params.parameters()) + list(params.buffers())
               + list(cache_leaves(cache).values()))
    return all(t.device.type == kind for t in tensors)


def prefill_batch(cfg, rng, tokens, src_len):
    """The prefill batch of ``cfg``'s family: the tokens, and for the
    encoder-decoder ``src_len`` seeded source frames (B, src_len, d)."""
    import numpy as np
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (tokens.shape[0], src_len, cfg.d_model)).astype(np.float32)
    return batch


def card_against_cpu(arch, seed, rng, dev) -> dict:
    """(c): ``arch``'s smoke config on the card against the same weights
    on the CPU: prefill over LM_SMOKE_STEPS tokens (the logits and every
    cache tensor), then LM_SMOKE_STEPS decode steps at per-slot lengths
    from the zero cache (the logits every step, the caches after), then
    LM_PAST_STEPS steps with ``past_cache="drop"`` at lengths past the
    cache (ROADMAP C8: the logits every step, the caches after), each
    within LM_TOL of the CPU's largest magnitude.  A MoE's card pass takes
    the experts the CPU's chose (``repro_torch.testing.routing``: a
    one-ulp gap at a near-tied expert flips the choice, and every later
    value of the token with it); the tokens whose own choice differed
    are counted."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.testing.routing import routing

    scfg = smoke_config(arch)
    cpu_api = build_model(scfg, device="cpu")
    cpu_params = cpu_api.init(torch.Generator().manual_seed(seed))
    s_api = build_model(scfg, device=dev)
    s_params = copy.deepcopy(cpu_params).to(dev)
    stoks = rng.integers(0, scfg.vocab, (2, LM_SMOKE_STEPS)).astype(np.int32)
    batch = prefill_batch(scfg, rng, stoks, 10)
    moved = 0

    def both(cpu_call, card_call):
        nonlocal moved
        with routing() as rec:
            want = cpu_call()
        with routing(rec["calls"]) as rec:
            got = card_call()
        moved += rec["moved"]
        return want, got

    (want, c_cache), (got, s_cache) = both(
        lambda: cpu_api.prefill(cpu_params, batch),
        lambda: s_api.prefill(s_params, batch))
    gaps = {"prefill_rel_logit_gap": rel_gap(want, got)}
    for key, w in cache_leaves(c_cache).items():
        gaps[f"prefill_{key}_rel_gap"] = rel_gap(w, cache_leaves(s_cache)[key])
    smax = LM_SMOKE_STEPS + 4
    c_cache = cpu_api.init_cache(2, smax)
    s_cache = s_api.init_cache(2, smax)
    smoke_gap = 0.0
    for t in range(LM_SMOKE_STEPS):
        lens = np.array([t + 1, max(t - 2, 1)], np.int32)
        (want, c_cache), (got, s_cache) = both(
            lambda: cpu_api.decode_step(cpu_params, c_cache, stoks[:, t],
                                        lens),
            lambda: s_api.decode_step(s_params, s_cache, stoks[:, t], lens))
        smoke_gap = max(smoke_gap, rel_gap(want, got))
    gaps["max_rel_logit_gap"] = smoke_gap
    for key, w in cache_leaves(c_cache).items():
        gaps[f"{key}_rel_gap"] = rel_gap(w, cache_leaves(s_cache)[key])
    # C8: the engine's past_cache="drop" steps, slot 0 past the cache
    # throughout and slot 1 crossing its end (the guarded write on both)
    past_gap = 0.0
    for j in range(LM_PAST_STEPS):
        lens = np.array([smax + 1 + j, smax - 2 + j], np.int32)
        tok = stoks[:, j % LM_SMOKE_STEPS]
        (want, c_cache), (got, s_cache) = both(
            lambda: cpu_api.decode_step(cpu_params, c_cache, tok, lens,
                                        past_cache="drop"),
            lambda: s_api.decode_step(s_params, s_cache, tok, lens,
                                      past_cache="drop"))
        past_gap = max(past_gap, rel_gap(want, got))
    gaps["past_cache_max_rel_logit_gap"] = past_gap
    for key, w in cache_leaves(c_cache).items():
        gaps[f"past_cache_{key}_rel_gap"] = rel_gap(
            w, cache_leaves(s_cache)[key])
    check(max(gaps.values()) < LM_TOL,
          f"{arch}: the card differs from the CPU at the smoke config {gaps}")
    return {"steps": LM_SMOKE_STEPS, "past_cache_steps": LM_PAST_STEPS,
            "tol": LM_TOL, "routings_differing_from_the_cpu": moved, **gaps}


def engine_arm(api, params, cfg, size, rng, label, dev) -> dict:
    """The engine arm: ``size["requests"]`` seeded requests of
    ``size["prompt"]`` tokens and ``size["max_new"]`` new ones through
    ``ServingEngine(slots, max_len)``; each decode call between CUDA events
    (its device span) and on the host clock (call to call: the step with
    the logits' copy and the argmax).  (d): every request served, each
    stopping by the reference's rule."""
    import numpy as np
    import torch
    from repro_torch.serving import Request, ServingEngine

    card = on_card(dev)
    reqs = [Request(i, rng.integers(0, cfg.vocab,
                                    int(rng.integers(size["prompt"][0],
                                                     size["prompt"][1] + 1))
                                    ).astype(np.int32), size["max_new"])
            for i in range(size["requests"])]
    eng = ServingEngine(api, slots=size["slots"], max_len=size["max_len"])
    inner, events, starts, issues = eng.decode, [], [], []

    def timed(*args, **kw):
        starts.append(time.perf_counter())
        if card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = inner(*args, **kw)
        issues.append(time.perf_counter() - starts[-1])
        if card:
            ev[1].record()
            events.append(ev)
        return out

    eng.decode = timed
    t0 = time.perf_counter()
    out = eng.run(params, reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    check(sorted(out) == list(range(size["requests"])),
          f"{label}: the engine did not serve every request")
    for r in reqs:       # (d) the reference's stopping rule
        check(len(out[r.rid]) == r.max_new
              or len(r.prompt) + len(out[r.rid]) >= size["max_len"] - 1,
              f"{label}: request {r.rid} stopped early ({len(out[r.rid])})")
    generated = sum(len(v) for v in out.values())
    host_ms = np.diff(starts) * 1e3
    step_ms = (np.array([a.elapsed_time(b) for a, b in events]) if card
               else host_ms)
    return {
        "slots": size["slots"], "max_len": size["max_len"],
        "requests": size["requests"], "served": len(out),
        "max_new": size["max_new"], "prompt_tokens": int(
            sum(len(r.prompt) for r in reqs)),
        "generated_tokens": generated, "engine_wall_s": wall,
        "generated_tokens_per_s": generated / wall,
        "decode_steps": len(starts),
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.quantile(step_ms, 0.9)),
        "host_step_ms_median": float(np.median(host_ms)),
        "host_step_ms_p90": float(np.quantile(host_ms, 0.9)),
        "host_issue_ms_median": float(np.median(issues) * 1e3),
    }


def step_bounds(weight_bytes, state_bytes, n_params, slots) -> dict:
    """A decode step's bytes by formula (the weights it reads, once, and
    its cache or state) and its bounds: the bytes at the data sheet's
    3.35 TB/s, and 2 flops a weight a slot at its dense bf16 rate."""
    step_bytes = weight_bytes + state_bytes
    return {"step_weight_bytes": weight_bytes, "kv_cache_bytes": state_bytes,
            "step_bytes": step_bytes,
            "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "step_flop_bound_ms": 2 * n_params * slots
            / BF16_FLOP_PER_S * 1e3}


def phase_lm(dev):
    """The LM serving path at Qwen3-4B's published widths and depth with
    random bf16 weights from a seed: decode against the full forward pass,
    the card against the CPU at the smoke config, the continuous-batching
    engine over 16 requests, and decode steps over a 32,768-position
    cache.  It runs before any CUDA graph or profiler session of the
    process, which slow every later eager launch; its profiled steps are
    phase_lm_profile's, at the end."""
    t_phase = time.perf_counter()
    card = on_card(dev)
    with f32_accumulation():
        return _phase_lm(dev, t_phase, card,
                         LM_SIZES["card" if card else "cpu"])


def _phase_lm(dev, t_phase, card, size):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model

    reduced = torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction
    cfg = get_arch(LM_ARCH) if card else smoke_config(LM_ARCH)
    api = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(LM_SEED))
    sync(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    tensors = list(params.parameters()) + list(params.buffers())
    check(all(t.device.type == dev.type for t in tensors),
          "lm: a model tensor is not on the card")

    # (a), (b): decode token by token against the full forward pass over
    # every prefix of the same 24 tokens
    split_s = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(LM_SEED)
    toks = rng.integers(0, cfg.vocab, (LM_CHECK_B, LM_CHECK_S)
                        ).astype(np.int32)
    cache = api.init_cache(LM_CHECK_B, LM_CHECK_S)
    gaps, rows, agree, clear, clear_agree, tight, tight_agree = \
        [], 0, 0, 0, 0, 0, 0
    for t in range(LM_CHECK_S):
        dec, cache = api.decode_step(params, cache, toks[:, t], t + 1)
        pre, pre_cache = api.prefill(params, {"tokens": toks[:, :t + 1]})
        gaps.append(rel_gap(pre, dec))
        check(torch.allclose(dec, pre, rtol=LM_RTOL, atol=LM_ATOL),
              f"lm: decode differs from prefill at step {t} "
              f"(max |d| {float((dec - pre).abs().max())})")
        top2 = pre[:, :cfg.vocab].topk(2, -1).values
        margin = top2[:, 0] - top2[:, 1]
        same = pre[:, :cfg.vocab].argmax(-1) == dec[:, :cfg.vocab].argmax(-1)
        ok = margin > LM_ATOL + LM_RTOL * top2[:, 0].abs()
        check(bool(same[ok].all()), f"lm: greedy ids differ at step {t} "
              "where prefill's top-2 margin exceeds the tolerance")
        rows += int(same.numel())
        agree += int(same.sum())
        clear += int(ok.sum())
        clear_agree += int(same[ok].sum())
        # reported only: rows clear at the CPU tests' tolerance
        ok = margin > LM_TOL * pre.abs().amax(-1)
        tight += int(ok.sum())
        tight_agree += int(same[ok].sum())
    kv_gap = {}
    for key in ("k", "v"):
        check(torch.allclose(cache[key].float(), pre_cache[key].float(),
                             rtol=LM_RTOL, atol=LM_ATOL),
              f"lm: the decoded {key} cache differs from prefill's")
        kv_gap[key] = rel_gap(pre_cache[key], cache[key])
    check_a = {"steps": LM_CHECK_S, "batch": LM_CHECK_B,
               "rtol": LM_RTOL, "atol": LM_ATOL,
               "max_rel_logit_gap": max(gaps), "tests_tol": LM_TOL,
               "within_tests_tol": max(gaps) < LM_TOL,
               "k_rel_gap": kv_gap["k"], "v_rel_gap": kv_gap["v"],
               "argmax_rows": rows, "argmax_agree": agree,
               "clear_margin_rows": clear, "clear_margin_agree": clear_agree,
               "tests_tol_margin_rows": tight,
               "tests_tol_margin_agree": tight_agree}
    del cache, pre_cache
    split_s["check_a_b"] = time.perf_counter() - t0

    # (c): the smoke config on the card against the same weights on the
    # CPU, per-slot lengths, the logits every step and the caches after
    t0 = time.perf_counter()
    check_c = card_against_cpu(LM_ARCH, LM_SEED, rng, dev)
    split_s["check_c"] = time.perf_counter() - t0

    # the engine arm: 16 seeded requests through 8 slots
    engine = engine_arm(api, params, cfg, size, rng, "lm", dev)
    cache_bytes = 2 * (cfg.n_layers * size["slots"] * size["max_len"]
                       * cfg.n_kv_heads * cfg.hd * 2)
    n_params = sum(p.numel() for p in params.parameters())
    engine.update(step_bounds(weight_bytes, cache_bytes, n_params,
                              size["slots"]))
    roofline = roofline_step(api, params, cfg, size, engine)

    # the long-cache arm: decode steps over a 32,768-position cache at
    # batch 8 holding seeded contents, lengths in [30,000, 32,768]
    t0 = time.perf_counter()
    B, S = size["long_b"], size["long_len"]
    cache = fill_long_cache(cfg, size, dev)
    long_cache_bytes = sum(t.numel() * t.element_size()
                           for t in cache.values())
    sync(dev)
    split_s["long_fill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cur = rng.integers(size["long_min"], S - size["long_steps"],
                       B).astype(np.int32)
    long_ms, long_host_ms, finite = [], [], True
    for i in range(size["long_steps"] + 1):       # the first warms up
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
        if card:
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
        t_step = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tok, cur + i)
        issued = time.perf_counter() - t_step
        if card:
            b.record()
            b.synchronize()
        if i:
            long_host_ms.append([issued * 1e3,
                                 (time.perf_counter() - t_step) * 1e3])
            long_ms.append(a.elapsed_time(b) if card
                           else long_host_ms[-1][1])
        finite &= bool(torch.isfinite(logits).all())
    check(finite, "lm: non-finite logits over the long cache")
    check(all(t.device.type == dev.type for t in cache.values()),
          "lm: the long KV cache is not on the card")
    long_bytes = weight_bytes + long_cache_bytes
    long = {"batch": B, "max_len": S,
            "cur_len_first": cur.tolist(), "steps": size["long_steps"],
            "step_ms": long_ms, "step_ms_median": float(np.median(long_ms)),
            "host_issue_and_wall_ms": long_host_ms,
            "kv_cache_bytes": long_cache_bytes, "step_bytes": long_bytes,
            "step_bound_ms": long_bytes / HBM_BYTES_PER_S * 1e3,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if card else 0)}
    del cache, logits
    free_card(dev)
    split_s["long"] = time.perf_counter() - t0
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": n_params,
           "weight_bytes": weight_bytes,
           "bf16_reduced_precision_reduction": reduced,
           "init_s": init_s, "check_decode_vs_prefill": check_a,
           "check_card_vs_cpu": check_c,
           "engine": engine, "roofline": roofline, "long_cache": long,
           "split_s": split_s, "phase_s": time.perf_counter() - t_phase}
    log("lm", **rec)
    return rec


def roofline_step(api, params, cfg, size, engine) -> dict:
    """A10 on the card: one engine-shaped decode step (``slots`` slots,
    ``max_len`` positions, per-slot lengths) counted op by op by
    ``launch.hlo_cost``.  The products with a weight operand count 2
    flops a weight they read a slot (``active_params``, less the
    embedding when the head is untied: a gather is not a product); the
    attention products apart, against 4 L H hd Smax B, whose factor is
    the code's own (on the card ``grouped_scores_bmm`` and
    ``grouped_mix_bmm`` compute every KV head's block); the counted bytes
    beside the step's bytes bound.  Its own seed, so the phase's later
    draws are those of earlier runs."""
    import numpy as np
    from repro_torch.launch import hlo_cost as HC
    from repro_torch.launch import roofline as RL
    t0 = time.perf_counter()
    rng = np.random.default_rng(LM_SEED + 3)
    B, S = size["slots"], size["max_len"]
    cache = api.init_cache(B, S)
    tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
    cur = rng.integers(1, S + 1, B).astype(np.int32)
    with HC.CostCounter(weights=list(params.parameters())) as c:
        api.decode_step(params, cache, tok, cur, past_cache="drop")
    tot = c.totals()
    read = RL.active_params(cfg) - (0 if cfg.tie_embeddings
                                    else cfg.vocab_padded * cfg.d_model)
    weight_formula = 2.0 * B * read
    attention = tot["matmul_flops"] - tot["weight_matmul_flops"]
    attention_formula = 4.0 * cfg.n_layers * cfg.n_heads * cfg.hd * S * B
    rec = {"slots": B, "max_len": S, "flops": tot["flops"],
           "matmul_flops": tot["matmul_flops"],
           "weight_matmul_flops": tot["weight_matmul_flops"],
           "weight_formula": weight_formula,
           "weight_gap": abs(tot["weight_matmul_flops"] - weight_formula)
           / weight_formula,
           "attention_flops": attention,
           "attention_formula": attention_formula,
           "attention_factor": attention / attention_formula,
           "bytes": tot["bytes"], "bytes_upper": tot["bytes_upper"],
           "terms_s": RL.terms(tot),
           "step_bytes_by_formula": engine["step_bytes"],
           "step_bound_ms": engine["step_bound_ms"],
           "counted_bytes_ms": tot["bytes"] / HBM_BYTES_PER_S * 1e3,
           "ops": sum(o["n"] for o in c.table()["ops"].values()),
           "count_s": time.perf_counter() - t0}
    log("roofline", **rec)
    check(rec["weight_gap"] <= 0.01,
          f"roofline: the weight GEMMs count {tot['weight_matmul_flops']} "
          f"flops against 2 x {B} x {read} parameters ({weight_formula})")
    return rec


# ------------------------------------------------------- encdec, ssm ---
ENCDEC_ARCH, ENCDEC_SEED = "seamless-m4t-large-v2", 21
SSM_ARCH, SSM_SEED = "mamba2-130m", 22
#: check (a)'s source frames (the encoder's input) on the card and the CPU
ENCDEC_SRC = {"card": 256, "cpu": 16}
#: the cross K/V positions the engine decodes against: init_cache's
#: enc_len, 1,024 zero positions as in the reference's engine
ENC_LEN = 1024
#: check (d)'s cache on the card: prompts of C8_MAX_LEN - 1, C8_MAX_LEN and
#: C8_MAX_LEN + 4 tokens (ROADMAP C8)
C8_MAX_LEN = 16
#: the SSD check at the full config's widths, and the prefill arm
#: (SHAPES["prefill_32k"]: 32,768 tokens, cut from batch 32 to 4, where
#: one (B, nc, Q, Q, H) f32 decay tensor holds 3.2 GB instead of 26 GB)
SSD_CHECK = {"card": dict(B=2, S=1024), "cpu": dict(B=2, S=64)}
SSM_PREFILL = {"card": dict(B=4, S=32_768), "cpu": dict(B=2, S=128)}
SSD_TOL = 1e-4                   # tests/test_torch_mamba2.py's SSD_TOL
SSM_PROMPT = 8                   # check (a): prefill, then LM_CHECK_S steps


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params)


def phase_encdec(dev):
    """The encoder-decoder serving path at seamless-m4t-large-v2's
    published widths and depth (24 + 24 layers) with random bf16 weights
    from a seed: (a) prefill over 256 seeded source frames at B 2, then
    decode from its cross K/V against the full forward pass over every
    prefix of 24 tokens; (c) the smoke config on the card against the CPU;
    (d) prompts past an engine's cache (ROADMAP C8) and the stopping rule
    of the engine arm; (e) every tensor on the card; the engine arm (the
    lm phase's traffic) with its bytes a step and bound."""
    t_phase = time.perf_counter()
    card = on_card(dev)
    with f32_accumulation():
        return _phase_encdec(dev, t_phase, card,
                             LM_SIZES["card" if card else "cpu"])


def _phase_encdec(dev, t_phase, card, size):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model

    cfg = get_arch(ENCDEC_ARCH) if card else smoke_config(ENCDEC_ARCH)
    api = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(ENCDEC_SEED))
    sync(dev)
    split_s = {"init": time.perf_counter() - t0}
    rng = np.random.default_rng(ENCDEC_SEED)

    # (a): decode from the prefill's cross K/V against the full forward
    # pass (encoder included) over every prefix of the same 24 tokens
    t0 = time.perf_counter()
    toks = rng.integers(0, cfg.vocab, (LM_CHECK_B, LM_CHECK_S)
                        ).astype(np.int32)
    batch = prefill_batch(cfg, rng, toks[:, :1],
                          ENCDEC_SRC["card" if card else "cpu"])
    _, pre_cache = api.prefill(params, batch)
    cache = {"self": api.init_cache(LM_CHECK_B, LM_CHECK_S,
                                    enc_len=0)["self"],
             "cross": pre_cache["cross"]}
    gaps = []
    for t in range(LM_CHECK_S):
        dec, cache = api.decode_step(params, cache, toks[:, t], t + 1)
        pre, pre_cache = api.prefill(params, dict(batch,
                                                  tokens=toks[:, :t + 1]))
        gaps.append(rel_gap(pre, dec))
        check(gaps[-1] < LM_TOL, f"encdec: decode differs from prefill at "
              f"step {t} ({gaps[-1]} of max |logits|)")
    kv_gap = {key: rel_gap(w, cache_leaves(cache)[key])
              for key, w in cache_leaves(pre_cache).items()}
    check(max(kv_gap.values()) < LM_TOL,
          f"encdec: the decoded caches differ from prefill's {kv_gap}")
    check(on_device(dev, params, cache),
          "encdec: a model or cache tensor is not on the card")
    check_a = {"steps": LM_CHECK_S, "batch": LM_CHECK_B,
               "src_frames": batch["src_embeds"].shape[1], "tol": LM_TOL,
               "max_rel_logit_gap": max(gaps), "rel_logit_gaps": gaps,
               **{f"{k}_rel_gap": v for k, v in kv_gap.items()}}
    del cache, pre_cache, pre, dec
    split_s["check_a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_c = card_against_cpu(ENCDEC_ARCH, ENCDEC_SEED, rng, dev)
    split_s["check_c"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_d = past_the_cache(api, params, cfg, rng, "encdec")
    split_s["check_d"] = time.perf_counter() - t0

    engine = engine_arm(api, params, cfg, size, rng, "encdec", dev)
    # a step reads the decoder and the head (not the encoder) and the
    # self and cross K/V
    dec_params = list(params.dec.parameters()) + [params.lm_head,
                                                  params.final_norm]

    def kv_bytes(n):
        return 2 * cfg.n_layers * size["slots"] * n * cfg.n_kv_heads \
            * cfg.hd * 2

    engine.update(step_bounds(param_bytes(dec_params),
                              kv_bytes(size["max_len"]) + kv_bytes(ENC_LEN),
                              sum(p.numel() for p in dec_params),
                              size["slots"]),
                  self_kv_bytes=kv_bytes(size["max_len"]),
                  cross_kv_bytes=kv_bytes(ENC_LEN))
    split_s["engine"] = engine["engine_wall_s"]
    rec = {"arch": cfg.name, "enc_layers": cfg.enc_layers,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_params": sum(p.numel() for p in params.parameters()),
           "weight_bytes": param_bytes(params.parameters()),
           "check_decode_vs_prefill": check_a, "check_card_vs_cpu": check_c,
           "check_past_the_cache": check_d, "engine": engine,
           "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if card else 0),
           "split_s": split_s, "phase_s": time.perf_counter() - t_phase}
    del params
    free_card(dev)
    log("encdec", **rec)
    return rec


def phase_ssm(dev):
    """The state-space serving path at mamba2-130m's published widths and
    depth (24 layers) with random weights from a seed: (a) the chunked
    SSD against the naive scan at full widths (B 2, S 1,024, a random
    initial state, f32), then prefill and decode from its states against
    the full forward pass over every prefix; (c) the smoke config on the
    card against the CPU; (d) the engine's state carried from one request
    to the next in a slot (ROADMAP C10) equal to the CPU engine's ids, and
    the engine arm's stopping rule; (e) every tensor on the card; the
    engine arm (the lm phase's traffic) with its bytes a step and bound;
    the prefill arm at 32,768 tokens and batch 4, its time and peak
    memory."""
    t_phase = time.perf_counter()
    card = on_card(dev)
    with f32_accumulation():
        return _phase_ssm(dev, t_phase, card,
                          LM_SIZES["card" if card else "cpu"])


def carried_state(arch, seed, rng, dev) -> dict:
    """(d) against the CPU at ``arch``'s smoke config, on the card and on
    the CPU, a MoE's card steps taking the experts the CPU's chose: ROADMAP
    C10, two requests through one slot, the second running on the first's
    state (the card's ids equal the CPU's; the second request served alone
    is reported beside them); and for a model with attention, ROADMAP C8,
    prompts of C8_MAX_LEN - 1, C8_MAX_LEN and C8_MAX_LEN + 4 tokens
    through 3 slots of a C8_MAX_LEN-position cache (the same ids)."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.testing.routing import routing

    scfg = smoke_config(arch)
    cpu_api = build_model(scfg, device="cpu")
    cpu_params = cpu_api.init(torch.Generator().manual_seed(seed))
    s_api = build_model(scfg, device=dev)
    s_params = copy.deepcopy(cpu_params).to(dev)
    out = {"routings_differing_from_the_cpu": 0}

    def serve(a, p, ps, slots, max_len):
        return ServingEngine(a, slots=slots, max_len=max_len).run(
            p, [Request(i, q, 4) for i, q in enumerate(ps)])

    def both(ps, slots, max_len):
        with routing() as rec:
            want = serve(cpu_api, cpu_params, ps, slots, max_len)
        with routing(rec["calls"]) as rec:
            got = serve(s_api, s_params, ps, slots, max_len)
        out["routings_differing_from_the_cpu"] += rec["moved"]
        check(got == want, f"{arch}: the card engine's ids {got} differ "
              f"from the CPU's {want}")
        return got

    prompts = [rng.integers(0, scfg.vocab, int(rng.integers(4, 9)))
               for _ in range(2)]
    got = both(prompts, 1, 32)
    alone = serve(s_api, s_params, prompts[1:], 1, 32)
    out.update(ids=[got[0], got[1]], second_alone=alone[0],
               carried_state_changed_ids=alone[0] != got[1])
    if scfg.family != "ssm":
        prompts = [rng.integers(0, scfg.vocab, C8_MAX_LEN + extra).astype(
            np.int32) for extra in (-1, 0, 4)]
        got = both(prompts, 3, C8_MAX_LEN)
        out["past_the_cache_ids"] = [got[i] for i in range(3)]
    return out


def _phase_ssm(dev, t_phase, card, size):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import mamba2 as M

    where = "card" if card else "cpu"
    cfg = get_arch(SSM_ARCH) if card else smoke_config(SSM_ARCH)
    api = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SSM_SEED)
    params = api.init(gen)
    sync(dev)
    split_s = {"init": time.perf_counter() - t0}
    rng = np.random.default_rng(SSM_SEED)

    # (a): the chunked SSD against the naive scan at the config's widths
    t0 = time.perf_counter()
    sc = cfg.ssm
    H = sc.expand * cfg.d_model // sc.head_dim
    B, S = SSD_CHECK[where]["B"], SSD_CHECK[where]["S"]
    x = torch.randn((B, S, H, sc.head_dim), generator=gen, device=dev)
    dt = torch.rand((B, S, H), generator=gen, device=dev) * 0.19 + 0.01
    Bm, Cm = (torch.randn((B, S, sc.d_state), generator=gen, device=dev)
              for _ in range(2))
    h0 = torch.randn((B, H, sc.head_dim, sc.d_state), generator=gen,
                     device=dev)
    A = params.layers[0].mixer.A_log
    y_c, h_c = M.ssd_chunked(x, dt, A, Bm, Cm, chunk=sc.chunk, init_state=h0)
    y_n, h_n = M.ssd_naive(x, dt, A, Bm, Cm, init_state=h0)
    ssd = {"batch": B, "seq": S, "chunk": sc.chunk, "tol": SSD_TOL,
           "y_rel_gap": rel_gap(y_n, y_c), "state_rel_gap": rel_gap(h_n, h_c)}
    check(ssd["y_rel_gap"] < SSD_TOL and ssd["state_rel_gap"] < SSD_TOL,
          f"ssm: the chunked SSD differs from the naive scan {ssd}")
    del x, dt, Bm, Cm, h0, y_c, h_c, y_n, h_n
    split_s["check_ssd"] = time.perf_counter() - t0

    # (a): prefill over SSM_PROMPT tokens, then decode from its states
    # against the full forward pass over every prefix
    t0 = time.perf_counter()
    toks = rng.integers(0, cfg.vocab, (LM_CHECK_B, SSM_PROMPT + LM_CHECK_S)
                        ).astype(np.int32)
    _, cache = api.prefill(params, {"tokens": toks[:, :SSM_PROMPT]})
    gaps = []
    for t in range(SSM_PROMPT, SSM_PROMPT + LM_CHECK_S):
        dec, cache = api.decode_step(params, cache, toks[:, t], t + 1)
        pre, pre_cache = api.prefill(params, {"tokens": toks[:, :t + 1]})
        gaps.append(rel_gap(pre, dec))
        check(gaps[-1] < LM_TOL, f"ssm: decode differs from prefill at "
              f"position {t} ({gaps[-1]} of max |logits|)")
    st_gap = {key: rel_gap(w, cache_leaves(cache)[key])
              for key, w in cache_leaves(pre_cache).items()}
    check(max(st_gap.values()) < LM_TOL,
          f"ssm: the decoded states differ from prefill's {st_gap}")
    check(on_device(dev, params, cache),
          "ssm: a model or state tensor is not on the card")
    check_a = {"ssd": ssd, "prompt": SSM_PROMPT, "steps": LM_CHECK_S,
               "batch": LM_CHECK_B, "tol": LM_TOL,
               "max_rel_logit_gap": max(gaps),
               **{f"{k}_rel_gap": v for k, v in st_gap.items()}}
    del cache, pre_cache, pre, dec
    split_s["check_a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check_c = card_against_cpu(SSM_ARCH, SSM_SEED, rng, dev)
    split_s["check_c"] = time.perf_counter() - t0

    # (d): two requests through one slot of the smoke engine, on the card
    # and the CPU: the second runs on the first's state (ROADMAP C10)
    t0 = time.perf_counter()
    check_d = carried_state(SSM_ARCH, SSM_SEED, rng, dev)
    split_s["check_d"] = time.perf_counter() - t0

    engine = engine_arm(api, params, cfg, size, rng, "ssm", dev)
    # a step reads every weight (the tied embedding is the head) and
    # reads and writes each slot's (h, conv) state
    state = api.init_cache(size["slots"], size["max_len"])
    state_bytes = 2 * param_bytes(state)
    del state
    engine.update(step_bounds(param_bytes(params.parameters()), state_bytes,
                              sum(p.numel() for p in params.parameters()),
                              size["slots"]))
    split_s["engine"] = engine["engine_wall_s"]

    # the prefill arm: CUDA events around each call, the first warms up
    t0 = time.perf_counter()
    B, S = SSM_PREFILL[where]["B"], SSM_PREFILL[where]["S"]
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    free_card(dev)
    before = held_bytes(dev)
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(2):
        if card:
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
        t_call = time.perf_counter()
        logits, states = api.prefill(params, {"tokens": tokens})
        if card:
            b.record()
            b.synchronize()
        walls.append(a.elapsed_time(b) if card
                     else (time.perf_counter() - t_call) * 1e3)
        check(bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(t.float()).all()) for t in states),
            "ssm: non-finite prefill logits or states")
    prefill = {"batch": B, "seq": S, "first_ms": walls[0], "ms": walls[1],
               "tokens_per_s": B * S / walls[1] * 1e3,
               "device_bytes_before": before,
               "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if card else 0)}
    del logits, states, tokens
    free_card(dev)
    split_s["prefill"] = time.perf_counter() - t0
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model,
           "n_params": sum(p.numel() for p in params.parameters()),
           "weight_bytes": param_bytes(params.parameters()),
           "check_decode_vs_prefill": check_a, "check_card_vs_cpu": check_c,
           "check_carried_state": check_d, "engine": engine,
           "prefill": prefill, "split_s": split_s,
           "phase_s": time.perf_counter() - t_phase}
    del params
    free_card(dev)
    log("ssm", **rec)
    return rec


# ------------------------------------------------------ moe, hybrid ---
MOE_ARCH, MOE_SEED = "deepseek-v2-236b", 23
MOE_V3_ARCH, MOE_V3_SEED = "deepseek-v3-671b", 25
HYBRID_ARCH, HYBRID_SEED = "jamba-v0.1-52b", 24
#: the depths one card holds at the published widths: DeepSeek-V2's dense
#: first layer and 5 of its 59 MoE layers (21,247,144,960 parameters,
#: 42.50 GB in bf16), and one of Jamba-v0.1's 4 groups of 8 layers
#: (13,267,598,848 parameters, 26.54 GB); whole, they hold 236 B and 52 B
CUT_LAYERS = {MOE_ARCH: 6, HYBRID_ARCH: 8}
#: check (a) of the routed families at B x S <= 32 tokens, so every prefix
#: takes the MoE's dropless path, as decode does (past 32 tokens the
#: capacity path may drop tokens, which a decode step never does): a
#: prefill over ROUTED_PROMPT tokens, then decode to ROUTED_CHECK_S
ROUTED_CHECK_B, ROUTED_CHECK_S, ROUTED_PROMPT = 1, 32, 8
#: check (a2): one MoE layer's capacity path at A2_TOKENS tokens with a
#: capacity factor of E (no token dropped) against its dropless path over
#: chunks of A2_CHUNK tokens
A2_TOKENS, A2_CHUNK = 256, 32


def lm_config(arch, card):
    """``arch``'s config: on the card its published widths, cut to the
    depth of CUT_LAYERS where the whole model does not fit, else its
    smoke config."""
    from repro_torch.configs import get_arch, smoke_config
    if not card:
        return smoke_config(arch)
    cfg = get_arch(arch)
    return cfg.scaled(n_layers=CUT_LAYERS[arch]) if arch in CUT_LAYERS \
        else cfg


def routed_decode_vs_prefill(api, params, cfg, rng, label, dev) -> dict:
    """(a): prefill over ROUTED_PROMPT tokens, its caches copied into a
    ROUTED_CHECK_S-position cache (positions) and taken whole (SSM
    states), then decode token by token against the full forward pass
    over every prefix: the logits at every step and every cache tensor
    after, within LM_TOL.  Every pass takes the experts the full forward
    pass over all ROUTED_CHECK_S tokens chose for each token and layer
    (``repro_torch.testing.routing``): decode and prefill round apart by
    bf16 ulps, which flip near-tied experts (ROADMAP C11).  The tokens
    whose own choice differed are counted.  Reading the routing syncs,
    so no timed run records it."""
    import numpy as np
    from repro_torch.testing.routing import routing
    B, S, P = ROUTED_CHECK_B, ROUTED_CHECK_S, ROUTED_PROMPT
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    with routing() as full:
        api.prefill(params, {"tokens": toks})
    full = [r.reshape(B, S, -1) for r in full["calls"]]

    def at(positions):
        return [r[:, positions].reshape(-1, r.shape[-1]) for r in full]

    moved = 0
    with routing(at(slice(0, P))) as rec:
        _, pre_cache = api.prefill(params, {"tokens": toks[:, :P]})
    moved += rec["moved"]
    cache = api.init_cache(B, S)
    for key, whole in cache_leaves(cache).items():
        part = cache_leaves(pre_cache)[key]
        (whole if whole.shape == part.shape else whole[:, :, :P]).copy_(part)
    del pre_cache
    gaps = []
    for t in range(P, S):
        with routing(at(slice(t, t + 1))) as rec:
            dec, cache = api.decode_step(params, cache, toks[:, t], t + 1)
        moved += rec["moved"]
        with routing(at(slice(0, t + 1))) as rec:
            pre, pre_cache = api.prefill(params, {"tokens": toks[:, :t + 1]})
        moved += rec["moved"]
        gaps.append(rel_gap(pre, dec))
        check(gaps[-1] < LM_TOL, f"{label}: decode differs from prefill at "
              f"position {t} ({gaps[-1]} of max |logits|)")
    kv_gap = {key: rel_gap(w, cache_leaves(cache)[key])
              for key, w in cache_leaves(pre_cache).items()}
    check(max(kv_gap.values()) < LM_TOL,
          f"{label}: the decoded caches differ from prefill's {kv_gap}")
    check(on_device(dev, params, cache),
          f"{label}: a model or cache tensor is not on the card")
    token_routings = len(full) * B * ((S - P) + sum(range(P, S + 1)))
    return {"batch": B, "prompt": P, "steps": S - P, "tol": LM_TOL,
            "max_rel_logit_gap": max(gaps), "rel_logit_gaps": gaps,
            "token_layer_routings": token_routings,
            "routings_differing_from_the_full_pass": moved,
            **{f"{k}_rel_gap": v for k, v in kv_gap.items()}}


def capacity_vs_dropless(layer, cfg, dev) -> dict:
    """(a2): one MoE layer at its full width over A2_TOKENS seeded tokens
    (unit-RMS bf16 rows, as a norm leaves them) through the capacity path
    with a capacity factor of E, so every expert takes every token and
    none is dropped, against the dropless path over chunks of A2_CHUNK
    tokens; the two round the SwiGLU at other points (f32 against
    bf16)."""
    import dataclasses

    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    mc = cfg.moe
    uncapped = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=float(mc.n_experts)))
    cap = int(A2_TOKENS * mc.top_k / mc.n_experts * mc.n_experts)
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    x = L.rms_norm(torch.randn((1, A2_TOKENS, cfg.d_model), generator=gen,
                               device=dev)).to(torch.bfloat16)
    capacity, _ = MOE.moe_forward(layer, uncapped, x)
    dropless = torch.cat(
        [MOE.moe_forward(layer, uncapped, x[:, i:i + A2_CHUNK])[0]
         for i in range(0, A2_TOKENS, A2_CHUNK)], 1)
    gap = rel_gap(capacity, dropless)
    check(cap >= A2_TOKENS and gap < LM_TOL,
          f"moe: the capacity path without drops differs from the dropless "
          f"path ({gap} of max |out|, capacity {cap})")
    return {"tokens": A2_TOKENS, "chunk": A2_CHUNK, "capacity": cap,
            "tol": LM_TOL, "rel_gap": gap}


def past_the_cache(api, params, cfg, rng, label) -> dict:
    """(d), ROADMAP C8: prompts of C8_MAX_LEN - 1, C8_MAX_LEN and
    C8_MAX_LEN + 4 tokens through an engine: each samples once (its prompt
    fills the cache) and stops."""
    import numpy as np
    from repro_torch.serving import Request, ServingEngine
    prompts = [rng.integers(0, cfg.vocab, C8_MAX_LEN + extra).astype(np.int32)
               for extra in (-1, 0, 4)]
    out = ServingEngine(api, slots=3, max_len=C8_MAX_LEN).run(
        params, [Request(i, p, 4) for i, p in enumerate(prompts)])
    check(sorted(out) == [0, 1, 2] and all(len(v) == 1 for v in out.values()),
          f"{label}: prompts past the cache were not served as the "
          f"reference serves them ({out})")
    return {"max_len": C8_MAX_LEN, "prompt_tokens": [len(p) for p in prompts],
            "generated": [out[i] for i in range(3)]}


def routed_step_bounds(api, params, cfg, size, rng, dev) -> dict:
    """The engine arm's bytes a step and its bounds (``step_bounds``): the
    weights a step reads once (the embedding's rows and V3's unused MTP
    head aside), each MoE layer's experts only those that one recorded
    engine-shaped step (``size["slots"]`` slots, ragged lengths) routes
    its tokens to, and the cache or state (read, and the SSM state
    written).  The flop bound counts the top-k experts a token runs."""
    import numpy as np
    from repro_torch.testing.routing import routing
    B, S = size["slots"], size["max_len"]
    cache = api.init_cache(B, S)
    with routing() as rec:
        api.decode_step(params, cache, rng.integers(0, cfg.vocab, B),
                        rng.integers(1, S - 1, B).astype(np.int32))
    mc = cfg.moe
    per_expert = 3 * cfg.d_model * mc.d_expert
    experts = [m for m in params.modules() if hasattr(m, "router")]
    skip = {id(p) for m in experts for p in (m.wg, m.wu, m.wd)}
    if hasattr(params, "mtp"):
        skip |= {id(p) for p in params.mtp.parameters()}
    if hasattr(params, "lm_head"):
        skip.add(id(params.embed))
    dense = [p for p in params.parameters() if id(p) not in skip]
    touched = [len(np.unique(r.cpu().numpy())) for r in rec["calls"]]
    state = cache_leaves(cache)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    state_bytes += sum(t.numel() * t.element_size()      # SSM states written
                       for k, t in state.items() if k.startswith("ssm."))
    del cache
    out = step_bounds(param_bytes(dense) + sum(touched) * per_expert * 2,
                      state_bytes,
                      sum(p.numel() for p in dense)
                      + len(experts) * mc.top_k * per_expert, B)
    out.update(experts_touched_per_layer=touched,
               experts_per_layer=mc.n_experts,
               step_bytes_all_experts=param_bytes(dense) + len(experts)
               * mc.n_experts * per_expert * 2 + state_bytes)
    return out


def phase_moe(dev):
    """The MoE serving path at DeepSeek-V2's published widths, cut from 60
    to 6 layers (the dense first layer and 5 MoE layers, random bf16
    weights from a seed, made on the card a tensor at a time, the router
    f32): (a) decode from a prefill's latent cache against the full
    forward pass over every prefix of 1 x 32 tokens; (a2) one MoE layer's
    capacity path without drops against its dropless path at 256 tokens;
    (c) the DeepSeek-V2 and V3 smoke configs on the card against the CPU;
    (d) prompts past an engine's cache (ROADMAP C8); (e) every tensor on
    the card; the lm phase's engine arm with its bytes a step and
    bound."""
    t_phase = time.perf_counter()
    card = on_card(dev)
    with f32_accumulation():
        return _phase_routed(dev, t_phase, card, "moe", MOE_ARCH, MOE_SEED)


def phase_hybrid(dev):
    """The hybrid serving path at Jamba-v0.1's published widths, cut from 4
    groups to 1 (8 layers: 7 Mamba-2, 1 attention, MoE on the 4 odd
    ones): (a) decode from a prefill's K/V and SSM states against the
    full forward pass over every prefix of 1 x 32 tokens; (c) the smoke
    config on the card against the CPU; (d) prompts past an engine's
    cache (C8) and the state carried across requests (C10) against the
    CPU engine's ids; (e); the engine arm with its bytes a step and
    bound."""
    t_phase = time.perf_counter()
    card = on_card(dev)
    with f32_accumulation():
        return _phase_routed(dev, t_phase, card, "hybrid", HYBRID_ARCH,
                             HYBRID_SEED)


def _phase_routed(dev, t_phase, card, label, arch, seed):
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    size = LM_SIZES["card" if card else "cpu"]
    cfg = lm_config(arch, card)
    api = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(seed))
    sync(dev)
    split_s = {"init": time.perf_counter() - t0}
    rng = np.random.default_rng(seed)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "published_layers": get_arch(arch).n_layers,
           "d_model": cfg.d_model,
           "n_params": sum(p.numel() for p in params.parameters()),
           "weight_bytes": param_bytes(params.parameters())}

    t0 = time.perf_counter()
    rec["check_decode_vs_prefill"] = routed_decode_vs_prefill(
        api, params, cfg, rng, label, dev)
    split_s["check_a"] = time.perf_counter() - t0
    if label == "moe":
        t0 = time.perf_counter()
        rec["check_capacity_vs_dropless"] = capacity_vs_dropless(
            params.moe_layers[0].moe, cfg, dev)
        free_card(dev)
        split_s["check_a2"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec["check_card_vs_cpu"] = card_against_cpu(arch, seed, rng, dev)
    if label == "moe":
        rec["check_card_vs_cpu_v3"] = card_against_cpu(
            MOE_V3_ARCH, MOE_V3_SEED, rng, dev)
    split_s["check_c"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rec["check_past_the_cache"] = past_the_cache(api, params, cfg, rng, label)
    if label == "hybrid":
        rec["check_carried_state"] = carried_state(arch, seed, rng, dev)
    split_s["check_d"] = time.perf_counter() - t0

    engine = engine_arm(api, params, cfg, size, rng, label, dev)
    engine.update(routed_step_bounds(api, params, cfg, size, rng, dev))
    split_s["engine"] = engine["engine_wall_s"]
    rec.update(engine=engine,
               peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                  if card else 0),
               split_s=split_s, phase_s=time.perf_counter() - t_phase)
    del params
    free_card(dev)
    log(label, **rec)
    return rec


# ---------------------------------------------------------------- train ---
TRAIN_ARCH, TRAIN_SEED = "olmo-1b", 26
SSM_TRAIN_SEED = 27
#: check (a): each family's smoke config, 2 steps on the card against the
#: CPU from one state (V2 and V3: the MoE without and with its MTP head)
TRAIN_SMOKE = (("olmo-1b", 30), ("paligemma-3b", 31),
               ("seamless-m4t-large-v2", 32), ("mamba2-130m", 33),
               ("deepseek-v2-236b", 34), ("deepseek-v3-671b", 35),
               ("jamba-v0.1-52b", 36))
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 16  # 32 tokens: the MoE's dropless path
#: the published train shape (SHAPES["train_4k"]: 4,096 tokens, global
#: batch 256), its batch cut to 8 as 2 microbatches of 4 to fit one card
#: and the run's time; mamba2-130m at 4 x 4,096 in one; the CPU rehearsal
#: runs the smoke configs at toy sizes
TRAIN_SIZES = {
    "card": dict(batch=8, seq=4096, microbatches=2, timed=4, repeat=2,
                 remat_batch=1, ssm_batch=4, ssm_seq=4096),
    "cpu": dict(batch=4, seq=64, microbatches=2, timed=2, repeat=2,
                remat_batch=1, ssm_batch=2, ssm_seq=64),
}
TRAIN_LR = 1e-3                  # the smoke comparisons' constant rate
TRAIN_PEAK_LR = 3e-4             # lr_schedule's peak: check (c)'s rate
#: tests/test_torch_train_step.py's tolerances: the loss relative (the
#: routed families' 4e-2), gnorm relative, the masters after one step where
#: the gradient is clear (above 5e-2 of its leaf's max and 1e-4)
TRAIN_LOSS_TOL = {"dense": 1e-3, "vlm": 1e-3, "encdec": 1e-3, "ssm": 1e-3,
                  "moe": 4e-2, "hybrid": 4e-2}
TRAIN_GNORM_TOL, TRAIN_CLEAR_TOL = 1e-2, 5e-2
#: check (b): remat="block" against "none" on the card, the first moments
#: (0.1 x the clipped grads) within this share of each leaf's max (the
#: card's scatter-adds may sum in another order)
TRAIN_REMAT_TOL = 1e-2
TRAIN_CKPT_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 2, 5


def state_on(state, dev):
    """A TrainState's tensors on ``dev``."""
    import dataclasses
    return dataclasses.replace(
        state, params={k: v.to(dev) for k, v in state.params.items()},
        opt={"m": {k: v.to(dev) for k, v in state.opt["m"].items()},
             "v": {k: v.to(dev) for k, v in state.opt["v"].items()},
             "step": state.opt["step"].to(dev)},
        step=state.step.to(dev))


def train_smoke_against_cpu(arch, seed, dev) -> dict:
    """(a): ``arch``'s smoke config, 2 train steps (remat="block") on the
    card and on the CPU from one state, on the pipeline's batches, the
    CPU's routing imposed on the card (the recompute's calls included)
    and the moves counted: the loss and gnorm of each step within the CPU
    tests' tolerances; after step 1 the masters within 1e-6 where the CPU's
    gradient is clear and within 2 lr + 1e-6 everywhere, after step 2
    within 4 lr + 1e-6."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunShape
    from repro_torch.data import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.testing.routing import routing
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = smoke_config(arch)
    cpu_api = build_model(cfg, device="cpu")
    state = init_state(cpu_api, torch.Generator().manual_seed(seed))
    cpu_step = make_train_step(cpu_api, lr_fn=lambda s: TRAIN_LR)
    card_step = make_train_step(build_model(cfg, device=dev),
                                lr_fn=lambda s: TRAIN_LR)
    batches = make_batch_fn(cfg, RunShape("smoke", TRAIN_SMOKE_S,
                                          TRAIN_SMOKE_B, "train"), seed=seed)
    want, got = state, state_on(state, dev)
    tol = TRAIN_LOSS_TOL[cfg.family]
    out, moved = {"loss": [], "gnorm": []}, 0
    for step in range(2):
        batch = batches(step)
        with routing() as rec:
            want, wm = cpu_step(want, batch)
        with routing(rec["calls"]) as crec:
            got, gm = card_step(got, batch)
        moved += crec["moved"]
        pair = {k: (float(wm[k]), float(gm[k])) for k in ("loss", "gnorm")}
        out["loss"].append(pair["loss"])
        out["gnorm"].append(pair["gnorm"])
        check(abs(pair["loss"][1] - pair["loss"][0])
              <= tol * abs(pair["loss"][0])
              and abs(pair["gnorm"][1] - pair["gnorm"][0])
              <= TRAIN_GNORM_TOL * pair["gnorm"][0],
              f"train {arch}: step {step} on the card differs from the CPU "
              f"{pair}")
        clear_gap, gap = 0.0, 0.0
        for name, w in want.params.items():
            g = got.params[name]
            check(g.device.type == dev.type and g.dtype == torch.float32,
                  f"train {arch}: master {name} is not f32 on the card")
            d = (g.cpu() - w).abs()
            gap = max(gap, float(d.max()))
            m = want.opt["m"][name].abs()
            clear = (m > TRAIN_CLEAR_TOL * m.max()) & (m > 1e-5)
            if step == 0 and bool(clear.any()):
                clear_gap = max(clear_gap, float(d[clear].max()))
        out[f"step{step + 1}_master_gap"] = gap
        if step == 0:
            out["step1_clear_master_gap"] = clear_gap
        check(gap <= 2 * (step + 1) * TRAIN_LR + 1e-6 and clear_gap <= 1e-6,
              f"train {arch}: the card's masters differ from the CPU's "
              f"after step {step + 1} ({gap}, {clear_gap})")
    return dict(out, routings_differing_from_the_cpu=moved,
                loss_tol=tol)


def train_flops(cfg, n_params, batch, seq) -> float:
    """A step's flops by formula: 6 N a token for the weight GEMMs, and
    attention's 12 L d S a token (QK^T and PV forward and backward over
    the whole S x S score matrix, as the port computes it; causal
    skipping would halve it).  Remat's recomputed forward is not
    counted."""
    tokens = batch * seq
    return 6.0 * n_params * tokens + 12.0 * cfg.n_layers * cfg.d_model \
        * seq * tokens


def timed_train_steps(step_fn, state, batches, dev) -> tuple:
    """Each step between CUDA events (the host clock on the CPU), its
    loss read on the host after: (state, losses, step ms)."""
    import torch
    card = on_card(dev)
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        if card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        state, metrics = step_fn(state, batch)
        if card:
            ev[1].record()
        losses.append(float(metrics["loss"]))
        ms.append(ev[0].elapsed_time(ev[1]) if card
                  else (time.perf_counter() - t0) * 1e3)
    return state, losses, ms


def phase_train(dev):
    """The training path (``repro_torch.train``) on the card: (a) every
    family's smoke config, 2 steps against the CPU; (b) OLMo-1B at its
    published widths and depth, remat="block" against "none" on one
    microbatch of 1 x 4,096; (c) OLMo-1B at 8 x 4,096 as 2 microbatches
    of 4 (train_4k cut from batch 256): 1 warm-up and 4 timed steps on the
    pipeline's batches, then 2 more steps on the last of them, whose
    loss must fall (step ms, tokens/s, peak bytes, flops and bound); (d)
    mamba2-130m at full size, 2 steps at 4 x 4,096; (e) the CLI's
    checkpoint/restart driver at the smoke config: a crash at step 5 and
    a resume end bit for bit where an uninterrupted run does.  Eager:
    it runs before any CUDA graph or profiler session of the process;
    its profiled step is lm_profile's."""
    t_phase = time.perf_counter()
    card = on_card(dev)
    with f32_accumulation():
        return _phase_train(dev, t_phase, card,
                            TRAIN_SIZES["card" if card else "cpu"])


def _phase_train(dev, t_phase, card, size):
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_arch, smoke_config
    from repro_torch.configs.base import RunShape
    from repro_torch.data import TokenPipeline, make_batch_fn
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import init_state, make_train_step

    rec, split_s = {}, {}
    t0 = time.perf_counter()
    rec["check_card_vs_cpu"] = {
        arch: train_smoke_against_cpu(arch, seed, dev)
        for arch, seed in TRAIN_SMOKE}
    split_s["check_a"] = time.perf_counter() - t0

    cfg = get_arch(TRAIN_ARCH) if card else smoke_config(TRAIN_ARCH)
    published = SHAPES["train_4k"]
    t0 = time.perf_counter()
    api = {r: build_model(cfg, remat=r, device=dev) for r in ("block",
                                                              "none")}
    state = init_state(api["block"],
                       torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    sync(dev)
    split_s["init"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.values())
    rec.update(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_params=n_params, master_bytes=n_params * 4,
               state_bytes=n_params * 12)
    check(all(p.device.type == dev.type and p.dtype == torch.float32
              for p in state.params.values()),
          "train: a master is not f32 on the card")

    # (b) remat="block" against "none", one microbatch of 1 x seq
    t0 = time.perf_counter()
    batch = make_batch_fn(cfg, RunShape("remat", size["seq"],
                                        size["remat_batch"], "train"),
                          seed=TRAIN_SEED)(0)
    moments, remat_rec = {}, {}
    for r in ("block", "none"):
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        new, m = make_train_step(api[r], lr_fn=lambda s: TRAIN_PEAK_LR)(
            state, batch)
        sync(dev)
        moments[r] = new.opt["m"]
        remat_rec[r] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                        "peak_device_bytes": (torch.cuda.max_memory_allocated(
                            dev) if card else 0)}
        del new, m
    gap = max(float((moments["block"][k] - v).abs().max()
                    / max(float(v.abs().max()), 1e-30))
              for k, v in moments["none"].items())
    remat_rec.update(batch=size["remat_batch"], seq=size["seq"],
                     max_rel_moment_gap=gap, tol=TRAIN_REMAT_TOL)
    rec["check_remat"] = remat_rec
    check(remat_rec["block"]["loss"] == remat_rec["none"]["loss"]
          and gap <= TRAIN_REMAT_TOL,
          f"train: remat='block' differs from 'none' {remat_rec}")
    del moments
    free_card(dev)
    split_s["check_b"] = time.perf_counter() - t0

    # (c) the cut train_4k shape: warm-up, timed steps, a repeated batch
    t0 = time.perf_counter()
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    step_fn = make_train_step(api["block"],
                              microbatches=size["microbatches"],
                              lr_fn=lambda s: TRAIN_PEAK_LR)
    shape = RunShape("train_4k_cut", size["seq"], size["batch"], "train")
    pipe = TokenPipeline(make_batch_fn(cfg, shape, seed=TRAIN_SEED))
    batches = [b for _, b in pipe.iter(0, 1 + size["timed"])]
    state, losses, ms = timed_train_steps(step_fn, state, batches, dev)
    repeat = batches[-1]
    state, rep_losses, rep_ms = timed_train_steps(
        step_fn, state, [repeat] * size["repeat"], dev)
    sync(dev)
    tokens = size["batch"] * size["seq"]
    step_ms = float(np.median(ms[1:]))
    flops = train_flops(cfg, n_params, size["batch"], size["seq"])
    rec["steps"] = {
        "batch": size["batch"], "seq": size["seq"],
        "microbatches": size["microbatches"],
        "published_batch": published.global_batch,
        "published_seq": published.seq_len,
        "reduced": (f"global batch {published.global_batch} -> "
                    f"{size['batch']} ({size['microbatches']} microbatches "
                    f"of {size['batch'] // size['microbatches']}): one "
                    "card's memory and the run's time"),
        "warmup_step_ms": ms[0], "step_ms": ms[1:],
        "step_ms_median": step_ms, "tokens_per_step": tokens,
        "tokens_per_s": tokens / step_ms * 1e3,
        "losses": losses, "repeated_batch_losses": rep_losses,
        "repeated_step_ms": rep_ms,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if card else 0),
        "step_flops": flops,
        "step_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
    }
    check(all(np.isfinite(losses + rep_losses)),
          f"train: a loss is not finite {losses} {rep_losses}")
    check(rep_losses[-1] < rep_losses[0],
          f"train: the loss did not fall on a repeated batch {rep_losses}")
    check(int(state.step) == 1 + size["timed"] + size["repeat"],
          "train: the state's step count is off")
    del state, step_fn, api, batches, repeat
    free_card(dev)
    split_s["check_c"] = time.perf_counter() - t0

    # (d) mamba2-130m at full size, 2 steps
    t0 = time.perf_counter()
    scfg = get_arch(SSM_ARCH) if card else smoke_config(SSM_ARCH)
    sapi = build_model(scfg, device=dev)
    sstate = init_state(sapi, torch.Generator(device=dev).manual_seed(
        SSM_TRAIN_SEED))
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    sbatches = make_batch_fn(scfg, RunShape("ssm", size["ssm_seq"],
                                            size["ssm_batch"], "train"),
                             seed=SSM_TRAIN_SEED)
    sstate, slosses, sms = timed_train_steps(
        make_train_step(sapi, lr_fn=lambda s: TRAIN_PEAK_LR), sstate,
        [sbatches(0), sbatches(1)], dev)
    rec["ssm"] = {"arch": scfg.name, "n_params": sum(
        p.numel() for p in sstate.params.values()),
        "batch": size["ssm_batch"], "seq": size["ssm_seq"],
        "losses": slosses, "step_ms": sms,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if card else 0)}
    check(all(np.isfinite(slosses)), f"train: mamba2 loss {slosses}")
    del sstate, sapi
    free_card(dev)
    split_s["check_d"] = time.perf_counter() - t0

    # (e) the CLI's checkpoint/restart driver: a crash, a resume
    t0 = time.perf_counter()
    argv = ["--arch", TRAIN_ARCH, "--smoke", "--device", str(dev),
            "--steps", str(TRAIN_CKPT_STEPS), "--batch", "4", "--seq", "64",
            "--microbatches", "2", "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    printed = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp, \
            contextlib.redirect_stdout(printed):
        whole = train_cli.main(argv + ["--ckpt-dir", f"{tmp}/a"])
        try:
            train_cli.main(argv + ["--ckpt-dir", f"{tmp}/b", "--fail-at",
                                   str(TRAIN_FAIL_AT)])
            crashed = False
        except RuntimeError:
            crashed = True
        saved = sorted(ckpt.latest_steps(f"{tmp}/b"))
        resumed = train_cli.main(argv + ["--ckpt-dir", f"{tmp}/b"])
    flat_w, flat_r = ckpt._flatten(whole), ckpt._flatten(resumed)
    same = len(flat_w) == len(flat_r) and all(
        a.device.type == dev.type and torch.equal(a, b)
        for a, b in zip(flat_w, flat_r))
    final = make_train_step(build_model(smoke_config(TRAIN_ARCH),
                                        device=dev))
    batch = make_batch_fn(smoke_config(TRAIN_ARCH),
                          RunShape("cli", 64, 4, "train"))(TRAIN_CKPT_STEPS)
    loss_w = final(whole, batch)[1]["loss"]
    loss_r = final(resumed, batch)[1]["loss"]
    rec["check_restart"] = {
        "steps": TRAIN_CKPT_STEPS, "fail_at": TRAIN_FAIL_AT,
        "crashed": crashed, "checkpoints_after_crash": saved,
        "state_bitwise_equal": same,
        "final_loss_bitwise_equal": bool(torch.equal(loss_w, loss_r)),
        "final_loss": float(loss_r),
        "cli_last_line": printed.getvalue().strip().splitlines()[-1]}
    check(crashed and same and rec["check_restart"]
          ["final_loss_bitwise_equal"],
          f"train: the resumed run differs {rec['check_restart']}")
    split_s["check_e"] = time.perf_counter() - t0
    rec.update(split_s=split_s, phase_s=time.perf_counter() - t_phase)
    log("train", **rec)
    return rec


# ------------------------------------------------------------- placement ---
#: the EP serving arm: DeepSeek-V2 at its published widths cut to 2 layers
#: (the dense first layer and one MoE layer of 160 experts), the moe
#: phase's seed, on (data 1, model 2): a prefill of 2 x 64 tokens (past 32,
#: so the capacity path, which at (1, 2) is the mesh-free prefill's) and
#: PLACE_DECODE decode steps
PLACE_EP_LAYERS, PLACE_EP_B, PLACE_EP_S, PLACE_DECODE = 2, 2, 64, 2
#: the FSDP train arm: OLMo-1B at its published widths cut to 4 layers, the
#: train phase's seed, on (data 2, model 1): 2 steps of 2 x 4,096 tokens
#: (one row a rank), remat="block", the smoke comparisons' constant rate
PLACE_TRAIN_LAYERS, PLACE_TRAIN_B, PLACE_TRAIN_STEPS = 4, 2, 2
PLACE_TRAIN_S = {"cuda": 4096, "cpu": 64}
PLACE_TIMEOUT_S = 420            # a group's ranks are killed past it
#: a rank's held bytes against those param_specs gives: the allocator's
#: rounding and the model's own small buffers
PLACE_BYTES_SLACK = 0.01
#: the long-context arm (A9 (e)): OLMo-1B at its published widths cut to
#: 4 layers, the FSDP arm's, at batch 1 over long_500k's 524,288 positions
#: (configs/base.py SHAPES) on (data 2, model 1), the cache split on its
#: sequence axis (262,144 positions a rank) and filled with seeded draws
#: in chunks of PLACE_LC_CHUNK positions, each on its own seed, so (1, 1)
#: holds the same values; two decode steps: one whose every valid
#: position and write fall on rank 0, one that writes on rank 1 and
#: attends over both ranks' full ranges
LC_ARCH, LC_SEED, PLACE_LC_LAYERS = "olmo-1b", 28, 4
PLACE_LC_S = {"cuda": 524_288, "cpu": 64}
PLACE_LC_STEPS = {"cuda": (200_000, 524_288), "cpu": (24, 64)}
PLACE_LC_CHUNK = {"cuda": 4096, "cpu": 8}
#: (2, 1) against (1, 1) is held to LM_TOL of max |logits| and reported
#: against PLACE_LC_TARGET.  The logits are a bf16 product (one ulp is
#: ~4e-3 of the largest), so only bit-equal steps meet the target: a
#: split of the positions sums the attention's f32 terms in another
#: order than one card does, and at random weights (the residual ~0.02
#: before the first MLP) one bf16 rounding of the attention output that
#: lands the other way moves later roundings.  (1, 1)'s own spread is
#: reported beside the gap: step 1 again over a view of its first half,
#: which holds every valid position, as rank 0 does
PLACE_LC_TARGET = 1e-3
#: the quantity the merge decides: each layer's f32 attention output (the
#: merged one on (2, 1), before its bf16 cast and ``wo``) against (1,
#: 1)'s, as a share of its max.  The first layer's input is the same on
#: both meshes, so it is held to PLACE_LC_ATTN_TOL; a later layer's
#: input carries the earlier layers' bf16 roundings (~1e-2 of the
#: logits), so it is held to LM_TOL.  A planted control, the last step
#: again with rank 1's softmax mass and weighted values zeroed in the
#: merge (``testing.long_context.attention_outputs``), must exceed each
#: layer's limit
PLACE_LC_ATTN_TOL = 1e-3
PLACE_LC_REDUCES = 50     # all-reduces timed for one's latency
#: every KV family's smoke config at batch 1 on (2, 1) against (1, 1) and
#: against the mesh-free model in the same rank: a prefill of 16
#: positions, its cache grown to 24 (12 encoder positions), 2 decode
#: steps.  At batch 1 on (2, 1) a MoE layer takes the mesh-free dropless
#: path, so the mesh-free model's routing is imposed there (C11); on
#: (1, 1) the batch splits and the expert-parallel branch routes by its
#: capacity path, as the reference's does, whose prefill drops tokens:
#: a routed family's (1, 1) prefill is reported, and its decode steps,
#: from the mesh-free prefill's cache under the mesh-free routing, held
PLACE_SMOKE_ARCHS = ("qwen3-4b", "paligemma-3b", "seamless-m4t-large-v2",
                     "deepseek-v2-236b", "jamba-v0.1-52b")
ROUTED_SMOKE = ("deepseek-v2-236b", "jamba-v0.1-52b")
PLACE_SMOKE_SEED, PLACE_SMOKE_S, PLACE_SMOKE_SMAX = 29, 16, 24
PLACE_SMOKE_ENC, PLACE_SMOKE_STEPS = 12, 2


def _spec_bytes(model, mesh, dp_axes) -> int:
    """The bytes one rank holds of ``model``'s parameters under
    ``param_specs`` on ``mesh`` (each tensor's numel over its shards)."""
    import numpy as np
    from repro_torch.configs.sharding import mesh_sizes, param_specs
    sizes = mesh_sizes(mesh)
    total = 0
    for name, spec in param_specs(model, mesh, fsdp=dp_axes).items():
        p = model.get_parameter(name)
        split = int(np.prod([sizes[a] for e in spec if e is not None
                             for a in ((e,) if isinstance(e, str) else e)]))
        total += p.numel() // split * p.element_size()
    return total


def _local_bytes(tensors) -> int:
    from repro_torch.models import placement as P
    return sum(P.local(t).numel() * P.local(t).element_size()
               for t in tensors)


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _shard_digests(params: dict, cfg, world: int) -> list:
    """For each data rank of a (world, 1) mesh, the digest of the shards
    of ``params`` (whole tensors) it holds under ``param_specs``: what
    :func:`_digest` gives over that rank's local masters."""
    from types import SimpleNamespace

    from repro_torch.configs.sharding import param_specs
    mesh = SimpleNamespace(shape={"data": world, "model": 1})
    specs = param_specs(params, mesh)
    out = []
    for r in range(world):
        shards = []
        for name, t in params.items():
            for d, axes in enumerate(specs[name]):
                if axes is not None and "data" in axes:
                    t = t.chunk(world, d)[r]
            shards.append(t)
        out.append(_digest(shards))
    return out


def _fill_seq_cache(cache, chunk: int, seed: int) -> None:
    """Seeded N(0, 1) bf16 draws in every K/V position this rank holds,
    chunk by chunk: chunk c of layer l of leaf j on seed (seed, j, l, c)
    with c the chunk's global index, so a rank holding any range of the
    positions holds the values the whole cache holds there."""
    import torch
    from repro_torch.models import placement as P
    for j, key in enumerate(("k", "v")):
        sh = P.seq_shard(cache[key])
        t = P.local(cache[key])
        first = (sh.start if sh else 0) // chunk
        gen = torch.Generator(device=t.device)
        for layer in range(t.shape[0]):
            for c in range(t.shape[2] // chunk):
                gen.manual_seed(seed + ((j * t.shape[0] + layer) << 24)
                                + first + c)
                t[layer, :, c * chunk:(c + 1) * chunk].normal_(generator=gen)


def long_context_rank(world: int, dev, device_type: str, out: dict) -> dict:
    """The placement phase's long-context arm in one rank: OLMo-1B cut to
    PLACE_LC_LAYERS at batch 1 over PLACE_LC_S positions on (world, 1),
    its cache filled with seeded draws (no prefill), two decode steps;
    the logits go to ``out``, the bytes held and exchanged to the
    returned record."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models import placement as P
    from repro_torch.testing.long_context import attention_outputs

    card = device_type == "cuda"
    t_arm = time.perf_counter()
    cfg = (get_arch(LC_ARCH) if card else smoke_config(LC_ARCH)).scaled(
        n_layers=PLACE_LC_LAYERS)
    smax = PLACE_LC_S[device_type]
    api = build_model(cfg, mesh=make_host_mesh(world, 1,
                                               device_type=device_type),
                      device=dev)
    params = api.init(torch.Generator(device=dev).manual_seed(LC_SEED))
    before = torch.cuda.memory_allocated(dev) if card else 0
    cache = api.init_cache(1, smax)
    held = (torch.cuda.memory_allocated(dev) if card else 0) - before
    t0 = time.perf_counter()
    _fill_seq_cache(cache, PLACE_LC_CHUNK[device_type], LC_SEED)
    if card:
        torch.cuda.synchronize(dev)
    fill_s = time.perf_counter() - t0
    toks = np.random.default_rng(LC_SEED).integers(0, cfg.vocab, (2, 1))
    step_s, attention, exchange = [], [], []
    with torch.no_grad():
        for t, n in enumerate(PLACE_LC_STEPS[device_type]):
            t0 = time.perf_counter()
            with CostCounter() as c, attention_outputs() as attn:
                logits, cache = api.decode_step(params, cache, toks[t], n)
            out[f"lc/decode{t}"] = P.full(logits).float().cpu().numpy()
            out[f"lc/attn{t}"] = torch.stack(attn).numpy()
            step_s.append(time.perf_counter() - t0)
            # at batch 1 the attention's are the step's only all-reduces
            exchange.append(c.totals()["collectives"])
            attention.append(exchange[-1].get("all-reduce", 0.0))
            if world == 1 and t == 0:
                # the same step over a view of the first half of the
                # positions (every valid one): one card's own spread
                view = P.Rows(api.mesh, api.dp_axes, 1).cache(
                    {k: P.local(cache[k])[:, :, :smax // 2]
                     for k in ("k", "v")})
                logits, _ = api.decode_step(params, view, toks[t], n)
                out["lc/decode0_view"] = P.full(logits).float().cpu().numpy()
        if world > 1:
            # the control: the last step again (its writes are the
            # step's own at layer 0, and nothing reads the cache after)
            # with rank 1's terms of the merge lost
            with attention_outputs(
                    zero_terms=torch.distributed.get_rank() == 1) as attn:
                api.decode_step(params, cache, toks[-1], n)
            out["lc/attn_control"] = torch.stack(attn).numpy()
    sh = P.seq_shard(cache["k"])
    # the latency of one of the merge's small all-reduces (B x H f32)
    # here, through gloo's host staging: what merge_softmax's third one
    # costs a layer and step on this card
    small = torch.zeros(1, cfg.n_heads, device=dev)
    t0 = time.perf_counter()
    for _ in range(PLACE_LC_REDUCES):
        P.all_reduce(small, api.mesh, api.dp_axes)
    small_reduce_s = (time.perf_counter() - t0) / PLACE_LC_REDUCES
    H, hd = cfg.n_heads, cfg.hd
    rec = {"lc_held_bytes": held,
           "lc_local_bytes": _local_bytes(cache.values()),
           "lc_whole_bytes": 2 * cfg.n_layers * smax * cfg.n_kv_heads * hd * 2,
           "lc_seq_range": [sh.start, sh.size] if sh else [0, smax],
           # per layer: the max and the sum (B x H f32 each) and the
           # weighted values (B x H x hd f32), whatever the length
           "lc_attention_formula": (cfg.n_layers * H * (hd + 2) * 4
                                    if sh else 0),
           "lc_attention_bytes": attention, "lc_exchange": exchange,
           "lc_fill_s": fill_s, "lc_step_s": step_s,
           "lc_small_all_reduce_s": small_reduce_s,
           "lc_peak_bytes": (torch.cuda.max_memory_allocated(dev) if card
                             else 0)}
    del cache, params, logits
    if card:
        torch.cuda.empty_cache()
    rec["lc_s"] = time.perf_counter() - t_arm
    return rec


def _smoke_prefill(api, params, batch) -> tuple:
    """A prefill of ``batch``: (its global logits on the host, its
    cache)."""
    from repro_torch.models import placement as P
    logits, pc = api.prefill(params, batch)
    return P.full(logits).float().cpu().numpy(), pc


def _smoke_decode(api, params, cfg, pc, toks) -> list:
    """A prefill's cache ``pc`` grown to PLACE_SMOKE_SMAX positions
    (``testing.long_context.copy_prefix``: on a mesh the two lengths
    split their positions differently), and a decode step a row of
    ``toks``: each step's global logits on the host."""
    from repro_torch.models import placement as P
    from repro_torch.testing.long_context import copy_prefix
    kw = {"enc_len": PLACE_SMOKE_ENC} if cfg.family == "encdec" else {}
    cache = api.init_cache(1, PLACE_SMOKE_SMAX, **kw)
    for group in cache:
        if group == "ssm":
            for dst, src in zip(cache["ssm"], pc["ssm"]):
                P.local(dst).copy_(P.local(src))
        elif isinstance(cache[group], dict):
            for key in cache[group]:
                copy_prefix(cache[group][key], pc[group][key])
        else:
            copy_prefix(cache[group], pc[group])
    got = []
    for t, tok in enumerate(toks):
        logits, cache = api.decode_step(params, cache, tok,
                                        PLACE_SMOKE_S + 1 + t)
        got.append(P.full(logits).float().cpu().numpy())
    return got


def smoke_seq_rank(world: int, dev, device_type: str, out: dict) -> dict:
    """Every KV family's smoke config at batch 1, mesh-free and on
    (world, 1) (its cache split on the sequence axis at world 2): both
    runs' logits go to ``out``, the routing moves to the returned
    record.  The mesh-free model's routing is imposed (C11) on (2, 1),
    whose MoE layers take the mesh-free dropless path at batch 1.  On
    (1, 1) they take the expert-parallel branch, whose capacity path
    drops tokens in a 16-token prefill by the reference's design, so no
    routing can make that prefill the dropless one: (1, 1) runs its own
    prefill (its logits reported), then decodes from the mesh-free
    prefill's cache with the mesh-free decode steps' routing imposed on
    its router (at one token the capacity path keeps every choice)."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.testing.routing import routing

    t_arm = time.perf_counter()
    mesh = make_host_mesh(world, 1, device_type=device_type)
    moved = {}
    with torch.no_grad():
        for i, arch in enumerate(PLACE_SMOKE_ARCHS):
            cfg = smoke_config(arch)
            rng = np.random.default_rng(PLACE_SMOKE_SEED + i)
            batch = {"tokens": rng.integers(
                0, cfg.vocab, (1, PLACE_SMOKE_S - cfg.prefix_len))}
            if cfg.prefix_len:
                batch["patches"] = rng.standard_normal(
                    (1, cfg.prefix_len, cfg.d_model)).astype(np.float32)
            if cfg.family == "encdec":
                batch["src_embeds"] = rng.standard_normal(
                    (1, PLACE_SMOKE_ENC, cfg.d_model)).astype(np.float32)
            toks = rng.integers(0, cfg.vocab, (PLACE_SMOKE_STEPS, 1))
            got = {}
            for label, m in (("one", None), ("mesh", mesh)):
                api = build_model(cfg, mesh=m, device=dev)
                params = api.init(torch.Generator(device=dev).manual_seed(
                    PLACE_SMOKE_SEED + i))
                if m is None:
                    with routing() as r:
                        first, pc = _smoke_prefill(api, params, batch)
                        got[label] = [first] + _smoke_decode(
                            api, params, cfg, pc, toks)
                    calls, one_pc = r["calls"], pc
                elif world > 1 or arch not in ROUTED_SMOKE:
                    with routing(calls if world > 1 else None) as r:
                        first, pc = _smoke_prefill(api, params, batch)
                        got[label] = [first] + _smoke_decode(
                            api, params, cfg, pc, toks)
                else:
                    first, _ = _smoke_prefill(api, params, batch)
                    # one router call a MoE layer a pass on the dropless
                    # path; the capacity path's token choice left alone
                    n = len(calls) // (1 + PLACE_SMOKE_STEPS)
                    with routing([c for call in calls[n:]
                                  for c in (call, None)]) as r:
                        got[label] = [first] + _smoke_decode(
                            api, params, cfg, one_pc, toks)
            for label, steps in got.items():
                for t, logits in enumerate(steps):
                    out[f"smoke/{arch}/{label}{t}"] = logits
            moved[arch] = r["moved"]
            del one_pc, pc
    return {"smoke_moved": moved, "smoke_s": time.perf_counter() - t_arm}


def placement_rank(outdir: str, backend: str, device_type: str = "cuda"
                   ) -> int:
    """One rank of the ``placement`` phase, started by
    :func:`phase_placement` (``chip_smoke.py --placement-rank OUTDIR
    BACKEND``): two gloo ranks sharing the card run the EP arm on (data
    1, model 2) and the FSDP arm on (data 2, model 1), whose state they
    save; one rank (nccl on the card) runs the EP arm's model without a
    mesh and on (1, 1), the FSDP arm on (1, 1), and restores the two
    ranks' checkpoint onto (1, 1).  Each rank writes
    OUTDIR/rank{r}.npz."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import join
    from repro_torch.models import build_model
    from repro_torch.models import placement as P
    from repro_torch.testing.routing import routing
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import (init_state, make_train_step,
                                              state_shardings)

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = join(backend)
    card = device_type == "cuda"
    dev = torch.device("cuda", 0) if card else torch.device("cpu")
    if card:
        torch.cuda.set_device(dev)
    out, rec = {}, {"rank": rank, "world": world, "backend": backend}

    def held():
        return torch.cuda.memory_allocated(dev) if card else 0

    def logits_of(t):
        return P.full(t).float().cpu().numpy()

    # --- EP serving arm
    cfg = (get_arch(MOE_ARCH) if card else smoke_config(MOE_ARCH)).scaled(
        n_layers=PLACE_EP_LAYERS)
    rng = np.random.default_rng(MOE_SEED)
    tokens = rng.integers(0, cfg.vocab, (PLACE_EP_B, PLACE_EP_S))
    steps = rng.integers(0, cfg.vocab, (PLACE_DECODE, PLACE_EP_B))
    # world 2: the meshes under test; world 1: the one-card model and the
    # (1, 1) mesh they are held against
    meshes = [("ep", make_host_mesh(1, world, device_type=device_type))]
    if world == 1:
        meshes.insert(0, ("one_card", None))
    t_arm = time.perf_counter()
    for label, mesh in meshes:
        api = build_model(cfg, mesh=mesh, device=dev)
        before, t0 = held(), time.perf_counter()
        params = api.init(torch.Generator(device=dev).manual_seed(MOE_SEED))
        rec[f"{label}_init_s"] = time.perf_counter() - t0
        rec[f"{label}_held_bytes"] = held() - before
        rec[f"{label}_local_bytes"] = _local_bytes(params.parameters())
        if mesh is not None:
            meta = build_model(cfg, device="meta").init(None)
            rec[f"{label}_spec_bytes"] = _spec_bytes(meta, mesh, ("data",))
            rec[f"{label}_whole_bytes"] = sum(
                p.numel() * p.element_size() for p in meta.parameters())
        with torch.no_grad():
            t0 = time.perf_counter()
            with routing() as calls:
                logits, pc = api.prefill(params, {"tokens": tokens})
            out[f"{label}/prefill"] = logits_of(logits)
            rec[f"{label}_prefill_s"] = time.perf_counter() - t0
            # the router's top-k of each MoE layer (the capacity path's
            # expert choice follows it)
            out[f"{label}/routing"] = torch.stack(
                calls["calls"][::2]).cpu().numpy()
            cache = api.init_cache(PLACE_EP_B, PLACE_EP_S + PLACE_DECODE)
            for dst, src in ((P.local_tree(cache)[k][j],
                              P.local_tree(pc)[k][j])
                             for k in ("dense", "moe")
                             for j in ("c_kv", "k_rope")):
                dst[:, :, :PLACE_EP_S].copy_(src)
            t0 = time.perf_counter()
            for t in range(PLACE_DECODE):
                logits, cache = api.decode_step(params, cache, steps[t],
                                                PLACE_EP_S + 1 + t)
                out[f"{label}/decode{t}"] = logits_of(logits)
            rec[f"{label}_decode_s"] = time.perf_counter() - t0
        del params, pc, cache, logits
        if card:
            torch.cuda.empty_cache()
    rec["ep_s"] = time.perf_counter() - t_arm

    # --- FSDP train arm
    t_arm = time.perf_counter()
    tcfg = (get_arch(TRAIN_ARCH) if card else smoke_config(TRAIN_ARCH)
            ).scaled(n_layers=PLACE_TRAIN_LAYERS)
    seq = PLACE_TRAIN_S[device_type]
    mesh = make_host_mesh(world, 1, device_type=device_type)
    api = build_model(tcfg, mesh=mesh, device=dev)
    state = init_state(api, torch.Generator(device=dev).manual_seed(
        TRAIN_SEED))
    rec.update(
        master_bytes=_local_bytes(state.params.values()),
        moment_bytes=_local_bytes([*state.opt["m"].values(),
                                   *state.opt["v"].values()]),
        whole_master_bytes=sum(p.numel() * 4 for p in state.params.values()))
    step = make_train_step(api, lr_fn=lambda s: TRAIN_LR)
    trng = np.random.default_rng(TRAIN_SEED)
    losses, gnorms, step_s = [], [], []
    for _ in range(PLACE_TRAIN_STEPS):
        batch = {"tokens": trng.integers(0, tcfg.vocab,
                                         (PLACE_TRAIN_B, seq))}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        step_s.append(time.perf_counter() - t0)
    rec.update(losses=losses, gnorms=gnorms, step_s=step_s,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if card
               else 0)
    ck = Path(outdir).parent / "ckpt"
    if world > 1:
        t0 = time.perf_counter()
        ckpt.save(state, str(ck), PLACE_TRAIN_STEPS)
        rec["save_s"] = time.perf_counter() - t0
        rec["saved_digest"] = _digest(P.local(t)
                                      for t in state.params.values())
    else:
        deadline = time.monotonic() + PLACE_TIMEOUT_S
        while not ckpt.latest_steps(str(ck)):
            if time.monotonic() > deadline:
                raise TimeoutError("placement: no checkpoint from the gloo "
                                   "ranks")
            time.sleep(0.5)
        t0 = time.perf_counter()
        onto, at = ckpt.restore(state, str(ck),
                                shardings=state_shardings(state))
        rec["restore_s"] = time.perf_counter() - t0
        rec.update(restored_step=at,
                   restored_digests=_shard_digests(
                       {n: P.full(t) for n, t in onto.params.items()},
                       tcfg, 2),
                   restored_placed=all(P.is_placed(t)
                                       for t in onto.params.values()))
        del onto
    rec["train_s"] = time.perf_counter() - t_arm
    del state, step, api
    if card:
        torch.cuda.empty_cache()

    # --- long-context arm (A9 (e)) and the KV families' smoke configs
    rec.update(long_context_rank(world, dev, device_type, out))
    rec.update(smoke_seq_rank(world, dev, device_type, out))
    rec["foreign"] = sorted(m for m in sys.modules if m == "jax" or
                            m.startswith(("jax.", "repro.")))
    out["rec"] = np.asarray(json.dumps(rec))
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    return 0


def _run_placement_group(outdir, world: int, backend: str,
                         device_type: str) -> list:
    import numpy as np
    from repro_torch.launch.ranks import run_ranks

    script = str(Path(__file__).resolve())
    argv = ([sys.executable, script, "--placement-rank", str(outdir),
             backend] if device_type == "cuda" else
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke;"
             " sys.exit(chip_smoke.placement_rank(sys.argv[2], sys.argv[3], "
             "'cpu'))", str(Path(script).parent), str(outdir), backend])
    run_ranks(argv, world, workdir=outdir, timeout_s=PLACE_TIMEOUT_S)
    outs = []
    for r in range(world):
        with np.load(Path(outdir) / f"rank{r}.npz") as z:
            o = dict(z)
        o["rec"] = json.loads(str(o["rec"]))
        outs.append(o)
    return outs


def phase_placement(dev):
    """A9 (d) on this card: the gloo group of two ranks and the NCCL group
    of one started together (``chip_smoke.py --placement-rank``).  (a)
    the EP prefill on (1, 2) against the one-card model of the same seed
    (the routing of both counted, C11), and the (1, 1) NCCL mesh's
    against it too; (b) the decode steps on (1, 2) against (1, 1), which
    takes the mesh branch as well; (c) the bytes each rank holds against
    those ``param_specs`` gives; (d) the FSDP steps' loss and gnorm on
    (2, 1) against (1, 1) within the train phase's tolerances; (e) the
    masters and moments a rank holds, half of the whole; (f) the state
    saved on (2, 1) restored onto (1, 1), the masters bit-equal.  One card
    holds one NCCL rank: no number here is a mesh's throughput."""
    import threading

    import numpy as np

    t_phase = time.perf_counter()
    card = on_card(dev)
    device_type = "cuda" if card else "cpu"
    groups = {"gloo": 2, "nccl": 1} if card else {"gloo": 2, "gloo1": 1}
    res, errs = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_place_") as tmp:
        def run(name, world):
            try:
                res[name] = _run_placement_group(
                    Path(tmp) / name, world, name.rstrip("1"), device_type)
            except Exception as exc:        # re-raised below, not hidden
                errs.append(exc)
        threads = [threading.Thread(target=run, args=kv)
                   for kv in groups.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
    gloo, one = res["gloo"], res["nccl" if card else "gloo1"]
    g0, n0 = gloo[0], one[0]
    rec = {"ep": {"arch": MOE_ARCH, "n_layers": PLACE_EP_LAYERS,
                  "tokens": [PLACE_EP_B, PLACE_EP_S],
                  "decode_steps": PLACE_DECODE},
           "fsdp": {"arch": TRAIN_ARCH, "n_layers": PLACE_TRAIN_LAYERS,
                    "tokens": [PLACE_TRAIN_B, PLACE_TRAIN_S[device_type]],
                    "steps": PLACE_TRAIN_STEPS}}
    # (a) prefill, routing counted
    moved = int((np.sort(g0["ep/routing"], -1)
                 != np.sort(n0["one_card/routing"], -1)).any(-1).sum())
    rec["ep"].update(
        prefill_vs_one_card=rel_gap_np(n0["one_card/prefill"],
                                       g0["ep/prefill"]),
        nccl_prefill_vs_one_card=rel_gap_np(n0["one_card/prefill"],
                                            n0["ep/prefill"]),
        routing_moved=moved,
        decode_vs_nccl=[rel_gap_np(n0[f"ep/decode{t}"], g0[f"ep/decode{t}"])
                        for t in range(PLACE_DECODE)],
        ranks=[{k: g["rec"][k] for k in (
            "ep_held_bytes", "ep_local_bytes", "ep_spec_bytes",
            "ep_whole_bytes", "ep_init_s", "ep_prefill_s", "ep_decode_s",
            "ep_s")} for g in gloo],
        one_card_held_bytes=n0["rec"]["one_card_held_bytes"])
    rec["fsdp"].update(
        losses=g0["rec"]["losses"], gnorms=g0["rec"]["gnorms"],
        nccl_losses=n0["rec"]["losses"], nccl_gnorms=n0["rec"]["gnorms"],
        ranks=[{k: g["rec"][k] for k in ("master_bytes", "moment_bytes",
                                         "whole_master_bytes", "step_s",
                                         "peak_bytes", "train_s")}
               for g in gloo],
        nccl_step_s=n0["rec"]["step_s"], save_s=g0["rec"]["save_s"],
        restore_s=n0["rec"]["restore_s"],
        restored_step=n0["rec"]["restored_step"])
    # (g) long context: each rank's half of the cache, the logits against
    # (1, 1)'s, the attention's exchange against its formula
    steps = PLACE_LC_STEPS[device_type]
    rec["long_context"] = {
        "arch": LC_ARCH, "n_layers": PLACE_LC_LAYERS, "batch": 1,
        "positions": PLACE_LC_S[device_type], "cur_len": list(steps),
        "vs_nccl": [rel_gap_np(n0[f"lc/decode{t}"], g0[f"lc/decode{t}"])
                    for t in range(len(steps))],
        "vs_nccl_same_positions": rel_gap_np(n0["lc/decode0_view"],
                                             g0["lc/decode0"]),
        "nccl_self_spread": rel_gap_np(n0["lc/decode0"],
                                       n0["lc/decode0_view"]),
        # each layer's f32 attention output against (1, 1)'s, a list a
        # step a rank, and the control's (rank 1's terms lost)
        "attn_vs_nccl": [[[rel_gap_np(n0[f"lc/attn{t}"][i],
                                      g[f"lc/attn{t}"][i])
                           for i in range(PLACE_LC_LAYERS)]
                          for t in range(len(steps))] for g in gloo],
        "attn_control_vs_nccl": [[rel_gap_np(n0[f"lc/attn{len(steps) - 1}"][i],
                                             g["lc/attn_control"][i])
                                  for i in range(PLACE_LC_LAYERS)]
                                 for g in gloo],
        "attn_tol": [PLACE_LC_ATTN_TOL] + [LM_TOL] * (PLACE_LC_LAYERS - 1),
        "ranks": [{k: g["rec"][k] for k in (
            "lc_held_bytes", "lc_local_bytes", "lc_whole_bytes",
            "lc_seq_range", "lc_attention_bytes", "lc_attention_formula",
            "lc_exchange", "lc_fill_s", "lc_step_s", "lc_small_all_reduce_s",
            "lc_peak_bytes", "lc_s")} for g in gloo],
        "nccl": {k: n0["rec"][k] for k in (
            "lc_held_bytes", "lc_local_bytes", "lc_attention_bytes",
            "lc_step_s", "lc_peak_bytes", "lc_s")}}
    # (h) every KV family's smoke config at batch 1 on (2, 1) against the
    # mesh-free model and against (1, 1), a gap a step (the prefill first)
    rec["smoke_seq"] = {
        arch: {"vs_one_card": max(
                   rel_gap_np(g0[f"smoke/{arch}/one{t}"],
                              g0[f"smoke/{arch}/mesh{t}"])
                   for t in range(PLACE_SMOKE_STEPS + 1)),
               "vs_nccl": [rel_gap_np(n0[f"smoke/{arch}/mesh{t}"],
                                      g0[f"smoke/{arch}/mesh{t}"])
                           for t in range(PLACE_SMOKE_STEPS + 1)],
               "moved": [g["rec"]["smoke_moved"][arch] for g in gloo],
               "nccl_moved": n0["rec"]["smoke_moved"][arch]}
        for arch in PLACE_SMOKE_ARCHS}
    rec["smoke_seq_s"] = [g["rec"]["smoke_s"] for g in gloo]
    rec["phase_s"] = time.perf_counter() - t_phase
    log("placement", **rec)
    ep = rec["ep"]
    check(ep["prefill_vs_one_card"] < LM_TOL and
          ep["nccl_prefill_vs_one_card"] < LM_TOL,
          f"placement: the EP prefill differs from the one-card model's "
          f"({ep['prefill_vs_one_card']}, {ep['nccl_prefill_vs_one_card']})")
    check(max(ep["decode_vs_nccl"]) < LM_TOL,
          f"placement: the (1, 2) decode differs from (1, 1)'s "
          f"({ep['decode_vs_nccl']})")
    for r in ep["ranks"]:
        check(r["ep_local_bytes"] == r["ep_spec_bytes"],
              "placement: a rank's shards are not param_specs' bytes")
        if card:
            check(r["ep_spec_bytes"] <= r["ep_held_bytes"]
                  <= r["ep_spec_bytes"] * (1 + PLACE_BYTES_SLACK),
                  f"placement: a rank holds {r['ep_held_bytes']} B against "
                  f"param_specs' {r['ep_spec_bytes']}")
    fs = rec["fsdp"]
    for a, b in zip(fs["losses"], fs["nccl_losses"]):
        check(abs(a - b) <= TRAIN_LOSS_TOL["dense"] * abs(b),
              f"placement: loss {a} on (2, 1) against {b} on (1, 1)")
    for a, b in zip(fs["gnorms"], fs["nccl_gnorms"]):
        check(abs(a - b) <= TRAIN_GNORM_TOL * abs(b),
              f"placement: gnorm {a} on (2, 1) against {b} on (1, 1)")
    for r in fs["ranks"]:
        half = r["whole_master_bytes"] / 2
        check(abs(r["master_bytes"] - half) <= PLACE_BYTES_SLACK * half
              and abs(r["moment_bytes"] - 2 * half)
              <= PLACE_BYTES_SLACK * 2 * half,
              "placement: a rank's masters or moments are not half")
    check(fs["restored_step"] == PLACE_TRAIN_STEPS and n0["rec"][
        "restored_placed"] and n0["rec"]["restored_digests"]
          == [g["rec"]["saved_digest"] for g in gloo],
          "placement: the masters restored onto (1, 1) are not, shard for "
          "shard, those each rank of (2, 1) saved")
    lc = rec["long_context"]
    lc["target"] = PLACE_LC_TARGET
    lc["target_met"] = max(lc["vs_nccl"]) < PLACE_LC_TARGET
    log("placement_long_context", **lc)
    check(max(lc["vs_nccl"] + [lc["vs_nccl_same_positions"]]) < LM_TOL,
          f"placement: long-context logits on (2, 1) differ from (1, 1)'s "
          f"({lc['vs_nccl']})")
    limits = lc["attn_tol"]
    for r in lc["attn_vs_nccl"]:
        check(len(r) == len(steps) and all(
                  len(step) == len(limits)
                  and all(x < tol for x, tol in zip(step, limits))
                  for step in r),
              f"placement: a layer's merged attention on (2, 1) differs "
              f"from (1, 1)'s ({lc['attn_vs_nccl']} against {limits})")
    for r in lc["attn_control_vs_nccl"]:
        check(all(x > tol for x, tol in zip(r, limits)),
              f"placement: the control (rank 1's softmax terms lost) "
              f"passes the attention check ({lc['attn_control_vs_nccl']}):"
              f" it cannot see the merge")
    for r in lc["ranks"]:
        half = r["lc_whole_bytes"] / 2
        check(r["lc_local_bytes"] == half,
              f"placement: a rank's long-context cache is "
              f"{r['lc_local_bytes']} B, not half of {r['lc_whole_bytes']}")
        if card:
            check(abs(r["lc_held_bytes"] - half) <= PLACE_BYTES_SLACK * half,
                  f"placement: a rank holds {r['lc_held_bytes']} B of "
                  f"long-context cache against {half}")
        check(all(b == r["lc_attention_formula"] > 0
                  for b in r["lc_attention_bytes"]),
              f"placement: the attention exchanged {r['lc_attention_bytes']}"
              f" B a step, not {r['lc_attention_formula']} (O(B H hd))")
        check(r["lc_exchange"][0] == r["lc_exchange"][1],
              "placement: the two long-context steps exchanged different "
              "bytes")
    for arch, g in rec["smoke_seq"].items():
        check(g["vs_one_card"] < LM_TOL,
              f"placement: {arch} at batch 1 on (2, 1) differs from the "
              f"mesh-free model ({g['vs_one_card']})")
        # a routed family's (1, 1) prefill drops tokens (its capacity
        # path): reported; its decode steps start from the same cache
        held = g["vs_nccl"][1:] if arch in ROUTED_SMOKE else g["vs_nccl"]
        check(max(held) < LM_TOL,
              f"placement: {arch} at batch 1 on (2, 1) differs from (1, 1) "
              f"({g['vs_nccl']})")
    check(all(o["rec"]["foreign"] == [] for o in gloo + one),
          "placement: a rank loaded jax or the reference")
    return rec


def rel_gap_np(ref, got) -> float:
    """``rel_gap`` of two numpy arrays."""
    import numpy as np
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    top = np.abs(ref).max()
    return float(np.abs(got - ref).max() / top if top else np.abs(got).max())


def profiled_steps(api, params, cache, tok, lens, steps, dev) -> tuple:
    """``steps`` decode steps under torch.profiler, each followed by the
    logits' copy to the host, after one unprofiled warm-up step, with
    ``past_cache="drop"`` as ServingEngine passes it: the device profile
    a step and the profiled wall a step in ms."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card(dev) else [])
    logits, cache = api.decode_step(params, cache, tok, lens,
                                    past_cache="drop")
    sync(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = api.decode_step(params, cache, tok, lens + 1 + i,
                                            past_cache="drop")
            np.asarray(logits.cpu())
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    check(all(t.device.type == dev.type
              for t in cache_leaves(cache).values()),
          "lm_profile: a cache tensor is not on the card")
    return device_profile(prof, steps), wall_ms


def profiled_train_step(dev, train_rec) -> dict:
    """The train phase's check (c) step (OLMo-1B, 2 microbatches of 4 x
    4,096 on the card) under torch.profiler, after one unprofiled warm-up
    step, from the same seeded masters: launches, device ms and the busy
    share against (c)'s unprofiled median step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.configs.base import RunShape
    from repro_torch.data import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.train.train_step import init_state, make_train_step

    card = on_card(dev)
    size = TRAIN_SIZES["card" if card else "cpu"]
    cfg = get_arch(TRAIN_ARCH) if card else smoke_config(TRAIN_ARCH)
    api = build_model(cfg, device=dev)
    state = init_state(api, torch.Generator(device=dev).manual_seed(
        TRAIN_SEED))
    step_fn = make_train_step(api, microbatches=size["microbatches"],
                              lr_fn=lambda s: TRAIN_PEAK_LR)
    batches = make_batch_fn(cfg, RunShape("train_4k_cut", size["seq"],
                                          size["batch"], "train"),
                            seed=TRAIN_SEED)
    state, m = step_fn(state, batches(0))
    float(m["loss"])
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batches(1))
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    unprofiled = train_rec["steps"]["step_ms_median"]
    got = device_profile(prof, 1)
    del state, step_fn
    free_card(dev)
    return dict(got, steps=1, profiled_step_ms=wall_ms,
                unprofiled_step_ms=unprofiled,
                device_busy_share=got["device_ms_per_step"] / unprofiled)


def phase_lm_profile(dev, rec, encdec_rec, ssm_rec, moe_rec, hybrid_rec,
                     train_rec=None):
    """The lm, encdec, ssm, moe and hybrid phases' steps under
    torch.profiler, after every wall of the run, on the same seeded
    weights and depths: for each, three engine-shaped steps (8 slots,
    max_len 1,024, ragged lengths), and for
    Qwen3-4B the same with slot 0 past the cache (the C8 write guard on)
    and one step over the 32,768-position cache; device kernels, copies
    and launches a step, device ms, the busy share against the phase's
    unprofiled step (none for the guarded steps, which the engine arm
    does not run), the top 5 device ops; the seconds each model took to
    build and each arm to run (the phase's time, A22)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    card = on_card(dev)
    size = LM_SIZES["card" if card else "cpu"]
    rng = np.random.default_rng(LM_SEED + 2)
    out, split_s = {}, {}
    with f32_accumulation():
        for arch, seed, arms, arch_rec in (
                (LM_ARCH, LM_SEED, ("engine", "engine_past_cache",
                                    "long_cache"), rec),
                (ENCDEC_ARCH, ENCDEC_SEED, ("engine",), encdec_rec),
                (SSM_ARCH, SSM_SEED, ("engine",), ssm_rec),
                (MOE_ARCH, MOE_SEED, ("engine",), moe_rec),
                (HYBRID_ARCH, HYBRID_SEED, ("engine",), hybrid_rec)):
            t0 = time.perf_counter()
            cfg = lm_config(arch, card)
            api = build_model(cfg, device=dev)
            params = api.init(torch.Generator(device=dev).manual_seed(seed))
            sync(dev)
            split_s[f"{arch}_init"] = time.perf_counter() - t0
            for arm in arms:
                t0 = time.perf_counter()
                if arm.startswith("engine"):
                    B, S = size["slots"], size["max_len"]
                    cache, steps = api.init_cache(B, S), LM_PROFILE_STEPS
                    lens = rng.integers(1, S - steps - 1, B).astype(np.int32)
                    unprofiled = arch_rec["engine"]["host_step_ms_median"]
                    if arm == "engine_past_cache":
                        lens[0], unprofiled = S + 1, None
                else:
                    B, S = size["long_b"], size["long_len"]
                    cache, steps = fill_long_cache(cfg, size, dev), 1
                    lens = rng.integers(size["long_min"], S - steps - 1,
                                        B).astype(np.int32)
                    unprofiled = arch_rec["long_cache"]["step_ms_median"]
                tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
                got, wall_ms = profiled_steps(api, params, cache, tok, lens,
                                              steps, dev)
                label = arm if arch == LM_ARCH else f"{arch}_{arm}"
                out[label] = dict(got, steps=steps, profiled_step_ms=wall_ms,
                                  unprofiled_step_ms=unprofiled,
                                  device_busy_share=None if unprofiled
                                  is None else got["device_ms_per_step"]
                                  / unprofiled)
                del cache
                free_card(dev)
                split_s[label] = time.perf_counter() - t0
            del params
            free_card(dev)
        if train_rec is not None:
            t0 = time.perf_counter()
            out["train"] = profiled_train_step(dev, train_rec)
            split_s["train"] = time.perf_counter() - t0
    log("lm_profile", **out, split_s=split_s,
        phase_s=time.perf_counter() - t_phase)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:        # one rank of phase_mesh
        return mesh_rank(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--placement-rank"]:   # one rank of phase_placement
        return placement_rank(sys.argv[2], sys.argv[3])
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.api import SchedulePolicy
    from repro_torch.kernels import _build
    from repro_torch.vecdata import recall_at_k

    t_all = time.perf_counter()
    # stated precision: full fp32 products everywhere (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    t0 = time.perf_counter()
    phase_parity(dev)
    log("parity_done", seconds=time.perf_counter() - t0)
    # A9: the LM serving path's walls, before any CUDA graph or profiler
    # session of the process; its profiled steps come last
    lm_rec = phase_lm(dev)
    torch.cuda.empty_cache()
    encdec_rec = phase_encdec(dev)
    ssm_rec = phase_ssm(dev)
    moe_rec = phase_moe(dev)
    hybrid_rec = phase_hybrid(dev)
    torch.cuda.empty_cache()
    # A9 (c): the training path, eager, before any graph or profiler too
    train_rec = phase_train(dev)
    torch.cuda.empty_cache()

    # A9 (d): the placements, as rank processes; meanwhile the host draws
    # the 1M corpus and the guardrails' drift scenario, fits DDCopq and
    # builds the IVF index (A22)
    drawn = draw_in_background(dev)
    phase_placement(dev)
    t0 = time.perf_counter()
    drawn["thread"].join()
    drawn_wait_s = time.perf_counter() - t0
    if "error" in drawn:
        raise drawn["error"]
    ds, gen_s = drawn["ds"], drawn["ds_s"]
    X, Q = ds.X, ds.Q
    # the exact distances of the queries to every row give the ground
    # truth of any prefix (the first N_RULES rows, the rows visible to a
    # served request) or subset (the live shards of the replica tier)
    t0 = time.perf_counter()
    d2 = distances64(X, Q, dev)
    gt = nearest(d2)
    log("data", shape=list(X.shape), nq=int(Q.shape[0]), gen_s=gen_s,
        drawn_during="placement", waited_after_placement_s=drawn_wait_s,
        ground_truth_s=time.perf_counter() - t0)

    pdsp = phase_graph(X, Q, gt, dev)
    t0 = time.perf_counter()
    sess, res, rec = run_method(X, Q, gt, "PDScanning+", dev, fitted=pdsp)
    log("main", **rec, phase_s=time.perf_counter() - t0)
    check(rec["recall_at_10"] == 1.0, "PDScanning+ recall@10 below 1.0")
    check(rec["uncertified_queries"] == 0.0, "PDScanning+ left queries "
          "uncertified")
    check(rec["launches_per_batch"]["dco_scan"] > 0,
          "the main path launched no dco_scan kernel")
    agree, inline_ids = inline_agreement(sess, Q, res, dev)
    log("kernel_vs_inline", method="PDScanning+", id_agreement=agree,
        inline_recall_at_10=recall_at_k(inline_ids, gt))
    check(agree == 1.0, "PDScanning+ ids differ between the kernel and the "
          "inline screen")
    # the PDX layout serves the same fitted method: hold one layout at a
    # time, so the flat session goes first
    pdsp, flat_ids, flat_dists, flat_rec = (sess.method, res.ids, res.dists,
                                            rec)
    # A22: the sessions the profile phase profiles stay alive until it
    # (about 32 GB of the card in all) instead of being built again there
    kept = {"dco_scan": (sess, res)}
    del sess, res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sess, res, rec = run_method(X, Q, gt, "PDScanning+", dev, fitted=pdsp,
                                schedule=SchedulePolicy(dim_groups=4))
    log("pdx", **rec, flat_dims_read_mean=flat_rec["dims_read_mean"],
        flat_device_bytes_held=flat_rec["device_bytes_held"],
        flat_layout_bytes=flat_rec["layout_bytes"],
        flat_qps=flat_rec["qps"], phase_s=time.perf_counter() - t0)
    check(rec["recall_at_10"] == 1.0, "PDX PDScanning+ recall@10 below 1.0")
    check(rec["uncertified_queries"] == 0.0,
          "PDX PDScanning+ left queries uncertified")
    check(rec["launches_per_batch"]["dco_scan_grouped"] > 0
          and rec["launches_per_batch"]["dco_scan"] == 0,
          "the PDX path did not run through dco_scan_grouped alone")
    check(np.array_equal(np.sort(res.ids, 1), np.sort(flat_ids, 1)),
          "PDX PDScanning+ ids differ from the flat path's")
    pdx_rec = rec
    kept["dco_scan_grouped"] = (sess, res)
    del sess, res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sess, res, rec = run_method(X, Q, gt, "DDCopq", dev, fitted=drawn["opq"])
    rec.update(fit_s=drawn["opq_s"], fit_during="placement")
    log("main", **rec, phase_s=time.perf_counter() - t0)
    check(rec["launches_per_batch"]["pq_lookup"] > 0,
          "the main path launched no pq_lookup kernel")
    check(rec["codes_dtype"] == "torch.uint8",
          "DDCopq's codes are not held as uint8 at K = 256")
    # DDCopq is an estimator whose recall falls with corpus size (the
    # reference package's does too: scripts/ddcopq_recall_scaling.py), so
    # the 0.9 bar is reported, met or not, and the check is that the
    # kernel screens as the plain gather does on the same fitted state
    log("recall_bar", method="DDCopq", required_recall_at_10=0.9,
        recall_at_10=rec["recall_at_10"], met=rec["recall_at_10"] >= 0.9)
    agree, inline_ids = inline_agreement(sess, Q, res, dev)
    inline_recall = recall_at_k(inline_ids, gt)
    log("kernel_vs_inline", method="DDCopq", id_agreement=agree,
        inline_recall_at_10=inline_recall)
    check(agree >= 0.99 and abs(inline_recall - rec["recall_at_10"]) <= 0.01,
          "DDCopq results differ between pq_lookup and the plain gather")
    opq, opq_rec, opq_ids = sess.method, rec, res.ids
    kept["pq_lookup"] = (sess, res)
    del sess, res, ds
    torch.cuda.empty_cache()

    ivf, ivf_recs = phase_ivf(X, Q, gt, pdsp, opq, dev, kept,
                              built=(drawn["ivf"], drawn["ivf_s"]))
    Xr = np.ascontiguousarray(X[:N_RULES])
    gt_r = nearest(d2[:, :N_RULES])
    phase_delta(X, Q, gt, Xr, gt_r, pdsp, dev)
    ts_rec = phase_two_stage(X, Q, gt, pdsp, flat_ids, dev, kept)
    Qo, d2o, ada_recs = phase_adaptive(X, Q, gt, pdsp, opq, opq_ids,
                                       (flat_ids, flat_dists, flat_rec), dev,
                                       kept)
    any_rec = phase_anytime(X, Q, gt, pdsp, dev)
    phase_host(Xr, Q, gt_r, dev)
    phase_guardrails(Xr, dev, drift=(drawn["drift"], drawn["drift_s"]))

    # A6: the serving front, the replica tier and snapshots
    sess, serve_rec = phase_serving(X, Q, d2, pdsp, dev)
    phase_serving_overload(sess, Q, d2,
                           serve_rec["calibration"]["steady_step_s"], dev)
    del sess
    torch.cuda.empty_cache()
    phase_serving_ood(X, Q, Qo, d2, d2o, pdsp, dev)
    del d2o
    replica_rec = phase_replica(X, Q, d2, flat_ids, Xr, dev)
    log("replica_done", seconds=replica_rec["phase_s"])
    phase_persist(Xr, Q, d2, dev)
    del d2

    t0 = time.perf_counter()
    snap_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_snap_")
    snap_dir = Path(snap_tmp.name)
    fd_ids = None
    for method in ("FDScanning", "PDScanning", "PDScanning+", "ADSampling",
                   "DADE", "DDCres", "DDCpca", "DDCopq"):
        sess, res, rec = run_method(Xr, Q, gt_r, method, dev)
        log("rules", **rec)
        if method == "FDScanning":
            fd_ids = np.sort(res.ids, 1)
        check_rule(sess.method, res, rec, fd_ids, gt_r)
        if method == "DDCopq":      # the mesh phase's DDCopq arm loads it
            sess.save(str(snap_dir / "ddcopq_100k.bin"))
        if method in ("FDScanning", "DDCopq"):      # no PDX layout
            del sess, res
            continue
        fitted = sess.method
        del sess, res
        sess, res, rec = run_method(Xr, Q, gt_r, method, dev, fitted=fitted,
                                    schedule=SchedulePolicy(dim_groups=4))
        log("rules", **rec)
        check_rule(fitted, res, rec, fd_ids, gt_r)
        check(rec["launches_per_batch"]["dco_scan_grouped"] > 0
              and rec["launches_per_batch"]["dco_scan"] == 0,
              f"{method} at dim_groups=4 did not run dco_scan_grouped alone")
        if method == "PDScanning+":
            # the inline R-cut path on the card: its certified queries
            # return the kernel path's ids
            kernel_ids = res.ids
            del sess, res
            sess, res, rec = run_method(
                Xr, Q, gt_r, method, dev, fitted=fitted,
                schedule=SchedulePolicy(dim_groups=4, use_kernel=False))
            log("rules", **rec)
            check_rule(fitted, res, rec, fd_ids, gt_r)
            ok = ~res.stats.extra["uncertified_mask"]
            check(np.array_equal(res.ids[ok], kernel_ids[ok]),
                  "PDX R-cut ids differ from the kernel path's on certified "
                  "queries")
        del sess, res, fitted
    log("rules_done", seconds=time.perf_counter() - t0)

    # A7 and A8: the sharded top-k as rank processes, the screened decode
    # attention; the attention phase's profiler session comes after its
    # walls, and only the profile phase follows it
    mesh_rec = phase_mesh(X, Q, snap_dir / "ddcopq_100k.bin", flat_ids,
                          flat_dists, flat_rec, dev)
    snap_tmp.cleanup()
    del X
    phase_attention(dev)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = {}
    for kernel, rec, timer in (
            ("dco_scan", flat_rec, time_dco_scan),
            ("dco_scan_grouped", pdx_rec, time_dco_scan_grouped),
            ("pq_lookup", opq_rec,
             lambda sess, Q, res, dev: time_pq_lookup(sess, Q, dev))):
        sess, res = kept.pop(kernel)
        log("profile", method=rec["method"], dim_groups=rec["dim_groups"],
            **profile_batch(sess, Q, float(np.median(rec["search_walls_s"]))))
        if kernel == "dco_scan":    # the fixed screen on the OOD batch
            sess.search(Qo, K)
            log("profile", method="PDScanning+", label="fixed_ood",
                **profile_batch(sess, Qo, float(np.median(
                    ada_recs["ood"]["fixed"]["search_walls_s"]))))
        t_timer = time.perf_counter()
        rows[kernel] = dict(launches=rec["launches_per_batch"][kernel],
                            **timer(sess, Q, res, dev))
        log("kernel_timing_done", kernel=kernel,
            seconds=time.perf_counter() - t_timer)
        del sess, res
        torch.cuda.empty_cache()
    for label, rec in (("ivf", ivf_recs["flat"]),
                       ("ivf_default_budget", ivf_recs["flat_default_budget"]),
                       ("two_stage", ts_rec)):
        sess, _ = kept.pop(label)
        log("profile", method="PDScanning+", label=label,
            **profile_batch(sess, Q,
                            float(np.median(rec["search_walls_s"]))))
        del sess
        torch.cuda.empty_cache()
    # the adaptive arms: the switching walk (in distribution), the
    # full-scan body (OOD) beside the fixed screen and FDScanning on the
    # same OOD batch, and DDCopq's switching walk with pq_lookup
    # (one adaptive session serves both PDScanning+ batches)
    for label, session, Qx, rec in (
            ("adaptive_id", "adaptive", Q, ada_recs["id"]),
            ("adaptive_ood", "adaptive", Qo, ada_recs["ood"]),
            ("adaptive_ddcopq", "adaptive_ddcopq", Q, ada_recs["ddcopq"])):
        sess, _ = kept[session]
        if Qx is Qo:
            sess.search(Qx, K)                  # the OOD batch's graphs
        log("profile", method=rec["method"], label=label,
            **profile_batch(sess, Qx,
                            float(np.median(rec["search_walls_s"]))))
        del sess
    kept.clear()
    torch.cuda.empty_cache()
    log("profile_done", seconds=time.perf_counter() - t0)
    phase_lm_profile(dev, lm_rec, encdec_rec, ssm_rec, moe_rec, hybrid_rec,
                     train_rec)

    # launches on the IVF, adaptive, anytime and serving paths of each
    # kernel, beside the main path's
    for kernel, label, ada_label in (("dco_scan", "flat", "id"),
                                     ("dco_scan_grouped", "pdx", "id_pdx"),
                                     ("pq_lookup", "DDCopq", "ddcopq")):
        rows[kernel]["launches_ivf"] = \
            ivf_recs[label]["launches_per_batch"][kernel]
        rows[kernel]["launches_adaptive"] = \
            ada_recs[ada_label]["launches_per_batch"][kernel]
    rows["dco_scan"]["launches_anytime"] = \
        any_rec["dco_scan_launches_per_batch"]
    rows["dco_scan_grouped"]["launches_anytime"] = \
        any_rec["pdx"]["dco_scan_grouped_launches_per_batch"]
    rows["pq_lookup"]["launches_anytime"] = \
        ada_recs["ddcopq"]["anytime"]["pq_lookup_launches"]
    # each rank's launches on a 100-query batch of the 2-rank 1M mesh
    rows["dco_scan"]["launches_mesh_per_rank"] = \
        mesh_rec["gloo_1m"][0]["dco_scan_launches_per_batch"]
    # ... and on each 16-query dispatch of the replica tier over it
    rows["dco_scan"]["launches_mesh_tier_per_dispatch"] = \
        mesh_rec["tier_1m"][0]["dco_scan_launches_per_dispatch"]
    # a 16-query step of the fixed serving arm (the median over its steps)
    for kernel in rows:
        rows[kernel]["launches_serving"] = \
            serve_rec["launches_per_step"][kernel]
    kernels = [
        dict(name="dco_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/dco_scan.cu",
             replaces="src/repro/kernels/dco_scan.py:111",
             **rows["dco_scan"]),
        dict(name="pq_lookup", route="cuda",
             source="src/repro_torch/kernels/csrc/pq_lookup.cu",
             replaces="src/repro/kernels/pq_lookup.py:36",
             **rows["pq_lookup"]),
        dict(name="dco_scan_grouped", route="cuda",
             source="src/repro_torch/kernels/csrc/dco_scan.cu",
             replaces="src/repro/kernels/dco_scan.py:144",
             **rows["dco_scan_grouped"]),
    ]
    log("done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

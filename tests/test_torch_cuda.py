"""The port's CUDA kernels against their plain PyTorch versions on the
card, the paths that launch them on new inputs (a launch no query
probes, the IVF streaming scan, a delta session) against the CPU or a
merged session, the block walk captured as a CUDA graph against the same
walk run eagerly on the card, the top-k selection against a stable
sort, the serving front, snapshots and shard tier on the card, and the
LM decoders and their engine on the card against the CPU, the MoE
layer's two paths and MLA's two forms against each other on the card,
and the training path: the f32-result GEMMs' backward against the
widened form, a routed train step on the card against the CPU, and
remat against none.
These tests need a CUDA card and skip without one; the module imports no
jax, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import dco_scan as dco_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pq_lookup as pq_mod

DCO_CASES = [(256, 128, 128), (300, 17, 130), (64, 8, 96), (1000, 5, 256),
             (128, 1, 32), (4096, 16, 128)]
#: (n, q, m, k, code dtype): the main path's shape, ragged n, query counts
#: that are not a multiple of the queries a block stages (130 at 4096 rows
#: stages 7 a block), M in {4, 8, 16}, K in {16, 64, 256} in both code
#: dtypes, and K = 512 (int32 only)
PQ_CASES = [(*shape, dtype)
            for shape in ((300, 9, 16, 256), (128, 8, 8, 64), (65, 3, 4, 16),
                          (4096, 16, 16, 256), (1000, 21, 4, 16),
                          (65, 3, 4, 256), (4096, 130, 16, 16))
            for dtype in (torch.int32, torch.uint8)] + [
    (4096, 16, 16, 512, torch.int32), (300, 7, 4, 512, torch.int32)]
#: (n, q, G, dg, d1): the PDX main path's shape (4 groups of 32), ragged
#: dg (not a multiple of the kernel's 32-dim slice, down to 1), a ragged
#: last group, G = 5, and G = 1
GROUPED_CASES = [(4096, 16, 4, 32, 128), (300, 17, 4, 10, 38),
                 (257, 128, 5, 33, 161), (64, 5, 3, 1, 3),
                 (1000, 16, 1, 48, 48)]


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode()) % 2 ** 31


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")



@pytest.mark.cuda
@pytest.mark.parametrize("n,q,d1", DCO_CASES)
@pytest.mark.parametrize("kind", ["lb", "adsampling", "ratio"])
def test_dco_scan_kernel_matches_plain(cuda_device, n, q, d1, kind):
    """Integer-valued inputs make every sum exact in float32, so the kernel
    and the plain version agree bit for bit whatever their summation
    order."""
    rng = np.random.default_rng(_seed("cuda", n, q, d1, kind))
    x = rng.integers(-4, 5, (n, d1)).astype(np.float32)
    qq = rng.integers(-4, 5, (q, d1)).astype(np.float32)
    tau = rng.uniform(d1 * 2.0, d1 * 10.0, q).astype(np.float32)
    tau[::5] = -1.0                       # padded queries prune everything
    sc = ref.make_dco_scales(kind, d1, 128, D=2 * d1, theta=0.8,
                             device=cuda_device)
    xt, qt, taut = _t(x, qq, tau, device=cuda_device)
    nr = torch.tensor([n - n // 7], dtype=torch.int32, device=cuda_device)
    before = dco_mod.launches
    got = ops.dco_scan_op(xt, qt, taut, sc, nr)
    assert dco_mod.launches == before + 1
    want = ops.dco_scan_op(xt.cpu(), qt.cpu(), taut.cpu(), sc.cpu(), nr.cpu())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,m,k,dtype", PQ_CASES)
def test_pq_lookup_kernel_matches_plain(cuda_device, n, q, m, k, dtype):
    """uint8 codes (the engine's storage at K <= 256) and int32 codes give
    the int32 plain version's sums."""
    rng = np.random.default_rng(_seed("cuda", n, q, m, k))
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    lut = rng.standard_normal((q, m, k)).astype(np.float32)
    before = pq_mod.launches
    got = ops.pq_lookup_op(torch.as_tensor(codes, device=cuda_device).to(
        dtype), torch.as_tensor(lut, device=cuda_device))
    assert pq_mod.launches == before + 1
    want = ops.pq_lookup_op(*_t(codes, lut))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,lo,hi", [(torch.uint8, 0, 64),
                                         (torch.int32, -8, 24)])
def test_pq_lookup_kernel_out_of_range_codes_add_nothing(cuda_device, dtype,
                                                         lo, hi):
    """A code outside [0, K) adds nothing, as the reference's one-hot row of
    zeros does."""
    n, q, m, k = 300, 5, 4, 16
    rng = np.random.default_rng(_seed("cuda-oob", dtype, lo, hi))
    codes = rng.integers(lo, hi, (n, m))
    lut = rng.standard_normal((q, m, k)).astype(np.float32)
    got = ops.pq_lookup_op(
        torch.as_tensor(codes, dtype=dtype, device=cuda_device),
        torch.as_tensor(lut, device=cuda_device)).cpu().numpy()
    ok = (codes >= 0) & (codes < k)
    g = lut[:, np.arange(m)[None, :], np.where(ok, codes, 0)]   # (q, n, m)
    want = np.where(ok[None], g, 0.0).sum(-1).T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def _grouped_inputs(rng, n, q, G, dg, d1, device):
    """Integer-valued x (G, n, dg) and q (G, q, dg) whose dims past d1 are
    zero (the layout's padding), their logical widths, and tau."""
    x = np.zeros((G, n, dg), np.float32)
    qq = np.zeros((G, q, dg), np.float32)
    for g in range(G):
        w = min(dg, d1 - g * dg)
        x[g, :, :w] = rng.integers(-4, 5, (n, w))
        qq[g, :, :w] = rng.integers(-4, 5, (q, w))
    widths = np.array([min(dg, d1 - g * dg) for g in range(G)], np.float32)
    tau = rng.uniform(d1 * 2.0, d1 * 10.0, q).astype(np.float32)
    tau[::5] = -1.0                       # padded queries prune everything
    return _t(x, qq, tau, widths, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,G,dg,d1", GROUPED_CASES)
@pytest.mark.parametrize("kind", ["lb", "adsampling"])
def test_dco_scan_grouped_kernel_matches_plain(cuda_device, n, q, G, dg, d1,
                                               kind):
    """Integer-valued inputs: every float32 sum is exact in any order, so
    the grouped kernel and its plain version agree bit for bit."""
    rng = np.random.default_rng(_seed("cuda-grouped", n, q, G, dg, kind))
    xt, qt, taut, wt = _grouped_inputs(rng, n, q, G, dg, d1, cuda_device)
    sc = ref.make_dco_scales(kind, G * dg, dg, D=2 * d1,
                             device=cuda_device)
    nr = torch.tensor([n - n // 7], dtype=torch.int32, device=cuda_device)
    before = (dco_mod.launches, dco_mod.grouped_launches)
    got = ops.dco_scan_grouped_op(xt, qt, taut, sc, wt, nr)
    assert (dco_mod.launches, dco_mod.grouped_launches) == (
        before[0], before[1] + 1)
    want = ops.dco_scan_grouped_op(xt.cpu(), qt.cpu(), taut.cpu(), sc.cpu(),
                                   wt.cpu(), nr.cpu())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,dg", [(4096, 16, 128), (300, 17, 40)])
def test_dco_scan_grouped_one_group_is_the_flat_kernel(cuda_device, n, q,
                                                       dg):
    """G = 1 at dg == block_d reads the same dims in the same order as the
    flat kernel: Gaussian inputs, all four outputs equal bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(_seed(n, q, dg))
    x = torch.randn(n, dg, device=cuda_device, generator=gen)
    qq = torch.randn(q, dg, device=cuda_device, generator=gen)
    tau = torch.rand(q, device=cuda_device, generator=gen) * 3 * dg
    sc = torch.ones(1, device=cuda_device)
    flat = ops.dco_scan_op(x, qq, tau, sc, block_d=dg)
    grouped = ops.dco_scan_grouped_op(x[None], qq[None], tau, sc,
                                      torch.full((1,), float(dg),
                                                 device=cuda_device))
    torch.cuda.synchronize()
    for f, g in zip(flat, grouped):
        assert torch.equal(f, g)


def _patterned_grouped(pattern, n, q, G, dg, d1, rng):
    """Integer-valued grouped inputs whose liveness after group 0 is set by
    construction: ``all_alive`` (tau above every partial), ``all_dead``
    (every group-0 slice of x is odd and every one of q even, so each pair
    adds at least 1 against tau = 0.5; ``revive`` is the same data, run
    with scales that drop after group 1) or ``one_row`` (as ``all_dead``
    plus one row in each 16-row tile equal to the queries' group-0 slice,
    so it alone stays alive).  Every fifth query has tau = -1."""
    x = np.zeros((G, n, dg), np.float32)
    qq = np.zeros((G, q, dg), np.float32)
    widths = np.array([min(dg, d1 - g * dg) for g in range(G)], np.float32)
    for g in range(G):
        w = int(widths[g])
        x[g, :, :w] = rng.integers(-4, 5, (n, w))
        qq[g, :, :w] = rng.integers(-4, 5, (q, w))
    tau = np.full(q, 0.5, np.float32)
    live_rows = np.zeros(n, bool)
    if pattern == "all_alive":
        tau[:] = 1e9
        live_rows[:] = True
    else:
        w0 = int(widths[0])
        x[0, :, :w0] = 2 * rng.integers(-2, 2, (n, w0)) + 1
        qq[0, :, :w0] = 2 * rng.integers(-2, 3, (1, w0))  # one shared slice
        if pattern == "one_row":
            live_rows[5::16] = True
            x[0, live_rows, :w0] = qq[0, 0, :w0]
    tau[::5] = -1.0
    return x, qq, tau, widths, live_rows


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,G,dg,d1", [(4096, 16, 4, 32, 128),
                                         (300, 17, 3, 10, 27),
                                         (257, 40, 5, 33, 161)])
@pytest.mark.parametrize("pattern", ["all_alive", "all_dead", "one_row",
                                     "revive"])
def test_dco_scan_grouped_kernel_liveness_patterns(cuda_device, pattern, n,
                                                   q, G, dg, d1):
    """Tiles whose pairs are all alive, all dead, or alive in a single row
    after group 0 (the compaction's edge cases), and pairs that come back
    to life at group 2 because the scales drop (their rows were not staged
    after group 0), with tau = -1 queries, ragged nrows, dg and G: bit for
    bit against the plain version."""
    rng = np.random.default_rng(_seed("cuda-pattern", pattern, n, q, G, dg))
    x, qq, tau, widths, live_rows = _patterned_grouped(pattern, n, q, G, dg,
                                                       d1, rng)
    sc = torch.ones(G)
    if pattern == "revive":
        sc[1:] = 2.0 ** -12         # exact: partial * scale stays exact
    nr = torch.tensor([n - n // 7], dtype=torch.int32)
    cpu = _t(x, qq, tau, widths)
    # the construction holds: rows with a live pair entering group 1
    p0 = ops.dco_scan_grouped_op(cpu[0][:1], cpu[1][:1], cpu[2], sc[:1],
                                 cpu[3][:1])[0]
    alive1 = (p0 <= cpu[2][None, :]).any(1).numpy()
    np.testing.assert_array_equal(alive1, live_rows)
    got = ops.dco_scan_grouped_op(*(t.to(cuda_device) for t in cpu[:3]),
                                  sc.to(cuda_device), cpu[3].to(cuda_device),
                                  nr.to(cuda_device))
    want = ops.dco_scan_grouped_op(*cpu[:3], sc, cpu[3], nr)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    if pattern == "revive":         # some pairs did enter group 2
        assert float(want[3].sum()) > float(
            widths[0] * (n - n // 7) * (tau >= 0).sum())


#: (n, q, d1, block_n): the engine's block_n = 256 (the fill-free cluster
#: path) and 64 (a 2-block cluster), and 24, 40, 48 (tiles that span row
#: blocks) and 512 (more than 8 tiles a row block) on the atomic path;
#: ragged n, and nd > 1 at d1 = 130 and 256
FLAT_BLOCK_N_CASES = [(4096 - 333, 16, 128, 256), (300, 17, 130, 256),
                      (1000, 5, 256, 256), (700, 16, 96, 64),
                      (700, 16, 96, 48), (1000, 17, 130, 24),
                      (333, 9, 256, 40), (1500, 33, 130, 512),
                      (4096, 16, 128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,d1,block_n", FLAT_BLOCK_N_CASES)
def test_dco_scan_kernel_block_n_paths(cuda_device, n, q, d1, block_n):
    """Both ways counts and dims are written (stored by a cluster a row
    block, or added to a zero fill with atomics) give the plain version's
    four outputs bit for bit on integer-valued inputs."""
    rng = np.random.default_rng(_seed("cuda-block-n", n, q, d1, block_n))
    x = rng.integers(-4, 5, (n, d1)).astype(np.float32)
    qq = rng.integers(-4, 5, (q, d1)).astype(np.float32)
    tau = rng.uniform(d1 * 2.0, d1 * 10.0, q).astype(np.float32)
    tau[::5] = -1.0
    sc = ref.make_dco_scales("adsampling", d1, 128, D=2 * d1,
                             device=cuda_device)
    xt, qt, taut = _t(x, qq, tau, device=cuda_device)
    nr = torch.tensor([n - n // 7], dtype=torch.int32, device=cuda_device)
    assert dco_mod.fill_free(block_n) == (block_n in (64, 256))
    got = ops.dco_scan_op(xt, qt, taut, sc, nr, block_n=block_n)
    want = dco_mod.dco_scan_plain(xt, qt, taut, sc, ops._widths(
        d1, 128, cuda_device), nr, block_n=block_n, block_d=128)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,G,d1", [(4096, 16, 2, 256), (300, 17, 3, 300),
                                      (257, 40, 3, 330)])
@pytest.mark.parametrize("pattern", ["all_alive", "all_dead", "one_row",
                                     "revive"])
def test_dco_scan_kernel_liveness_patterns(cuda_device, pattern, n, q, G,
                                           d1):
    """The grouped liveness patterns laid out flat (dim block b of 128 dims
    = group b): tiles all alive, all dead after dim block 0 (the tile-level
    skip fires), alive in one row in 16, and pairs that come back
    to life when the scales drop; tau = -1 queries and ragged nrows: bit
    for bit against the plain version."""
    rng = np.random.default_rng(_seed("cuda-flat-pattern", pattern, n, q, G))
    xg, qg, tau, _, live_rows = _patterned_grouped(pattern, n, q, G, 128, d1,
                                                   rng)
    x = np.ascontiguousarray(xg.transpose(1, 0, 2).reshape(n, -1)[:, :d1])
    qq = np.ascontiguousarray(qg.transpose(1, 0, 2).reshape(q, -1)[:, :d1])
    sc = torch.ones(G)
    if pattern == "revive":
        sc[1:] = 2.0 ** -12
    nr = torch.tensor([n - n // 7], dtype=torch.int32)
    cpu = _t(x, qq, tau)
    p0 = ops.dco_scan_op(cpu[0][:, :128], cpu[1][:, :128], cpu[2], sc[:1],
                         block_d=128)[0]
    np.testing.assert_array_equal(
        (p0 <= cpu[2][None, :]).any(1).numpy(), live_rows)
    got = ops.dco_scan_op(*(t.to(cuda_device) for t in cpu),
                          sc.to(cuda_device), nr.to(cuda_device))
    want = ops.dco_scan_op(*cpu, sc, nr)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("block_n,ops_expected", [(256, 1), (512, 2)])
def test_dco_scan_op_device_operations(cuda_device, block_n, ops_expected):
    """One dco_scan_op call at the main path's shape (4096 x 16 x 128), with
    nrows a device int32 tensor and the scales a contiguous f32 tensor of
    length nd, as the engine passes them, runs the kernel alone at the
    engine's block_n = 256 (no zero fill), and the fill plus the kernel at
    block_n = 512."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(_seed("ops", 1))
    x = torch.randn(4096, 128, device=cuda_device, generator=gen)
    qq = torch.randn(16, 128, device=cuda_device, generator=gen)
    tau = torch.rand(16, device=cuda_device, generator=gen) * 300
    sc = torch.ones(1, device=cuda_device)
    nr = torch.tensor([4096], dtype=torch.int32, device=cuda_device)
    ops.dco_scan_op(x, qq, tau, sc, nr, block_n=block_n)   # build, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.dco_scan_op(x, qq, tau, sc, nr, block_n=block_n)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.key for e in prof.key_averages()
             for _ in range(e.count)
             if getattr(e, "device_type", None) == cuda]
    assert len(names) == ops_expected, names
    assert any("dco_scan_flat_kernel" in k for k in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_all_unprobed_launch_matches_plain(cuda_device, grouped):
    """A block no query of the chunk probes: every tau is -1, as the IVF
    gate sets it.  At the main path's shape (4096 x 16 x 128; PDX 4 groups
    of 32) the launch gives its plain version's outputs bit for bit, with
    keep, counts and dims all zero."""
    rng = np.random.default_rng(_seed("cuda-unprobed", grouped))
    n, q, d1 = 4096, 16, 128
    tau = torch.full((q,), -1.0, device=cuda_device)
    nr = torch.tensor([n], dtype=torch.int32, device=cuda_device)
    if grouped:
        G, dg = 4, 32
        xt, qt, _, wt = _grouped_inputs(rng, n, q, G, dg, d1, cuda_device)
        sc = torch.ones(G, device=cuda_device)
        before = dco_mod.grouped_launches
        got = ops.dco_scan_grouped_op(xt, qt, tau, sc, wt, nr)
        assert dco_mod.grouped_launches == before + 1
        want = dco_mod.dco_scan_grouped_plain(xt, qt, tau, sc, wt, nr,
                                              block_n=256)
    else:
        xt, qt = _t(rng.integers(-4, 5, (n, d1)).astype(np.float32),
                    rng.integers(-4, 5, (q, d1)).astype(np.float32),
                    device=cuda_device)
        sc = torch.ones(1, device=cuda_device)
        before = dco_mod.launches
        got = ops.dco_scan_op(xt, qt, tau, sc, nr, block_n=256)
        assert dco_mod.launches == before + 1
        want = dco_mod.dco_scan_plain(xt, qt, tau, sc,
                                      ops._widths(d1, 128, cuda_device), nr,
                                      block_n=256, block_d=128)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, keep, counts, dims = got
    assert not keep.any() and not counts.any() and not dims.any()


def _ivf_layout(rng, n, D, d1, n_list):
    """Integer-valued rows (every float32 sum exact, so the card and the
    CPU agree bit for bit) laid out partition-major over ``n_list``
    partitions of uneven size."""
    from repro_torch.core.torch_engine import build_device_state
    X = rng.integers(-4, 5, (n, D)).astype(np.float32)
    part = np.sort(rng.integers(0, n_list, n))
    perm = rng.permutation(n)            # ids are not the row order
    st = build_device_state({"Xrot": X[perm]}, d1, "cpu")
    st["row_ids"] = torch.as_tensor(perm.astype(np.int32))
    st["row_part"] = torch.as_tensor(part.astype(np.int32))
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4])
def test_ivf_stream_topk_card_matches_cpu(cuda_device, groups):
    """IVF stream_topk on the card (the CUDA kernels) against the same call
    on the CPU (their plain versions): all six outputs equal."""
    from repro_torch.core.stream_engine import stream_topk
    from repro_torch.core.torch_engine import DcoEngineConfig
    rng = np.random.default_rng(_seed("cuda-ivf", groups))
    n, D, d1, n_list, nq = 3000, 64, 32, 12, 21
    st = _ivf_layout(rng, n, D, d1, n_list)
    Q = rng.integers(-4, 5, (nq, D)).astype(np.float32)
    probe = np.stack([rng.choice(n_list, 3, replace=False)
                      for _ in range(nq)]).astype(np.int32)
    cfg = DcoEngineConfig(kind="lb", d1=d1, k=10, query_chunk=8,
                          row_block=512, block_capacity=512,
                          use_kernel=True, dim_groups=groups)
    args = (Q[:, :d1], Q[:, d1:], probe)
    want = stream_topk(st, *(torch.as_tensor(a) for a in args[:2]), cfg,
                       probe=torch.as_tensor(args[2]))
    launches = (dco_mod.launches, dco_mod.grouped_launches)
    got = stream_topk({k: v.to(cuda_device) for k, v in st.items()},
                      *(torch.as_tensor(a, device=cuda_device)
                        for a in args[:2]), cfg,
                      probe=torch.as_tensor(args[2], device=cuda_device))
    torch.cuda.synchronize()
    assert (dco_mod.grouped_launches if groups > 1 else dco_mod.launches) > (
        launches[1] if groups > 1 else launches[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("index,groups", [("flat", 1), ("flat", 4),
                                          ("ivf", 1)])
def test_delta_session_card_matches_merged(cuda_device, index, groups):
    """A session on the card after a delta add answers as a session freshly
    materialized on the same fitted method (IVF at nprobe = n_list)."""
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1536, 48)).astype(np.float32)
    Q = rng.normal(size=(12, 48)).astype(np.float32)
    pol = SchedulePolicy(d1=24, query_chunk=4, row_block=256,
                         block_capacity=256, dim_groups=groups)
    params = {"n_list": 16} if index == "ivf" else None
    sess = open_index(X[:1200], index=index, method="PDScanning+",
                      schedule=pol, index_params=params, device=cuda_device)
    sess.search(Q, 10, nprobe=16)
    sess.add(X[1200:])
    assert sess.last_write_mode == "delta"
    rd = sess.search(Q, 10, nprobe=16)
    assert sess.backend._delta_blocks["xl"].is_cuda
    merged = SearchSession(sess.method, pol, index_kind=index,
                           index=sess.index, device=cuda_device)
    rm = merged.search(Q, 10, nprobe=16)
    np.testing.assert_array_equal(rd.ids, rm.ids)
    np.testing.assert_allclose(rd.dists, rm.dists, rtol=1e-5, atol=1e-5)
    assert not rd.stats.extra["uncertified_mask"].any()


# ---------------------------------------------------- the captured walk ---
def _graph_session(index, method, groups=1, n=1536, D=48, seed=0):
    """A small session on the card: integer-valued rows, so every float32
    sum is exact and the eager walk and the graph must agree bit for
    bit; IVF at the default completion budget (128)."""
    from repro_torch.api import SchedulePolicy, open_index
    rng = np.random.default_rng(_seed("cuda-graph", index, method, groups))
    X = rng.integers(-4, 5, (n, D)).astype(np.float32)
    Q = rng.integers(-4, 5, (8, D)).astype(np.float32)
    pol = SchedulePolicy(d1=24, query_chunk=4, row_block=256,
                         dim_groups=groups)
    params = {"n_list": 16} if index == "ivf" else None
    sess = open_index(X[:1200], index=index, method=method, schedule=pol,
                      index_params=params, device="cuda", seed=seed)
    return sess, X, Q


def _engine_args(sess, Q, nprobe=4):
    """The arguments the backend hands stream_topk for ``Q``."""
    be = sess.backend
    dev = be.device

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=dev)

    ql, qt, qe = be._prep_queries(Q)
    probe = None
    if sess.index_kind == "ivf":
        probe = t(be._probe(Q, nprobe)[0], np.int32)
    blocks, st = be._blocks, be._state
    if be.delta_rows:
        blocks, st = be._delta_blocks, be._delta_state
    return (st, t(ql), t(qt), be._config(10), {k: t(v) for k, v in
                                              qe.items()}, probe, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat", "pdx", "ddcopq", "ivf", "delta"])
def test_graph_replay_equals_eager_walk(cuda_device, case):
    """stream_topk on the card (one captured walk, replayed per chunk)
    against the eager walk of the same chunks on the card: all six outputs
    (dists, ids, survivors, passed, dropped_min_est, dims) equal, and the
    replays count each chunk's kernel launches."""
    from repro_torch.core import stream_engine as se
    method = "DDCopq" if case == "ddcopq" else "PDScanning+"
    sess, X, Q = _graph_session("ivf" if case == "ivf" else "flat", method,
                                groups=4 if case == "pdx" else 1)
    sess.search(Q, 10, nprobe=4)
    if case == "delta":
        sess.add(X[1200:1300])
        assert sess.last_write_mode == "delta"
        sess.search(Q, 10)
    st, ql, qt, cfg, qe, probe, blocks = _engine_args(sess, Q)
    graphs = {}
    got = se.stream_topk(st, ql, qt, cfg, qe, probe, blocks=blocks,
                         graphs=graphs)
    want = se._stream_topk_padded(st, blocks, ql, qt, qe, probe, cfg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (graph,) = graphs.values()
    kernel = {"pdx": 1, "ddcopq": 2}.get(case, 0)
    n_blocks = blocks["xl"].shape[0]
    assert graph.launches[kernel] == n_blocks
    assert sum(graph.launches) == n_blocks
    before = se._launch_counts()
    again = se.stream_topk(st, ql, qt, cfg, qe, probe, blocks=blocks,
                           graphs=graphs)
    after = se._launch_counts()
    assert after[kernel] - before[kernel] == 2 * n_blocks    # 2 chunks
    assert len(graphs) == 1
    for g, w in zip(again, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_graph_cache_follows_the_layout(cuda_device):
    """The backend keeps its graphs with its layout: an add() into the
    delta segment makes the next search capture a new graph over the
    combined layout (and answer as a freshly opened session), and
    invalidate() leaves no graph behind."""
    from repro_torch.api import SearchSession
    sess, X, Q = _graph_session("flat", "PDScanning+")
    be = sess.backend
    sess.search(Q, 10)
    assert len(be._graphs) == 1
    (first,) = be._graphs.values()
    assert first.keep[1] is be._blocks
    sess.add(X[1200:1300])
    res = sess.search(Q, 10)
    (graph,) = be._graphs.values()
    assert graph is not first and graph.keep[1] is be._delta_blocks
    fresh = SearchSession(sess.method, sess.policy, device="cuda")
    want = fresh.search(Q, 10)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.dists, want.dists)
    be.invalidate()
    assert be._graphs == {}
    again = sess.search(Q, 10)
    np.testing.assert_array_equal(again.ids, want.ids)
    assert len(be._graphs) == 1


@pytest.mark.cuda
def test_graph_ragged_batch_matches_cpu(cuda_device):
    """A batch whose row count is not a whole number of chunks (7 queries,
    chunks of 4) on the card: the rows of the aligned batch of 8, exactly
    (each query's walk is its own: ids, distances, certificate flags),
    and the CPU session's ids."""
    from repro_torch.api import SearchSession
    sess, _, Q = _graph_session("flat", "PDScanning+")
    got = sess.search(Q[:7], 10)
    aligned = sess.search(Q, 10)
    np.testing.assert_array_equal(got.ids, aligned.ids[:7])
    np.testing.assert_array_equal(got.dists, aligned.dists[:7])
    np.testing.assert_array_equal(got.stats.extra["uncertified_mask"],
                                  aligned.stats.extra["uncertified_mask"][:7])
    cpu = SearchSession(sess.method, sess.policy, device="cpu")
    want = cpu.search(Q[:7], 10)
    np.testing.assert_array_equal(got.ids, want.ids)
    # the rotated queries are not integer-valued: sums in another order
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width,n", [(138, 10), (4096, 129), (4106, 10),
                                     (2 ** 20, 2048)])
def test_smallest_agrees_with_stable_sort_on_the_card(cuda_device, width, n):
    """The selection on the card against a stable ascending sort, on score
    rows shaped as the engine's (estimates with ties, +inf where screened
    out, no signed zeros): the same values and columns."""
    from repro_torch.core.stream_engine import _smallest
    rng = np.random.default_rng(_seed("cuda-smallest", width, n))
    a = rng.integers(0, 50, (16, width)).astype(np.float32) / 8
    a[rng.random(a.shape) < 0.6] = np.inf
    at = torch.as_tensor(a, device=cuda_device)
    vals, idx = _smallest(at, n)
    svals, sidx = torch.sort(at, dim=1, stable=True)
    assert torch.equal(idx, sidx[:, :n])
    assert torch.equal(vals, svals[:, :n])


# ------------------------------------- the adaptive and anytime walks ---
def _mixed_queries(sess, X, Q):
    """Four in-distribution queries, then four out-of-distribution ones
    (chunks of 4): the seed sends the chunks down different bodies."""
    from repro_torch.vecdata import make_ood_queries
    ood = make_ood_queries(X[:1200], 4, severity=1.0, seed=5)
    return np.concatenate([Q[:4], np.round(ood)]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat", "pdx", "ddcopq", "ivf",
                                  "forced"])
def test_adaptive_graph_equals_eager_walk(cuda_device, case):
    """The adaptive batch on the card (the switching walk and the
    full-scan body, each a captured graph a chunk) against the same
    chunks walked eagerly on the card: the six outputs and the report
    equal; adaptive flat and PDX launch no dco_scan kernel (the inline
    screen), adaptive DDCopq launches pq_lookup in every block, the
    full-scan body launches none."""
    import dataclasses

    from repro_torch.api import SchedulePolicy, SearchSession
    from repro_torch.core import stream_engine as se
    from repro_torch.core.policy import PolicyConfig
    method = "DDCopq" if case == "ddcopq" else "PDScanning+"
    sess, X, Q = _graph_session("ivf" if case == "ivf" else "flat", method,
                                groups=4 if case == "pdx" else 1)
    pol = dataclasses.replace(sess.policy, adaptive=True)
    sess = SearchSession(sess.method, pol, index_kind=sess.index_kind,
                         index=sess.index, device="cuda")
    Q = _mixed_queries(sess, X, Q)
    sess.search(Q, 10, nprobe=4)
    st, ql, qt, cfg, qe, probe, blocks = _engine_args(sess, Q)
    if case == "forced":
        cfg = dataclasses.replace(cfg, policy=PolicyConfig(
            force_fallback=True))
    assert cfg.use_kernel == (case == "ddcopq")
    graphs = {}
    before = se._launch_counts()
    got = se.stream_topk(st, ql, qt, cfg, qe, probe, blocks=blocks,
                         graphs=graphs)
    again = se.stream_topk(st, ql, qt, cfg, qe, probe, blocks=blocks,
                           graphs=graphs)
    after = se._launch_counts()
    want = se._adaptive_topk(st, blocks, ql, qt, qe, probe, cfg, 8, None)
    torch.cuda.synchronize()
    for out in (got, again):
        for g, w in zip(out[:6], want[:6]):
            assert torch.equal(g, w)
        for key in want[6]:
            assert torch.equal(out[6][key], want[6][key]), key
    n_blocks = blocks["xl"].shape[0]
    launched = [a - b for a, b in zip(after, before)]
    assert launched[0] == launched[1] == 0          # no dco_scan kernels
    if case == "ddcopq":
        # the capture's eager warm-up walks each new graph's chunk once
        assert launched[2] >= 4 * n_blocks
    else:
        assert launched[2] == 0
    if case == "forced":
        assert all(key[4] for key in graphs)         # every graph forced
        assert torch.equal(want[6]["fallback_blocks"],
                           torch.full_like(want[6]["fallback_blocks"],
                                           n_blocks))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flat", "pdx", "ddcopq", "ivf"])
def test_anytime_groups_equal_the_one_shot_walk(cuda_device, case):
    """The anytime walk on the card, replayed a graph a group span (the
    ragged last group its own key) and eagerly: with a deadline that does
    not fire, the one-shot walk's six outputs bit for bit, coverage 1.0,
    and the kernel launches of every block."""
    from repro_torch.core import stream_engine as se
    method = "DDCopq" if case == "ddcopq" else "PDScanning+"
    sess, X, Q = _graph_session("ivf" if case == "ivf" else "flat", method,
                                groups=4 if case == "pdx" else 1)
    sess.search(Q, 10, nprobe=4)
    st, ql, qt, cfg, qe, probe, blocks = _engine_args(sess, Q)
    want = se.stream_topk(st, ql, qt, cfg, qe, probe, blocks=blocks,
                          graphs={})
    graphs = {}
    got = se.stream_topk(st, ql, qt, cfg, qe, probe, blocks=blocks,
                         deadline_ts=1e18, block_group=2, graphs=graphs)
    eager = se._anytime_topk(st, blocks, ql, qt, qe, probe, cfg, 8, 1e18,
                             2, None)
    torch.cuda.synchronize()
    assert got[6] == eager[6] == 1.0
    for g, e, w in zip(got[:6], eager[:6], want):
        assert torch.equal(g, w) and torch.equal(e, w)
    n_blocks = blocks["xl"].shape[0]
    spans = {key[5] for key in graphs}
    assert spans == {(s, min(2, n_blocks - s))
                     for s in range(0, n_blocks, 2)}
    kernel = {"pdx": 1, "ddcopq": 2}.get(case, 0)
    assert sum(g.launches[kernel] for g in graphs.values()) == n_blocks


@pytest.mark.cuda
def test_adaptive_graph_cache_follows_the_layout(cuda_device):
    """With an adaptive policy the backend keeps a switching and a
    full-scan graph beside its layout; add() makes the next search
    capture over the combined layout and answer as a freshly opened
    session, and invalidate() leaves no graph behind."""
    import dataclasses

    from repro_torch.api import SearchSession
    sess, X, Q = _graph_session("flat", "PDScanning+")
    pol = dataclasses.replace(sess.policy, adaptive=True)
    sess = SearchSession(sess.method, pol, device="cuda")
    be = sess.backend
    Q = _mixed_queries(sess, X, Q)
    sess.search(Q, 10)
    first = set(be._graphs)
    assert first and all(g.keep[1] is be._blocks
                         for g in be._graphs.values())
    sess.add(X[1200:1300])
    res = sess.search(Q, 10)
    assert not first & set(be._graphs)
    assert all(g.keep[1] is be._delta_blocks for g in be._graphs.values())
    fresh = SearchSession(sess.method, sess.policy, device="cuda")
    want = fresh.search(Q, 10)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.dists, want.dists)
    assert (res.stats.extra["fallback_blocks"]
            == want.stats.extra["fallback_blocks"])
    be.invalidate()
    assert be._graphs == {}
    again = sess.search(Q, 10)
    np.testing.assert_array_equal(again.ids, want.ids)


# ------------------------------------------------ serving and snapshots ---
def _service_stream(svc, Q, X):
    """Steps of every fill (one to four queries; slots 4 pads the rest),
    an add, then more steps; returns the tickets and the distinct graphs
    the session's backend held after each step."""
    reqs, seen = [], []
    be = svc.session.backend

    def step(qs, t):
        for q in qs:
            reqs.append(svc.submit(q, now=t))
        svc.step(now=t)
        new = [g for g in be._graphs.values()
               if all(g is not s for s in seen)]
        seen.extend(new)

    for j, n in enumerate((4, 1, 3, 2, 4)):
        step(Q[:n], float(j))
    before = len(seen)
    svc.add(X[1200:1300])
    for j, n in enumerate((2, 4, 1)):
        step(Q[n:2 * n], 10.0 + j)
    return reqs, before, seen


@pytest.mark.cuda
def test_service_on_the_card_replays_one_graph(cuda_device):
    """A service with slots = query_chunk pads every step to one chunk, so
    the card captures one block walk for all steps and exactly one more
    after an add() (which drops the graphs with the layout); its tickets
    equal a CPU service's on the same stream."""
    from repro_torch.api import open_index
    sess, X, Q = _graph_session("flat", "PDScanning+")
    cpu = open_index(X[:1200], method="PDScanning+", schedule=sess.policy,
                     device="cpu")
    got, before, seen = _service_stream(sess.serve(slots=4, k=10), Q, X)
    want, _, _ = _service_stream(cpu.serve(slots=4, k=10), Q, X)
    assert before == 1 and len(seen) == 2
    assert len(sess.backend._graphs) == 1
    assert seen[0].replays == 5
    assert sess.last_write_mode == "delta"
    for a, b in zip(got, want):
        assert a.status == b.status == "done"
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5)
        assert (a.certified, a.coverage, a.n_visible) == (
            b.certified, b.coverage, b.n_visible)


@pytest.mark.cuda
def test_snapshot_saved_and_loaded_on_the_card(cuda_device, tmp_path):
    """A card session with a delta segment, saved, then loaded by default
    (onto the card) with a WAL frame replayed: the live session's ids."""
    from repro_torch.api import SearchSession
    sess, X, Q = _graph_session("flat", "PDScanning+")
    sess.search(Q, 10)
    sess.add(X[1200:1250])
    p = str(tmp_path / "idx.bin")
    sess.save(p)
    sess.add(X[1250:1300])                  # logged in the WAL
    live = sess.search(Q, 10)
    loaded = SearchSession.load(p)
    assert loaded.backend.device.type == "cuda"
    assert loaded.n == 1300 and loaded.last_write_mode == "cold"
    res = loaded.search(Q, 10)
    np.testing.assert_array_equal(res.ids, live.ids)
    np.testing.assert_allclose(res.dists, live.dists, rtol=1e-5)


@pytest.mark.cuda
def test_shard_tier_on_the_card_equals_one_session(cuda_device):
    """Three shard sessions on the card, merged, give one session's ids
    over the whole corpus (certified: the completion budget is a whole
    row block)."""
    from repro_torch.api import SchedulePolicy, open_index
    from repro_torch.serving import open_replicated
    rng = np.random.default_rng(_seed("cuda-shard"))
    X = rng.normal(size=(3000, 48)).astype(np.float32)
    Q = rng.normal(size=(12, 48)).astype(np.float32)
    pol = SchedulePolicy(d1=24, query_chunk=4, row_block=256,
                         block_capacity=256)
    svc = open_replicated(X, replicas=3, mode="shard", method="PDScanning+",
                          schedule=pol, slots=4, k=10)
    assert all(rs.session.backend.device.type == "cuda"
               for rs in svc.replicas)
    for j, q in enumerate(Q):
        svc.submit(q, now=1e-4 * j)
    done = sorted(svc.drain(now=1.0), key=lambda r: r.rid)
    want = open_index(X, method="PDScanning+", schedule=pol,
                      device="cuda").search(Q, 10)
    assert all(r.done and r.certified and r.coverage == 1.0 for r in done)
    np.testing.assert_array_equal(np.stack([r.ids for r in done]), want.ids)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lb", "adsampling"])
def test_dco_scan_at_the_mesh_shard_block(cuda_device, kind):
    """The row block of a 500,000-row mesh shard (4,000 rows: the last
    256-row tile holds 160) at the engine's block_n = 256: the four
    outputs equal the plain version's bit for bit."""
    n, q, d1 = 4000, 16, 128
    rng = np.random.default_rng(_seed("cuda-shard-block", kind))
    x = rng.integers(-4, 5, (n, d1)).astype(np.float32)
    qq = rng.integers(-4, 5, (q, d1)).astype(np.float32)
    tau = rng.uniform(d1 * 2.0, d1 * 10.0, q).astype(np.float32)
    sc = ref.make_dco_scales(kind, d1, 128, D=2 * d1, device=cuda_device)
    xt, qt, taut = _t(x, qq, tau, device=cuda_device)
    nr = torch.tensor([n], dtype=torch.int32, device=cuda_device)
    got = ops.dco_scan_op(xt, qt, taut, sc, nr, block_n=256)
    want = dco_mod.dco_scan_plain(xt, qt, taut, sc, ops._widths(
        d1, 128, cuda_device), nr, block_n=256, block_d=128)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["PDScanning+", "DDCres", "DADE"])
def test_nccl_world_one_mesh_equals_one_device(cuda_device, method):
    """A 1 x 1 mesh of a one-rank NCCL group (the exchange on device
    tensors) gives the single-device session's ids and distances."""
    import torch.distributed as dist
    from repro_torch.api import SchedulePolicy, open_index
    from repro_torch.launch import make_host_mesh
    rng = np.random.default_rng(_seed("cuda-nccl", method))
    X = rng.normal(size=(3000, 64)).astype(np.float32)
    Q = rng.normal(size=(13, 64)).astype(np.float32)
    pol = SchedulePolicy(d1=32, query_chunk=8)
    want = open_index(X, method=method, schedule=pol).search(Q, 10)
    mesh = make_host_mesh(1, 1, device_type="cuda")
    try:
        assert dist.get_backend() == "nccl"
        sess = open_index(X, method=method, schedule=pol, mesh=mesh)
        got = sess.search(Q, 10)
        again = sess.search(Q, 10)      # the cached shard graphs
    finally:
        dist.destroy_process_group()
    assert sess.backend.device.type == "cuda"
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5)
    np.testing.assert_array_equal(again.ids, got.ids)


@pytest.mark.cuda
def test_nccl_world_one_mesh_service_equals_one_device(cuda_device):
    """The service over a 1 x 1 mesh of a one-rank NCCL group serves with
    no follower and no broadcast: its tickets carry the single-device
    session's ids, and ``follow()`` on rank 0 refuses."""
    import torch.distributed as dist
    from repro_torch.api import SchedulePolicy, open_index
    from repro_torch.launch import make_host_mesh
    rng = np.random.default_rng(_seed("cuda-nccl-service"))
    X = rng.normal(size=(3000, 64)).astype(np.float32)
    Q = rng.normal(size=(13, 64)).astype(np.float32)
    pol = SchedulePolicy(d1=32, query_chunk=8)
    want = open_index(X, method="PDScanning+", schedule=pol).search(Q, 10)
    mesh = make_host_mesh(1, 1, device_type="cuda")
    try:
        assert dist.get_backend() == "nccl"
        svc = open_index(X, method="PDScanning+", schedule=pol, mesh=mesh,
                         serving=True, serving_params={"slots": 8, "k": 10})
        reqs = [svc.submit(q) for q in Q]
        svc.drain()
        with pytest.raises(RuntimeError, match="rank 0 drives"):
            svc.follow()
        svc.close()
    finally:
        dist.destroy_process_group()
    assert [r.status for r in reqs] == ["done"] * len(Q)
    assert svc.health()["steps"] == 2
    np.testing.assert_array_equal(np.stack([r.ids for r in reqs]), want.ids)
    np.testing.assert_allclose(np.stack([r.dists for r in reqs]), want.dists,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dco_attention_on_the_card_matches_cpu(cuda_device, dtype):
    """The screened and the exact decode attention on the card against
    the same functions on the CPU, ragged cur_len, GQA 4:1."""
    from repro_torch.serving import (dco_decode_attention,
                                     exact_decode_attention, fit_key_rotation)
    rng = np.random.default_rng(_seed("cuda-attention"))
    B, S, Hkv, G, hd = 2, 2048, 2, 4, 64
    scale = (np.arange(1, hd + 1) ** -0.7).astype(np.float32)
    k = (rng.standard_normal((B, S, Hkv, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    q = (rng.standard_normal((B, Hkv * G, hd)) * scale).astype(np.float32)
    rot = torch.from_numpy(fit_key_rotation(k.reshape(-1, hd)))
    k_rot = torch.einsum("bshd,de->bshe", torch.from_numpy(k), rot)
    cur = np.array([1500, 2048], np.int32)
    cpu = [torch.from_numpy(q).to(dtype), k_rot.to(dtype),
           torch.from_numpy(v).to(dtype)]
    card = [t.to(cuda_device) for t in cpu]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    got = dco_decode_attention(*card, rot.to(cuda_device), cur, d1=16,
                               cap=256)
    want = dco_decode_attention(*cpu, rot, cur, d1=16, cap=256)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)
    cpu[1] = torch.from_numpy(k).to(dtype)
    got = exact_decode_attention(card[0], cpu[1].to(cuda_device), card[2], cur)
    want = exact_decode_attention(*cpu, cur)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


# ------------------------------------------------------------- LM serving --
LM_TOL = 4e-2       # tests/test_torch_models.py's, relative to max |logits|


def _lm_pair(cuda_device, arch="qwen3-4b"):
    """The smoke decoder on the CPU and the same weights on the card."""
    import copy
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    cfg = smoke_config(arch)
    cpu_api = build_model(cfg, device="cpu")
    cpu_params = cpu_api.init(torch.Generator().manual_seed(0))
    return (cfg, cpu_api, cpu_params, build_model(cfg, device=cuda_device),
            copy.deepcopy(cpu_params).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "olmo-1b", "paligemma-3b"])
def test_lm_decode_on_the_card_matches_cpu(cuda_device, arch):
    cfg, cpu_api, cpu_params, api, params = _lm_pair(cuda_device, arch)
    assert all(p.device.type == "cuda" for p in params.parameters())
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    cpu_cache, cache = cpu_api.init_cache(2, 16), api.init_cache(2, 16)
    for t in range(12):
        lens = np.array([t + 1, max(t - 2, 1)], np.int32)
        want, cpu_cache = cpu_api.decode_step(cpu_params, cpu_cache,
                                              tokens[:, t], lens)
        got, cache = api.decode_step(params, cache, tokens[:, t], lens)
        assert (got.cpu() - want).abs().max() < LM_TOL * want.abs().max()
    for key in ("k", "v"):
        want, got = cpu_cache[key].float(), cache[key].float().cpu()
        assert (got - want).abs().max() < LM_TOL * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,hkv,G,hd", [(8, 1024, 8, 4, 128),
                                          (3, 77, 1, 8, 256),
                                          (2, 33, 4, 1, 64)])
def test_bmm_f32_result_equals_the_f32_upcast(cuda_device, B, S, hkv, G, hd):
    """The card's attention products (one bf16 bmm with an f32 result over
    the block-diagonal query) against both operands widened to f32."""
    from repro_torch.models import layers as TL
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    q = torch.randn(B, hkv, G, hd, device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, hkv, hd, device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    p = torch.softmax(torch.randn(B, hkv, G, S, device=cuda_device,
                                  generator=gen), -1).to(torch.bfloat16)
    s_bmm, s_up = TL.grouped_scores_bmm(q, k), TL.grouped_scores_upcast(q, k)
    assert s_bmm.dtype == torch.float32 and s_bmm.shape == s_up.shape
    torch.testing.assert_close(s_bmm, s_up, rtol=1e-5, atol=1e-4)
    m_bmm, m_up = TL.grouped_mix_bmm(p, k), TL.grouped_mix_upcast(p, k)
    assert m_bmm.shape == m_up.shape == (B, hkv, G, hd)
    torch.testing.assert_close(m_bmm, m_up, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_lm_engine_on_the_card(cuda_device):
    """The engine over the smoke decoder on the card: every request gets
    max_new ids, equal to the CPU engine's up to the CPU logits' first
    near-tie."""
    from repro_torch.serving import Request, ServingEngine
    cfg, cpu_api, cpu_params, api, params = _lm_pair(cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 10)))
               for _ in range(6)]
    want = ServingEngine(cpu_api, slots=4, max_len=32).run(
        cpu_params, [Request(i, p, 8) for i, p in enumerate(prompts)])
    got = ServingEngine(api, slots=4, max_len=32).run(
        params, [Request(i, p, 8) for i, p in enumerate(prompts)])
    assert sorted(got) == list(range(6))
    for rid, prompt in enumerate(prompts):
        assert len(got[rid]) == 8
        seq = list(prompt) + want[rid][:-1]
        cache = cpu_api.init_cache(1, len(seq) + 1)
        gen = []
        for i, tok in enumerate(seq):
            logits, cache = cpu_api.decode_step(cpu_params, cache,
                                                np.array([tok]), i + 1)
            if i >= len(prompt) - 1:
                gen.append(logits[0, :cfg.vocab])
        gen = torch.stack(gen)
        top2 = gen.topk(2, -1).values
        near = (top2[:, 0] - top2[:, 1]) <= LM_TOL * gen.abs().amax(-1)
        upto = int(near.int().argmax()) if bool(near.any()) else len(gen)
        assert got[rid][:upto] == want[rid][:upto], (rid, upto)


def _assert_caches_close(want, got):
    """Every tensor of a cache (K/V, self/cross K/V, or the SSM's (h,
    conv)) on the card, of the CPU's dtype, within LM_TOL of its largest
    magnitude."""
    if isinstance(want, tuple):
        want, got = dict(zip("hc", want)), dict(zip("hc", got))
    for key, w in want.items():
        if isinstance(w, (dict, tuple)):
            _assert_caches_close(w, got[key])
        elif key != "len":
            g = got[key]
            assert g.device.type == "cuda" and g.dtype == w.dtype, key
            w, g = w.float(), g.float().cpu()
            assert (g - w).abs().max() <= LM_TOL * w.abs().max(), key


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True])
def test_ssd_on_the_card_matches_cpu(cuda_device, init):
    """The chunked and the naive SSD scan in f32 on the card against the
    same scans on the CPU, and against each other, within 1e-4 of the
    largest magnitude (tests/test_torch_mamba2.py's SSD_TOL)."""
    from repro_torch.models import mamba2 as TM
    rng = np.random.default_rng(3)
    B, S, H, P, N = 2, 512, 24, 64, 128
    args = [rng.standard_normal((B, S, H, P)), rng.uniform(0.01, 0.2, (B, S, H)),
            np.log(np.linspace(1.0, 16.0, H)), rng.standard_normal((B, S, N)),
            rng.standard_normal((B, S, N))]
    cpu = [torch.as_tensor(a, dtype=torch.float32) for a in args]
    h0 = (torch.as_tensor(rng.standard_normal((B, H, P, N)),
                          dtype=torch.float32) if init else None)
    card = [a.to(cuda_device) for a in cpu]
    h0c = None if h0 is None else h0.to(cuda_device)
    want = TM.ssd_chunked(*cpu, chunk=256, init_state=h0)
    got = TM.ssd_chunked(*card, chunk=256, init_state=h0c)
    naive = TM.ssd_naive(*card, init_state=h0c)
    for w, g, n in zip(want, got, naive):
        top = w.abs().max()
        assert (g.cpu() - w).abs().max() < 1e-4 * top
        assert (n.cpu() - w).abs().max() < 1e-4 * top


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "mamba2-130m",
                                  "deepseek-v2-236b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_new_family_prefill_and_decode_on_the_card_match_cpu(cuda_device,
                                                             arch):
    """Prefill (with seeded source frames for the encoder-decoder), then
    12 decode steps at per-slot lengths from the zero cache: logits and
    every cache tensor on the card within LM_TOL of the CPU's.  A MoE's
    card pass takes the experts the CPU's chose (``testing.routing``):
    a one-ulp gap at a near-tied expert would flip the choice."""
    from repro_torch.testing.routing import routing
    cfg, cpu_api, cpu_params, api, params = _lm_pair(cuda_device, arch)
    assert all(p.device.type == "cuda" for p in params.parameters())
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (2, 10, cfg.d_model)).astype(np.float32)

    def both(cpu_call, card_call):
        with routing() as rec:
            want = cpu_call()
        with routing(rec["calls"]):
            return want, card_call()

    (want, want_cache), (got, cache) = both(
        lambda: cpu_api.prefill(cpu_params, batch),
        lambda: api.prefill(params, batch))
    assert (got.cpu() - want).abs().max() < LM_TOL * want.abs().max()
    _assert_caches_close(want_cache, cache)
    cpu_cache, cache = cpu_api.init_cache(2, 16), api.init_cache(2, 16)
    for t in range(12):
        lens = np.array([t + 1, max(t - 2, 1)], np.int32)
        (want, cpu_cache), (got, cache) = both(
            lambda: cpu_api.decode_step(cpu_params, cpu_cache, tokens[:, t],
                                        lens),
            lambda: api.decode_step(params, cache, tokens[:, t], lens))
        assert (got.cpu() - want).abs().max() < LM_TOL * want.abs().max()
    _assert_caches_close(cpu_cache, cache)


@pytest.mark.cuda
def test_ssm_engine_on_the_card_carries_the_state_as_the_cpu(cuda_device):
    """Two requests through one slot of the mamba2 smoke engine on the
    card: the CPU engine's ids, the state carried from the first request
    into the second (ROADMAP C10)."""
    from repro_torch.serving import Request, ServingEngine
    cfg, cpu_api, cpu_params, api, params = _lm_pair(cuda_device,
                                                     "mamba2-130m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 9)))
               for _ in range(2)]
    want = ServingEngine(cpu_api, slots=1, max_len=32).run(
        cpu_params, [Request(i, p, 4) for i, p in enumerate(prompts)])
    got = ServingEngine(api, slots=1, max_len=32).run(
        params, [Request(i, p, 4) for i, p in enumerate(prompts)])
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_moe_capacity_path_without_drops_equals_dropless_on_the_card(
        cuda_device, arch):
    """T = 256 tokens through the capacity path with a capacity factor of
    E (no token dropped) against the dropless path over chunks of 32
    tokens, on the card: the two round the SwiGLU at other points (f32
    against bf16), within LM_TOL of the largest magnitude."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import moe as TMOE
    cfg = smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    layer = TMOE.MoE(cfg, torch.Generator(device=cuda_device).manual_seed(6),
                     device=cuda_device)
    x = torch.randn(1, 256, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(
                        7)).to(torch.bfloat16)
    capacity, _ = TMOE.moe_forward(layer, cfg, x)
    dropless = torch.cat([TMOE.moe_forward(layer, cfg, x[:, i:i + 32])[0]
                          for i in range(0, 256, 32)], 1)
    top = capacity.float().abs().max()
    assert (dropless.float() - capacity.float()).abs().max() < LM_TOL * top


@pytest.mark.cuda
def test_absorbed_mla_decode_equals_expanded_on_the_card(cuda_device):
    """DeepSeek-V2's MLA at its smoke widths on the card: the absorbed
    decode (one bf16 bmm with an f32 result a product) token by token
    against the expanded forward pass over every prefix, and the latent
    caches, within LM_TOL."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mla as TMLA
    cfg = smoke_config("deepseek-v2-236b")
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    attn = TMLA.MLA(cfg, gen, device=cuda_device)
    x = torch.randn(2, 12, cfg.d_model, device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    cache = TMLA.init_mla_cache(cfg, 2, 12, device=cuda_device)
    for t in range(12):
        dec, cache = TMLA.mla_decode(attn, cfg, x[:, t:t + 1], cache, t + 1)
        full, (c_kv, k_rope) = TMLA.mla_forward(attn, cfg, x[:, :t + 1])
        want = full[:, -1].float()
        assert (dec[:, 0].float() - want).abs().max() < \
            LM_TOL * want.abs().max(), t
    for w, g in ((c_kv, cache["c_kv"]), (k_rope, cache["k_rope"])):
        assert (g.float() - w.float()).abs().max() < \
            LM_TOL * w.float().abs().max()


# ------------------------------------------------------------- training ---
@pytest.mark.cuda
@pytest.mark.parametrize("helper", ["bmm_f32", "grouped_scores",
                                    "grouped_mix"])
def test_f32_result_gemm_backward_equals_the_f32_upcast(cuda_device, helper):
    """(F2) The backward of each f32-result bf16 GEMM helper on the card
    (``layers.bmm_out_f32``) against autograd of the widened f32 form:
    the bf16 cotangents of both operands within one bf16 rounding (1e-2
    of their largest magnitude)."""
    from repro_torch.models import layers as TL
    gen = torch.Generator(device=cuda_device).manual_seed(21)

    def leaf(*shape):
        return torch.randn(*shape, device=cuda_device, generator=gen).to(
            torch.bfloat16).requires_grad_(True)

    B, S, hkv, G, hd = 3, 40, 2, 4, 64
    if helper == "bmm_f32":
        a, b = leaf(6, 9, 32), leaf(6, 32, 17)
        card, plain = TL.bmm_f32, lambda x, y: torch.bmm(x.float(), y.float())
    elif helper == "grouped_scores":
        a, b = leaf(B, hkv, G, hd), leaf(B, S, hkv, hd)
        card, plain = TL.grouped_scores_bmm, TL.grouped_scores_upcast
    else:
        a, b = leaf(B, hkv, G, S), leaf(B, S, hkv, hd)
        card, plain = TL.grouped_mix_bmm, TL.grouped_mix_upcast
    cot = torch.randn(card(a, b).shape, device=cuda_device, generator=gen)
    got = torch.autograd.grad((card(a, b) * cot).sum(), (a, b))
    want = torch.autograd.grad((plain(a, b) * cot).sum(), (a, b))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert (g.float() - w.float()).abs().max() <= \
            1e-2 * w.float().abs().max()


def _train_pair(cuda_device, arch, remat="block"):
    """``arch``'s smoke model on the CPU and the card from one state."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.train.train_step import init_state
    cfg = smoke_config(arch)
    cpu_api = build_model(cfg, remat=remat, device="cpu")
    state = init_state(cpu_api, torch.Generator().manual_seed(3))
    return cfg, cpu_api, state, build_model(cfg, remat=remat,
                                            device=cuda_device)


def _on(state, device):
    import dataclasses
    return dataclasses.replace(
        state, params={k: v.to(device) for k, v in state.params.items()},
        opt={"m": {k: v.to(device) for k, v in state.opt["m"].items()},
             "v": {k: v.to(device) for k, v in state.opt["v"].items()},
             "step": state.opt["step"].to(device)},
        step=state.step.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_routed_train_step_on_the_card_matches_cpu(cuda_device, arch):
    """One smoke train step (2 x 16 tokens: the dropless path, F2's GEMM
    in the backward) on the card against the CPU from one state, the
    CPU's routing imposed on the card (``repro_torch.testing.routing``,
    the remat recompute's calls included): the loss within 4e-2 relative,
    gnorm within 1e-2, the masters within 1e-6 where the CPU's gradient
    is clear and within 2 lr elsewhere."""
    from repro_torch.testing.routing import routing
    from repro_torch.train.train_step import make_train_step
    cfg, cpu_api, state, api = _train_pair(cuda_device, arch)
    lr = 1e-3
    batch = {"tokens": np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)}
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with routing() as rec:
            want, wm = make_train_step(cpu_api, lr_fn=lambda s: lr)(state,
                                                                    batch)
        with routing(rec["calls"]):
            got, gm = make_train_step(api, lr_fn=lambda s: lr)(
                _on(state, cuda_device), batch)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= \
        4e-2 * abs(float(wm["loss"]))
    assert abs(float(gm["gnorm"]) - float(wm["gnorm"])) <= \
        1e-2 * float(wm["gnorm"])
    for name, w in want.params.items():
        m = want.opt["m"][name]
        clear = (m.abs() > 5e-2 * m.abs().max()) & (m.abs() > 1e-5)
        gap = (got.params[name].cpu() - w).abs()
        assert got.params[name].device.type == cuda_device.type
        if bool(clear.any()):
            assert float(gap[clear].max()) <= 1e-6, name
        assert float(gap.max()) <= 2 * lr + 1e-6, name


@pytest.mark.cuda
def test_remat_block_equals_none_on_the_card(cuda_device):
    """At the OLMo smoke config on the card, checkpointing each layer
    recomputes the same forward: the loss equal, every grad within 1e-2
    of its largest magnitude (the card's scatter-adds may sum in another
    order)."""
    from repro_torch.train.train_step import make_train_step
    out = {}
    batch = {"tokens": np.random.default_rng(5).integers(
        0, 512, (2, 32)).astype(np.int32)}
    for remat in ("block", "none"):
        cfg, _, state, api = _train_pair(cuda_device, "olmo-1b", remat)
        new, m = make_train_step(api, lr_fn=lambda s: 1e-3)(
            _on(state, cuda_device), batch)
        out[remat] = (m, new)
    assert torch.equal(out["block"][0]["loss"], out["none"][0]["loss"])
    for name, m in out["none"][1].opt["m"].items():
        got = out["block"][1].opt["m"][name]
        assert float((got - m).abs().max()) <= \
            1e-2 * float(m.abs().max()) + 1e-12, name

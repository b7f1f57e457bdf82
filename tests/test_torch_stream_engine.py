"""The port's streaming engine (repro_torch.core.stream_engine) against the
reference ``repro.core.stream_engine.stream_topk`` on the same fitted
method state, for all 7 decision rules and both stage-1 paths (kernel op
vs inline block; the reference runs its Pallas kernels in interpret mode),
on the row-blocked and on the PDX layout (the reference's own parity and
decoy cases from tests/test_pdx_layout.py).

Ids, survivors, passed, dims read and the per-query certificate flag must
be exact; distances within rtol 1e-4 (float32 sums in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transforms as JT
from repro.core.engine import make_schedule
from repro.core.jax_engine import DcoEngineConfig as JaxConfig
from repro.core.jax_engine import build_device_state as jax_state
from repro.core.methods import make_method
from repro.core.stream_engine import _group_plan as jax_group_plan
from repro.core.stream_engine import stream_topk as jax_stream_topk
from repro_torch.convert import method_from_reference, state_from_reference
from repro_torch.core.stream_engine import (_group_plan, _merge_topk,
                                            _smallest, build_stream_blocks,
                                            stream_topk)
from repro_torch.core.torch_engine import DcoEngineConfig, build_device_state
from repro_torch.vecdata import recall_at_k
from tests.test_pdx_layout import PARITY_CASES, _decayed, _decoy_corpus

K = 10
D1 = 48
RULES = {"FDScanning": "fdscan", "PDScanning+": "lb",
         "ADSampling": "adsampling", "DADE": "dade",
         "DDCres": "ddcres", "DDCpca": "ratio", "DDCopq": "opq"}
_FITTED: dict = {}


def _fitted(ds, name, n):
    key = (name, n)
    if key not in _FITTED:
        m = make_method(name).fit(ds.X[:n])
        if m.needs_training:
            rng = np.random.default_rng(7)
            m.train(ds.X[rng.choice(n, 24)], K, make_schedule(ds.dim))
        _FITTED[key] = m
    return _FITTED[key]


def _inputs(method, Q, d1=D1):
    """Rotated queries and per-rule extras, in numpy, from the method's
    device export (what both backends' ``_prep_queries`` compute)."""
    ds = method.device_state()
    Qp = Q - ds["mean"] if ds.get("mean") is not None else Q
    Qr = np.asarray(Qp @ ds["W"] if ds.get("W") is not None else Qp,
                    np.float32)
    qe = {}
    if ds["kind"] == "ddcres":
        qres = np.clip((Qp ** 2).sum(1) - (Qr ** 2).sum(1), 0.0, None)
        var = ((Qr[:, d1:] ** 2) * ds["sigma_sq"][None, d1:]).sum(1)
        qe = {"qtail_sq": (Qr[:, d1:] ** 2).sum(1) + qres,
              "var_d1": var + qres * float(ds["tail_var"])}
    elif ds["kind"] == "opq":
        pq = {"books": ds["books"], "splits": ds["splits"]}
        qe = {"lut": np.stack([JT.pq_query_lut(pq, q) for q in Qr])}
    return ds, Qr[:, :d1], Qr[:, d1:], qe


def _cfg_kw(ds, **kw):
    base = dict(kind=ds["kind"], d1=D1, k=K, query_chunk=8, row_block=512,
                block_capacity=128)
    if ds["kind"] == "adsampling":
        base["eps0"] = float(ds["eps0"])
    base.update(kw)
    return base


def _run_both(dstate, ql, qt, qe, **kw):
    """(reference outputs, port outputs) as numpy tuples.  The PQ codes of
    the opq rule (256 codebook entries) are int32 for the reference and
    uint8 for the port, as its backend holds them."""
    d1 = ql.shape[1]
    js = jax_state(dstate, d1)
    ts = build_device_state(dstate, d1, "cpu")
    if "codes" in dstate:
        codes = np.asarray(dstate["codes"], np.int32)
        js["codes"] = jnp.asarray(codes)
        ts["codes"] = torch.as_tensor(codes).to(torch.uint8)
    a = jax_stream_topk(js, jnp.asarray(ql), jnp.asarray(qt),
                        JaxConfig(**kw), {k: jnp.asarray(v) for k, v in qe.items()})
    b = stream_topk(ts, torch.as_tensor(ql), torch.as_tensor(qt),
                    DcoEngineConfig(**kw), state_from_reference(qe))
    return tuple(np.asarray(x) for x in a), tuple(x.numpy() for x in b)


def _assert_parity(a, b, exact_ids=True):
    (jd, ji, js, jp, jm, jr), (td, ti, ts, tp, tm, tr) = a, b
    if exact_ids:
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tm <= td[:, -1], jm <= jd[:, -1])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", list(RULES))
def test_stream_topk_matches_reference(name, use_kernel, sift_small):
    """All 7 rules on both stage-1 paths; the kernel path keeps the corpus
    at 2,000 rows because the reference runs Pallas in interpret mode."""
    ds = sift_small
    n = 2000 if use_kernel else ds.n
    ref_m = _fitted(ds, name, n)
    port_m = method_from_reference(ref_m)
    dstate, ql, qt, qe = _inputs(port_m, ds.Q[:8])
    assert dstate["kind"] == RULES[name]
    a, b = _run_both(dstate, ql, qt, qe,
                     **_cfg_kw(dstate, use_kernel=use_kernel,
                               theta=_theta(dstate)))
    _assert_parity(a, b)
    gt, _ = _gt(ds.X[:n], ds.Q[:8])
    assert recall_at_k(b[1], gt) >= 0.9


def _theta(dstate):
    if dstate["kind"] == "opq":
        return float(dstate["theta"])
    if dstate["kind"] == "ratio":       # largest trained stage <= d1
        trained = [(d, th) for (kk, d), th in dstate["models"].items()
                   if kk == dstate["trained_k"] and d <= D1]
        return max(trained)[1] if trained else 1.0
    return 1.0


def _gt(X, Q, k=K):
    d2 = ((X ** 2).sum(1)[None, :] - 2.0 * Q @ X.T + (Q ** 2).sum(1)[:, None])
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d2, ids, 1)


def test_stream_ragged_query_batch(sift_small):
    """nq not a multiple of query_chunk pads and slices like the
    reference; the first rows equal the aligned batch's."""
    ds = sift_small
    m = _fitted(ds, "PDScanning+", ds.n)
    dstate, ql, qt, qe = _inputs(m, ds.Q[:13])
    kw = _cfg_kw(dstate, use_kernel=False)
    a, b = _run_both(dstate, ql, qt, qe, **kw)
    _assert_parity(a, b)
    _, b8 = _run_both(dstate, ql[:8], qt[:8], qe, **kw)
    np.testing.assert_array_equal(b[1][:8], b8[1])


@pytest.mark.parametrize("row_block", [384, 512, 4999, 8192])
def test_stream_corpus_not_multiple_of_row_block(row_block, sift_small):
    """N % row_block != 0: pad rows never surface, and the scan matches
    the reference block for block."""
    ds = sift_small
    m = _fitted(ds, "PDScanning+", ds.n)
    dstate, ql, qt, qe = _inputs(m, ds.Q[:8])
    a, b = _run_both(dstate, ql, qt, qe,
                     **_cfg_kw(dstate, row_block=row_block, use_kernel=False))
    _assert_parity(a, b)
    assert (b[1] >= 0).all() and (b[1] < ds.n).all()
    gt, _ = _gt(ds.X, ds.Q[:8])
    assert recall_at_k(b[1], gt) == 1.0


def test_stream_k_exceeds_block_capacity(sift_small):
    ds = sift_small
    m = _fitted(ds, "PDScanning+", ds.n)
    dstate, ql, qt, qe = _inputs(m, ds.Q[:8])
    a, b = _run_both(dstate, ql, qt, qe,
                     **_cfg_kw(dstate, k=32, block_capacity=16,
                               use_kernel=False))
    _assert_parity(a, b)
    d = b[0]
    assert d.shape == (8, 32) and np.isfinite(d).all()
    assert (np.diff(d, axis=1) >= 0).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_stream_truncation_is_flagged(use_kernel):
    """Adversarial block-capacity overflow: 300 decoys with tiny lead
    distances crowd out the true neighbor at capacity 128 — the miss must
    be FLAGGED by the certificate; at capacity 512 the result is exact and
    certified.  Same outcome as the reference."""
    rng = np.random.default_rng(0)
    n, D, d1, k = 4096, 128, 48, 10
    X = rng.standard_normal((n, D)).astype(np.float32) * 4.0
    X[:300, :d1] = rng.standard_normal((300, d1)).astype(np.float32) / 8.0
    X[:300, d1:] = 0.0
    X[:300, d1] = 10.0
    X[300] = 0.0
    X[300, 0] = 2.0
    q = np.zeros((1, D), np.float32)
    dstate = {"Xrot": X}
    kw = dict(kind="lb", d1=d1, k=k, query_chunk=1, row_block=4096,
              block_capacity=128, use_kernel=use_kernel)
    a, b = _run_both(dstate, q[:, :d1], q[:, d1:], {}, **kw)
    _assert_parity(a, b)
    d, i, _, _, dm, _ = b
    assert 300 not in i[0] and dm[0] <= d[0, -1]          # missed, flagged
    a2, b2 = _run_both(dstate, q[:, :d1], q[:, d1:], {},
                       **dict(kw, block_capacity=512))
    _assert_parity(a2, b2)
    d2, i2, _, _, dm2, _ = b2
    assert i2[0, 0] == 300 and d2[0, 0] == 4.0 and dm2[0] > d2[0, -1]


def test_build_stream_blocks_pads_with_invalid_ids():
    st = {"x_lead": torch.ones(5, 3), "x_tail": torch.ones(5, 2),
          "lead_sq": torch.ones(5), "tail_sq": torch.ones(5),
          "codes": torch.ones(5, 4, dtype=torch.int64)}
    xs = build_stream_blocks(st, 2)
    assert xs["xl"].shape == (3, 2, 3) and xs["codes"].dtype == torch.int32
    st["codes"] = st["codes"].to(torch.uint8)       # one byte a code stays
    assert build_stream_blocks(st, 2)["codes"].dtype == torch.uint8
    np.testing.assert_array_equal(xs["ids"].reshape(-1).numpy(),
                                  [0, 1, 2, 3, 4, -1])
    assert xs["xl"][2, 1].abs().sum() == 0


def test_topk_ties_break_by_lower_index():
    """The stable-sort selection keeps XLA top_k's tie order: the lower
    index first, so the carried top-k wins ties against new rows."""
    inf = float("inf")
    v, i = _smallest(torch.tensor([[3.0, 1.0, inf, 1.0, inf]]), 4)
    np.testing.assert_array_equal(i.numpy(), [[1, 3, 0, 2]])
    d, ids = _merge_topk(torch.tensor([[1.0, 2.0]]),
                         torch.tensor([[7, 8]], dtype=torch.int32),
                         torch.tensor([[2.0, 1.0]]),
                         torch.tensor([[5, 6]], dtype=torch.int32), 3)
    np.testing.assert_array_equal(ids.numpy(), [[7, 6, 8]])


def test_stream_topk_refuses_unported_paths(sift_small):
    st = build_device_state({"Xrot": sift_small.X[:64]}, D1, "cpu")
    ql = torch.zeros(2, D1)
    qt = torch.zeros(2, sift_small.dim - D1)
    cfg = DcoEngineConfig(d1=D1, k=2)
    # a probe is served once the layout is partition-major
    with pytest.raises(ValueError, match="partition-major"):
        stream_topk(st, ql, qt, cfg, probe=torch.zeros(2, 1))
    # a deadline is served: one that does not fire scans every block
    # and returns the non-deadline outputs with coverage 1.0
    want = stream_topk(st, ql, qt, cfg)
    got = stream_topk(st, ql, qt, cfg, deadline_ts=1e18)
    assert got[6] == 1.0
    for g, w in zip(got[:6], want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- PDX -------
#: the rules whose layout groups (fdscan and opq force G = 1)
GROUPED = ("PDScanning+", "ADSampling", "DADE", "DDCres", "DDCpca")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,D,d1,rb,g,k", PARITY_CASES)
def test_stream_pdx_matches_reference(n, D, d1, rb, g, k, use_kernel):
    """The PDX layout on the reference's parity cases (ragged rows and dim
    groups, no tail, G = 1, k > block_capacity): the port's grouped path
    against the reference's grouped path, on the R-cut path and on the
    kernel path (the reference's in interpret mode)."""
    X, Q = _decayed(n, D, seed=n + g)
    kw = dict(kind="lb", d1=d1, k=k, query_chunk=4, row_block=rb,
              block_capacity=min(128, rb), dim_groups=g,
              use_kernel=use_kernel)
    a, b = _run_both({"Xrot": X}, Q[:, :d1], Q[:, d1:], {}, **kw)
    _assert_parity(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", GROUPED)
def test_stream_pdx_rules_match_reference(name, use_kernel, sift_small):
    """Every rule that groups, at dim_groups = 4 on sift_small; the kernel
    path keeps the corpus at 2,000 rows as the flat test does."""
    ds = sift_small
    n = 2000 if use_kernel else ds.n
    port_m = method_from_reference(_fitted(ds, name, n))
    dstate, ql, qt, qe = _inputs(port_m, ds.Q[:8])
    a, b = _run_both(dstate, ql, qt, qe,
                     **_cfg_kw(dstate, use_kernel=use_kernel, dim_groups=4,
                               theta=_theta(dstate)))
    _assert_parity(a, b)
    gt, _ = _gt(ds.X[:n], ds.Q[:8])
    assert recall_at_k(b[1], gt) >= 0.9


@pytest.mark.parametrize("group_capacity", [0, 2048])
def test_stream_pdx_rcut_drop_flagged(group_capacity):
    """The reference's decoy corpus: at the auto R = 512 the R-cut drops
    the true neighbour and the certificate says so; group_capacity = 2048
    (no cut) returns it, certified.  Both packages alike."""
    X, q, nn_id, d1 = _decoy_corpus()
    a, b = _run_both({"Xrot": X}, q[:, :d1], q[:, d1:], {},
                     kind="lb", d1=d1, k=K, query_chunk=1, row_block=2048,
                     block_capacity=64, dim_groups=4, use_kernel=False,
                     group_capacity=group_capacity)
    _assert_parity(a, b)
    d, i, _, _, dm, _ = b
    if group_capacity == 0:
        assert nn_id not in i[0] and dm[0] <= d[0, -1]    # missed, flagged
    else:
        assert i[0, 0] == nn_id and d[0, 0] == 4.0 and dm[0] > d[0, -1]


def test_pdx_blocks_layout_and_guard():
    """The grouped layout is dim-group-major with a zero-padded ragged last
    group and per-group norms; a cached layout whose group count differs
    from the config's is refused."""
    X, Q = _decayed(600, 64, seed=3)
    d1 = 30                                 # 4 groups of 8, the last of 6
    st = build_device_state({"Xrot": X}, d1, "cpu")
    xs = build_stream_blocks(st, 256, dim_groups=4)
    assert xs["xl"].shape == (3, 4, 256, 8) and xs["xl"].is_contiguous()
    lead = torch.as_tensor(X[:256, :d1])
    np.testing.assert_array_equal(xs["xl"][0, 1].numpy(), lead[:, 8:16])
    np.testing.assert_array_equal(xs["xl"][0, 3, :, :6].numpy(),
                                  lead[:, 24:30])
    assert not xs["xl"][:, 3, :, 6:].any() and not xs["xl"][2, :, 88:].any()
    np.testing.assert_allclose(xs["lsg"].sum(1).reshape(-1)[:600].numpy(),
                               (X[:, :d1] ** 2).sum(1), rtol=1e-5)
    cfg = DcoEngineConfig(d1=d1, k=K, row_block=256)
    ql, qt = torch.as_tensor(Q[:, :d1]), torch.as_tensor(Q[:, d1:])
    with pytest.raises(ValueError, match="dim group"):
        stream_topk(st, ql, qt, cfg, blocks=xs)
    with pytest.raises(ValueError, match="dim group"):
        stream_topk(st, ql, qt, dataclasses.replace(cfg, dim_groups=4),
                    blocks=build_stream_blocks(st, 256))
    flat = dataclasses.replace(cfg, kind="fdscan", dim_groups=4)
    stream_topk(st, ql, qt, flat, blocks=build_stream_blocks(st, 256))


def test_group_plan_matches_reference():
    for d1 in range(1, 70):
        for groups in range(1, 10):
            assert _group_plan(d1, groups) == jax_group_plan(d1, groups)

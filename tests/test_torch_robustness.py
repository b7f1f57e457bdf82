"""The port's anytime deadlines and fault hooks (DESIGN.md §7) against the
reference package: the deadline and fault-plumbing cases of
tests/test_robustness.py on both backends of the port, and the resumable
walk of ``stream_topk(deadline_ts=)`` against the reference engine's.

1. A generous deadline is a pure generalization: the result equals the
   non-deadline path's bit for bit on both backends, flat and IVF, and
   the reference's (ids exact, distances within rtol 1e-4 on the torch
   backend; equal to the last bit on the host, a numpy copy).
2. A tight deadline returns the running top-k over a prefix of the corpus
   blocks, with coverage < 1 and the certificate withdrawn.
3. The fault plan counts, scopes and parses as the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.jax_engine import DcoEngineConfig as JaxConfig
from repro.core.jax_engine import build_device_state as jax_state
from repro.core.stream_engine import stream_topk as jax_stream_topk
from repro.testing import faults as jax_faults
from repro_torch.api import SchedulePolicy, open_index
from repro_torch.convert import method_from_reference, state_from_reference
from repro_torch.core.engine import (EXTRA_COVERAGE, EXTRA_UNCERTIFIED_MASK,
                                     EXTRA_UNCERTIFIED_QUERIES)
from repro_torch.core.stream_engine import stream_topk
from repro_torch.core.torch_engine import DcoEngineConfig, build_device_state
from repro_torch.testing import FaultError, FaultPlan, faults
from tests.test_torch_stream_engine import D1, _fitted, _inputs, _theta

#: far enough in the future that no deadline fires
NEVER = 1e18


def _data(n=2048, d=24, nq=8, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


def _pol(cls=SchedulePolicy, **kw):
    kw.setdefault("d1", 24)
    kw.setdefault("query_chunk", 4)
    kw.setdefault("row_block", 256)
    kw.setdefault("block_capacity", 256)
    kw.setdefault("anytime_block_group", 2)
    return cls(**kw)


def _open_both(X, backend, **kw):
    """(reference session, port session) on the same corpus and seed."""
    jpol = kw.pop("jax_policy", None) or _pol(JaxPolicy)
    tpol = kw.pop("policy", None) or _pol()
    sj = jax_open_index(X, backend="jax" if backend == "torch" else "host",
                        schedule=jpol, **kw)
    st = open_index(X, backend=backend, schedule=tpol,
                    device="cpu" if backend == "torch" else None, **kw)
    return sj, st


def _same(rj, rt, backend):
    np.testing.assert_array_equal(rt.ids, rj.ids)
    if backend == "host":
        np.testing.assert_array_equal(rt.dists, rj.dists)
    else:
        np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)
    for key in (EXTRA_COVERAGE, EXTRA_UNCERTIFIED_MASK):
        np.testing.assert_array_equal(rt.stats.extra[key],
                                      rj.stats.extra[key])


# ------------------------------------------------- deadline = ∞ identity ----
@pytest.mark.parametrize("backend", ["host", "torch"])
@pytest.mark.parametrize("deadline", [1e6, np.inf])
def test_generous_deadline_is_bit_identical(backend, deadline):
    X, Q = _data()
    sj, sess = _open_both(X, backend)
    r0 = sess.search(Q, 10)
    r1 = sess.search(Q, 10, deadline_s=float(deadline))
    assert np.array_equal(r0.ids, r1.ids)
    assert np.array_equal(r0.dists, r1.dists)
    cov = r1.stats.extra[EXTRA_COVERAGE]
    assert cov.shape == (Q.shape[0],) and (cov == 1.0).all()
    assert not r1.stats.extra[EXTRA_UNCERTIFIED_MASK].any()
    _same(sj.search(Q, 10, deadline_s=float(deadline)), r1, backend)
    assert r1.stats.n_dco == r0.stats.n_dco
    assert r1.stats.dims_scanned == r0.stats.dims_scanned


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_generous_deadline_is_bit_identical_ivf(backend):
    X, Q = _data()
    sj, sess = _open_both(X, backend, index="ivf")
    r0 = sess.search(Q, 10, nprobe=8)
    r1 = sess.search(Q, 10, nprobe=8, deadline_s=1e6)
    assert np.array_equal(r0.ids, r1.ids)
    assert np.array_equal(r0.dists, r1.dists)
    _same(sj.search(Q, 10, nprobe=8, deadline_s=1e6), r1, backend)


@pytest.mark.parametrize("kw", [dict(dim_groups=4, d1=16),
                                dict(engine="two_stage"),
                                dict(adaptive=True)])
def test_generous_deadline_other_schedules(kw):
    """A deadline on a PDX, a two-stage or an adaptive session runs the
    fixed streaming walk (the policy is stripped; the two-stage session
    lays its blocks out for it): the reference's ids, full coverage."""
    X, Q = _data()
    sj, st = _open_both(X, "torch", jax_policy=_pol(JaxPolicy, **kw),
                        policy=_pol(**kw))
    rt = st.search(Q, 10, deadline_s=1e6)
    _same(sj.search(Q, 10, deadline_s=1e6), rt, "torch")
    fixed = open_index(X, device="cpu", schedule=_pol(
        **{key: v for key, v in kw.items() if key != "adaptive"}))
    r0 = fixed.search(Q, 10, deadline_s=1e6)
    np.testing.assert_array_equal(rt.ids, r0.ids)


# ----------------------------------------------------- partial coverage -----
def _prefix_oracle(X, Q, res, row_block):
    """The brute-force top-k ids over the scanned prefix of blocks."""
    nb = -(-X.shape[0] // row_block)
    done = round(float(res.stats.extra[EXTRA_COVERAGE][0]) * nb)
    prefix = X[: done * row_block]
    d2 = ((Q[:, None] - prefix[None]) ** 2).sum(-1)
    return np.argsort(d2, 1)[:, :10]


@pytest.mark.parametrize("groups", [1, 4])
def test_torch_tight_deadline_partial_prefix(groups):
    """An expired deadline: coverage < 1 for the whole batch (it advances
    together), at least one group scanned, the certificate withdrawn, and
    the ids EXACTLY the brute-force top-k of the scanned block prefix
    (block_capacity == row_block keeps every screen survivor); flat and
    PDX (the inline R-cut at R = B)."""
    X, Q = _data()
    kw = dict(anytime_block_group=1)
    if groups > 1:
        kw.update(d1=16, dim_groups=groups, use_kernel=False)
    pol = _pol(**kw)
    sess = open_index(X, device="cpu", schedule=pol)
    sess.search(Q, 10)
    with faults.inject(slow_block_s=0.05):
        res = sess.search(Q, 10, deadline_s=0.01)
    cov = res.stats.extra[EXTRA_COVERAGE]
    assert (cov < 1.0).all() and (cov > 0.0).all()
    assert res.stats.extra[EXTRA_UNCERTIFIED_MASK].all()
    assert res.stats.extra[EXTRA_UNCERTIFIED_QUERIES] == 1.0
    oracle = _prefix_oracle(X, Q, res, pol.row_block)
    for i in range(Q.shape[0]):
        assert set(res.ids[i].tolist()) == set(oracle[i].tolist())


def test_host_tight_deadline_is_per_query():
    """The host scan serves queries one by one, so an expiring budget gives
    full coverage to early queries and less to the starved tail, and only
    the starved ones lose their certificate."""
    X, Q = _data()
    sess = open_index(X, backend="host", schedule=_pol())
    with faults.inject(slow_block_s=0.03):
        res = sess.search(Q, 10, deadline_s=0.04)
    cov = res.stats.extra[EXTRA_COVERAGE]
    mask = res.stats.extra[EXTRA_UNCERTIFIED_MASK]
    assert cov[0] > 0.0
    assert (cov < 1.0).any()
    assert (mask == (cov < 1.0)).all()
    full = cov == 1.0
    if full.any():
        d2 = ((Q[full][:, None] - X[None]) ** 2).sum(-1)
        oracle = np.sort(d2, 1)[:, :10]
        assert np.allclose(res.dists[full], oracle, rtol=1e-4, atol=1e-4)


def test_deadline_rejected_where_meaningless():
    X, Q = _data(n=512)
    hnsw = open_index(X, index="hnsw", backend="host")
    with pytest.raises(ValueError, match="anytime"):
        hnsw.search(Q, 5, deadline_s=1.0)
    sess = open_index(X, device="cpu")
    with pytest.raises(ValueError, match="deadline_s must be > 0"):
        sess.search(Q, 5, deadline_s=0.0)
    with pytest.raises(ValueError, match="deadline_s must be > 0"):
        sess.search(Q, 5, deadline_s=-1.0)


def test_search_rejects_non_finite_queries():
    X, Q = _data(n=512)
    sess = open_index(X, device="cpu")
    bad = Q.copy()
    bad[2, 5] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        sess.search(bad, 5)
    bad[2, 5] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        sess.search(bad, 5, deadline_s=1.0)
    with pytest.raises(ValueError, match="numeric"):
        sess.search(np.array([["a"] * X.shape[1]]), 5)


# ------------------------------------------- the engine against the ref ---
@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("name", ["PDScanning+", "DDCres", "DDCopq",
                                  "FDScanning"])
def test_anytime_stream_topk_matches_reference(name, group, sift_small):
    """The resumable walk in groups of ``group`` blocks (the last group
    ragged at 10 blocks) with no deadline firing: the non-deadline walk's
    six outputs bit for bit, the reference's outputs, coverage 1.0."""
    ds = sift_small
    m = method_from_reference(_fitted(ds, name, ds.n))
    dstate, ql, qt, qe = _inputs(m, ds.Q[:12])
    kw = dict(kind=dstate["kind"], d1=D1, k=10, query_chunk=8,
              row_block=512, block_capacity=128, use_kernel=False,
              theta=_theta(dstate))
    js = jax_state(dstate, D1)
    ts = build_device_state(dstate, D1, "cpu")
    if "codes" in dstate:
        codes = np.asarray(dstate["codes"], np.int32)
        js["codes"] = jnp.asarray(codes)
        ts["codes"] = torch.as_tensor(codes).to(torch.uint8)
    qe_t = state_from_reference(qe)
    args = (ts, torch.as_tensor(ql), torch.as_tensor(qt),
            DcoEngineConfig(**kw), qe_t)
    want = stream_topk(*args)
    got = stream_topk(*args, deadline_ts=NEVER, block_group=group)
    assert got[6] == 1.0
    for g, w in zip(got[:6], want):
        assert torch.equal(g, w)
    ref = jax_stream_topk(js, jnp.asarray(ql), jnp.asarray(qt),
                          JaxConfig(**kw),
                          {k: jnp.asarray(v) for k, v in qe.items()},
                          deadline_ts=NEVER, block_group=group)
    assert ref[6] == got[6]
    (jd, ji, jsv, jp, jm, jr) = (np.asarray(x) for x in ref[:6])
    td, ti, tsv, tp, tm, tr = (x.numpy() for x in got[:6])
    if name in ("PDScanning+", "FDScanning"):
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_array_equal(tsv, jsv)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tm <= td[:, -1], jm <= jd[:, -1])


def test_anytime_kernel_path_equals_one_shot(sift_small):
    """The kernel ops' path (their plain versions on the CPU) resumed in
    block groups: the one-shot walk's outputs bit for bit."""
    ds = sift_small
    m = method_from_reference(_fitted(ds, "PDScanning+", ds.n))
    dstate, ql, qt, qe = _inputs(m, ds.Q[:8])
    ts = build_device_state(dstate, D1, "cpu")
    cfg = DcoEngineConfig(kind="lb", d1=D1, k=10, query_chunk=8,
                          row_block=512, block_capacity=128, use_kernel=True)
    args = (ts, torch.as_tensor(ql), torch.as_tensor(qt), cfg)
    want = stream_topk(*args)
    got = stream_topk(*args, deadline_ts=NEVER, block_group=4)
    for g, w in zip(got[:6], want):
        assert torch.equal(g, w)


# ------------------------------------------------------- fault plumbing -----
def test_fault_plan_counts_search_calls():
    plan = FaultPlan(fail_search_after=1)
    faults.check_search(plan)                 # call 0: fine
    with pytest.raises(FaultError):
        faults.check_search(plan)             # call 1: injected failure
    faults.check_search(plan)                 # spent: fine again


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_fault_plan_fails_the_nth_search(backend):
    """A session-scoped plan fails its backend's N-th search, once."""
    X, Q = _data(n=512)
    plan = FaultPlan(fail_search_after=1)
    # counters are keyed by id(plan), which a dead plan of an earlier test
    # may have held: install() resets them (and the old plan goes back)
    faults.install(faults.install(plan))
    sess = open_index(X, backend=backend,
                      device="cpu" if backend == "torch" else None,
                      schedule=_pol(faults=plan))
    sess.search(Q, 5)
    with pytest.raises(FaultError, match="search call 1"):
        sess.search(Q, 5)
    assert sess.search(Q, 5).ids.shape == (Q.shape[0], 5)


def test_fault_env_route(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "slow_block_s=0.25,fail_search_after=2")
    plan = faults.active()
    assert plan == FaultPlan(slow_block_s=0.25, fail_search_after=2)
    assert vars(plan) == vars(jax_faults.active())
    monkeypatch.setenv("REPRO_FAULTS", "bogus_knob=1")
    with pytest.raises(ValueError, match="bogus_knob"):
        faults.active()


def test_fault_policy_route_takes_precedence():
    plan = FaultPlan(slow_block_s=0.5)
    pol = SchedulePolicy(faults=plan)
    with faults.inject(slow_block_s=0.125):
        assert faults.active(pol) is plan
        assert faults.active() == FaultPlan(slow_block_s=0.125)
    assert faults.active(pol) is plan
    assert faults.active() is None or isinstance(faults.active(), FaultPlan)


def test_torn_frame_tears_at_most_once():
    plan = FaultPlan(torn_frame_keep=0.5)
    buf = bytes(range(100))
    out1, crash1 = faults.torn_frame(plan, buf)
    assert crash1 and len(out1) == 50
    out2, crash2 = faults.torn_frame(plan, buf)
    assert not crash2 and out2 == buf


def test_fault_plan_fields_match_the_reference():
    """One plan spelling for both packages: the same fields and defaults."""
    assert vars(FaultPlan()) == vars(jax_faults.FaultPlan())

"""The port's adaptive DCO policy (repro_torch.core.policy, the adaptive
walk of repro_torch.core.stream_engine, the host policy of
repro_torch.core.engine.scan_topk and both backends) against the reference
package on the same numpy inputs: the cases of tests/test_policy.py, the
pre-scan seed, and the adaptive walk on every screening rule, flat, PDX
and IVF-probed, with and without the guardrail's forced fallback.

Ids, certificate flags, survivors, passed, dims read, ``fallback_blocks``
and ``rule_timeline`` must be exact; distances and ``est_saved_flops``
within rtol 1e-4 (float32 sums in another order).  The reference runs its
jnp path (``use_kernel=False``), as its own tests do on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.jax_engine import DcoEngineConfig as JaxConfig
from repro.core.jax_engine import build_device_state as jax_state
from repro.core.policy import HostPolicy as JaxHostPolicy
from repro.core.policy import PolicyConfig as JaxPolicyConfig
from repro.core.policy import pass_threshold as jax_pass_threshold
from repro.core.stream_engine import _seed_eval as jax_seed_eval
from repro.core.stream_engine import build_stream_blocks as jax_blocks
from repro.core.stream_engine import stream_topk as jax_stream_topk
from repro.search.ivf import IVFIndex as JaxIVF
from repro_torch.api import SchedulePolicy, open_index
from repro_torch.convert import method_from_reference, state_from_reference
from repro_torch.core.engine import (EXTRA_EST_SAVED_FLOPS,
                                     EXTRA_FALLBACK_BLOCKS,
                                     EXTRA_RULE_TIMELINE,
                                     EXTRA_SCREEN_PASS_MEAN,
                                     EXTRA_SURVIVORS_MEAN,
                                     EXTRA_UNCERTIFIED_MASK,
                                     EXTRA_UNCERTIFIED_QUERIES)
from repro_torch.core.policy import HostPolicy, PolicyConfig, pass_threshold
from repro_torch.core.stream_engine import (_seed_eval, build_stream_blocks,
                                            stream_topk)
from repro_torch.core.torch_engine import DcoEngineConfig, build_device_state
from repro_torch.vecdata import make_ood_queries, recall_at_k
from tests.test_torch_ivf import _ivf_state
from tests.test_torch_stream_engine import (D1, GROUPED, RULES, _fitted,
                                            _inputs, _theta)

K = 10
ADAPTIVE_KEYS = (EXTRA_FALLBACK_BLOCKS, EXTRA_EST_SAVED_FLOPS,
                 EXTRA_RULE_TIMELINE)
POLICY = dict(d1=48, query_chunk=8, capacity=512, row_block=512,
              block_capacity=128)


def _policies(**kw):
    """The same schedule for the reference (jax backend) and the port."""
    base = dict(POLICY)
    base.update(kw)
    return JaxPolicy(**base), SchedulePolicy(**base)


def _gt(X, Q, k=K):
    d2 = (X ** 2).sum(1)[None, :] - 2.0 * Q @ X.T + (Q ** 2).sum(1)[:, None]
    return np.argsort(d2, axis=1)[:, :k]


def _both(X, Q, method, index="flat", nprobe=16, backend="torch",
          index_params=None, **kw):
    """(reference result, port result) of one batch through the facades,
    fitted from the same seed: the torch backend against the reference's
    jax backend, the host backend against the reference's host backend."""
    jpol, tpol = _policies(**kw)
    rj = jax_open_index(X, index=index, method=method,
                        backend="jax" if backend == "torch" else "host",
                        schedule=jpol, index_params=index_params).search(
        Q, K, nprobe=nprobe)
    rt = open_index(X, index=index, method=method, backend=backend,
                    device="cpu" if backend == "torch" else None,
                    schedule=tpol, index_params=index_params).search(
        Q, K, nprobe=nprobe)
    return rj, rt


def _same_adaptive(rj, rt):
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)
    ej, et = rj.stats.extra, rt.stats.extra
    assert et[EXTRA_FALLBACK_BLOCKS] == ej[EXTRA_FALLBACK_BLOCKS]
    assert et[EXTRA_RULE_TIMELINE] == ej[EXTRA_RULE_TIMELINE]
    np.testing.assert_allclose(et[EXTRA_EST_SAVED_FLOPS],
                               ej[EXTRA_EST_SAVED_FLOPS], rtol=1e-4)
    np.testing.assert_array_equal(et[EXTRA_UNCERTIFIED_MASK],
                                  ej[EXTRA_UNCERTIFIED_MASK])
    for key in (EXTRA_SURVIVORS_MEAN, EXTRA_SCREEN_PASS_MEAN,
                EXTRA_UNCERTIFIED_QUERIES):
        assert et[key] == ej[key], key
    assert rt.stats.dims_scanned == rj.stats.dims_scanned


# ---------------------------------------------------------------------------
# cost model + host decision unit tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(200, 48, 152, 1.0, 8.0),
                                  (200, 48, 152, 1.3, 8.0),
                                  (200, 196, 4, 1.1, 8.0),
                                  (200, 1, 10, 1.0, 0.0),
                                  (960, 16.0, 960.0, 1.5, 8.0)])
def test_pass_threshold_cost_model(args):
    """The threshold equals the reference's; it falls with margin and
    vanishes when screening can't pay."""
    assert pass_threshold(*args) == jax_pass_threshold(*args)
    t1 = pass_threshold(200, 48, 152, 1.0, 8.0)
    t2 = pass_threshold(200, 48, 152, 1.3, 8.0)
    assert 0.0 < t2 < t1 < 1.0
    assert pass_threshold(200, 196, 4, 1.1, 8.0) <= 0.0
    assert pass_threshold(200, 1, 10, 1.0, 0.0) >= 1.0


def test_host_policy_hysteresis_and_recovery():
    """Mode enters above the threshold, exits only below the hysteresis
    band, and the telemetry counts what was served, as the reference's."""
    kw = dict(fallback_margin=1.0, ewma_alpha=1.0, overhead_dims=0.0,
              hysteresis=0.5)
    hp, jp = HostPolicy(PolicyConfig(**kw), D=100), \
        JaxHostPolicy(JaxPolicyConfig(**kw), D=100)
    for n_pass, want in ((95, True), (60, True), (20, False)):
        for p in (hp, jp):
            p.observe(100, n_pass, 10.0)
        assert hp.mode == jp.mode == want
    for p in (hp, jp):
        p.block_served(True, 100, 100, 10.0)
        p.block_served(False, 100, 5, 10.0)
    assert hp.fallback_blocks == jp.fallback_blocks == 1
    assert hp.timeline == jp.timeline == [True, False]
    assert hp.saved_flops == jp.saved_flops and hp.ewma == jp.ewma


def test_policy_config_from_schedule():
    assert PolicyConfig.from_schedule(SchedulePolicy()) is None
    pc = PolicyConfig.from_schedule(SchedulePolicy(adaptive=True,
                                                   fallback_margin=2.0))
    jc = JaxPolicyConfig.from_schedule(JaxPolicy(adaptive=True,
                                                 fallback_margin=2.0))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


# ---------------------------------------------------------------------------
# the facade's torch backend against the reference's jax backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 4])
def test_adaptive_bit_identical_on_id_queries(groups, sift_small):
    """On an exact rule with in-distribution queries the adaptive session
    returns the fixed session's ids and distances bit for bit and the
    policy never fires; flat and PDX, as the reference."""
    ds = sift_small
    Q = ds.Q[:8]
    r0 = open_index(ds.X, method="PDScanning+", device="cpu",
                    schedule=SchedulePolicy(**POLICY, dim_groups=groups)
                    ).search(Q, K)
    rj, r1 = _both(ds.X, Q, "PDScanning+", adaptive=True, dim_groups=groups)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    np.testing.assert_array_equal(r0.dists, r1.dists)
    assert r1.stats.extra[EXTRA_FALLBACK_BLOCKS] == 0.0
    assert all(v == 0.0 for v in r1.stats.extra[EXTRA_RULE_TIMELINE])
    assert r1.stats.extra[EXTRA_EST_SAVED_FLOPS] > 0.0
    _same_adaptive(rj, r1)


@pytest.mark.parametrize("groups", [1, 4])
def test_adaptive_ood_triggers_fallback_and_matches_fdscan(groups,
                                                           sift_small):
    """An OOD batch triggers the fallback while matching FDScanning's ids
    exactly, certified; the fixed rule on the same batch is flagged
    uncertified; the telemetry equals the reference's."""
    ds = sift_small
    Qo = make_ood_queries(ds.X, 8, severity=1.0)
    rj, ra = _both(ds.X, Qo, "PDScanning+", adaptive=True,
                   dim_groups=groups)
    _same_adaptive(rj, ra)
    assert ra.stats.extra[EXTRA_FALLBACK_BLOCKS] > 0
    assert ra.stats.extra[EXTRA_UNCERTIFIED_QUERIES] == 0.0
    rf = open_index(ds.X, method="FDScanning", device="cpu",
                    schedule=SchedulePolicy(**POLICY)).search(Qo, K)
    np.testing.assert_array_equal(ra.ids, rf.ids)
    assert recall_at_k(ra.ids, _gt(ds.X, Qo)) == 1.0
    rfix = open_index(ds.X, method="PDScanning+", device="cpu",
                      schedule=SchedulePolicy(**POLICY)).search(Qo, K)
    assert rfix.stats.extra[EXTRA_UNCERTIFIED_QUERIES] > 0.0


def test_adaptive_ragged_batch_matches_aligned(sift_small):
    """Padding queries must not perturb chunk-level decisions or
    results."""
    ds = sift_small
    sess = open_index(ds.X, method="PDScanning+", device="cpu",
                      schedule=SchedulePolicy(**dict(POLICY, query_chunk=4),
                                              adaptive=True))
    r_full = sess.search(ds.Q[:8], K)
    r_ragged = sess.search(ds.Q[:7], K)
    assert r_ragged.ids.shape == (7, K)
    np.testing.assert_array_equal(r_ragged.ids, r_full.ids[:7])
    rj, rt = _both(ds.X, ds.Q[:7], "PDScanning+", adaptive=True,
                   query_chunk=4)
    _same_adaptive(rj, rt)


def test_adaptive_estimator_rule_stays_reasonable(sift_small):
    """Estimator rules under the policy: the fallback only adds exactly
    completed rows, so OOD recall does not fall below the fixed rule's;
    the adaptive DADE session equals the reference's."""
    ds = sift_small
    Qo = make_ood_queries(ds.X, 8, severity=1.0)
    gt = _gt(ds.X, Qo)
    rfix = open_index(ds.X, method="DADE", device="cpu",
                      schedule=SchedulePolicy(**POLICY)).search(Qo, K)
    rj, rada = _both(ds.X, Qo, "DADE", adaptive=True)
    _same_adaptive(rj, rada)
    assert recall_at_k(rada.ids, gt) >= recall_at_k(rfix.ids, gt)
    assert rada.stats.extra[EXTRA_FALLBACK_BLOCKS] > 0


def test_adaptive_ivf_matches_reference(sift_small):
    """An adaptive IVF session (no seed: the probed chunks all run the
    switching walk) against the reference's device IVF, ID and OOD."""
    ds = sift_small
    Qo = make_ood_queries(ds.X, 8, severity=1.0)
    for Q in (ds.Q[:8], Qo):
        rj, rt = _both(ds.X, Q, "PDScanning+", index="ivf", nprobe=16,
                       index_params={"n_list": 32}, adaptive=True)
        _same_adaptive(rj, rt)


def test_adaptive_mesh_rejected(sift_small):
    """The adaptive policy is single-device: on a mesh (a 1 x 1 mesh of a
    one-rank gloo group) it raises the reference's ValueError, with its
    message."""
    import torch.distributed as dist
    from repro.launch.mesh import make_host_mesh as jax_mesh
    from repro_torch.launch import make_host_mesh
    X = sift_small.X[:512]
    with pytest.raises(ValueError) as want:
        jax_open_index(X, method="PDScanning+", backend="jax",
                       mesh=jax_mesh(1, 1),
                       schedule=JaxPolicy(adaptive=True))
    mesh = make_host_mesh(1, 1, device_type="cpu")
    try:
        with pytest.raises(ValueError) as got:
            open_index(X, method="PDScanning+", device="cpu", mesh=mesh,
                       schedule=SchedulePolicy(adaptive=True))
    finally:
        dist.destroy_process_group()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# host engine + cross-backend telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "torch"])
def test_adaptive_telemetry_present_on_both_backends(backend, sift_small):
    """Both backends report the canonical extra keys with the same names,
    and the same values as the reference's matching backend."""
    ds = sift_small
    Qo = make_ood_queries(ds.X, 8, severity=1.0)
    rj, res = _both(ds.X, Qo, "PDScanning+", backend=backend, adaptive=True)
    ex = res.stats.extra
    for key in ADAPTIVE_KEYS + (EXTRA_SURVIVORS_MEAN, EXTRA_SCREEN_PASS_MEAN,
                                EXTRA_UNCERTIFIED_QUERIES):
        assert key in ex, (backend, key)
    assert ex[EXTRA_FALLBACK_BLOCKS] > 0, backend
    assert isinstance(ex[EXTRA_RULE_TIMELINE], list)
    assert recall_at_k(res.ids, _gt(ds.X, Qo)) == 1.0, backend
    _same_adaptive(rj, res)


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_host_adaptive_identical_results_and_ivf(index, sift_small):
    """The host fallback only adds scanned dims, so flat and IVF results
    are those of the fixed scan; the port's host scan equals the
    reference's to the last bit, stats included."""
    ds = sift_small
    Qo = make_ood_queries(ds.X, 6, severity=1.0)
    pol = SchedulePolicy(**POLICY)
    r0 = open_index(ds.X, index=index, method="PDScanning+", backend="host",
                    schedule=pol).search(Qo, K, nprobe=64)
    rj, r1 = _both(ds.X, Qo, "PDScanning+", index=index, nprobe=64,
                   backend="host", adaptive=True)
    np.testing.assert_array_equal(r0.ids, r1.ids)
    assert r1.stats.extra[EXTRA_FALLBACK_BLOCKS] > 0
    assert len(r1.stats.extra[EXTRA_RULE_TIMELINE]) > 0
    np.testing.assert_array_equal(r1.ids, rj.ids)
    np.testing.assert_array_equal(r1.dists, rj.dists)
    assert r1.stats.dims_scanned == rj.stats.dims_scanned
    assert set(r1.stats.extra) == set(rj.stats.extra)
    for key, v in rj.stats.extra.items():
        np.testing.assert_array_equal(np.asarray(r1.stats.extra[key]),
                                      np.asarray(v), err_msg=key)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

def _states(dstate, rows=None):
    """(reference state, port state) from one numpy export: opq codes are
    int32 for the reference and uint8 for the port, as its backend holds
    them."""
    js = jax_state(dstate, D1)
    ts = build_device_state(dstate, D1, "cpu")
    rows = dict(rows or {})
    if "codes" in dstate and "codes" not in rows:
        rows["codes"] = np.asarray(dstate["codes"], np.int32)
    for key, v in rows.items():
        js[key] = jnp.asarray(v)
        ts[key] = torch.as_tensor(v)
    if "codes" in ts:
        ts["codes"] = ts["codes"].to(torch.uint8)
    return js, ts


def _engine_both(dstate, ql, qt, qe, probe=None, rows=None, policy=None,
                 **kw):
    """(reference, port) outputs of ``stream_topk`` as numpy tuples, the
    adaptive report (a dict) last."""
    js, ts = _states(dstate, rows)
    jkw, tkw = dict(kw), dict(kw)
    if policy is not None:
        jkw["policy"] = JaxPolicyConfig(**policy)
        tkw["policy"] = PolicyConfig(**policy)
    a = jax_stream_topk(js, jnp.asarray(ql), jnp.asarray(qt),
                        JaxConfig(**jkw),
                        {k: jnp.asarray(v) for k, v in qe.items()},
                        None if probe is None else jnp.asarray(probe))
    b = stream_topk(ts, torch.as_tensor(ql), torch.as_tensor(qt),
                    DcoEngineConfig(**tkw), state_from_reference(qe),
                    None if probe is None else torch.as_tensor(probe))

    def np_out(out, conv):
        head = tuple(conv(x) for x in out[:6])
        if len(out) == 6:
            return head
        return head + ({key: conv(v) for key, v in out[6].items()},)
    return (np_out(a, np.asarray), np_out(b, lambda x: x.numpy()))


def _assert_engine_parity(a, b):
    (jd, ji, js, jp, jm, jr), (td, ti, ts, tp, tm, tr) = a[:6], b[:6]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tm <= td[:, -1], jm <= jd[:, -1])
    np.testing.assert_array_equal(np.isinf(tm), np.isinf(jm))
    if len(a) == 7:
        ja, ta = a[6], b[6]
        np.testing.assert_array_equal(ta["fallback_blocks"],
                                      ja["fallback_blocks"])
        np.testing.assert_array_equal(ta["rule_timeline"],
                                      np.atleast_1d(ja["rule_timeline"]))
        np.testing.assert_allclose(ta["est_saved_flops"],
                                   ja["est_saved_flops"], rtol=1e-4)


def _cfg_kw(dstate, **kw):
    base = dict(kind=dstate["kind"], d1=D1, k=K, query_chunk=8,
                row_block=512, block_capacity=128, use_kernel=False,
                theta=_theta(dstate))
    if dstate["kind"] == "adsampling":
        base["eps0"] = float(dstate["eps0"])
    base.update(kw)
    return base


ADAPTIVE_RULES = [name for name in RULES if name != "FDScanning"]


@pytest.mark.parametrize("ood", [False, True])
@pytest.mark.parametrize("name", ADAPTIVE_RULES)
def test_adaptive_stream_topk_matches_reference(name, ood, sift_small):
    """The switching walk on every screening rule (DDCopq screens through
    the pq_lookup plain version), in- and out-of-distribution: outputs,
    certificate flags and the report equal the reference's."""
    ds = sift_small
    m = method_from_reference(_fitted(ds, name, ds.n))
    Q = make_ood_queries(ds.X, 8, severity=1.0) if ood else ds.Q[:8]
    dstate, ql, qt, qe = _inputs(m, Q)
    a, b = _engine_both(dstate, ql, qt, qe, policy={},
                        **_cfg_kw(dstate))
    _assert_engine_parity(a, b)
    if ood and name == "PDScanning+":
        assert b[6]["fallback_blocks"].min() > 0


@pytest.mark.parametrize("name", GROUPED)
def test_adaptive_pdx_matches_reference(name, sift_small):
    """The adaptive PDX walk (the R-cut in the spill gate, the escape's
    full lead read group by group) on OOD queries."""
    ds = sift_small
    m = method_from_reference(_fitted(ds, name, ds.n))
    Q = make_ood_queries(ds.X, 8, severity=0.7)
    dstate, ql, qt, qe = _inputs(m, Q)
    a, b = _engine_both(dstate, ql, qt, qe, policy={},
                        **_cfg_kw(dstate, dim_groups=4))
    _assert_engine_parity(a, b)


@pytest.mark.parametrize("name", ["PDScanning+", "DDCres", "DDCopq"])
def test_adaptive_ivf_stream_topk_matches_reference(name, sift_small):
    """The switching walk over a partition-major layout with a probe: no
    seed, every chunk starts in screening."""
    ds = sift_small
    ref_m = _fitted(ds, name, ds.n)
    index = JaxIVF(n_list=32).build(ds.X)
    Q = make_ood_queries(ds.X, 8, severity=1.0)
    dstate, rows, ql, qt, qe, probe = _ivf_state(
        method_from_reference(ref_m), index, Q, 8)
    a, b = _engine_both(dstate, ql, qt, qe, probe, rows, policy={},
                        **_cfg_kw(dstate))
    _assert_engine_parity(a, b)


@pytest.mark.parametrize("ivf", [False, True])
def test_forced_fallback_matches_reference(ivf, sift_small):
    """The guardrail's demotion (``force_fallback``): every chunk runs the
    full-scan body, certified, with the reference's outputs and a report
    of every block in fallback."""
    ds = sift_small
    ref_m = _fitted(ds, "PDScanning+", ds.n)
    m = method_from_reference(ref_m)
    probe = rows = None
    if ivf:
        index = JaxIVF(n_list=32).build(ds.X)
        dstate, rows, ql, qt, qe, probe = _ivf_state(m, index, ds.Q[:8], 8)
    else:
        dstate, ql, qt, qe = _inputs(m, ds.Q[:8])
    a, b = _engine_both(dstate, ql, qt, qe, probe, rows,
                        policy={"force_fallback": True}, **_cfg_kw(dstate))
    _assert_engine_parity(a, b)
    nb = -(-ds.n // 512)
    assert (b[6]["fallback_blocks"] == nb).all()
    assert np.isinf(b[4]).all()


@pytest.mark.parametrize("name,groups",
                         [(name, 1) for name in ADAPTIVE_RULES]
                         + [(name, 4) for name in GROUPED])
def test_seed_eval_matches_reference(name, groups, sift_small):
    """The pre-scan seed: ``tau0`` within rtol 1e-4 and the sample pass
    fraction ``ew0`` exactly, flat and PDX (opq has no PDX layout)."""
    ds = sift_small
    m = method_from_reference(_fitted(ds, name, ds.n))
    dstate, ql, qt, qe = _inputs(m, ds.Q[:8])
    js, ts = _states(dstate)
    kw = _cfg_kw(dstate, dim_groups=groups)
    jt, je = jax_seed_eval(js, jax_blocks(js, 512, dim_groups=groups),
                           jnp.asarray(ql), jnp.asarray(qt),
                           {k: jnp.asarray(v) for k, v in qe.items()},
                           JaxConfig(**kw))
    tt, te = _seed_eval(ts, build_stream_blocks(ts, 512, dim_groups=groups),
                        torch.as_tensor(ql), torch.as_tensor(qt),
                        state_from_reference(qe), DcoEngineConfig(**kw))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_adaptive_repairs_capacity_overflow_miss():
    """The adversarial decoy corpus of tests/test_stream_engine.py is a
    flagged MISS for the fixed engine; the adaptive engine re-completes
    the spilled block and returns the exact, certified answer, as the
    reference does."""
    rng = np.random.default_rng(0)
    n, D, d1, k = 4096, 128, 48, 10
    X = rng.standard_normal((n, D)).astype(np.float32) * 4.0
    q = np.zeros((1, D), np.float32)
    X[:300, :d1] = rng.standard_normal((300, d1)).astype(np.float32) / 8.0
    X[:300, d1:] = 0.0
    X[:300, d1] = 10.0
    X[300] = 0.0
    X[300, 0] = 2.0
    st = build_device_state({"Xrot": X}, d1, "cpu")
    ql, qt = torch.as_tensor(q[:, :d1]), torch.as_tensor(q[:, d1:])
    cfg = DcoEngineConfig(kind="lb", d1=d1, k=k, query_chunk=1,
                          row_block=4096, block_capacity=128,
                          use_kernel=False)
    d0, i0, _, _, dm0, _ = stream_topk(st, ql, qt, cfg)
    assert 300 not in i0[0].tolist()
    assert float(dm0[0]) <= float(d0[0, -1])
    cfga = dataclasses.replace(cfg, policy=PolicyConfig())
    d1_, i1, _, _, dm1, _, rep = stream_topk(st, ql, qt, cfga)
    assert int(i1[0, 0]) == 300 and float(d1_[0, 0]) == 4.0
    assert not np.isfinite(float(dm1[0]))
    assert int(rep["fallback_blocks"][0]) > 0
    kw = dict(kind="lb", d1=d1, k=k, query_chunk=1, row_block=4096,
              block_capacity=128, use_kernel=False)
    a, b = _engine_both({"Xrot": X}, q[:, :d1], q[:, d1:], {}, policy={},
                        **kw)
    _assert_engine_parity(a, b)


def test_adaptive_repairs_pdx_rcut_drop():
    """The PDX decoy corpus of tests/test_pdx_layout.py: the adaptive
    spill gate treats a finite R-cut drop as a spill, so the miss the
    fixed PDX walk flags comes back exact, as in the reference."""
    from tests.test_pdx_layout import _decoy_corpus
    X, q, nn_id, d1 = _decoy_corpus()
    kw = dict(kind="lb", d1=d1, k=K, query_chunk=1, row_block=2048,
              block_capacity=64, dim_groups=4, use_kernel=False)
    js = jax_state({"Xrot": X}, d1)
    ts = build_device_state({"Xrot": X}, d1, "cpu")
    a = jax_stream_topk(js, jnp.asarray(q[:, :d1]), jnp.asarray(q[:, d1:]),
                        JaxConfig(**kw, policy=JaxPolicyConfig()))
    b = stream_topk(ts, torch.as_tensor(q[:, :d1]),
                    torch.as_tensor(q[:, d1:]),
                    DcoEngineConfig(**kw, policy=PolicyConfig()))
    d, i, dm = b[0].numpy(), b[1].numpy(), b[4].numpy()
    assert i[0, 0] == nn_id and float(d[0, 0]) == 4.0
    assert float(dm[0]) > float(d[0, -1])
    np.testing.assert_array_equal(i, np.asarray(a[1]))
    np.testing.assert_array_equal(b[6]["fallback_blocks"].numpy(),
                                  np.asarray(a[6]["fallback_blocks"]))


def test_adaptive_with_deadline_raises(sift_small):
    """A deadline runs the fixed walk: the engine refuses an adaptive
    config with one (the backend strips the policy first)."""
    st = build_device_state({"Xrot": sift_small.X[:64]}, D1, "cpu")
    cfg = DcoEngineConfig(d1=D1, k=2, policy=PolicyConfig())
    with pytest.raises(ValueError, match="adaptive"):
        stream_topk(st, torch.zeros(2, D1),
                    torch.zeros(2, sift_small.dim - D1), cfg,
                    deadline_ts=1e18)

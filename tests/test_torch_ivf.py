"""The port's IVF path against the reference: the host scan
(``core.engine.scan_topk``) for all 8 methods, the ``IVFIndex`` (build with
and without a method, insert, probe, search), the streaming engine's
device probe gate (``stream_topk(..., probe=...)``) for all 7 rules on both
stage-1 paths, flat and PDX, the facade's ``index="ivf"`` against the
reference facade on its jax backend, and ``convert.index_from_reference``.

Ids, survivors, passed, dims read and certificate flags exact; distances
within rtol 1e-4 (float32 sums in another order).  The host modules are
numpy copies, so their outputs must be equal to the last bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.engine import QueryBatch as JaxBatch
from repro.core.engine import make_schedule
from repro.core.engine import scan_topk as jax_scan_topk
from repro.core.jax_engine import DcoEngineConfig as JaxConfig
from repro.core.jax_engine import build_device_state as jax_state
from repro.core.methods import make_method as ref_make_method
from repro.core.stream_engine import stream_topk as jax_stream_topk
from repro.search.ivf import IVFIndex as JaxIVF
from repro_torch.api import METHODS, SchedulePolicy, SearchSession, open_index
from repro_torch.convert import (index_from_reference, method_from_reference,
                                 state_from_reference)
from repro_torch.core.engine import QueryBatch, scan_topk
from repro_torch.core.stream_engine import stream_topk
from repro_torch.core.torch_engine import DcoEngineConfig, build_device_state
from repro_torch.search.ivf import IVFIndex
from repro_torch.vecdata import recall_at_k
from tests.test_torch_stream_engine import (D1, GROUPED, RULES, _fitted,
                                            _inputs, _theta)

K = 10
STAT_KEYS = ("survivors_mean", "screen_pass_mean", "uncertified_queries",
             "dims_read_mean")
POLICY = dict(d1=48, query_chunk=8, capacity=512, row_block=512,
              block_capacity=128)


def _ref_fitted(ds, name, n):
    m = ref_make_method(name).fit(ds.X[:n])
    if m.needs_training:
        rng = np.random.default_rng(7)
        m.train(ds.X[rng.choice(n, 24)], K, make_schedule(ds.dim))
    return m


# ------------------------------------------------------------ host scan ----
@pytest.mark.parametrize("name", METHODS)
def test_scan_topk_matches_reference(name, sift_small):
    """The host staged scan on the same fitted state: ids, distances and
    the batch's n_dco / dims_scanned equal to the last bit."""
    ds = sift_small
    ref_m = _ref_fitted(ds, name, 2000)
    port_m = method_from_reference(ref_m)
    rng = np.random.default_rng(3)
    cands = rng.permutation(2000)[:1500]
    jb = JaxBatch.create(ref_m, ds.Q[:4])
    tb = QueryBatch.create(port_m, ds.Q[:4])
    for qi in range(4):
        jd, ji = jax_scan_topk(ref_m, jb, qi, cands, K, block=256)
        td, ti = scan_topk(port_m, tb, qi, cands, K, block=256)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    assert tb.stats.n_dco == jb.stats.n_dco == 4 * 1500
    assert tb.stats.dims_scanned == jb.stats.dims_scanned
    assert tb.stats.n_true == jb.stats.n_true
    assert (tb.stats.extra["_completed_total"]
            == jb.stats.extra["_completed_total"])


def test_scan_topk_serves_policy_and_deadline(sift_small):
    """The host scan with the adaptive policy (its fdscan fallback) and
    with a deadline that does not fire: the reference's ids, distances
    and stats to the last bit, the policy's private accumulator and the
    coverage list included."""
    from repro.core.policy import PolicyConfig as JaxPolicyConfig
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.vecdata import make_ood_queries
    ref_m = _ref_fitted(sift_small, "PDScanning+", 2000)
    port_m = method_from_reference(ref_m)
    Q = make_ood_queries(sift_small.X[:2000], 3, severity=1.0)
    jb = JaxBatch.create(ref_m, Q)
    tb = QueryBatch.create(port_m, Q)
    for qi in range(3):
        jd, ji = jax_scan_topk(ref_m, jb, qi, np.arange(2000), K, block=256,
                               policy=JaxPolicyConfig(), deadline_ts=1e18)
        td, ti = scan_topk(port_m, tb, qi, np.arange(2000), K, block=256,
                           policy=PolicyConfig(), deadline_ts=1e18)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    assert tb.stats.dims_scanned == jb.stats.dims_scanned
    assert tb.stats.extra == jb.stats.extra
    assert tb.stats.extra["_adaptive_acc"]["fb"] > 0
    assert tb.stats.extra["_coverage"] == [1.0, 1.0, 1.0]


# ------------------------------------------------------------- IVFIndex ----
@pytest.mark.parametrize("with_method", [False, True])
def test_ivf_index_matches_reference(with_method, sift_small):
    """Build (with and without a DCO-screened final assignment), insert,
    probe_ids and search through scan_topk: the same seed gives the same
    centroids, lists, assignments and results."""
    ds = sift_small
    n = 1200
    ref_m = _ref_fitted(ds, "PDScanning+", n)
    port_m = method_from_reference(ref_m)
    kw = dict(n_list=16, seed=5, kmeans_iters=4)
    ja = JaxIVF(**kw).build(ds.X[:n], method=ref_m if with_method else None)
    ta = IVFIndex(**kw).build(ds.X[:n],
                              method=port_m if with_method else None)
    np.testing.assert_array_equal(ta.centroids, ja.centroids)
    assert len(ta.lists) == len(ja.lists) and ta.n == ja.n == n
    for a, b in zip(ta.lists, ja.lists):
        np.testing.assert_array_equal(a, b)
    assert set(ta.build_seconds) == {"lloyd", "assign"}
    new = ds.X[n:n + 40]
    jp = ja.insert(np.arange(n, n + 40), new,
                   method=ref_m if with_method else None)
    tp = ta.insert(np.arange(n, n + 40), new,
                   method=port_m if with_method else None)
    np.testing.assert_array_equal(tp, jp)
    assert ta.n == ja.n == n + 40
    for a, b in zip(ta.lists, ja.lists):
        np.testing.assert_array_equal(a, b)
    ref_m.append(new)
    port_m.append(new)
    jb = JaxBatch.create(ref_m, ds.Q[:4])
    tb = QueryBatch.create(port_m, ds.Q[:4])
    for qi in range(4):
        np.testing.assert_array_equal(ta.probe_ids(ds.Q[qi], 3),
                                      ja.probe_ids(ds.Q[qi], 3))
        jd, ji = ja.search(ref_m, jb, qi, K, 3)
        td, ti = ta.search(port_m, tb, qi, K, 3)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    assert tb.stats.dims_scanned == jb.stats.dims_scanned


# -------------------------------------------------- stream_topk + probe ----
def _ivf_state(method, index, Q, nprobe):
    """Partition-major device inputs, as both backends lay them out: the
    rows permuted by partition, their ids and partitions, and each query's
    probed partitions (the backends' centroid ranking)."""
    ds, ql, qt, qe = _inputs(method, Q)
    part = np.empty(method.state["N"], np.int64)
    for j, lst in enumerate(index.lists):
        part[lst] = j
    perm = np.argsort(part, kind="stable")
    dstate = dict(ds, Xrot=np.asarray(ds["Xrot"], np.float32)[perm])
    rows = {"row_ids": perm.astype(np.int32),
            "row_part": part[perm].astype(np.int32)}
    if ds["kind"] == "opq":
        rows["codes"] = np.asarray(ds["codes"], np.int32)[perm]
    cent = index.centroids
    d2 = (cent ** 2).sum(1)[None, :] - 2.0 * Q @ cent.T
    probe = np.argpartition(d2, nprobe - 1, axis=1)[:, :nprobe]
    return dstate, rows, ql, qt, qe, probe.astype(np.int32)


def _run_probe(dstate, rows, ql, qt, qe, probe, **kw):
    js = jax_state(dstate, D1)
    ts = build_device_state(dstate, D1, "cpu")
    for key, v in rows.items():
        js[key] = jnp.asarray(v)
        ts[key] = torch.as_tensor(v)
    if "codes" in rows:     # one byte a code, as the port's backend holds
        ts["codes"] = ts["codes"].to(torch.uint8)
    a = jax_stream_topk(js, jnp.asarray(ql), jnp.asarray(qt), JaxConfig(**kw),
                        {k: jnp.asarray(v) for k, v in qe.items()},
                        jnp.asarray(probe))
    b = stream_topk(ts, torch.as_tensor(ql), torch.as_tensor(qt),
                    DcoEngineConfig(**kw), state_from_reference(qe),
                    torch.as_tensor(probe))
    return tuple(np.asarray(x) for x in a), tuple(x.numpy() for x in b)


def _assert_parity(a, b):
    (jd, ji, js, jp, jm, jr), (td, ti, ts, tp, tm, tr) = a, b
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tm <= td[:, -1], jm <= jd[:, -1])


PROBE_CASES = ([(name, 1) for name in RULES]
               + [(name, 4) for name in GROUPED])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name,groups", PROBE_CASES)
def test_stream_topk_probe_matches_reference(name, groups, use_kernel,
                                             sift_small):
    """The device probe gate on a partition-major layout (16 lists, 4
    probed, 2,000 rows in 4 row blocks): unprobed blocks at tau = -1, rows
    of unprobed partitions masked, for every rule on the kernel op (the
    reference's Pallas kernels in interpret mode) and the inline screen,
    flat and at dim_groups = 4."""
    ds = sift_small
    n = 2000
    port_m = method_from_reference(_fitted(ds, name, n))
    index = JaxIVF(n_list=16, kmeans_iters=4).build(ds.X[:n])
    dstate, rows, ql, qt, qe, probe = _ivf_state(port_m, index, ds.Q[:8], 4)
    kw = dict(kind=dstate["kind"], d1=D1, k=K, query_chunk=8, row_block=512,
              block_capacity=128, use_kernel=use_kernel, dim_groups=groups,
              theta=_theta(dstate))
    if dstate["kind"] == "adsampling":
        kw["eps0"] = float(dstate["eps0"])
    a, b = _run_probe(dstate, rows, ql, qt, qe, probe, **kw)
    _assert_parity(a, b)
    # only rows of probed partitions come back
    part_of = {int(r): j for j, lst in enumerate(index.lists) for r in lst}
    for q in range(8):
        assert {part_of[int(r)] for r in b[1][q]} <= set(probe[q].tolist())


def test_stream_topk_probe_ragged_batch(sift_small):
    """A ragged batch pads its probe with the queries."""
    ds = sift_small
    port_m = method_from_reference(_fitted(ds, "PDScanning+", ds.n))
    index = JaxIVF(n_list=32, kmeans_iters=4).build(ds.X)
    dstate, rows, ql, qt, qe, probe = _ivf_state(port_m, index, ds.Q[:13], 6)
    kw = dict(kind="lb", d1=D1, k=K, query_chunk=8, row_block=512,
              block_capacity=128, use_kernel=False)
    a, b = _run_probe(dstate, rows, ql, qt, qe, probe, **kw)
    _assert_parity(a, b)
    with pytest.raises(ValueError, match="partition-major"):
        stream_topk(build_device_state(dstate, D1, "cpu"),
                    torch.as_tensor(ql), torch.as_tensor(qt),
                    DcoEngineConfig(**kw), probe=torch.as_tensor(probe))


# --------------------------------------------------------------- facade ----
@pytest.mark.parametrize("name,groups", [("PDScanning+", 1),
                                         ("PDScanning+", 4), ("DDCopq", 1),
                                         ("DDCres", 1), ("FDScanning", 1)])
def test_facade_ivf_matches_reference_jax_backend(name, groups, sift_small):
    """index='ivf' through both facades (each builds its own IVFIndex from
    the same seed): ids and stats equal at nprobe 2/8/32, distances within
    rtol 1e-4; for the exact rule recall grows with nprobe and reaches 1.0
    at full probe."""
    ds = sift_small
    gt, _ = ds.ground_truth(K)
    params = {"n_list": 32}
    pol = dict(POLICY, dim_groups=groups)
    sj = jax_open_index(ds.X, index="ivf", method=name, backend="jax",
                        schedule=JaxPolicy(**pol), index_params=params)
    st = open_index(ds.X, index="ivf", method=name, device="cpu",
                    schedule=SchedulePolicy(**pol), index_params=params)
    assert st.index_kind == "ivf" and st.index.n_list == 32
    recs = []
    for nprobe in (2, 8, 32):
        a = sj.search(ds.Q[:8], K, nprobe=nprobe)
        b = st.search(ds.Q[:8], K, nprobe=nprobe)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.dists, a.dists, rtol=1e-4)
        for key in STAT_KEYS:
            assert (key in b.stats.extra) == (key in a.stats.extra), key
            if key in a.stats.extra:
                assert b.stats.extra[key] == a.stats.extra[key], key
        assert b.stats.n_dco == a.stats.n_dco
        assert b.stats.dims_scanned == a.stats.dims_scanned
        if name != "FDScanning":
            assert b.stats.dims_scanned < b.stats.dims_total
        recs.append(recall_at_k(b.ids, gt[:8]))
    if name in ("PDScanning+", "FDScanning"):
        assert recs[0] <= recs[1] <= recs[2] == 1.0
    if groups > 1:
        assert st.backend._blocks["xl"].dim() == 4


def test_facade_ivf_default_lists_and_hnsw_refused(sift_small):
    X = sift_small.X[:1000]
    sess = open_index(X, index="ivf", method="PDScanning+", device="cpu")
    assert sess.index.n_list == 64 and len(sess.index.lists) == 64
    with pytest.raises(ValueError, match="host"):
        open_index(X, index="hnsw", method="PDScanning+", device="cpu")
    with pytest.raises(ValueError, match="index must be"):
        open_index(X, index="lsh", method="PDScanning+", device="cpu")


def test_convert_index_from_reference(sift_small):
    """A converted index and method probe the same partitions as the
    reference session that built them, so the two sessions agree."""
    ds = sift_small
    sj = jax_open_index(ds.X[:3000], index="ivf", method="PDScanning+",
                        backend="jax", schedule=JaxPolicy(**POLICY),
                        index_params={"n_list": 24, "seed": 3})
    idx = index_from_reference(sj.index)
    assert type(idx).__module__ == "repro_torch.search.ivf"
    assert idx.n_list == 24 and idx.n == 3000 and idx.seed == 3
    np.testing.assert_array_equal(idx.centroids, sj.index.centroids)
    assert idx.lists[0] is not sj.index.lists[0]
    for a, b in zip(idx.lists, sj.index.lists):
        np.testing.assert_array_equal(a, b)
    st = SearchSession(method_from_reference(sj.method),
                       SchedulePolicy(**POLICY), index_kind="ivf", index=idx,
                       device="cpu")
    a = sj.search(ds.Q[:8], K, nprobe=5)
    b = st.search(ds.Q[:8], K, nprobe=5)
    np.testing.assert_array_equal(b.ids, a.ids)
    assert b.stats.n_dco == a.stats.n_dco


@pytest.mark.parametrize("k", [1, 7, 64])
def test_cluster_sums_equal_the_scatter_they_replace(k):
    """The host k-means' per-cluster sums (IVF Lloyd and the PQ codebooks)
    are np.add.at's numbers bit for bit: empty clusters, a cluster of
    -0.0 rows (0.0 from a zero start) and float32 rows summed in float64
    in row order."""
    from repro_torch.core.transforms import cluster_sums
    rng = np.random.default_rng(k)
    X = (rng.standard_normal((3000, 24)) * 1e3).astype(np.float32)
    assign = rng.integers(0, max(k - 2, 1), 3000)     # the last ones empty
    X[assign == 0] = -0.0
    want = np.zeros((k, 24), np.float64)
    np.add.at(want, assign, X)
    sums, counts = cluster_sums(X, assign, k)
    np.testing.assert_array_equal(counts, np.bincount(assign, minlength=k))
    assert sums.dtype == np.float64
    assert want.tobytes() == sums.tobytes()        # the signs of zeros too

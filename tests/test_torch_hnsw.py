"""The port's HNSW index (repro_torch.search.hnsw) against the reference's
(repro.search.hnsw) for equal seeds: the same graph (levels, links, entry,
top level), the same ids, distances and ScanStats after ``build``,
``insert_batch`` and ``search``, for FDScanning, PDScanning+ (its screen
reads incremental dim ranges) and an estimator, DADE; and the facade's
HNSW sessions, ``add()`` included, against the reference facade's."""
import numpy as np
import pytest

from repro.core.engine import QueryBatch as RefBatch
from repro.core.engine import ScanStats as RefStats
from repro.core.engine import make_schedule
from repro.core.methods import make_method as ref_make_method
from repro.search.hnsw import HNSWIndex as RefHNSW
from repro_torch.core.engine import QueryBatch, ScanStats
from repro_torch.core.methods import make_method
from repro_torch.search.hnsw import HNSWIndex

K = 10
METHODS = ("FDScanning", "PDScanning+", "DADE")


def _data(n=360, dim=48, nq=8, seed=0):
    """Rows with a decaying spectrum, so the lead dims carry the energy
    the screening rules prune on."""
    rng = np.random.default_rng(seed)
    scale = np.linspace(2.0, 0.2, dim).astype(np.float32)
    X = (rng.normal(size=(n + 40, dim)) * scale).astype(np.float32)
    Q = (rng.normal(size=(nq, dim)) * scale).astype(np.float32)
    return X[:n], X[n:], Q


def _same_graph(a, b):
    assert b.levels == a.levels
    assert (b.entry, b.max_level) == (a.entry, a.max_level)
    assert len(b.links) == len(a.links)
    for la, lb in zip(a.links, b.links):
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(y, x)


def _same_stats(a, b):
    assert (b.n_dco, b.n_true) == (a.n_dco, a.n_true)
    assert b.dims_scanned == a.dims_scanned
    assert b.dims_total == a.dims_total


@pytest.mark.parametrize("name", METHODS)
def test_hnsw_matches_reference(name):
    X, Xnew, Q = _data()
    sched = make_schedule(X.shape[1])
    ref_m = ref_make_method(name, seed=0).fit(X)
    port_m = make_method(name, seed=0).fit(X)
    ref_st, port_st = RefStats(), ScanStats()
    ref = RefHNSW(m=6, ef_construction=24, seed=3).build(
        X, method=ref_m, schedule=sched, stats=ref_st)
    port = HNSWIndex(m=6, ef_construction=24, seed=3).build(
        X, method=port_m, schedule=sched, stats=port_st)
    _same_graph(ref, port)
    _same_stats(ref_st, port_st)
    assert port_st.n_dco > 0

    ref_st, port_st = RefStats(), ScanStats()
    ref.insert_batch(ref_m, Xnew, stats=ref_st, schedule=sched)
    port.insert_batch(port_m, Xnew, stats=port_st, schedule=sched)
    _same_graph(ref, port)
    _same_stats(ref_st, port_st)
    assert port_m.state["N"] == X.shape[0] + Xnew.shape[0]

    rb = RefBatch.create(ref_m, Q, sched)
    pb = QueryBatch.create(port_m, Q, sched)
    for qi in range(Q.shape[0]):
        rd, ri = ref.search(ref_m, rb, qi, K, 40)
        pd, pi = port.search(port_m, pb, qi, K, 40)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pd, rd)
    _same_stats(rb.stats, pb.stats)


def test_hnsw_recall_on_a_small_corpus():
    """The port's walk finds the true neighbours on a small corpus (the
    reference's test_hnsw_build_and_search at a smaller size)."""
    X, _, Q = _data(n=400, seed=1)
    sched = make_schedule(X.shape[1])
    m = make_method("PDScanning+").fit(X)
    idx = HNSWIndex(m=8, ef_construction=40).build(X, method=m,
                                                   schedule=sched)
    batch = QueryBatch.create(m, Q, sched)
    found = np.stack([idx.search(m, batch, qi, K, 90)[1]
                      for qi in range(Q.shape[0])])
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, 1)[:, :K]
    hits = np.mean([len(set(f) & set(g)) / K for f, g in zip(found, gt)])
    assert hits >= 0.9, hits


@pytest.mark.parametrize("name", ["PDScanning+", "DADE"])
def test_facade_hnsw_session_matches_reference(name):
    """open_index(index="hnsw", backend="host") and add() against the
    reference facade: the same graph, ids and stats before and after the
    add, which links the new rows ("noop" write mode)."""
    from repro.api import open_index as ref_open_index
    from repro_torch.api import open_index
    X, Xnew, Q = _data(seed=2)
    params = {"m": 6, "ef_construction": 24}
    sj = ref_open_index(X, index="hnsw", method=name, backend="host",
                        index_params=params)
    st = open_index(X, index="hnsw", method=name, backend="host",
                    index_params=params)
    _same_graph(sj.index, st.index)
    for _ in range(2):
        rj, rt = sj.search(Q, K, ef=40), st.search(Q, K, ef=40)
        np.testing.assert_array_equal(rt.ids, rj.ids)
        np.testing.assert_array_equal(rt.dists, rj.dists)
        _same_stats(rj.stats, rt.stats)
        assert rt.stats.extra["uncertified_queries"] == 0.0
        sj.add(Xnew)
        st.add(Xnew)
        assert st.last_write_mode == "noop"
        _same_graph(sj.index, st.index)
    assert st.n == X.shape[0] + 2 * Xnew.shape[0]

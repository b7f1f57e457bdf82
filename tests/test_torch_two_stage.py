"""The port's two-stage engine (``core.torch_engine.two_stage_topk``)
against the reference ``repro.core.jax_engine.two_stage_topk`` on the same
fitted state, for the 6 partial rules and fdscan with a ragged query
batch, and ``SchedulePolicy(engine="two_stage")`` through the facade
against the reference facade on its jax backend: ids exact, distances
within rtol 1e-4, survivors and the stats the reference reports exact (the
two-stage engine has no certificate, so neither reports one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.jax_engine import DcoEngineConfig as JaxConfig
from repro.core.jax_engine import build_device_state as jax_state
from repro.core.jax_engine import two_stage_topk as jax_two_stage
from repro_torch.api import SchedulePolicy, open_index
from repro_torch.convert import method_from_reference, state_from_reference
from repro_torch.core.torch_engine import (DcoEngineConfig,
                                           build_device_state, two_stage_topk)
from repro_torch.vecdata import recall_at_k
from tests.test_torch_stream_engine import D1, _fitted, _inputs, _theta

K = 10
#: the two-stage engine's rules: the 6 partial rules and fdscan (DDCopq's
#: opq rule is stream-only; PDScanning and PDScanning+ share lb)
TWO_STAGE_RULES = {"FDScanning": "fdscan", "PDScanning": "lb",
                   "PDScanning+": "lb", "ADSampling": "adsampling",
                   "DADE": "dade", "DDCres": "ddcres", "DDCpca": "ratio"}
STAT_KEYS = ("survivors_mean", "screen_pass_mean", "uncertified_queries",
             "uncertified_mask", "dims_read_mean")
POLICY = dict(d1=48, query_chunk=8, capacity=512, row_block=512,
              block_capacity=128, engine="two_stage")


@pytest.mark.parametrize("name", list(TWO_STAGE_RULES))
def test_two_stage_topk_matches_reference(name, sift_small):
    """13 queries in chunks of 8 (ragged) at capacity 512 over 5,000
    rows."""
    ds = sift_small
    port_m = method_from_reference(_fitted(ds, name, ds.n))
    dstate, ql, qt, qe = _inputs(port_m, ds.Q[:13])
    assert dstate["kind"] == TWO_STAGE_RULES[name]
    kw = dict(kind=dstate["kind"], d1=D1, k=K, capacity=512, query_chunk=8,
              theta=_theta(dstate))
    if dstate["kind"] == "adsampling":
        kw["eps0"] = float(dstate["eps0"])
    a = jax_two_stage(jax_state(dstate, D1), jnp.asarray(ql), jnp.asarray(qt),
                      JaxConfig(**kw),
                      {k: jnp.asarray(v) for k, v in qe.items()})
    b = two_stage_topk(build_device_state(dstate, D1, "cpu"),
                       torch.as_tensor(ql), torch.as_tensor(qt),
                       DcoEngineConfig(**kw), state_from_reference(qe))
    (jd, ji, js), (td, ti, ts) = (tuple(np.asarray(x) for x in a),
                                  tuple(x.numpy() for x in b))
    assert ti.shape == (13, K) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_array_equal(ts, js)
    gt, _ = sift_small.ground_truth(K)
    assert recall_at_k(ti, gt[:13]) >= 0.9
    with pytest.raises(ValueError, match="at least one query"):
        two_stage_topk(build_device_state(dstate, D1, "cpu"),
                       torch.zeros(0, D1), torch.zeros(0, ds.dim - D1),
                       DcoEngineConfig(**kw))


@pytest.mark.parametrize("name", ["FDScanning", "PDScanning+", "DADE",
                                  "DDCres", "DDCpca"])
def test_facade_two_stage_matches_reference_jax_backend(name, sift_small):
    ds = sift_small
    rj = jax_open_index(ds.X, method=name, backend="jax",
                        schedule=JaxPolicy(**POLICY)).search(ds.Q[:11], K)
    sess = open_index(ds.X, method=name, device="cpu",
                      schedule=SchedulePolicy(**POLICY))
    rt = sess.search(ds.Q[:11], K)
    assert sess.backend._resolved_engine() == "two_stage"
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)
    for key in STAT_KEYS:
        assert (key in rt.stats.extra) == (key in rj.stats.extra), key
        if key in rj.stats.extra:
            assert rt.stats.extra[key] == rj.stats.extra[key], key
    assert "uncertified_queries" not in rt.stats.extra
    assert rt.stats.n_dco == rj.stats.n_dco
    assert rt.stats.dims_scanned == rj.stats.dims_scanned
    # the row-major layout alone: no blocks, no pad rows
    be = sess.backend
    assert be._blocks is None and be._state["x_lead"].shape == (ds.n, 48)


@pytest.mark.parametrize("name,index", [("DDCopq", "flat"),
                                        ("PDScanning+", "ivf")])
def test_two_stage_falls_back_to_stream(name, index, sift_small):
    """opq and IVF probing are stream-only: with engine='two_stage' both
    packages serve them by the streaming engine, with its certificate."""
    ds = sift_small
    X = ds.X[:3000]
    params = {"n_list": 16} if index == "ivf" else None
    rj = jax_open_index(X, index=index, method=name, backend="jax",
                        schedule=JaxPolicy(**POLICY),
                        index_params=params).search(ds.Q[:8], K, nprobe=4)
    sess = open_index(X, index=index, method=name, device="cpu",
                      schedule=SchedulePolicy(**POLICY), index_params=params)
    rt = sess.search(ds.Q[:8], K, nprobe=4)
    assert sess.backend._resolved_engine() == "stream"
    assert sess.backend._blocks is not None
    np.testing.assert_array_equal(rt.ids, rj.ids)
    assert "uncertified_queries" in rt.stats.extra
    assert rt.stats.dims_scanned == rj.stats.dims_scanned


def test_two_stage_add_rebuilds(sift_small):
    """The delta segment is stream-only: an add to a two-stage session
    rebuilds the layout, and the new rows are found."""
    ds = sift_small
    sess = open_index(ds.X[:2000], method="PDScanning+", device="cpu",
                      schedule=SchedulePolicy(**POLICY))
    sess.search(ds.Q[:4], K)
    sess.add(ds.Q[:2])
    assert sess.last_write_mode == "rebuild" and sess.backend._dstate is None
    res = sess.search(ds.Q[:2], K)
    np.testing.assert_array_equal(res.ids[:, 0], [2000, 2001])
    assert sess.backend.notify_append(1) == "rebuild"

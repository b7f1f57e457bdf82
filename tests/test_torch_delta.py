"""The port's LSM delta write path against the reference jax backend:
``append_stream_blocks`` (flat and PDX, with partitions and codes), and
sessions after the same ``add()`` calls with the non-adaptive policy — the
delta answers as a merged layout over the same fitted state does, repeated
adds accumulate, the merge threshold re-materializes, threshold 0
rebuilds, an IVF delta at nprobe = n_list, a DDCres delta whose rows have
less tail energy than any main row, and a DDCopq delta whose codes stay
one byte each.

Parity convention (the reference's tests/test_serving_search.py): every
comparison reuses the SAME fitted method object; block_capacity equals
row_block, so every scan is certified and ids compare exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.stream_engine import append_stream_blocks as jax_append
from repro.core.stream_engine import build_stream_blocks as jax_blocks
from repro_torch.api import SchedulePolicy, SearchSession, open_index
from repro_torch.core.engine import EXTRA_UNCERTIFIED_MASK
from repro_torch.core.stream_engine import (append_stream_blocks,
                                            build_stream_blocks)

K = 10
STAT_KEYS = ("survivors_mean", "screen_pass_mean", "uncertified_queries",
             "dims_read_mean")


def _data(n=1536, d=48, nq=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


def _kw(**kw):
    kw.setdefault("d1", 24)
    kw.setdefault("query_chunk", 4)
    kw.setdefault("row_block", 256)
    kw.setdefault("block_capacity", 256)
    return kw


def _pair(X, *, index="flat", method="PDScanning+", params=None, **kw):
    """The same corpus opened by the reference facade (jax backend) and by
    the port on the CPU."""
    sj = jax_open_index(X, index=index, method=method, backend="jax",
                        schedule=JaxPolicy(**_kw(**kw)), index_params=params)
    st = open_index(X, index=index, method=method, device="cpu",
                    schedule=SchedulePolicy(**_kw(**kw)),
                    index_params=params)
    return sj, st


def _same(a, b, stats=True):
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_allclose(b.dists, a.dists, rtol=1e-4)
    if stats:
        for key in STAT_KEYS:
            assert (key in b.stats.extra) == (key in a.stats.extra), key
            if key in a.stats.extra:
                assert b.stats.extra[key] == a.stats.extra[key], key
        assert b.stats.n_dco == a.stats.n_dco
        assert b.stats.dims_scanned == a.stats.dims_scanned


def _merged(sess, **kw):
    return SearchSession(sess.method, SchedulePolicy(**_kw(**kw)),
                         index_kind=sess.index_kind, index=sess.index,
                         device="cpu")


# ------------------------------------------------- append_stream_blocks ----
@pytest.mark.parametrize("groups", [1, 4])
def test_append_stream_blocks_matches_reference(groups):
    """A 70-row delta (partitions edge-padded, uint8 codes kept one byte)
    appended after a 3-block main layout: every plane equals the
    reference's, block for block."""
    rng = np.random.default_rng(groups)
    d1, D, B = 20, 32, 64

    def state(n, lo, with_pad_ids):
        x = rng.normal(size=(n, D)).astype(np.float32)
        return {"x_lead": x[:, :d1], "x_tail": x[:, d1:],
                "lead_sq": (x[:, :d1] ** 2).sum(1),
                "tail_sq": (x[:, d1:] ** 2).sum(1),
                "row_ids": np.arange(lo, lo + n, dtype=np.int32),
                "row_part": np.sort(rng.integers(0, 9, n)).astype(np.int32),
                "codes": rng.integers(0, 256, (n, 4)).astype(np.uint8)}

    main, delta = state(3 * B, 0, False), state(70, 3 * B, True)
    jm = jax_blocks({k: jnp.asarray(v) for k, v in main.items()}, B,
                    dim_groups=groups)
    ja = jax_append(jm, {k: jnp.asarray(v) for k, v in delta.items()})
    tm = build_stream_blocks({k: torch.as_tensor(v) for k, v in main.items()},
                             B, dim_groups=groups)
    ta = append_stream_blocks(tm, {k: torch.as_tensor(v)
                                   for k, v in delta.items()})
    assert set(ta) == set(ja)
    assert ta["xl"].shape[0] == 5 and ta["codes"].dtype == torch.uint8
    for key in ja:
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]),
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(ta["ids"][4, 6:].numpy(), -1)
    assert (ta["part"][4, 6:] == int(delta["row_part"][-1])).all()
    with pytest.raises(ValueError, match="keys differ"):
        append_stream_blocks(tm, {k: torch.as_tensor(v)
                                  for k, v in delta.items()
                                  if k != "row_part"})


# ------------------------------------------------------- delta sessions ----
@pytest.mark.parametrize("groups", [1, 4])
def test_flat_delta_matches_merged_layout_and_reference(groups):
    X, Q = _data()
    sj, st = _pair(X[:1200], dim_groups=groups)
    sj.search(Q, K)
    st.search(Q, K)
    n_main0, written0 = st.backend._n_main, st.backend.rows_written
    sj.add(X[1200:])
    st.add(X[1200:])
    assert st.last_write_mode == sj.last_write_mode == "delta"
    rd = st.search(Q, K)
    _same(sj.search(Q, K), rd)
    # an insert below the merge threshold does not re-materialize the main
    # layout: only the delta rows are written
    be = st.backend
    assert be._n_main == n_main0 and be.merges == 0
    assert be.rows_written == written0 + (X.shape[0] - 1200)
    assert be.delta_rows == X.shape[0] - 1200 == 336
    assert be.rows_inserted == 336
    assert be._delta_blocks["xl"].shape[0] == 5 + 2      # 1200 + 336 rows
    rm = _merged(st, dim_groups=groups).search(Q, K)
    np.testing.assert_array_equal(rd.ids, rm.ids)
    np.testing.assert_allclose(rd.dists, rm.dists, rtol=1e-5, atol=1e-5)
    assert not rd.stats.extra[EXTRA_UNCERTIFIED_MASK].any()


def test_repeated_adds_accumulate_in_delta():
    X, Q = _data()
    sj, st = _pair(X[:1200])
    sj.search(Q, 5)
    st.search(Q, 5)
    for lo in range(1200, X.shape[0], 112):
        sj.add(X[lo:lo + 112])
        st.add(X[lo:lo + 112])
        assert st.last_write_mode == "delta"
        _same(sj.search(Q, 5), st.search(Q, 5))
    assert st.backend.rows_written == sj.backend.rows_written
    rm = _merged(st).search(Q, 5)
    np.testing.assert_array_equal(st.search(Q, 5).ids, rm.ids)


def test_merge_threshold_triggers_rematerialization():
    X, Q = _data()
    sj, st = _pair(X[:1200], delta_merge_threshold=200)
    st.search(Q, K)
    sj.search(Q, K)
    st.add(X[1200:1350])
    assert st.last_write_mode == "delta"
    st.add(X[1350:])                            # delta would exceed 200
    assert st.last_write_mode == "merge" and st.backend.merges == 1
    sj.add(X[1200:1350])
    sj.add(X[1350:])
    rd = st.search(Q, K)
    assert st.backend._n_main == X.shape[0] and st.backend.delta_rows == 0
    _same(sj.search(Q, K), rd)
    np.testing.assert_array_equal(
        rd.ids, _merged(st, delta_merge_threshold=200).search(Q, K).ids)


def test_zero_threshold_disables_delta_path():
    X, Q = _data()
    sess = open_index(X[:1200], method="PDScanning+", device="cpu",
                      schedule=SchedulePolicy(**_kw(delta_merge_threshold=0)))
    assert sess.add(X[1200:1210]).last_write_mode == "cold"
    sess.search(Q, K)
    sess.add(X[1210:])
    assert sess.last_write_mode == "rebuild"
    sess.search(Q, K)
    assert sess.backend._n_main == X.shape[0]


@pytest.mark.parametrize("groups", [1, 4])
def test_ivf_delta_matches_reference_at_full_probe(groups):
    """An IVF delta: the new rows' partitions come from IVFIndex.insert;
    at nprobe = n_list the result is exact and equals the reference's,
    and the candidate counts include the delta rows."""
    X, Q = _data()
    params = {"n_list": 16}
    sj, st = _pair(X[:1200], index="ivf", params=params, dim_groups=groups)
    sj.search(Q, K, nprobe=16)
    st.search(Q, K, nprobe=16)
    sj.add(X[1200:])
    st.add(X[1200:])
    assert st.last_write_mode == "delta"
    assert st.backend._delta_parts.shape == (336,)
    for nprobe in (4, 16):
        _same(sj.search(Q, K, nprobe=nprobe), st.search(Q, K, nprobe=nprobe))
    rd = st.search(Q, K, nprobe=16)
    assert rd.stats.n_dco == Q.shape[0] * X.shape[0]
    rm = _merged(st, dim_groups=groups).search(Q, K, nprobe=16)
    np.testing.assert_array_equal(rd.ids, rm.ids)
    with pytest.raises(ValueError, match="partition assignment"):
        st.backend.notify_append(1)


def test_ddcres_delta_threads_the_lower_tail_min():
    """Delta rows at the corpus mean carry almost no tail energy, less than
    any main row: the combined minimum reaches the screen, and the session
    answers as the reference's does."""
    X, Q = _data()
    sj, st = _pair(X[:1200], method="DDCres")
    sj.search(Q, K)
    st.search(Q, K)
    rng = np.random.default_rng(9)
    new = (X[:1200].mean(0) + 1e-3 * rng.normal(size=(40, X.shape[1]))
           ).astype(np.float32)
    new = np.concatenate([new, X[1200:1300]])
    sj.add(new)
    st.add(new)
    rd = st.search(Q, K)
    be = st.backend
    assert float(be._delta_state["tail_min"]) < float(be._state["tail_min"])
    _same(sj.search(Q, K), rd)


def test_ddcopq_delta_codes_stay_one_byte():
    X, Q = _data()
    sj, st = _pair(X[:1200], method="DDCopq")
    sj.search(Q, K)
    st.search(Q, K)
    assert st.backend._blocks["codes"].dtype == torch.uint8
    sj.add(X[1200:])
    st.add(X[1200:])
    rd = st.search(Q, K)
    assert st.backend._delta_blocks["codes"].dtype == torch.uint8
    _same(sj.search(Q, K), rd)

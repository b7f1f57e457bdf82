"""The port's top-k selection (``stream_engine._smallest``) against the
reference's ``jax.lax.top_k(-a, n)``: the same values and the same column
indices, exactly, on rows with heavy ties, +inf padding, signed zeros and
negative values, at the widths the engines select from."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.stream_engine import _merge_topk, _smallest

#: (rows, width, n): k + C = 10 + 128 (a merge), a row block B = 4,096
#: (the observer cut, C + 1 = 129 of them), IVF's whole-block merge
#: k + 4,096 = 4,106, and a (16, 2^17) two-stage tile (k and the capacity)
SHAPES = [(16, 138, 10), (16, 4096, 129), (16, 4106, 10), (16, 4106, 4096),
          (16, 2 ** 17, 10), (16, 2 ** 17, 2048)]


def _reference(a, n):
    neg, pos = jax.lax.top_k(-jnp.asarray(a), n)
    return -np.asarray(neg), np.asarray(pos)


def _port(a, n):
    vals, idx = _smallest(torch.as_tensor(a), n)
    return vals.numpy(), idx.numpy()


def _assert_same(a, n):
    want_v, want_i = _reference(a, n)
    got_v, got_i = _port(a, n)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    # signed zeros too: assert_array_equal holds -0.0 == +0.0
    np.testing.assert_array_equal(np.signbit(got_v), np.signbit(want_v))


def _rows(kind, rows, width, rng):
    if kind == "ties":          # a handful of distinct values
        return rng.integers(0, 5, (rows, width)).astype(np.float32)
    if kind == "inf_padding":   # most columns +inf, as masked scores are
        a = rng.random((rows, width)).astype(np.float32)
        a[rng.random((rows, width)) < 0.9] = np.inf
        return a
    if kind == "signed_zeros":  # -0.0 beside +0.0, as clamp_min yields
        return rng.choice(np.array([0.0, -0.0, 0.5], np.float32),
                          (rows, width))
    if kind == "negative":      # DDCres estimates can be negative
        a = rng.normal(size=(rows, width)).astype(np.float32)
        a[:, ::7] = -np.abs(a[:, ::7]).round(1)      # negative ties
        return a
    raise ValueError(kind)


@pytest.mark.parametrize("rows,width,n", SHAPES)
@pytest.mark.parametrize("kind", ["ties", "inf_padding", "signed_zeros",
                                  "negative"])
def test_smallest_matches_lax_top_k(kind, rows, width, n):
    rng = np.random.default_rng([rows, width, n, len(kind)])
    _assert_same(_rows(kind, rows, width, rng), n)


@pytest.mark.parametrize("width", [1, 138, 4106])
def test_smallest_whole_row_and_one(width):
    """n = 1 and n = width (a full ordering of the row)."""
    rng = np.random.default_rng(width)
    a = rng.choice(np.array([0.0, -0.0, -1.0, 2.0, np.inf], np.float32),
                   (3, width))
    _assert_same(a, 1)
    _assert_same(a, width)


def test_smallest_all_inf_keeps_index_order():
    a = np.full((2, 300), np.inf, np.float32)
    _, idx = _port(a, 300)
    np.testing.assert_array_equal(idx, np.broadcast_to(np.arange(300),
                                                       (2, 300)))
    _assert_same(a, 17)


def test_merge_topk_matches_reference():
    """The engine's merge of a running top-k with a block's completions:
    values and the ids they carry, as the reference's ``_merge_topk``."""
    from repro.core.stream_engine import _merge_topk as ref_merge
    rng = np.random.default_rng(7)
    best_d = np.sort(rng.integers(0, 4, (16, 10)).astype(np.float32), 1)
    best_i = rng.integers(0, 1000, (16, 10)).astype(np.int32)
    new_d = rng.integers(0, 4, (16, 4096)).astype(np.float32)
    new_d[rng.random(new_d.shape) < 0.5] = np.inf
    new_i = rng.integers(0, 10 ** 6, (16, 4096)).astype(np.int32)
    want = ref_merge(*(jnp.asarray(x) for x in (best_d, best_i, new_d,
                                                 new_i)), 10)
    got = _merge_topk(*(torch.as_tensor(x) for x in (best_d, best_i, new_d,
                                                      new_i)), 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

"""The plain reference against a numpy brute force, the TF32 rounding of
the control, and the comparison's numbers."""
import numpy as np
import pytest
import torch

from perfbench import check, reference


def _brute(X, Q, k):
    d = ((Q[:, None, :].astype(np.float64) - X[None].astype(np.float64)) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("row_block", [7, 64, 1000])
def test_reference_matches_numpy_brute_force(row_block):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 24)).astype(np.float32)
    Q = rng.standard_normal((17, 24)).astype(np.float32)
    want_d, want_i = _brute(X, Q, 10)
    d, i = reference.topk(torch.as_tensor(X), torch.as_tensor(Q), 10,
                          row_block=row_block)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-10, atol=1e-10)
    got = reference.distances(torch.as_tensor(X), torch.as_tensor(Q), i)
    np.testing.assert_allclose(got.numpy(), want_d, rtol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -13,
                      1.0 + 2.0 ** -12, -3.0], dtype=torch.float32)
    r = reference.round_tf32(x)
    assert r.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0]
    bits = r.view(torch.int32) & 0x1FFF
    assert not bits.any()


def _case():
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((500, 32)).astype(np.float32))
    Q = torch.as_tensor(rng.standard_normal((20, 32)).astype(np.float32))
    d, i = reference.topk(X, Q, 10)
    qidx = np.r_[np.arange(20), np.arange(20)]
    return X, Q, qidx, i.numpy()[qidx], d.numpy().astype(np.float32)[qidx]


def test_exact_answers_read_zero_gap():
    X, Q, qidx, ids, dists = _case()
    n = check.compare(X, Q, qidx, ids, dists, k=10)
    assert n["rank_gap"] < 1e-12 and n["dist_err"] < 1e-6
    assert n["recall_at_10"] == 1.0 and n["answers_checked"] == 40


@pytest.mark.parametrize("fault", ["wrong_id", "repeated_id", "out_of_range",
                                   "swapped_order", "wrong_distance"])
def test_each_fault_shows_in_a_number(fault):
    X, Q, qidx, ids, dists = _case()
    ids, dists = ids.copy(), dists.copy()
    if fault == "wrong_id":
        far = reference.topk(X, -Q[:1], 1)[1].item()     # far from query 0
        ids[0, 3] = far
    elif fault == "repeated_id":
        ids[5, 9] = ids[5, 8]
    elif fault == "out_of_range":
        ids[2, 0] = 10_000
    elif fault == "swapped_order":
        ids[7, [0, 9]] = ids[7, [9, 0]]
    else:
        dists[4, 2] *= 1.01
    n = check.compare(X, Q, qidx, ids, dists, k=10)
    assert max(n["rank_gap"], n["dist_err"]) > 1e-3, n

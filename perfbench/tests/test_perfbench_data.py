"""The seeded corpora and query pools of ``data.py``, at a small size on
the CPU."""
import torch

from perfbench import data

GIST = {"n": 4000, "dim": 64, "queries": 300,
        "generator": {"family": "gist", "spectrum_alpha": 0.6,
                      "n_clusters": 16, "nonneg": True}}


def test_same_seed_same_arrays_other_seed_others():
    X1, Q1 = data.make(GIST, 2 ** 31 + 5, "cpu")
    X2, Q2 = data.make(GIST, 2 ** 31 + 5, "cpu")
    X3, _ = data.make(GIST, 2 ** 31 + 6, "cpu")
    assert torch.equal(X1, X2) and torch.equal(Q1, Q2)
    assert not torch.equal(X1, X3)
    assert X1.shape == (4000, 64) and Q1.shape == (300, 64)
    assert X1.dtype == Q1.dtype == torch.float32


def test_ood_pool_moves_energy_into_low_variance_directions():
    """At severity 1 the OOD queries put the energy of the corpus's top
    principal directions into its bottom ones; their mean norm is the
    corpus's."""
    X, Qin = data.make(GIST, 9, "cpu")
    _, Qood = data.make(GIST, 9, "cpu", pool="ood", severity=1.0)
    mu = X.double().mean(0)
    _, V = torch.linalg.eigh(torch.cov((X.double() - mu).T))  # ascending
    low = V[:, :16]

    def low_share(Q):
        c = Q.double() - mu
        return float(((c @ low) ** 2).sum() / (c ** 2).sum())
    assert low_share(Qood) > 10 * low_share(Qin)
    ratio = torch.linalg.vector_norm(Qood, dim=1).mean() / \
        torch.linalg.vector_norm(X, dim=1).mean()
    assert abs(float(ratio) - 1.0) < 1e-4

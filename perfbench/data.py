"""Seeded corpora and query pools, made on the device.

A frozen copy of the dataset families of ``repro_torch/vecdata/
synthetic.py`` (``_mixture``, ``_rotate``, ``make_ood_queries``),
rewritten in torch so that a 1M x 960 or 10M x 96 corpus is drawn on the
card in a few large calls instead of in host numpy.  The draws follow the
same recipe (an anisotropic Gaussian mixture with a power-law spectrum,
made non-negative for GIST, then a random rotation) but not the same
random stream, so the arrays differ from the port's.

Every array comes from ``seed`` alone: the same seed gives the same
corpus and queries on the same device type.
"""
from __future__ import annotations

import torch

#: rows drawn and rotated at a time, so the temporaries stay small
CHUNK_ROWS = 1 << 17
#: rows of the corpus sampled for the OOD shift's covariance
OOD_SAMPLE = 20_000


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of ``seed``, so that
    the corpus, the pools and the traffic draw independent numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) % (1 << 62))
    return g


class Family:
    """One dataset family: the mixture's centres, its spectrum and its
    rotation, drawn once from the seed; rows are then drawn from it in
    chunks."""

    def __init__(self, spec: dict, seed: int, device):
        self.dim = int(spec["dim"])
        self.nonneg = bool(spec["nonneg"])
        self.device = torch.device(device)
        g = generator(seed, device, 1)
        d = self.dim
        self.scales = torch.arange(1, d + 1, dtype=torch.float32,
                                   device=device) ** -float(spec["spectrum_alpha"])
        self.centers = torch.randn(int(spec["n_clusters"]), d, generator=g,
                                   device=device) * self.scales * 3.0
        # a Haar rotation, so the original dim order carries no free PCA
        # signal (the port's families rotate the same way below 2,048 dims)
        a = torch.randn(d, d, generator=g, device=device, dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        self.rotation = (q * torch.sign(torch.diagonal(r))[None, :]).float()

    def draw(self, n: int, g: torch.Generator, out: torch.Tensor | None = None):
        """``n`` rows of the family, (n, dim) float32 on the device."""
        if out is None:
            out = torch.empty(n, self.dim, device=self.device)
        for lo in range(0, n, CHUNK_ROWS):
            m = min(CHUNK_ROWS, n - lo)
            assign = torch.randint(0, self.centers.shape[0], (m,), generator=g,
                                   device=self.device)
            z = torch.randn(m, self.dim, generator=g, device=self.device)
            x = self.centers[assign] + z * self.scales
            if self.nonneg:
                x.abs_()
            torch.matmul(x, self.rotation, out=out[lo:lo + m])
        return out


def ood_queries(X: torch.Tensor, nq: int, g: torch.Generator, *,
                severity: float = 1.0) -> torch.Tensor:
    """Queries whose energy per principal direction of ``X`` is moved
    towards the corpus's low-variance directions (the port's
    ``make_ood_queries``): at ``severity`` 1 the spectrum is reversed.
    Norms are rescaled to the corpus's mean row norm."""
    n, d = X.shape
    pick = torch.randperm(n, generator=g, device=X.device)[:min(n, OOD_SAMPLE)]
    mu = X.double().mean(0)
    sub = X[pick].double() - mu
    cov = sub.T @ sub / max(sub.shape[0] - 1, 1)
    lam, V = torch.linalg.eigh(cov)                    # ascending
    lam = lam.flip(0).clamp_min(1e-12)
    V = V.flip(1)
    std = lam.sqrt()
    w = std ** (1.0 - severity) * std.flip(0) ** severity
    z = torch.randn(nq, d, generator=g, device=X.device, dtype=torch.float64)
    Q = (mu + (z * w) @ V.T).float()
    mean_norm = torch.linalg.vector_norm(X, dim=1).mean()
    Q *= mean_norm / torch.linalg.vector_norm(Q, dim=1).mean().clamp_min(1e-9)
    return Q


def make(config: dict, seed: int, device, *, pool: str = "in_distribution",
         severity: float = 1.0) -> tuple:
    """The corpus and the query pool of ``config`` for ``seed``, drawn on
    ``device``: ``(X, Q)``, (n, dim) and (queries, dim) float32 tensors.
    ``pool`` is ``"in_distribution"`` (rows of the same mixture) or
    ``"ood"`` (the OOD shift of ``severity`` away from the corpus)."""
    fam = Family(config["generator"] | {"dim": config["dim"]}, seed, device)
    X = fam.draw(int(config["n"]), generator(seed, device, 2))
    nq = int(config["queries"])
    if pool == "in_distribution":
        Q = fam.draw(nq, generator(seed, device, 3))
    elif pool == "ood":
        Q = ood_queries(X, nq, generator(seed, device, 4), severity=severity)
    else:
        raise ValueError(f"unknown query pool {pool!r}")
    return X, Q

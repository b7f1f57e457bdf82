"""Synthetic dataset families mirroring Table IV of the paper.

This container has no network access, so each of the paper's 10 datasets is
represented by a synthetic family with matched DIMENSIONALITY, matched
distributional character (clustered image embeddings, heavy-tailed word
vectors, normalized LLM embeddings, OOD multimodal pairs, concatenated
token-block XUltra) and CPU-feasible cardinality.  Rankings / trends — the
paper's actual claims — are what we validate; absolute QPS is hardware-bound
anyway (we run the TPU story through the dry-run roofline instead).

Every dataset carries in-distribution queries; the multimodal families
(text2image, laion) also carry OOD queries drawn from a different modality
distribution, mirroring the paper's §V-B setup.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

# name -> (dim, n_base, n_query, category, ood)
DATASETS: dict = {
    "deep":       dict(dim=96,    n=200_000, nq=100, category="low",        ood=False),
    "glove":      dict(dim=100,   n=100_000, nq=100, category="low",        ood=False),
    "sift":       dict(dim=128,   n=100_000, nq=100, category="high",       ood=False),
    "text2image": dict(dim=200,   n=100_000, nq=100, category="high",       ood=True),
    "laion":      dict(dim=512,   n=50_000,  nq=100, category="high",       ood=True),
    "wikipedia":  dict(dim=768,   n=50_000,  nq=100, category="high",       ood=False),
    "gist":       dict(dim=960,   n=30_000,  nq=100, category="high",       ood=False),
    "openai":     dict(dim=1536,  n=20_000,  nq=100, category="ultra",      ood=False),
    "trevi":      dict(dim=4096,  n=10_000,  nq=50,  category="ultra",      ood=False),
    "xultra":     dict(dim=12288, n=4_000,   nq=25,  category="ultra",      ood=False),
}


@dataclass
class VectorDataset:
    name: str
    X: np.ndarray                 # (N, D) float32 base vectors
    Q: np.ndarray                 # (nq, D) in-distribution queries
    Q_ood: np.ndarray | None = None
    category: str = "high"
    _gt: dict = field(default_factory=dict)

    @property
    def dim(self):
        return self.X.shape[1]

    @property
    def n(self):
        return self.X.shape[0]

    def ground_truth(self, k: int, *, ood: bool = False) -> tuple:
        """Exact top-k ids + squared distances by brute force (cached)."""
        key = (k, ood)
        if key not in self._gt:
            Q = self.Q_ood if ood else self.Q
            d2 = (np.ascontiguousarray((self.X ** 2).sum(1))[None, :]
                  - 2.0 * Q @ self.X.T + (Q ** 2).sum(1)[:, None])
            idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
            row = np.arange(Q.shape[0])[:, None]
            order = np.argsort(d2[row, idx], axis=1)
            ids = idx[row, order]
            self._gt[key] = (ids, d2[row, ids])
        return self._gt[key]

    def normalized(self) -> "VectorDataset":
        """Unit-norm copy (for IP / cosine via the Eq. 8 transform)."""
        def nz(a):
            return a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-9)
        return VectorDataset(self.name + "-norm", nz(self.X), nz(self.Q),
                             None if self.Q_ood is None else nz(self.Q_ood),
                             self.category)


def _mixture(rng, n, dim, *, n_clusters, spectrum_alpha, spread=1.0, nonneg=False,
             heavy_tail=False):
    """Anisotropic Gaussian mixture with power-law eigen-spectrum — gives the
    PCA-based methods realistic variance concentration to exploit."""
    scales = (np.arange(1, dim + 1, dtype=np.float32) ** -spectrum_alpha)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * scales * 3.0
    assign = rng.integers(0, n_clusters, n)
    Z = rng.standard_normal((n, dim)).astype(np.float32)
    if heavy_tail:
        Z *= rng.gamma(2.0, 1.0, (n, 1)).astype(np.float32)
    X = centers[assign] + Z * scales * spread
    if nonneg:
        X = np.abs(X)
    # random rotation so "original dim order" carries no free PCA signal
    return X


def _rotate(rng, X):
    d = X.shape[1]
    if d > 2048:      # a full Haar rotation is too costly; block-rotate
        blk = 512
        for lo in range(0, d, blk):
            hi = min(lo + blk, d)
            Q, _ = np.linalg.qr(rng.standard_normal((hi - lo, hi - lo)).astype(np.float32))
            X[:, lo:hi] = X[:, lo:hi] @ Q
        return X
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    return X @ Q


_CACHE: dict = {}


def load_dataset(name: str, *, scale: float = 1.0, seed: int = 0) -> VectorDataset:
    """Generate (cached per-process) one of the 10 families."""
    key = (name, scale, seed)
    if key in _CACHE:
        return _CACHE[key]
    spec = DATASETS[name]
    # stable hash: builtin hash() is salted per process, which made every
    # process draw a DIFFERENT corpus (flaky thresholds, unpaired benchmarks)
    rng = np.random.default_rng(
        (zlib.crc32(name.encode()) + 7919 * seed) % (2 ** 31))
    n = max(1000, int(spec["n"] * scale))
    nq, dim = spec["nq"], spec["dim"]

    if name == "xultra":
        # concatenated token-block embeddings (paper §IV-B): 48 blocks of 256
        blk, nblk = 256, dim // 256
        vocab = _mixture(rng, 4096, blk, n_clusters=64, spectrum_alpha=0.6)
        tok = rng.integers(0, 4096, (n + nq, nblk))
        A = vocab[tok].reshape(n + nq, dim) + \
            0.1 * rng.standard_normal((n + nq, dim)).astype(np.float32)
        X, Q = A[:n], A[n:]
    else:
        alpha = {"deep": 0.35, "glove": 0.8, "sift": 0.5, "text2image": 0.6,
                 "laion": 0.7, "wikipedia": 0.7, "gist": 0.6, "openai": 0.8,
                 "trevi": 0.9}[name]
        A = _mixture(rng, n + nq, dim,
                     n_clusters=min(64, max(8, n // 2000)),
                     spectrum_alpha=alpha,
                     nonneg=(name in ("sift", "gist")),
                     heavy_tail=(name == "glove"))
        A = _rotate(rng, A)
        X, Q = A[:n], A[n:]

    Q_ood = None
    if spec["ood"]:
        # different modality: different spectrum + shifted cluster structure
        B = _mixture(rng, nq, dim, n_clusters=8, spectrum_alpha=0.2, spread=1.6)
        Q_ood = _rotate(np.random.default_rng(123), B).astype(np.float32)
        # keep scale comparable so thresholds stay in-range
        Q_ood *= (np.linalg.norm(X, axis=1).mean()
                  / max(np.linalg.norm(Q_ood, axis=1).mean(), 1e-9))
    if name == "openai":   # LLM embeddings ship normalized
        X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-9)
        Q /= np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-9)

    ds = VectorDataset(name, np.ascontiguousarray(X, np.float32),
                       np.ascontiguousarray(Q, np.float32), Q_ood, spec["category"])
    _CACHE[key] = ds
    return ds


def recall_at_k(found_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Paper Eq. (1), averaged over queries."""
    k = gt_ids.shape[1]
    hits = sum(len(set(f[:k].tolist()) & set(g.tolist())) for f, g in zip(found_ids, gt_ids))
    return hits / (k * gt_ids.shape[0])

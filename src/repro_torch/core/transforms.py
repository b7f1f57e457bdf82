"""Offline pre-processing shared by the DCO methods.

All fitting happens on the host in numpy (mirroring the paper, which uses
Python for PCA / model training and C++ only for the online path).  The
fitted state is a plain dict of numpy arrays so the JAX engine, the numpy
engine and the Pallas kernels can all consume it.

Ultra-high-D note (DESIGN.md §3): when ``D`` is too large for a dense
eigendecomposition we fit the leading ``r = min(N, D, max_rank)`` principal
directions by economy SVD.  Stage-1 partial distances over *any* orthonormal
set of directions are valid Euclidean lower bounds, and stage-2 always
recomputes the exact distance in the ORIGINAL coordinates, so correctness is
unaffected; only the tail of the eigen-spectrum used by DADE/DDCres estimates
is then approximated through the (exactly known) total variance.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# PCA rotation (PDScanning+, DADE, DDCres, DDCpca)
# ---------------------------------------------------------------------------


def fit_pca(X: np.ndarray, *, max_rank: int = 2048, seed: int = 0) -> dict:
    """Fit a distance-preserving PCA rotation.

    Returns dict with:
      mean (D,), W (D, r) orthonormal loading columns ordered by descending
      eigenvalue, eigvals (r,), total_var (scalar; exact trace of covariance),
      rank r.
    """
    X = np.asarray(X, np.float32)
    n, d = X.shape
    mean = X.mean(axis=0)
    Xc = X - mean
    total_var = float((Xc ** 2).sum() / max(1, n - 1))
    r = min(n, d, max_rank)
    if d <= 1024 and n >= d:  # exact eigendecomposition is cheap here
        cov = (Xc.T @ Xc) / max(1, n - 1)
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1]
        W = evecs[:, order].astype(np.float32)
        eigvals = np.clip(evals[order], 0.0, None).astype(np.float32)
        r = d
    else:  # economy SVD on (possibly subsampled) data
        m = min(n, 4 * max_rank)
        if m < n:
            rng = np.random.default_rng(seed)
            Xs = Xc[rng.choice(n, m, replace=False)]
        else:
            Xs = Xc
        _, s, Vt = np.linalg.svd(Xs, full_matrices=False)
        W = Vt[:r].T.astype(np.float32)
        eigvals = (s[:r] ** 2 / max(1, Xs.shape[0] - 1)).astype(np.float32)
    return {
        "mean": mean.astype(np.float32),
        "W": W[:, :r],
        "eigvals": eigvals[:r],
        "total_var": np.float32(total_var),
        "rank": r,
    }


def pca_rotate(pca: dict, X: np.ndarray, *, center: bool = False) -> np.ndarray:
    """Rotate rows of X into the PCA basis (leading ``rank`` dims).

    Distances are rotation-invariant, so when ``center`` is False we rotate
    the raw vectors (the mean cancels in o - q) — this keeps stage-2
    original-space distances and stage-1 rotated partials consistent.
    """
    X = np.asarray(X, np.float32)
    if center:
        X = X - pca["mean"]
    return X @ pca["W"]


# ---------------------------------------------------------------------------
# Random orthonormal (JL) rotation (ADSampling)
# ---------------------------------------------------------------------------


def fit_random_rotation(dim: int, *, max_rank: int = 2048, seed: int = 0) -> dict:
    """Random orthonormal projection P (D, r): leading block of a Haar matrix.

    ADSampling's estimator sqrt(D/d)*dis(P_d o, P_d q) needs the rows to be an
    orthonormal subset of a full rotation; a QR of a Gaussian matrix gives
    exactly that.
    """
    rng = np.random.default_rng(seed)
    r = min(dim, max_rank)
    G = rng.standard_normal((dim, r)).astype(np.float32)
    Q, _ = np.linalg.qr(G)  # (D, r), orthonormal columns
    return {"P": Q.astype(np.float32), "rank": r}


# ---------------------------------------------------------------------------
# Product quantization (DDCopq)
# ---------------------------------------------------------------------------


def cluster_sums(X: np.ndarray, assign: np.ndarray, k: int):
    """(sums (k, D) float64, counts (k,) int64) of X's rows by cluster.

    The same numbers as ``np.add.at(np.zeros((k, D)), assign, X)``: each
    cluster's rows are added in row order in float64 (``np.add.reduceat``
    along rows accumulates sequentially) and the trailing ``+ 0.0`` turns
    a -0.0 sum into the 0.0 that adding from zero gives.  A stable sort
    and one reduceat replace the unbuffered scatter of every element,
    which took most of a host k-means' time."""
    counts = np.bincount(assign, minlength=k)
    sums = np.zeros((k, X.shape[1]), np.float64)
    nz = counts > 0
    if nz.any():
        rows = X[np.argsort(assign, kind="stable")].astype(np.float64)
        starts = (np.cumsum(counts) - counts)[nz]
        sums[nz] = np.add.reduceat(rows, starts, axis=0) + 0.0
    return sums, counts


def _kmeans(X: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    n = X.shape[0]
    cent = X[rng.choice(n, size=min(k, n), replace=False)].copy()
    if cent.shape[0] < k:  # duplicate-pad degenerate case
        cent = np.concatenate([cent, cent[rng.integers(0, cent.shape[0], k - cent.shape[0])]])
    for _ in range(iters):
        d2 = (X ** 2).sum(1, keepdims=True) - 2 * X @ cent.T + (cent ** 2).sum(1)
        assign = d2.argmin(1)
        sums, counts = cluster_sums(X, assign, k)
        counts = counts.astype(np.float64)
        upd = counts > 0
        cent[upd] = (sums[upd] / counts[upd, None]).astype(np.float32)
    return cent.astype(np.float32)


def fit_pq(X: np.ndarray, *, n_sub: int = 8, n_codes: int = 256, iters: int = 8,
           train_n: int = 20000, seed: int = 0) -> dict:
    """Product quantizer: split dims into n_sub groups, k-means each.

    Returns codebooks (n_sub, n_codes, d_sub_max) zero-padded, sub-dim splits,
    and the codes for X (N, n_sub) uint8/uint16.
    """
    X = np.asarray(X, np.float32)
    n, d = X.shape
    rng = np.random.default_rng(seed)
    n_codes = min(n_codes, max(4, n // 4))
    splits = np.linspace(0, d, n_sub + 1).astype(int)
    train = X[rng.choice(n, min(train_n, n), replace=False)]
    d_sub_max = int(np.max(np.diff(splits)))
    books = np.zeros((n_sub, n_codes, d_sub_max), np.float32)
    for m in range(n_sub):
        lo, hi = splits[m], splits[m + 1]
        books[m, :, : hi - lo] = _kmeans(train[:, lo:hi], n_codes, iters, rng)
    codes = pq_encode({"books": books, "splits": splits, "n_codes": n_codes}, X)
    return {"books": books, "splits": splits, "n_codes": n_codes, "codes": codes}


def pq_encode(pq: dict, X: np.ndarray) -> np.ndarray:
    X = np.asarray(X, np.float32)
    splits, books = pq["splits"], pq["books"]
    out = np.zeros((X.shape[0], len(splits) - 1), np.uint16)
    for m in range(len(splits) - 1):
        lo, hi = splits[m], splits[m + 1]
        sub = X[:, lo:hi]
        cb = books[m, :, : hi - lo]
        d2 = (sub ** 2).sum(1, keepdims=True) - 2 * sub @ cb.T + (cb ** 2).sum(1)
        out[:, m] = d2.argmin(1)
    return out


def pq_query_lut(pq: dict, q: np.ndarray) -> np.ndarray:
    """Per-query lookup table (n_sub, n_codes) of squared sub-distances."""
    splits, books = pq["splits"], pq["books"]
    n_sub, n_codes = books.shape[0], books.shape[1]
    lut = np.zeros((n_sub, n_codes), np.float32)
    for m in range(n_sub):
        lo, hi = splits[m], splits[m + 1]
        cb = books[m, :, : hi - lo]
        lut[m] = ((cb - q[lo:hi]) ** 2).sum(1)
    return lut


def pq_adist(pq: dict, lut: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Approximate squared distances for rows of ``codes`` given query LUT."""
    return lut[np.arange(codes.shape[1])[None, :], codes].sum(1)

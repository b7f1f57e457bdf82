"""The 8 DCO methods of the paper, in a unified batched form.

A numpy copy of the reference package's ``core/methods.py``: fitting the
same data with the same seed gives the same state in both packages.

Taxonomy (paper §III):
  simple scanning      : FDScanning, PDScanning, PDScanning+
  hypothesis testing   : ADSampling, DADE, DDCres
  classification based : DDCpca, DDCopq

TPU adaptation (DESIGN.md §3): the per-vector `while d < D: if dis' > τ`
loop becomes *staged screening over candidate blocks*.  A method exposes a
``screen(ids, ctx, qi, d, tau_sq) -> keep_mask`` operation per stage plus an
``exact_sq`` completion in ORIGINAL coordinates, so every method is exact for
the survivors and differs only in what it prunes.  The numpy backend below is
the host reference (used by the HNSW index and the CPU benchmarks); the JAX /
Pallas engines consume the same fitted state.

All arithmetic is in SQUARED Euclidean distance (monotone equivalent).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import transforms as T

# ---------------------------------------------------------------------------


class DCOMethod:
    """Base class.  Subclasses set ``name`` / ``exact`` and implement hooks.

    docs/methods.md is the operator's guide to all 8 methods (math sketch,
    exactness, training, device support, when-to-use matrix).
    """

    name: str = "base"
    exact: bool = True          # never prunes a true positive
    needs_training: bool = False

    def __init__(self, **params):
        self.params = params
        self.state: dict = {}

    # -- offline ------------------------------------------------------------
    def fit(self, X: np.ndarray):
        """Fit on the base vectors: store X/norms, then the method hook."""
        X = np.asarray(X, np.float32)
        self.state["X"] = X
        self.state["N"], self.state["D"] = X.shape
        self.state["norms"] = (X ** 2).sum(1)
        self._fit(X)
        return self

    def _fit(self, X):  # override
        pass

    def append(self, Xnew: np.ndarray):
        """Incremental insert support (paper §V-E): extend stored arrays
        WITHOUT refitting the transforms — the dynamic-data scenario."""
        Xnew = np.asarray(Xnew, np.float32)
        self.state["X"] = np.concatenate([self.state["X"], Xnew])
        self.state["norms"] = np.concatenate([self.state["norms"], (Xnew ** 2).sum(1)])
        self._append(Xnew)
        self.state["N"] = self.state["X"].shape[0]

    def _append(self, Xnew):  # override if method keeps derived arrays
        pass

    # -- online -------------------------------------------------------------
    def prep_queries(self, Q: np.ndarray) -> dict:
        """Per-query online pre-processing (the O(D^2) cost the paper flags).
        Batched: rotations become a single (Q,D)@(D,r) matmul."""
        Q = np.atleast_2d(np.asarray(Q, np.float32))
        return self._prep(Q) | {"Q": Q, "qnorms": (Q ** 2).sum(1)}

    def _prep(self, Q) -> dict:
        return {}

    def stage_dims(self, schedule) -> list:
        """Screening stages actually used (methods may cap at their rank)."""
        return [d for d in schedule if d < self.state["D"]]

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Return (keep_mask, dims_charged). keep=True means 'cannot prune yet'."""
        raise NotImplementedError

    def exact_sq(self, ids, ctx, qi):
        """Exact squared distances in ORIGINAL coordinates for ``ids``."""
        X, q = self.state["X"], ctx["Q"][qi]
        diff = X[ids] - q
        return np.einsum("nd,nd->n", diff, diff)

    # -- device export --------------------------------------------------------
    def device_state(self) -> dict:
        """Uniform export consumed by the JAX engine (jax_engine).

        Every method returns a dict with at least:
          kind -- the engine decision rule (fdscan|lb|adsampling|dade|ddcres|ratio)
          Xrot -- (N, r) row matrix the device streams (raw X when identity)
          W    -- (D, r) query rotation, or None for identity
          mean -- (D,) query centering, or None
        plus rule-specific arrays (e.g. ``mass``/``eps_d`` for DADE).  The
        default is exact lower-bound screening over the raw coordinates —
        valid for any method, since partial ssd on original dims never prunes
        a true neighbor.
        """
        return {"kind": "lb", "Xrot": self.state["X"], "W": None, "mean": None}


# ---------------------------------------------------------------------------
# Simple scanning
# ---------------------------------------------------------------------------


class FDScanning(DCOMethod):
    """Full-dimension scan: no screening stages at all (docs/methods.md)."""

    name = "FDScanning"
    exact = True

    def stage_dims(self, schedule):
        """No screening stages: every candidate completes exactly."""
        return []

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Keep everything; charge no dims (there is no screen)."""
        return np.ones(len(ids), bool), 0

    def device_state(self):
        """Engine rule ``fdscan`` over the raw coordinates."""
        return {"kind": "fdscan", "Xrot": self.state["X"], "W": None, "mean": None}


class PDScanning(DCOMethod):
    """Partial-dimension scan on ORIGINAL dims: partial ssd is an exact lower
    bound, so pruning at ``partial > tau`` is exact (docs/methods.md)."""

    name = "PDScanning"
    exact = True

    def _partial(self, ids, ctx, qi, d):
        X, q = self.state["X"], ctx["Q"][qi]
        diff = X[ids, :d] - q[:d]
        return np.einsum("nd,nd->n", diff, diff)

    def partial_range(self, ids, ctx, qi, lo, hi):
        """Partial ssd over the dim slice [lo, hi) only — the strided group
        read scan_topk accumulates across stages instead of recomputing the
        whole prefix per stage (host PDX mirror, DESIGN.md §8)."""
        X, q = self.state["X"], ctx["Q"][qi]
        diff = X[ids, lo:hi] - q[lo:hi]
        return np.einsum("nd,nd->n", diff, diff)

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Exact lower-bound test: partial ssd over the leading ``d`` dims."""
        return self._partial(ids, ctx, qi, d) <= tau_sq, d


class PDScanningPlus(PDScanning):
    """PDScanning on PCA-rotated dims (variance-ordered -> earlier exits).
    Still exact: partial sums over orthonormal directions lower-bound dis^2
    (docs/methods.md)."""

    name = "PDScanning+"
    exact = True

    def _fit(self, X):
        self.state["pca"] = self.params.get("pca") or T.fit_pca(X, seed=self.params.get("seed", 0))
        self.state["Xrot"] = T.pca_rotate(self.state["pca"], X)

    def _append(self, Xnew):
        self.state["Xrot"] = np.concatenate(
            [self.state["Xrot"], T.pca_rotate(self.state["pca"], Xnew)])

    def _prep(self, Q):
        return {"Qrot": T.pca_rotate(self.state["pca"], Q)}

    def stage_dims(self, schedule):
        """Stages capped at the PCA rank (rotated dims beyond it are 0)."""
        r = self.state["pca"]["rank"]
        return [d for d in schedule if d < min(r, self.state["D"])]

    def _partial(self, ids, ctx, qi, d):
        diff = self.state["Xrot"][ids, :d] - ctx["Qrot"][qi, :d]
        return np.einsum("nd,nd->n", diff, diff)

    def partial_range(self, ids, ctx, qi, lo, hi):
        """Partial ssd over the rotated dim slice [lo, hi) — the incremental
        group read of the host PDX scan (see PDScanning.partial_range)."""
        diff = self.state["Xrot"][ids, lo:hi] - ctx["Qrot"][qi, lo:hi]
        return np.einsum("nd,nd->n", diff, diff)

    def device_state(self):
        """Engine rule ``lb`` over the PCA-rotated corpus."""
        return {"kind": "lb", "Xrot": self.state["Xrot"],
                "W": self.state["pca"]["W"], "mean": None}


# ---------------------------------------------------------------------------
# Hypothesis testing
# ---------------------------------------------------------------------------


class ADSampling(DCOMethod):
    """Gao & Long [1]: JL rotation; est = sqrt(D/d) * partial; reject H0 when
    est > (1 + eps0/sqrt(d)) * tau (docs/methods.md)."""

    name = "ADSampling"
    exact = False

    def _fit(self, X):
        rot = T.fit_random_rotation(self.state["D"], seed=self.params.get("seed", 0))
        self.state["rot"] = rot
        self.state["Xrot"] = X @ rot["P"]

    def _append(self, Xnew):
        self.state["Xrot"] = np.concatenate([self.state["Xrot"], Xnew @ self.state["rot"]["P"]])

    def _prep(self, Q):
        return {"Qrot": Q @ self.state["rot"]["P"]}

    def stage_dims(self, schedule):
        """Stages capped at the random-rotation rank."""
        r = self.state["rot"]["rank"]
        return [d for d in schedule if d < min(r, self.state["D"])]

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Scaled-partial hypothesis test at significance ``eps0``."""
        diff = self.state["Xrot"][ids, :d] - ctx["Qrot"][qi, :d]
        partial = np.einsum("nd,nd->n", diff, diff)
        eps0 = self.params.get("eps0", 2.1)
        D = self.state["D"]
        bound = tau_sq * (1.0 + eps0 / np.sqrt(d)) ** 2
        return partial * (D / d) <= bound, d

    def device_state(self):
        """Engine rule ``adsampling`` (JL-rotated corpus + eps0)."""
        return {"kind": "adsampling", "Xrot": self.state["Xrot"],
                "W": self.state["rot"]["P"], "mean": None,
                "eps0": self.params.get("eps0", 2.1)}


class DADE(DCOMethod):
    """Deng et al. [2]: PCA rotation; eigen-mass-scaled unbiased estimator with
    a significance-level bound (Eq. 2) (docs/methods.md)."""

    name = "DADE"
    exact = False

    def _fit(self, X):
        pca = self.params.get("pca") or T.fit_pca(X, seed=self.params.get("seed", 0))
        self.state["pca"] = pca
        self.state["Xrot"] = T.pca_rotate(pca, X)
        lam = pca["eigvals"].astype(np.float64)
        total = max(float(pca["total_var"]), float(lam.sum()))
        cum = np.cumsum(lam)
        self.state["mass"] = (cum / total).astype(np.float32)       # sum_{<=d} / sum_all
        # eps_d: relative slack from the residual eigen-mass at significance
        # alpha (z_alpha * sqrt residual fraction); alpha is empirical (paper).
        z = self.params.get("z_alpha", 2.0)
        resid = np.clip(1.0 - cum / total, 0.0, None)
        self.state["eps_d"] = (z * np.sqrt(resid / np.maximum(cum / total, 1e-9))
                               ).astype(np.float32)

    def _append(self, Xnew):
        self.state["Xrot"] = np.concatenate(
            [self.state["Xrot"], T.pca_rotate(self.state["pca"], Xnew)])

    def _prep(self, Q):
        return {"Qrot": T.pca_rotate(self.state["pca"], Q)}

    def stage_dims(self, schedule):
        """Stages capped at the PCA rank."""
        r = self.state["pca"]["rank"]
        return [d for d in schedule if d < min(r, self.state["D"])]

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Eigen-mass-scaled estimate vs the eps_d significance bound."""
        diff = self.state["Xrot"][ids, :d] - ctx["Qrot"][qi, :d]
        partial = np.einsum("nd,nd->n", diff, diff)
        mass = max(float(self.state["mass"][d - 1]), 1e-9)
        est = partial / mass                       # unbiased under eigen-mass scaling
        eps = float(self.state["eps_d"][d - 1])
        return est <= tau_sq * (1.0 + eps) ** 2, d

    def device_state(self):
        """Engine rule ``dade`` (rotated corpus + mass/eps_d arrays)."""
        return {"kind": "dade", "Xrot": self.state["Xrot"],
                "W": self.state["pca"]["W"], "mean": None,
                "mass": self.state["mass"], "eps_d": self.state["eps_d"]}


class DDCres(DCOMethod):
    """Yang et al. [3] residual cross-term estimator: norm decomposition +
    Gaussian bound on the unscanned cross term (Eqs. 4-7), tightened by PCA
    (docs/methods.md)."""

    name = "DDCres"
    exact = False

    def _fit(self, X):
        pca = self.params.get("pca") or T.fit_pca(X, seed=self.params.get("seed", 0))
        self.state["pca"] = pca
        Xc = X - pca["mean"]
        self.state["Xrot"] = Xc @ pca["W"]                  # centered + rotated
        self.state["cnorms"] = (Xc ** 2).sum(1)             # ||o||^2 centered
        lam = pca["eigvals"].astype(np.float64)
        total = max(float(pca["total_var"]), float(lam.sum()))
        self.state["sigma_sq"] = lam.astype(np.float32)     # per-dim variance
        # average variance assigned to the un-materialized tail (rank < D)
        r, D = pca["rank"], self.state["D"]
        tail = max(total - float(lam.sum()), 0.0)
        self.state["tail_var"] = np.float32(tail / max(D - r, 1))

    def _append(self, Xnew):
        pca = self.state["pca"]
        Xc = Xnew - pca["mean"]
        self.state["Xrot"] = np.concatenate([self.state["Xrot"], Xc @ pca["W"]])
        self.state["cnorms"] = np.concatenate([self.state["cnorms"], (Xc ** 2).sum(1)])

    def _prep(self, Q):
        pca = self.state["pca"]
        Qc = Q - pca["mean"]
        Qrot = Qc @ pca["W"]
        # suffix sums of q_i^2 * sigma_i^2 over rotated dims (Eq. 6)
        qs = (Qrot ** 2) * self.state["sigma_sq"][None, :]
        suffix = np.concatenate(
            [np.cumsum(qs[:, ::-1], axis=1)[:, ::-1], np.zeros((Q.shape[0], 1), np.float32)],
            axis=1)
        # tail beyond materialized rank: residual query energy * avg tail var
        qres = np.clip((Qc ** 2).sum(1) - (Qrot ** 2).sum(1), 0.0, None)
        tail = qres * self.state["tail_var"]
        return {"Qrot": Qrot, "qcnorms": (Qc ** 2).sum(1),
                "var_suffix": suffix + tail[:, None]}

    def stage_dims(self, schedule):
        """Stages capped at the PCA rank."""
        r = self.state["pca"]["rank"]
        return [d for d in schedule if d < min(r, self.state["D"])]

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Eq. 7 lower-bound estimate with Gaussian cross-term slack."""
        cross = self.state["Xrot"][ids, :d] @ ctx["Qrot"][qi, :d]
        dis_p = self.state["cnorms"][ids] + ctx["qcnorms"][qi] - 2.0 * cross
        m = self.params.get("m", 3.0)
        var = float(ctx["var_suffix"][qi, d])
        est = dis_p - 2.0 * m * np.sqrt(max(var, 0.0))      # Eq. 7 lower bound
        return est <= tau_sq, d

    def device_state(self):
        """Engine rule ``ddcres`` (centered rotation + variance scalars)."""
        pca = self.state["pca"]
        return {"kind": "ddcres", "Xrot": self.state["Xrot"],
                "W": pca["W"], "mean": pca["mean"],
                "sigma_sq": self.state["sigma_sq"],
                "tail_var": self.state["tail_var"],
                "m": self.params.get("m", 3.0)}


# ---------------------------------------------------------------------------
# Classification based
# ---------------------------------------------------------------------------


class DDCpca(DCOMethod):
    """Yang et al. [3]: per-(k, d) linear model on (partial, tau).  We use the
    scale-free form  prune <=> partial_sq > theta_{k,d} * tau_sq, with
    theta calibrated on index-generated training samples to a target
    false-prune rate (the 'linear model M_{k,d}' of Alg. 3)
    (docs/methods.md)."""

    name = "DDCpca"
    exact = False
    needs_training = True

    def _fit(self, X):
        pca = self.params.get("pca") or T.fit_pca(X, seed=self.params.get("seed", 0))
        self.state["pca"] = pca
        self.state["Xrot"] = T.pca_rotate(pca, X)
        self.state["models"] = {}   # (k, d) -> theta

    def _append(self, Xnew):
        self.state["Xrot"] = np.concatenate(
            [self.state["Xrot"], T.pca_rotate(self.state["pca"], Xnew)])

    def _prep(self, Q):
        return {"Qrot": T.pca_rotate(self.state["pca"], Q)}

    def stage_dims(self, schedule):
        """Stages capped at the PCA rank."""
        r = self.state["pca"]["rank"]
        return [d for d in schedule if d < min(r, self.state["D"])]

    def train(self, sample_queries: np.ndarray, k: int, schedule,
              *, candidates_per_query: int = 2048, fpr: float = 0.002, seed: int = 0):
        """Offline phase of Alg. 3: sampled queries + a fixed candidate
        generator produce (partial, tau, label) samples per stage d."""
        rng = np.random.default_rng(seed)
        ctx = self.prep_queries(sample_queries)
        N = self.state["N"]
        ratios = {d: [] for d in self.stage_dims(schedule)}
        for qi in range(sample_queries.shape[0]):
            ids = rng.choice(N, size=min(candidates_per_query, N), replace=False)
            full = self.exact_sq(ids, ctx, qi)
            tau_sq = np.partition(full, k - 1)[k - 1]
            pos = full <= tau_sq                      # true "dis <= tau" rows
            if not pos.any():
                continue
            for d in ratios:
                diff = self.state["Xrot"][ids, :d] - ctx["Qrot"][qi, :d]
                partial = np.einsum("nd,nd->n", diff, diff)
                ratios[d].append(partial[pos] / max(float(tau_sq), 1e-12))
        for d, r in ratios.items():
            allr = np.concatenate(r) if r else np.array([1.0])
            # keep everything below the (1-fpr) quantile of positives' ratio
            self.state["models"][(k, d)] = float(np.quantile(allr, 1.0 - fpr))
        self.state["trained_k"] = k
        return self

    def screen(self, ids, ctx, qi, d, tau_sq):
        """Trained ratio test; untrained stages keep everything."""
        k = self.state.get("trained_k")
        theta = self.state["models"].get((k, d))
        if theta is None:                      # untrained stage: keep all
            return np.ones(len(ids), bool), 0
        diff = self.state["Xrot"][ids, :d] - ctx["Qrot"][qi, :d]
        partial = np.einsum("nd,nd->n", diff, diff)
        return partial <= theta * tau_sq, d

    def device_state(self):
        """Engine rule ``ratio`` (rotated corpus + trained thetas)."""
        return {"kind": "ratio", "Xrot": self.state["Xrot"],
                "W": self.state["pca"]["W"], "mean": None,
                "models": dict(self.state["models"]),
                "trained_k": self.state.get("trained_k")}


class DDCopq(DCOMethod):
    """Yang et al. [3]: single per-k linear model on the PQ approximate
    distance; negatives verified by a full scan (Alg. 3 variant)
    (docs/methods.md)."""

    name = "DDCopq"
    exact = False
    needs_training = True

    def _fit(self, X):
        self.state["pq"] = T.fit_pq(
            X, n_sub=self.params.get("n_sub", 16),
            n_codes=self.params.get("n_codes", 256),
            seed=self.params.get("seed", 0))
        self.state["models"] = {}

    def _append(self, Xnew):
        pq = self.state["pq"]
        pq["codes"] = np.concatenate([pq["codes"], T.pq_encode(pq, Xnew)])

    def _prep(self, Q):
        luts = np.stack([T.pq_query_lut(self.state["pq"], q) for q in Q])
        return {"luts": luts}

    def stage_dims(self, schedule):
        """A single PQ screening stage; the dim argument is unused."""
        return [0]

    def train(self, sample_queries: np.ndarray, k: int, schedule=None,
              *, candidates_per_query: int = 2048, fpr: float = 0.002, seed: int = 0):
        """Calibrate the per-k adist threshold on sampled queries (Alg. 3)."""
        rng = np.random.default_rng(seed)
        ctx = self.prep_queries(sample_queries)
        N = self.state["N"]
        ratios = []
        for qi in range(sample_queries.shape[0]):
            ids = rng.choice(N, size=min(candidates_per_query, N), replace=False)
            full = self.exact_sq(ids, ctx, qi)
            tau_sq = np.partition(full, k - 1)[k - 1]
            pos = full <= tau_sq
            if not pos.any():
                continue
            adist = T.pq_adist(self.state["pq"], ctx["luts"][qi], self.state["pq"]["codes"][ids])
            ratios.append(adist[pos] / max(float(tau_sq), 1e-12))
        allr = np.concatenate(ratios) if ratios else np.array([1.0])
        self.state["models"][k] = float(np.quantile(allr, 1.0 - fpr))
        self.state["trained_k"] = k
        return self

    def screen(self, ids, ctx, qi, d, tau_sq):
        """PQ-adist ratio test; charges n_sub 'dims' for the LUT pass."""
        k = self.state.get("trained_k")
        theta = self.state["models"].get(k)
        if theta is None:
            return np.ones(len(ids), bool), 0
        adist = T.pq_adist(self.state["pq"], ctx["luts"][qi], self.state["pq"]["codes"][ids])
        n_sub = self.state["pq"]["books"].shape[0]
        return adist <= theta * tau_sq, n_sub   # charge n_sub 'dims' for the LUT pass

    def device_state(self):
        """Engine rule ``opq`` when trained; exact-lb fallback otherwise."""
        theta = self.state["models"].get(self.state.get("trained_k"))
        if theta is None:
            # untrained: fall back to exact lower-bound screening on raw dims
            return {"kind": "lb", "Xrot": self.state["X"], "W": None,
                    "mean": None}
        # native device screening: the pq_lookup Pallas kernel turns the LUT
        # gather into a one-hot matmul per candidate block (streaming engine
        # rule "opq"); survivors complete exact distances in original coords
        pq = self.state["pq"]
        return {"kind": "opq", "Xrot": self.state["X"], "W": None, "mean": None,
                "codes": pq["codes"], "books": pq["books"],
                "splits": pq["splits"], "theta": float(theta),
                "trained_k": self.state.get("trained_k")}


# ---------------------------------------------------------------------------

ALL_METHODS = {
    "FDScanning": FDScanning,
    "PDScanning": PDScanning,
    "PDScanning+": PDScanningPlus,
    "ADSampling": ADSampling,
    "DADE": DADE,
    "DDCres": DDCres,
    "DDCpca": DDCpca,
    "DDCopq": DDCopq,
}

BASELINES = ("FDScanning", "PDScanning", "PDScanning+")
SOTA = ("ADSampling", "DADE", "DDCres", "DDCpca", "DDCopq")


def make_method(name: str, **params) -> DCOMethod:
    """Instantiate one of the paper's 8 methods by facade name."""
    return ALL_METHODS[name](**params)

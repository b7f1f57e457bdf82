"""The facade: ``open_index(...)`` -> ``SearchSession``.

Counterpart of the reference package's ``api/session.py`` for the flat
streaming search on a torch device:

    sess = open_index(X, method="PDScanning+")       # fits, runs on CUDA
    res = sess.search(Q, k=10)                       # res.ids (nq, k)
    sess.add(X_new)                                  # re-materializes

Options the port does not serve yet raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.api.backends import make_backend, resolve_device
from repro_torch.api.types import SchedulePolicy, SearchResult
from repro_torch.core.methods import ALL_METHODS, make_method

INDEX_KINDS = ("flat",)
METHODS = tuple(ALL_METHODS)


def _unsupported(policy: SchedulePolicy) -> None:
    """Refuse schedule options whose engine paths are not ported yet."""
    if policy.adaptive:
        raise NotImplementedError(
            "SchedulePolicy(adaptive=True) is not ported yet (ROADMAP A7)")
    if policy.guardrails is not None and policy.guardrails is not False:
        raise NotImplementedError(
            "SchedulePolicy(guardrails=...) is not ported yet (ROADMAP A10)")
    if policy.dim_groups > 1:
        raise NotImplementedError(
            "SchedulePolicy(dim_groups > 1), the PDX layout, is not ported "
            "yet (ROADMAP A9)")
    if policy.engine != "stream":
        raise NotImplementedError(
            f"SchedulePolicy(engine={policy.engine!r}) is not ported yet; "
            "the streaming engine is (ROADMAP A1)")
    if policy.faults is not None:
        raise NotImplementedError(
            "SchedulePolicy(faults=...) is not ported yet (ROADMAP A8)")


class SearchSession:
    """A fitted method + the torch backend, behind batched calls."""

    def __init__(self, method, policy: SchedulePolicy | None = None, *,
                 backend: str = "torch", device=None):
        self.method = method
        self.index_kind = "flat"
        self.policy = policy if policy is not None else SchedulePolicy()
        _unsupported(self.policy)
        self.backend = make_backend(backend, method, self.policy,
                                    device=device)
        self.last_write_mode: str | None = None   # set by add()

    @property
    def n(self) -> int:
        """Number of indexed vectors."""
        return int(self.method.state["N"])

    @property
    def dim(self) -> int:
        """Vector dimensionality."""
        return int(self.method.state["D"])

    @property
    def backend_name(self) -> str:
        """Executing backend: ``"torch"``."""
        return self.backend.name

    def search(self, Q, k: int = 10, *, deadline_s: float | None = None
               ) -> SearchResult:
        """Batched top-k for all rows of ``Q``; one online prep for the
        whole batch."""
        if deadline_s is not None:
            raise NotImplementedError(
                "search(deadline_s=...) is not ported yet (ROADMAP A8)")
        Q = np.atleast_2d(np.asarray(Q))
        if Q.dtype.kind not in "fiu":
            raise ValueError(
                f"search(): expected a numeric query array, got dtype {Q.dtype}")
        Q = np.ascontiguousarray(Q, np.float32)
        if not np.isfinite(Q).all():
            bad = int((~np.isfinite(Q).all(axis=1)).sum())
            raise ValueError(
                f"search(): {bad} of {Q.shape[0]} queries contain NaN/Inf "
                "values; distances to non-finite queries are meaningless "
                "and would poison the running top-k threshold")
        t0 = time.perf_counter()
        dists, ids, stats = self.backend.search(Q, k)
        return SearchResult(dists, ids, stats, time.perf_counter() - t0,
                            self.backend.name)

    def add(self, Xnew) -> "SearchSession":
        """Dynamic inserts: extend the fitted method state without
        refitting transforms.  The device layout is rebuilt in full on the
        next search (the reference's ``"rebuild"`` write mode; the delta
        segment is ROADMAP A6)."""
        Xnew = np.atleast_2d(np.asarray(Xnew))
        if Xnew.dtype.kind not in "fiu":
            raise ValueError(
                f"add(): expected a numeric array, got dtype {Xnew.dtype}")
        if Xnew.ndim != 2:
            raise ValueError(
                f"add(): expected (n, D) vectors, got shape {Xnew.shape}")
        if Xnew.shape[1] != self.dim:
            raise ValueError(
                f"add(): vectors have dimension {Xnew.shape[1]}, but this "
                f"index was built with D={self.dim}")
        Xnew = np.ascontiguousarray(Xnew, np.float32)
        if not np.isfinite(Xnew).all():
            bad = int((~np.isfinite(Xnew).all(axis=1)).sum())
            raise ValueError(
                f"add(): {bad} of {Xnew.shape[0]} rows contain NaN/Inf "
                "values; a non-finite corpus row poisons every distance "
                "computed against it, so it is rejected before any state "
                "changes")
        self.method.append(Xnew)
        self.backend.invalidate()
        self.last_write_mode = "rebuild"
        return self


def open_index(X=None, *, index: str = "flat", method: str = "DADE",
               backend: str = "torch",
               schedule: SchedulePolicy | None = None,
               method_params: dict | None = None,
               train_queries=None, train_k: int = 10, seed: int = 0,
               device=None, mesh=None, serving: bool = False, path=None):
    """Fit ``method`` on ``X`` and return a ready flat-index session on
    ``device`` (default: the CUDA card; without one this raises
    ``RuntimeError`` — pass ``device="cpu"`` to run on the CPU).

    ``method`` is one of the paper's 8 (``METHODS``); training-based
    methods (DDCpca/DDCopq) are trained on ``train_queries`` (default: a
    sample of X rows) for ``k=train_k``."""
    if index in ("ivf", "hnsw"):
        raise NotImplementedError(
            f"index={index!r} is not ported yet (ROADMAP A5 for device IVF "
            "probing, A4 for the host indexes)")
    if index not in INDEX_KINDS:
        raise ValueError(f"index must be one of {INDEX_KINDS}, got {index!r}")
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet "
                                  "(ROADMAP A12)")
    if serving:
        raise NotImplementedError("the serving front is not ported yet "
                                  "(ROADMAP A11)")
    if path is not None:
        raise NotImplementedError("snapshots and the delta WAL are not "
                                  "ported yet (ROADMAP A11)")
    if backend == "host":
        raise NotImplementedError("backend='host' is not ported yet "
                                  "(ROADMAP A4)")
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r} (expected 'torch')")
    if X is None:
        raise ValueError("open_index(): pass vectors X to build an index")
    if method not in ALL_METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    policy = schedule if schedule is not None else SchedulePolicy()
    _unsupported(policy)
    device = resolve_device(device)     # fail before paying for the fit
    X = np.ascontiguousarray(np.atleast_2d(X), np.float32)
    m = make_method(method, **{"seed": seed, **(method_params or {})})
    m.fit(X)
    if m.needs_training:
        if train_queries is None:
            rng = np.random.default_rng(seed)
            train_queries = X[rng.choice(X.shape[0], min(24, X.shape[0]),
                                         replace=False)]
        m.train(np.asarray(train_queries, np.float32), train_k,
                policy.stage_dims(X.shape[1]))
    return SearchSession(m, policy, backend=backend, device=device)

"""The facade: ``open_index(...)`` -> ``SearchSession``.

Counterpart of the reference package's ``api/session.py``: the streaming
search on a torch device over a flat or an IVF index, and the numpy host
backend over a flat, IVF or HNSW index:

    sess = open_index(X, method="PDScanning+")       # fits, runs on CUDA
    res = sess.search(Q, k=10)                       # res.ids (nq, k)
    sess.add(X_new)                                  # the delta segment
    print(sess.last_write_mode)                      # "delta", "merge", ...
    ivf = open_index(X, index="ivf", method="PDScanning+",
                     index_params={"n_list": 64})
    res = ivf.search(Q, k=10, nprobe=16)             # the device IVF probe
    pdx = open_index(X, method="PDScanning+",        # the PDX layout
                     schedule=SchedulePolicy(dim_groups=4))
    two = open_index(X, method="PDScanning+",        # the one-shot engine
                     schedule=SchedulePolicy(engine="two_stage"))
    hnsw = open_index(X, index="hnsw", method="PDScanning+",
                      backend="host", index_params={"m": 16})
    res = hnsw.search(Q, k=10, ef=64)                # the host graph walk
    ada = open_index(X, method="PDScanning+",        # the adaptive policy
                     schedule=SchedulePolicy(adaptive=True))
    res = ada.search(Q, k=10, deadline_s=0.05)       # anytime: coverage
    grd = open_index(X, method="PDScanning+",        # the guardrail breaker
                     schedule=SchedulePolicy(guardrails=True))
    print(grd.guardrails()["state"])
    svc = sess.serve(slots=16, k=10)                 # continuous batching
    svc.submit(Q[0]); svc.drain()
    sess.save("idx.bin")                             # snapshot + delta WAL
    sess = SearchSession.load("idx.bin")             # back on the card
    sess = open_index(path="idx.bin", device="cpu")  # ... or on the CPU
    mesh = make_host_mesh(2, 1, device_type="cuda")  # on each of 2 ranks
    shd = open_index(X, method="PDScanning+", mesh=mesh)   # one shard a rank
    svc = shd.serve(slots=16, k=10)                  # on every rank, then
    svc.submit(Q[0]); svc.drain(); svc.close()       # rank 0 drives it
    svc.follow()                                     # the others follow

A mesh session is collective: every rank of the mesh calls ``open_index``,
``search``, ``add`` and ``save`` with the same arguments and gets the same
result; snapshots and the WAL are written by rank 0.  Its serving front
has one clock, rank 0's: rank 0's ``SearchService`` admits, sheds,
expires and batches requests and broadcasts each device step, and the
other ranks' ``follow()`` makes the same search or add until rank 0
calls ``close()``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.api.backends import make_backend, resolve_device
from repro_torch.api.types import SchedulePolicy, SearchResult
from repro_torch.core.methods import ALL_METHODS, make_method
from repro_torch.search.hnsw import HNSWIndex
from repro_torch.search.ivf import IVFIndex
from repro_torch.testing import faults
from repro_torch.utils import trace

INDEX_KINDS = ("flat", "ivf", "hnsw")
BACKENDS = ("torch", "host")
METHODS = tuple(ALL_METHODS)


def _check_engine(policy: SchedulePolicy) -> None:
    if policy.engine not in ("stream", "two_stage"):
        raise ValueError(f"SchedulePolicy(engine={policy.engine!r}): "
                         "expected 'stream' or 'two_stage'")


class SearchSession:
    """A fitted method + built index + a backend, behind batched calls.
    ``index_kind`` is ``"flat"`` (``index`` None), ``"ivf"`` (``index`` a
    built ``IVFIndex``) or ``"hnsw"`` (a built ``HNSWIndex``, host backend
    only); ``backend`` is ``"torch"`` (on ``device``) or ``"host"``."""

    def __init__(self, method, policy: SchedulePolicy | None = None, *,
                 index_kind: str = "flat", index=None,
                 backend: str = "torch", device=None, mesh=None):
        if index_kind not in INDEX_KINDS:
            raise ValueError(
                f"index must be one of {INDEX_KINDS}, got {index_kind!r}")
        if index_kind == "hnsw" and backend != "host":
            raise ValueError("HNSW graph walks are host-side indexes: "
                             "serve index_kind='hnsw' with backend='host'")
        self.method = method
        self.index_kind = index_kind
        self.index = index
        self.policy = policy if policy is not None else SchedulePolicy()
        _check_engine(self.policy)
        self.mesh = mesh
        self.backend = make_backend(backend, method, self.policy,
                                    index_kind=index_kind, index=index,
                                    device=device, mesh=mesh)
        self.last_write_mode: str | None = None   # set by add()
        self.wal = None   # DeltaWAL once save()/load() ties a path to us

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
        """Executing backend: ``"torch"`` or ``"host"``."""
        return self.backend.name

    def search(self, Q, k: int = 10, *, nprobe: int = 16, ef: int = 64,
               deadline_s: float | None = None) -> SearchResult:
        """Batched top-k for all rows of ``Q``; one online prep for the
        whole batch.  ``nprobe`` is the IVF probe width (ignored by a flat
        index); ``ef`` is the HNSW walk's candidate list width (ignored by
        flat and IVF).

        ``deadline_s`` arms anytime search (DESIGN.md §7): the scan stops
        after the last row block (torch: block group) that finishes within
        ``deadline_s`` seconds of wall time and returns the running top-k
        as a partial result.  Partial queries report ``coverage < 1.0`` and
        a set ``uncertified_mask`` bit in ``result.stats.extra``; with a
        generous deadline the result equals the non-deadline path's bit
        for bit.  Flat/IVF only (HNSW walks reject it)."""
        with trace.span("session.search") as sp:
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
            if deadline_s is not None and deadline_s <= 0.0:
                raise ValueError(
                    f"search(): deadline_s must be > 0 (got {deadline_s}); the "
                    "engines always finish at least one block group, so a "
                    "non-positive budget cannot mean 'return nothing'")
            t0 = time.perf_counter()
            dists, ids, stats = self.backend.search(Q, k, nprobe=nprobe, ef=ef,
                                                    deadline_s=deadline_s)
            if sp:
                _count_stats(stats)
            return SearchResult(dists, ids, stats, time.perf_counter() - t0,
                                self.backend.name)

    def add(self, Xnew) -> "SearchSession":
        """Dynamic inserts (paper §V-E): extend the fitted method state
        without refitting transforms, then assign the rows into the index.
        Below ``policy.delta_merge_threshold`` rows they land in a delta
        segment scanned after the cached main block layout (no
        re-materialization); an HNSW index links them into its graph
        (``HNSWIndex.insert_batch``).  The write mode taken is readable as
        ``session.last_write_mode``.

        When the session is tied to a snapshot path (after ``save()`` or
        ``load()``), the rows are first written to the crash-safe delta WAL
        (fsync'd, before any state changes; DESIGN.md §7) — a crash at any
        point after ``add()`` returns loses nothing, and a crash mid-write
        tears only a frame that was never acknowledged."""
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
                "or WAL write")
        if self.wal is not None:
            self.wal.append(Xnew, self.n, plan=faults.active(self.policy))
            _mesh_barrier(self)
        return self._apply_add(Xnew)

    def _apply_add(self, Xnew: np.ndarray) -> "SearchSession":
        """The state mutation of :meth:`add`, without validation and WAL
        logging — the WAL's ``replay()`` calls this directly so replayed
        frames are not logged again."""
        parts = None
        if self.index_kind == "hnsw":
            # insert_batch appends to the method itself, then links
            self.index.insert_batch(self.method, Xnew,
                                    schedule=self.policy.stage_dims(self.dim))
        else:
            start = self.n
            self.method.append(Xnew)
            if self.index_kind == "ivf":
                parts = self.index.insert(
                    np.arange(start, start + Xnew.shape[0]), Xnew)
        self.last_write_mode = self.backend.notify_append(
            Xnew.shape[0], parts=parts)
        return self

    def guardrails(self) -> dict | None:
        """Guardrail snapshot (DESIGN.md §9) when the session was opened
        with ``SchedulePolicy(guardrails=...)``: breaker state, drift and
        audit EWMAs, audit counters and the transition log.  ``None`` when
        no guardrail is armed (FDScanning sessions included: they are
        already the certified fallback)."""
        g = getattr(self.backend, "guardrail", None)
        return None if g is None else g.report()

    def serve(self, **kwargs) -> "SearchService":
        """Wrap this session in a continuous-batching serving front
        (``repro_torch.serving.SearchService``); kwargs are its knobs
        (slots/k/nprobe/...).  On a mesh every rank calls it: rank 0's
        service serves (``submit``/``step``/``drain``/``add``/``health``,
        then ``close()``), and every other rank calls its ``follow()``,
        which makes the searches and adds rank 0 broadcasts until rank 0
        closes."""
        from repro_torch.serving.search_service import SearchService
        return SearchService(self, **kwargs)

    # -- persistence ---------------------------------------------------------
    def save(self, path) -> None:
        """Persist the fitted state + index to ``path`` (api.persistence;
        numpy only, no tensor) and arm the crash-safe delta WAL at
        ``path + ".wal"`` — later ``add()`` calls are logged there and
        survive a crash (the log is cleared first: this snapshot supersedes
        it).  On a mesh, rank 0 writes and every rank waits for it."""
        from repro_torch.api.persistence import save_session
        save_session(self, path)

    @classmethod
    def load(cls, path, *, backend: str | None = None, device=None,
             mesh=None) -> "SearchSession":
        """Rebuild a saved session on ``device`` (default: the CUDA card)
        and replay its delta WAL (inserts made after the snapshot);
        ``backend`` may override the saved one, and every rank of
        ``mesh`` reads the snapshot to serve its shard.  Raises
        ``api.IndexLoadError`` on an unreadable snapshot."""
        from repro_torch.api.persistence import load_session
        return load_session(path, backend=backend, device=device, mesh=mesh)


def _count_stats(stats) -> None:
    """The screen's counters of one search, from its ``ScanStats``, on
    the innermost span: the dims it read and the dims a full scan reads
    (``dims_read_share.batch`` reads their ratio)."""
    trace.count("dims_read", float(stats.dims_scanned))
    trace.count("dims_total", float(stats.dims_total))


def _mesh_barrier(session) -> None:
    """On a mesh, wait until every rank gets here (rank 0's file writes
    are then on disk for all of them)."""
    if session.mesh is not None:
        import torch.distributed as dist
        dist.barrier()


def open_index(X=None, *, index: str = "flat", method: str = "DADE",
               backend: str | None = None,
               schedule: SchedulePolicy | None = None,
               method_params: dict | None = None,
               index_params: dict | None = None,
               train_queries=None, train_k: int = 10, seed: int = 0,
               device=None, mesh=None, serving: bool = False,
               serving_params: dict | None = None, path=None):
    """Fit ``method`` on ``X``, build ``index`` and return a ready session.
    The torch backend (the default) runs on ``device`` (default: the CUDA
    card; without one this raises ``RuntimeError`` — pass ``device="cpu"``
    to run on the CPU); ``backend="host"`` runs the numpy scan on the host.

    ``method`` is one of the paper's 8 (``METHODS``); training-based
    methods (DDCpca/DDCopq) are trained on ``train_queries`` (default: a
    sample of X rows) for ``k=train_k``.  ``index="ivf"`` builds an
    ``IVFIndex(**index_params)`` (default ``n_list=64``), probed on the
    device by the torch backend; ``index="hnsw"`` an
    ``HNSWIndex(**index_params)`` by DCO-screened insertion, walked by the
    host backend only.  ``serving=True`` wraps the session in a
    continuous-batching ``repro_torch.serving.SearchService``
    (``serving_params`` are its knobs) and returns that instead.

    ``mesh`` (a ``launch.mesh`` ``DeviceMesh``; torch backend, flat index)
    shards the corpus over the mesh's ranks: every rank calls
    ``open_index`` with the same arguments, fits the same method, and lays
    out only its own rows, on ``device`` (default: the card ``rank %
    cards``).  With ``serving=True`` every rank gets its service: rank 0
    drives it, the others ``follow()`` it (``SearchSession.serve``).

    ``path`` ties the session to a snapshot file (DESIGN.md §7).  With
    ``X=None`` the session is *loaded* from ``path`` — snapshot plus a
    replay of its delta WAL, so inserts acknowledged after the last
    ``save()`` survive a crash (``IndexLoadError`` on unreadable files);
    ``backend`` then overrides the saved one.  With both given, the fresh
    index is saved to ``path`` at once, arming the WAL for every later
    ``add()``."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if X is None:
        if path is None:
            raise ValueError("open_index(): pass vectors X to build an "
                             "index, or path= to load a saved one")
        sess = SearchSession.load(path, backend=backend, device=device,
                                  mesh=mesh)
        if serving:
            return sess.serve(**(serving_params or {}))
        return sess
    backend = backend if backend is not None else "torch"
    if index not in INDEX_KINDS:
        raise ValueError(f"index must be one of {INDEX_KINDS}, got {index!r}")
    # fail before paying for an index the backend can't serve
    if backend == "torch" and index == "hnsw":
        raise ValueError(
            f"backend='torch' serves index='flat' or 'ivf' (got {index!r}); "
            "HNSW graph walks are host-side indexes (backend='host')")
    if backend == "torch" and index == "ivf" and mesh is not None:
        raise ValueError(
            "device IVF probing is single-device; mesh-shard a flat corpus "
            "instead")
    if method not in ALL_METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    policy = schedule if schedule is not None else SchedulePolicy()
    _check_engine(policy)
    if backend == "torch":
        device = resolve_device(device, mesh)   # fail before the fit
    X = np.ascontiguousarray(np.atleast_2d(X), np.float32)
    m = make_method(method, **{"seed": seed, **(method_params or {})})
    with trace.setup_span("open.fit", method=method, rows=X.shape[0]):
        m.fit(X)
    if m.needs_training:
        if train_queries is None:
            rng = np.random.default_rng(seed)
            train_queries = X[rng.choice(X.shape[0], min(24, X.shape[0]),
                                         replace=False)]
        m.train(np.asarray(train_queries, np.float32), train_k,
                policy.stage_dims(X.shape[1]))
    params = dict(index_params or {})
    idx = None
    if index == "ivf":
        params.setdefault("n_list", 64)
        idx = IVFIndex(**params).build(X)
    elif index == "hnsw":
        idx = HNSWIndex(**params).build(X, method=m,
                                        schedule=policy.stage_dims(X.shape[1]))
    sess = SearchSession(m, policy, index_kind=index, index=idx,
                         backend=backend, device=device, mesh=mesh)
    if path is not None:
        sess.save(path)
    if serving:
        return sess.serve(**(serving_params or {}))
    return sess

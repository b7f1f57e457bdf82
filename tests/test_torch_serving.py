"""The port's serving front (repro_torch.serving.SearchService) against the
reference package's.

1. The service cases of tests/test_serving_search.py, the overload and
   fault cases of tests/test_robustness.py and
   tests/test_guardrails.py's breaker-in-health case, on both backends of
   the port (the torch backend on the CPU).
2. Across packages: one explicit request stream (``now`` stamps, bounded
   admission, interleaved adds, queue-expiry timeouts and an injected
   device-step failure) through the reference's service and the port's
   gives, per request, the same status, ids exactly, distances within
   rtol 1e-4, the same certificate and coverage, and equal counters.
   Timing fields are not compared: the walls are each package's own.
"""
import numpy as np
import pytest

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.testing import faults as jax_faults
from repro_torch.api import GuardrailConfig, SchedulePolicy, open_index
from repro_torch.serving import SearchRequest, SearchService
from repro_torch.testing import faults

BACKENDS = ["torch", "host"]
COUNTERS = ("submitted", "completed", "shed", "timeouts", "failures",
            "partials", "uncertified", "steps", "rows_inserted")


def _data(n=1536, d=48, nq=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


def _pol(cls=SchedulePolicy, **kw):
    kw.setdefault("d1", 24)
    kw.setdefault("query_chunk", 4)
    kw.setdefault("row_block", 256)
    kw.setdefault("block_capacity", 256)
    return cls(**kw)


def _open(X, backend, **kw):
    return open_index(X, backend=backend, device="cpu", **kw)


# ------------------------------------------------ test_serving_search ------
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_batches_match_batched_search(backend):
    X, Q = _data(nq=11)                           # < slots and > slots below
    sess = _open(X, backend, index="flat", method="PDScanning+",
                 schedule=_pol(adaptive=True))
    svc = sess.serve(slots=4, k=10)
    assert isinstance(svc, SearchService)
    reqs = [svc.submit(q) for q in Q]
    assert all(isinstance(r, SearchRequest) for r in reqs)
    assert svc.pending == len(Q)
    served = svc.drain()
    assert svc.pending == 0 and len(served) == len(Q)
    ref = sess.search(Q, 10)
    for i, r in enumerate(reqs):
        assert r.done and r.latency_s >= 0.0
        assert r.certified is True                # adaptive => certified
        assert r.batch_size <= 4 and r.n_visible == X.shape[0]
        np.testing.assert_array_equal(r.ids, ref.ids[i])


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_rejects_bad_dimension_and_empty_step(backend):
    X, _ = _data()
    svc = _open(X, backend, index="flat", method="PDScanning",
                serving=True, serving_params={"slots": 2, "k": 5})
    assert isinstance(svc, SearchService)
    assert svc.step() == []
    with pytest.raises(ValueError, match="dimension"):
        svc.submit(np.zeros(7, np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_interleaved_add_becomes_visible(backend):
    X, Q = _data()
    sess = _open(X[:1400], backend, index="flat", method="PDScanning+",
                 schedule=_pol(adaptive=True))
    svc = sess.serve(slots=4, k=5)
    svc.submit(Q[0])
    first = svc.drain()[0]
    assert first.n_visible == 1400
    probe = X[1400]                               # insert, then query it
    info = svc.add(X[1400:])
    assert info["rows"] == X.shape[0] - 1400
    assert info["mode"] == ("delta" if backend == "torch" else "noop")
    svc.submit(probe)
    req = svc.drain()[0]
    assert req.n_visible == X.shape[0]
    assert req.ids[0] == 1400                     # its own row wins top-1
    assert req.dists[0] <= 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_simulated_time_stamps(backend):
    X, Q = _data()
    svc = _open(X, backend, index="flat", method="PDScanning",
                serving=True, serving_params={"slots": 4, "k": 5})
    r0 = svc.submit(Q[0], now=10.0)
    r1 = svc.submit(Q[1], now=10.5)
    served = svc.drain(now=11.0)
    assert [r.rid for r in served] == [r0.rid, r1.rid]
    assert r0.t_submit == 10.0 and r1.t_submit == 10.5
    assert r0.t_done == pytest.approx(11.0 + r0.service_s)
    assert r0.latency_s > r1.latency_s            # same batch, earlier submit


# ------------------------------------------------------ test_robustness ----
def _rdata(n=2048, d=24, nq=8, seed=7):
    return _data(n=n, d=d, nq=nq, seed=seed)


def _rpol(**kw):
    kw.setdefault("anytime_block_group", 2)
    return _pol(**kw)


def _service(X, backend, **kw):
    sess = _open(X, backend)
    return sess.serve(slots=4, k=5, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_queue_reject_new(backend):
    X, Q = _rdata(n=512)
    svc = _service(X, backend, max_queue=3, admission="reject")
    kept = [svc.submit(Q[i % Q.shape[0]], now=0.0) for i in range(3)]
    turned = [svc.submit(Q[i % Q.shape[0]], now=0.0) for i in range(4)]
    assert all(r.status == "pending" for r in kept)
    assert all(r.status == "shed" and r.resolved and not r.done
               for r in turned)
    assert svc.pending == 3 and svc.shed == 4
    done = svc.drain(now=0.0)
    assert len(done) == 3 and all(r.done for r in done)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bounded_queue_shed_oldest(backend):
    X, Q = _rdata(n=512)
    svc = _service(X, backend, max_queue=2, admission="shed_oldest")
    a = svc.submit(Q[0], now=0.0)
    b = svc.submit(Q[1], now=0.0)
    c = svc.submit(Q[2], now=0.0)            # evicts a, not c
    assert a.status == "shed" and b.status == "pending" \
        and c.status == "pending"
    assert svc.pending == 2 and svc.shed == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_queued_timeout_resolves_instead_of_hanging(backend):
    X, Q = _rdata(n=512)
    svc = _service(X, backend, deadline_s=0.5)
    early = svc.submit(Q[0], now=0.0)
    late = svc.submit(Q[1], now=0.6)
    out = svc.step(now=1.0)                  # early expired, late still live
    assert early.status == "timeout" and early in out
    assert late.done and late in out
    assert svc.timeouts == 1 and svc.completed == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_request_deadline_overrides_service_default(backend):
    X, Q = _rdata(n=512)
    svc = _service(X, backend, deadline_s=100.0)
    tight = svc.submit(Q[0], now=0.0, deadline_s=0.1)
    out = svc.drain(now=5.0)
    assert tight.status == "timeout" and out == [tight]
    with pytest.raises(ValueError, match="deadline_s"):
        svc.submit(Q[0], deadline_s=0.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_submit_rejects_non_finite_query(backend):
    X, Q = _rdata(n=512)
    svc = _service(X, backend)
    bad = Q[0].copy()
    bad[3] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        svc.submit(bad)
    assert svc.pending == 0


def test_service_rejects_bad_knobs():
    X, _ = _rdata(n=256)
    sess = _open(X, "host")
    for kw, what in ((dict(slots=0), "slots"),
                     (dict(admission="drop"), "admission"),
                     (dict(max_queue=0), "max_queue"),
                     (dict(deadline_s=0.0), "deadline_s")):
        with pytest.raises(ValueError, match=what):
            sess.serve(**kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_counters_account_for_every_ticket(backend):
    """The §7 invariant: submitted == completed + shed + timeouts +
    failures + pending, through a mix of all outcomes."""
    X, Q = _rdata(n=512)
    svc = _service(X, backend, max_queue=4, admission="reject",
                   deadline_s=1.0)
    for i in range(8):                        # 4 admitted, 4 shed
        svc.submit(Q[i % Q.shape[0]], now=0.0)
    svc.step(now=0.5)                         # serves 4
    for i in range(3):
        svc.submit(Q[i], now=10.0)            # fresh, expire 2 below
    svc.submit(Q[3], now=10.9)
    svc.step(now=12.0)                        # 3 timeout, 1 served... all 4
    h = svc.health()
    assert h["submitted"] == 12
    assert h["submitted"] == (h["completed"] + h["shed"] + h["timeouts"]
                              + h["failures"] + h["queue_depth"])
    assert h["shed"] == 4 and h["timeouts"] >= 3
    assert h["p99_ewma_s"] is not None and h["p99_ewma_s"] >= 0.0
    assert 0 <= h["uncertified"] <= h["completed"]
    assert 0 <= h["partials"] <= h["completed"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_device_fault_fails_batch_not_service(backend):
    X, Q = _rdata(n=512)
    svc = _service(X, backend)
    with faults.inject(fail_search_after=0):
        doomed = svc.submit(Q[0])
        out = svc.step()
    assert doomed.status == "failed" and doomed in out
    assert "FaultError" in doomed.error
    assert svc.failures == 1
    ok = svc.submit(Q[1])                     # the service keeps serving
    svc.step()
    assert ok.done and ok.certified


@pytest.mark.parametrize("backend", BACKENDS)
def test_anytime_partial_served_through_service(backend):
    X, Q = _rdata()
    sess = _open(X, backend, schedule=_rpol())
    svc = sess.serve(slots=4, k=5, deadline_s=0.05)
    with faults.inject(slow_block_s=0.03):
        for i in range(4):
            svc.submit(Q[i])
        out = svc.drain()
    served = [r for r in out if r.done]
    assert served and svc.partials >= 1
    partial = [r for r in served if r.coverage is not None
               and r.coverage < 1.0]
    assert partial and all(r.certified is False for r in partial)
    # every withdrawn certificate is counted once in health()
    h = svc.health()
    assert h["uncertified"] == sum(r.certified is False for r in served)
    assert h["uncertified"] >= len(partial)


# ------------------------------------------------------ test_guardrails ----
def _corpus(n=1500, d=48, seed=5):
    """Anisotropic corpus (power-law spectrum) under a random rotation."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X *= (np.arange(1, d + 1, dtype=np.float32) ** -0.7)
    R, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float32))
    return np.ascontiguousarray(X @ R, np.float32)


def _id_queries(X, nq=16, seed=11):
    rng = np.random.default_rng(seed)
    idx = rng.choice(X.shape[0], nq, replace=False)
    return X[idx] + 0.01 * rng.standard_normal(
        (nq, X.shape[1])).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_health_reports_breaker(backend):
    X = _corpus()
    sess = _open(X, backend, method="PDScanning",
                 schedule=SchedulePolicy(d1=16, query_chunk=8, row_block=256,
                                         block_capacity=32,
                                         guardrails=GuardrailConfig()))
    svc = sess.serve(slots=4, k=5)
    for q in _id_queries(X, 4):
        svc.submit(q)
    svc.drain()
    h = svc.health()
    assert h["breaker_state"] == "closed"
    assert 0.0 <= h["drift_score"] <= 1.0
    assert h["audit_recall"] == pytest.approx(1.0)
    assert h["demoted_batches"] == 0
    assert "wal_bytes" not in h                   # no snapshot path


# ------------------------------------------------------- cross-package ----
def _stream(svc, X, Q, faults_mod):
    """One explicit request stream: a burst past the bounded queue, adds
    between steps, a queued request that expires, and the fourth search
    failing.  Returns every ticket in submission order."""
    reqs = []

    def sub(i, t, **kw):
        reqs.append(svc.submit(Q[i], now=t, **kw))

    with faults_mod.inject(fail_search_after=3):
        for i in range(8):                      # 6 admitted, the 2 oldest
            sub(i, 0.0, deadline_s=5.0)         # shed
        svc.step(now=0.1)                       # search 0
        svc.add(X[1000:1050])
        sub(8, 0.2, deadline_s=0.3)
        sub(9, 0.25)
        svc.step(now=0.3)                       # search 1: a deadline batch
        sub(10, 1.0, deadline_s=0.2)            # expires at 1.2
        sub(11, 1.0)
        svc.step(now=1.5)                       # 10 times out; search 2
        svc.add(X[1050:1100])
        for i in range(4):
            sub(i, 2.0)
        svc.step(now=2.1)                       # search 3: injected failure
        sub(4, 3.0)
        sub(5, 3.0)
        svc.step(now=3.1)                       # search 4
    return reqs


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_stream_matches_reference(backend):
    X, Q = _data(n=1100, d=32, nq=12, seed=3)
    kw = dict(slots=4, k=5, max_queue=6, admission="shed_oldest")
    ref = jax_open_index(X[:1000], method="PDScanning+",
                         backend="jax" if backend == "torch" else "host",
                         schedule=_pol(JaxPolicy)).serve(**kw)
    port = _open(X[:1000], backend, method="PDScanning+",
                 schedule=_pol()).serve(**kw)
    rr = _stream(ref, X, Q, jax_faults)
    rp = _stream(port, X, Q, faults)
    assert [r.status for r in rp] == [r.status for r in rr]
    assert [r.status for r in rp].count("failed") == 4
    assert {r.status for r in rp} == {"done", "shed", "timeout", "failed"}
    for a, b in zip(rp, rr):
        assert (a.rid, a.t_submit, a.t_deadline) == (b.rid, b.t_submit,
                                                     b.t_deadline)
        assert (a.certified, a.coverage, a.n_visible, a.batch_size) == (
            b.certified, b.coverage, b.n_visible, b.batch_size)
        assert (a.error is None) == (b.error is None)
        if b.ids is None:
            assert a.ids is None and a.dists is None
            continue
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4)
    hp, hr = port.health(), ref.health()
    assert {c: hp[c] for c in COUNTERS} == {c: hr[c] for c in COUNTERS}
    assert port.write_modes == ref.write_modes
    assert hp["submitted"] == (hp["completed"] + hp["shed"] + hp["timeouts"]
                               + hp["failures"] + hp["queue_depth"])


# ------------------------------------------- chip_smoke.py's A6 phases ----
def test_chip_smoke_serving_phases_run_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's serving, overload, OOD, replica and persistence
    phases, at a tiny size on the CPU (no kernel, no graph): every check
    they hold on the card passes here too."""
    import importlib.util
    from pathlib import Path

    import torch

    from repro_torch.vecdata import make_ood_queries
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "SERVE_INSERT_ROWS", 640)
    monkeypatch.setattr(cs, "SERVE_REQUESTS", 160)
    monkeypatch.setattr(cs, "SERVE_INSERT_EVERY", 20)
    monkeypatch.setattr(cs, "OOD_REQUESTS", 80)
    monkeypatch.setattr(cs, "PERSIST_ROWS", 256)
    # the slow replica's stall is charged, never slept: make it dwarf a
    # CPU step's wall, which a loaded host can stretch to a second
    monkeypatch.setattr(cs, "SLOW_REPLICA_S", 60.0)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    dev = torch.device("cpu")
    X = _corpus(n=12_000, d=32, seed=9)
    Q = _id_queries(X, 48, seed=10)         # 3 steps of 16: each replica
    Qo = make_ood_queries(X, 48, severity=1.0)    # leads one a pass
    sess = _open(X, "torch", method="PDScanning+")
    flat_ids = sess.search(Q, cs.K).ids
    d2, d2o = cs.distances64(X, Q, dev), cs.distances64(X, Qo, dev)
    grown, rec = cs.phase_serving(X, Q, d2, sess.method, dev)
    # 8 writes, the 6th past the merge threshold (an add that meets the
    # loop before the merge's search is "cold")
    assert sum(rec["write_modes"].values()) == 8 and rec["merges"] == 1
    assert rec["recall_min"] == 1.0 and grown.n == X.shape[0]
    over = cs.phase_serving_overload(
        grown, Q, d2, rec["calibration"]["steady_step_s"], dev)
    assert over["health"]["submitted"] == cs.SERVE_REQUESTS
    ood = cs.phase_serving_ood(X, Q, Qo, d2, d2o, sess.method, dev)
    assert set(ood["classes"]) == {"id", "ood"}
    tiers = cs.phase_replica(X, Q, d2, flat_ids, X[:4000], dev)
    assert tiers["shard"]["dead_1"]["uncertified"] == Q.shape[0]
    saved = cs.phase_persist(X[:4000], Q, d2, dev)
    assert saved["replayed_rows"] == 3 * 256 and saved["bitflip_refused"]

"""The port's guardrail layer (repro_torch.core.guardrails: drift
sentinel, online audits, circuit breaker; DESIGN.md §9) against the
reference package: the cases of tests/test_guardrails.py on both backends
of the port, the OOD and drift generators, and the breaker's transitions
on the same drift scenario.

1. The sentinel separates in-distribution from OOD batches and scores
   them as the reference's does (a numpy copy: equal to the last bit).
2. An open breaker serves the certified full scan: FDScanning's ids and
   distances bit for bit, on both backends.
3. Closed-state serving is untouched: an armed session returns the
   unguarded session's ids and distances bit for bit.
4. State-machine edges are deterministic under the fault plan's drift and
   audit overrides, and the port's transitions equal the reference's.
"""
import numpy as np
import pytest

from repro.api import GuardrailConfig as JaxGuardrailConfig
from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.guardrails import DriftSentinel as JaxSentinel
from repro.testing import faults as jax_faults
from repro.vecdata.synthetic import make_drift_scenario as jax_drift
from repro.vecdata.synthetic import make_ood_queries as jax_ood
from repro_torch.api import (GuardrailConfig, SchedulePolicy, SearchSession,
                             open_index)
from repro_torch.core.engine import (EXTRA_AUDIT_RECALL, EXTRA_BREAKER_STATE,
                                     EXTRA_DRIFT_SCORE)
from repro_torch.core.guardrails import DriftSentinel, Guardrail, _sample_recall
from repro_torch.testing import faults
from repro_torch.vecdata import make_drift_scenario, make_ood_queries


def _corpus(n=1500, d=48, seed=5):
    """Anisotropic corpus (power-law spectrum) under a random rotation:
    the regime where the principal-split sentinel has signal."""
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


def _pol(cls=SchedulePolicy, **kw):
    kw.setdefault("d1", 16)
    kw.setdefault("query_chunk", 8)
    kw.setdefault("row_block", 256)
    kw.setdefault("block_capacity", 32)
    return cls(**kw)


def _open(X, backend, **kw):
    """A port session on ``backend`` (the torch one on the CPU)."""
    if backend == "torch":
        kw["device"] = "cpu"
    return open_index(X, backend=backend, **kw)


# ------------------------------------------------------------- sentinel -----
def test_sentinel_separates_id_from_ood():
    X = _corpus()
    s = DriftSentinel.fit(X, r=8, seed=0)
    js = JaxSentinel.fit(X, r=8, seed=0)
    sid = s.score(_id_queries(X))
    sood = s.score(make_ood_queries(X, 16, severity=1.0))
    assert 0.0 <= sid <= 1.0 and 0.0 <= sood <= 1.0
    assert sid < 0.2 < 0.5 < sood
    smid = s.score(make_ood_queries(X, 16, severity=0.5))
    assert sid < smid < 1.0
    for Q in (_id_queries(X), make_ood_queries(X, 16, severity=0.5)):
        assert s.score(Q) == js.score(Q)
    np.testing.assert_array_equal(s.lead, js.lead)


def test_sentinel_catches_scale_drift():
    X = _corpus()
    s = DriftSentinel.fit(X, r=8, seed=0)
    assert s.score(5.0 * _id_queries(X)) > 0.35


def test_drift_scenario_shapes_and_profiles():
    X = _corpus()
    for scen in ("gradual", "sudden", "recovering"):
        stream = make_drift_scenario(X, 8, 9, scenario=scen)
        assert len(stream) == 9
        assert all(b.shape == (8, X.shape[1]) for b in stream)
        for b, jb in zip(stream, jax_drift(X, 8, 9, scenario=scen)):
            np.testing.assert_array_equal(b, jb)
    s = DriftSentinel.fit(X, r=8, seed=0)
    sudden = [s.score(b) for b in make_drift_scenario(X, 16, 9,
                                                      scenario="sudden")]
    assert max(sudden[:3]) < 0.35 < min(sudden[3:])
    recov = [s.score(b) for b in make_drift_scenario(X, 16, 9,
                                                     scenario="recovering")]
    assert recov[4] > 0.5 and max(recov[0], recov[-1]) < 0.35
    with pytest.raises(ValueError, match="scenario"):
        make_drift_scenario(X, 8, 9, scenario="chaotic")
    with pytest.raises(ValueError, match="n_batches"):
        make_drift_scenario(X, 8, 0)


@pytest.mark.parametrize("severity", [0.0, 0.5, 1.0])
def test_ood_queries_match_reference(severity):
    X = _corpus()
    np.testing.assert_array_equal(
        make_ood_queries(X, 12, severity=severity, seed=3),
        jax_ood(X, 12, severity=severity, seed=3))


def test_sample_recall():
    a = np.array([[1, 2, 3], [4, 5, 6]])
    assert _sample_recall(a, a, 3) == 1.0
    b = np.array([[1, 2, 9], [4, 5, 6]])
    assert _sample_recall(b, a, 3) == pytest.approx(5 / 6)


# ------------------------------------------------- breaker on real drift ----
@pytest.mark.parametrize("backend", ["host", "torch"])
def test_breaker_trips_on_ood_and_open_matches_fdscan(backend):
    X = _corpus()
    gcfg = GuardrailConfig(min_dwell=2, audit_rate=0.25, audit_batch=2)
    sess = _open(X, backend, method="PDScanning",
                 schedule=_pol(guardrails=gcfg))
    ref = _open(X, backend, method="FDScanning", schedule=_pol())
    assert sess.guardrails()["state"] == "closed"
    r0 = sess.search(_id_queries(X), 10)
    assert r0.stats.extra[EXTRA_BREAKER_STATE] == "closed"
    assert r0.stats.extra[EXTRA_DRIFT_SCORE] < 0.35
    ood = make_ood_queries(X, 16, severity=1.0)
    # the host screen completes every survivor exactly, so OOD gives no
    # uncertified/audit evidence there: inject the audit divergence the
    # torch path produces by itself (capacity overflow)
    chaos = (faults.inject(audit_recall=0.5) if backend == "host"
             else faults.inject())
    with chaos:
        for _ in range(8):
            res = sess.search(ood, 10)
            if res.stats.extra[EXTRA_BREAKER_STATE] == "open":
                break
    g = sess.guardrails()
    assert g["state"] == "open" and g["demoted_batches"] >= 1
    assert any(t["to"] == "open" for t in g["transitions"])
    ro = sess.search(ood, 10)
    rf = ref.search(ood, 10)
    assert ro.stats.extra[EXTRA_BREAKER_STATE] == "open"
    assert np.array_equal(ro.ids, rf.ids)
    assert np.array_equal(ro.dists, rf.dists)


def test_open_breaker_ivf_torch_matches_fdscan():
    """An open breaker on an IVF session serves the forced full-scan body
    over the probed partitions: FDScanning's IVF ids and distances."""
    X = _corpus()
    sess = _open(X, "torch", index="ivf", method="PDScanning",
                 index_params={"n_list": 16},
                 schedule=_pol(guardrails=GuardrailConfig()))
    ref = SearchSession(_open(X, "torch", method="FDScanning").method,
                        _pol(), index_kind="ivf", index=sess.index,
                        device="cpu")
    sess.backend.guardrail.force_state("open")
    Q = make_ood_queries(X, 16, severity=1.0)
    ro = sess.search(Q, 10, nprobe=4)
    rf = ref.search(Q, 10, nprobe=4)
    assert ro.stats.extra[EXTRA_BREAKER_STATE] == "open"
    assert np.array_equal(ro.ids, rf.ids)
    assert np.array_equal(ro.dists, rf.dists)


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_closed_state_is_bit_identical_to_unguarded(backend):
    X = _corpus()
    Q = _id_queries(X)
    gcfg = GuardrailConfig(audit_rate=0.5, audit_batch=1)   # audits fire
    guarded = _open(X, backend, method="PDScanning",
                    schedule=_pol(guardrails=gcfg))
    bare = _open(X, backend, method="PDScanning", schedule=_pol())
    for _ in range(3):
        rg = guarded.search(Q, 10)
        rb = bare.search(Q, 10)
        assert rg.stats.extra[EXTRA_BREAKER_STATE] == "closed"
        assert np.array_equal(rg.ids, rb.ids)
        assert np.array_equal(rg.dists, rb.dists)
    assert guarded.guardrails()["audits"] >= 1


def test_closed_state_identical_ivf_host():
    X = _corpus()
    Q = _id_queries(X)
    gcfg = GuardrailConfig(audit_rate=0.5, audit_batch=1)
    guarded = open_index(X, index="ivf", method="PDScanning", backend="host",
                         schedule=_pol(guardrails=gcfg))
    bare = open_index(X, index="ivf", method="PDScanning", backend="host",
                      schedule=_pol())
    rg, rb = guarded.search(Q, 10), bare.search(Q, 10)
    assert np.array_equal(rg.ids, rb.ids)
    assert np.array_equal(rg.dists, rb.dists)


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_breaker_transitions_match_reference(backend):
    """The "recovering" drift scenario through a guarded PDScanning
    session of the port and of the reference (host against host, torch
    against jax; the wall-clock cost evidence parked out of reach): the
    same served state, ids and transitions batch by batch."""
    X = _corpus()
    kw = dict(min_dwell=2, trip_after=2, promote_after=2, audit_rate=0.25,
              audit_batch=2, cost_ceiling=100.0)
    st = _open(X, backend, method="PDScanning",
               schedule=_pol(guardrails=GuardrailConfig(**kw)))
    sj = jax_open_index(X, method="PDScanning",
                        backend="jax" if backend == "torch" else "host",
                        schedule=_pol(JaxPolicy, guardrails=JaxGuardrailConfig(
                            **kw)))
    stream = make_drift_scenario(X, 16, 12, scenario="recovering")
    audit = 0.5 if backend == "host" else -1.0
    with faults.inject(audit_recall=audit), \
            jax_faults.inject(audit_recall=audit):
        for Q in stream:
            rt, rj = st.search(Q, 10), sj.search(Q, 10)
            assert (rt.stats.extra[EXTRA_BREAKER_STATE]
                    == rj.stats.extra[EXTRA_BREAKER_STATE])
            np.testing.assert_array_equal(rt.ids, rj.ids)
            assert (rt.stats.extra[EXTRA_DRIFT_SCORE]
                    == rj.stats.extra[EXTRA_DRIFT_SCORE])
    gt, gj = st.guardrails(), sj.guardrails()
    seq = [(t["batch"], t["from"], t["to"]) for t in gt["transitions"]]
    assert seq == [(t["batch"], t["from"], t["to"])
                   for t in gj["transitions"]]
    assert ("closed", "open") in [s[1:] for s in seq]
    for key in ("state", "batches", "audits", "audited_queries", "canaries",
                "demoted_batches"):
        assert gt[key] == gj[key], key


# ------------------------------------------- state-machine edges (faults) ---
def _scripted(X, **gkw):
    """Host session with every pacing knob at 1 except where overridden;
    the fault-override tests script drift and audits per batch."""
    gkw.setdefault("min_dwell", 1)
    gkw.setdefault("trip_after", 1)
    gkw.setdefault("promote_after", 1)
    gkw.setdefault("audit_rate", 1.0)
    gkw.setdefault("audit_batch", 1)
    # cost_ratio is measured wall clock: park its ceiling out of reach
    gkw.setdefault("cost_ceiling", 100.0)
    return open_index(X, method="PDScanning", backend="host",
                      schedule=_pol(guardrails=GuardrailConfig(**gkw)))


def test_trip_needs_drift_and_evidence():
    X = _corpus()
    Q = _id_queries(X)
    sess = _scripted(X)
    with faults.inject(drift_score=0.9, audit_recall=1.0):
        for _ in range(4):
            sess.search(Q, 10)
    assert sess.guardrails()["state"] == "closed"
    sess = _scripted(X)
    with faults.inject(drift_score=0.0, audit_recall=0.2):
        for _ in range(4):
            sess.search(Q, 10)
    assert sess.guardrails()["state"] == "closed"
    sess = _scripted(X)
    with faults.inject(drift_score=0.9, audit_recall=0.2):
        for _ in range(4):
            sess.search(Q, 10)
    assert sess.guardrails()["state"] == "open"


def test_flaps_bounded_by_min_dwell():
    """Alternating 2-batch id/ood bursts: serving-mode transitions (into or
    out of 'closed') are at least min_dwell batches apart."""
    X = _corpus()
    Q = _id_queries(X)
    sess = _scripted(X, min_dwell=3)
    for burst in range(10):
        drift = 0.9 if burst % 2 else 0.0
        with faults.inject(drift_score=drift,
                           audit_recall=0.2 if drift else 1.0):
            for _ in range(2):
                sess.search(Q, 10)
    g = sess.guardrails()
    flips = [t["batch"] for t in g["transitions"]
             if (t["from"] == "closed") != (t["to"] == "closed")]
    assert all(b - a >= 3 for a, b in zip(flips, flips[1:]))
    assert g["batches"] == 20


def test_canary_failure_reopens():
    X = _corpus()
    Q = _id_queries(X)
    sess = _scripted(X)
    g = sess.backend.guardrail
    g.force_state("half_open")
    with faults.inject(drift_score=0.0, audit_recall=0.0):
        res = sess.search(Q, 10)
    assert res.stats.extra[EXTRA_BREAKER_STATE] == "half_open"
    assert g.state == "open"
    assert any(t["to"] == "open" and "canary" in t["reason"]
               for t in g.transitions)


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_drift_then_recover_repromotes(backend):
    X = _corpus()
    Q = _id_queries(X)
    gkw = dict(min_dwell=2, trip_after=1, promote_after=2, audit_rate=1.0,
               audit_batch=1, cost_ceiling=100.0)
    sess = _open(X, backend, method="PDScanning",
                 schedule=_pol(guardrails=GuardrailConfig(**gkw)))
    with faults.inject(drift_score=0.95, audit_recall=0.0):
        for _ in range(4):
            sess.search(Q, 10)
    assert sess.guardrails()["state"] == "open"
    with faults.inject(drift_score=0.0, audit_recall=1.0):
        for _ in range(10):
            res = sess.search(Q, 10)
    g = sess.guardrails()
    assert g["state"] == "closed"
    assert g["audit_recall"] > 0.99
    assert res.stats.extra[EXTRA_AUDIT_RECALL] > 0.99
    seq = [(t["from"], t["to"]) for t in g["transitions"]]
    assert ("open", "half_open") in seq and ("half_open", "closed") in seq


def test_force_state_validates():
    X = _corpus(n=400)
    sess = _scripted(X)
    g = sess.backend.guardrail
    with pytest.raises(ValueError, match="breaker state"):
        g.force_state("bogus")
    g.force_state("open")
    assert sess.guardrails()["state"] == "open"


# --------------------------------------------------- sampling determinism ---
class _Method:
    """Minimal stand-in exposing what Guardrail needs."""

    name = "PDScanning"

    def __init__(self, X):
        self.state = {"X": X}


def test_audit_sampling_is_deterministic():
    X = _corpus(n=400)
    a = Guardrail(GuardrailConfig(seed=3), _Method(X), "host")
    b = Guardrail(GuardrailConfig(seed=3), _Method(X), "host")
    for _ in range(5):
        assert a._take_audit(16) == b._take_audit(16)
        assert np.array_equal(a._sample(16, 4), b._sample(16, 4))
        a.batches += 1
        b.batches += 1
    a.batches = 0
    s0 = a._sample(16, 4)
    a.batches = 1
    a._sample(16, 4)
    a.batches = 0
    assert np.array_equal(a._sample(16, 4), s0)


def test_audit_accumulator_batches_shadow_calls():
    X = _corpus(n=400)
    g = Guardrail(GuardrailConfig(audit_rate=1 / 64, audit_batch=8),
                  _Method(X), "host")
    taken = [g._take_audit(16) for _ in range(64)]
    assert sum(taken) == 16
    assert sorted(set(taken)) == [0, 8]


# ----------------------------------------------------------- arming rules ---
def test_hnsw_rejects_guardrails():
    X = _corpus(n=400)
    with pytest.raises(ValueError, match="HNSW"):
        open_index(X, index="hnsw", backend="host",
                   schedule=SchedulePolicy(guardrails=GuardrailConfig()))


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_fdscan_is_silently_unarmed(backend):
    X = _corpus(n=400)
    sess = _open(X, backend, method="FDScanning",
                 schedule=SchedulePolicy(guardrails=GuardrailConfig()))
    assert sess.guardrails() is None
    res = sess.search(_id_queries(X), 10)
    assert EXTRA_BREAKER_STATE not in res.stats.extra


def test_guardrails_true_means_defaults():
    X = _corpus(n=400)
    sess = open_index(X, method="PDScanning", backend="host",
                      schedule=_pol(guardrails=True))
    g = sess.backend.guardrail
    assert g is not None and g.cfg == GuardrailConfig()
    assert sess.guardrails()["state"] == "closed"


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_deadline_calls_bypass_guardrail(backend):
    X = _corpus()
    sess = _open(X, backend, method="PDScanning",
                 schedule=_pol(guardrails=GuardrailConfig()))
    res = sess.search(_id_queries(X), 10, deadline_s=1e3)
    assert EXTRA_BREAKER_STATE not in res.stats.extra
    assert sess.guardrails()["batches"] == 0


def test_guarded_torch_session_streams():
    """A guardrail session runs the streaming engine (the demoted body is
    its forced full scan), even under engine="two_stage"."""
    X = _corpus(n=400)
    sess = _open(X, "torch", method="PDScanning",
                 schedule=_pol(guardrails=True, engine="two_stage"))
    sess.search(_id_queries(X), 10)
    assert sess.backend._resolved_engine() == "stream"
    assert sess.backend._blocks is not None


# ---------------------------------------------------------- non-finite add --
def test_add_rejects_non_finite_rows():
    X = _corpus(n=400)
    sess = open_index(X, backend="host")
    bad = np.ones((3, X.shape[1]), np.float32)
    bad[1, 5] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        sess.add(bad)
    assert sess.n == 400
    sess.add(np.ones((2, X.shape[1]), np.float32))
    assert sess.n == 402

"""The port's replicated serving tier (repro_torch.serving.replica,
DESIGN.md §10) against the reference package's.

1. Every case of tests/test_replica.py, on both backends of the port (the
   torch backend on the CPU): a healthy tier is transparent, faults
   degrade but never lie, the ticket lifecycle never leaks, routing heals
   and chaos is replay-exact.
2. Across packages: one chaos script (a replica that dies after a few
   dispatches, a slow replica, revival) through the reference's tier and
   the port's, with the same injected timer and jitter seed, gives per
   batch the same serving replica, hedge and degraded flags, the same
   retry and hedge counters, the same per-replica transition logs and
   the same ids.
"""
import numpy as np
import pytest

from repro.serving import ReplicaPolicy as JaxReplicaPolicy
from repro.serving import open_replicated as jax_open_replicated
from repro.testing import FaultPlan as JaxFaultPlan
from repro.testing import faults as jax_faults
from repro_torch.api import open_index
from repro_torch.core.engine import (EXTRA_DEGRADED, EXTRA_HEDGED,
                                     EXTRA_REPLICA)
from repro_torch.serving import (REPLICA_MODES, ReplicaDispatchError,
                                 ReplicaPolicy, ReplicatedService,
                                 open_replicated)
from repro_torch.testing import FaultPlan, faults

BACKENDS = ["torch", "host"]


def _data(n=900, d=24, nq=12, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


def _tier(X, backend="torch", **kw):
    kw.setdefault("replicas", 3)
    kw.setdefault("k", 8)
    kw.setdefault("slots", 4)
    return open_replicated(X, backend=backend, device="cpu", **kw)


def _single(X, backend):
    return open_index(X, method="DADE", backend=backend, device="cpu")


def _submit_all(svc, Q, t0=0.0):
    for j, q in enumerate(Q):
        svc.submit(q, now=t0 + 1e-4 * j)


def _by_rid(reqs):
    return sorted([r for r in reqs if r.status == "done"],
                  key=lambda r: r.rid)


def _oracle(X, Q, k):
    d = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _acct(svc):
    h = svc.health()
    return h["submitted"] == (h["completed"] + h["shed"] + h["timeouts"]
                              + h["failures"] + svc.pending)


# ------------------------------------------------------------ transparency --
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["replicate", "shard"])
def test_healthy_tier_matches_single_session(mode, backend):
    X, Q = _data()
    svc = _tier(X, backend, mode=mode)
    assert mode in REPLICA_MODES
    _submit_all(svc, Q)
    done = _by_rid(svc.drain(now=1.0))
    assert len(done) == len(Q)
    ref = _single(X, backend).search(Q, 8)
    got = np.stack([r.ids for r in done])
    assert np.array_equal(got, ref.ids)
    for r in done:
        assert r.certified is True and r.coverage == 1.0
        assert r.stats[EXTRA_DEGRADED] == 0.0
    assert _acct(svc)


@pytest.mark.parametrize("backend", BACKENDS)
def test_replicate_round_robins_over_replicas(backend):
    X, Q = _data(nq=12)
    svc = _tier(X, backend, mode="replicate", slots=2,
                replica_policy=ReplicaPolicy(hedge=False))
    _submit_all(svc, Q)
    svc.drain(now=1.0)
    served = [rs.served for rs in svc.replicas]
    assert sum(served) == 6 and max(served) - min(served) <= 1


# ----------------------------------------------------------- retry/backoff --
@pytest.mark.parametrize("backend", BACKENDS)
def test_dead_replica_is_retried_on_another(backend):
    X, Q = _data(nq=4)
    svc = _tier(X, backend, mode="replicate", slots=4)
    with faults.inject(dead_replica=0):
        _submit_all(svc, Q)
        done = svc.drain(now=1.0)
    assert all(r.status == "done" for r in done)
    h = svc.health()
    assert h["failures"] == 0 and h["retries"] >= 1
    assert svc.replicas[0].failures >= 1
    assert _acct(svc)


def test_backoff_is_capped_exponential_and_deterministic():
    X, _ = _data()
    pol = ReplicaPolicy(backoff_base_s=0.01, backoff_cap_s=0.03,
                        jitter=0.5, seed=3)
    a = _tier(X, "host", mode="replicate", replica_policy=pol)
    b = _tier(X, "host", mode="replicate", replica_policy=pol)
    da = [a._backoff(i) for i in range(1, 6)]
    db = [b._backoff(i) for i in range(1, 6)]
    assert da == db                       # same seed -> same jitter stream
    for i, d in enumerate(da, start=1):
        base = min(0.03, 0.01 * 2 ** (i - 1))
        assert base <= d <= base * 1.5
    assert max(da) <= 0.03 * 1.5          # cap holds jitter included


def _kill_sessions(svc):
    """Break every replica's backend (the connection-level failure the
    tier must survive).  Returns the original bound methods for healing."""
    saved = [rs.session.search for rs in svc.replicas]
    for rs in svc.replicas:
        def _down(*a, _i=rs.idx, **k):
            raise RuntimeError(f"replica {_i} backend down")
        rs.session.search = _down
    return saved


def _heal_sessions(svc, saved):
    for rs, fn in zip(svc.replicas, saved):
        rs.session.search = fn


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_replicas_down_fails_batch_not_service(backend):
    X, Q = _data(nq=6)
    svc = _tier(X, backend, mode="replicate", slots=3,
                replica_policy=ReplicaPolicy(max_retries=2, eject_after=1))
    saved = _kill_sessions(svc)
    _submit_all(svc, Q[:3])
    out = svc.drain(now=1.0)
    assert all(r.status == "failed" for r in out)
    assert all("replica" in r.error for r in out)
    assert _acct(svc)
    # the service survives: heal the replicas and serve again
    _heal_sessions(svc, saved)
    _submit_all(svc, Q[3:], t0=2.0)
    out2 = svc.drain(now=3.0)
    assert all(r.status == "done" for r in out2)
    assert _acct(svc)


def test_dispatch_error_carries_wall():
    err = ReplicaDispatchError("boom", wall_s=0.25)
    assert err.wall_s == 0.25


# ----------------------------------------------- ejection and re-admission --
@pytest.mark.parametrize("backend", BACKENDS)
def test_ejection_then_half_open_probe_readmits(backend):
    X, Q = _data(nq=24)
    pol = ReplicaPolicy(eject_after=2, probe_after=2, promote_after=2,
                        max_retries=1, hedge=False)
    svc = _tier(X, backend, mode="replicate", slots=2, replica_policy=pol)
    plan = faults.install(FaultPlan(dead_replica=1))
    try:
        _submit_all(svc, Q[:12])
        svc.drain(now=1.0)
    finally:
        faults.install(plan)
    rs = svc.replicas[1]
    # ejected; a probe window may already be open (probes fail while the
    # fault is live, bouncing half_open -> open -> half_open)
    assert rs.state in ("open", "half_open")
    assert any(t["to"] == "open" and "ejected" in t["reason"]
               for t in rs.breaker.transitions)
    # revived: probe window opens after probe_after quiet rounds, then
    # promote_after successful probes re-admit
    _submit_all(svc, Q[12:], t0=2.0)
    svc.drain(now=3.0)
    assert rs.state == "closed"
    reasons = [t["reason"] for t in rs.breaker.transitions]
    assert any("probe window" in r for r in reasons)
    assert any("re-admitted" in r for r in reasons)
    assert rs.probes >= pol.promote_after
    assert svc.health()["failures"] == 0 and _acct(svc)


# ------------------------------------------------------------------ hedging --
def _slow_timer(slow_idx, slow_s=0.2, fast_s=0.01):
    return lambda idx, wall: slow_s if idx == slow_idx else fast_s


@pytest.mark.parametrize("backend", BACKENDS)
def test_hedge_fires_and_wins_on_slow_replica(backend):
    X, Q = _data(nq=16)
    pol = ReplicaPolicy(hedge=True, hedge_factor=2.0, hedge_min_delay_s=0.02,
                        jitter=0.0)
    svc = _tier(X, backend, mode="replicate", slots=2, replica_policy=pol,
                timer=_slow_timer(0))
    _submit_all(svc, Q)
    done = _by_rid(svc.drain(now=1.0))
    h = svc.health()
    assert h["hedges"] >= 1
    assert h["hedge_wins"] >= 1
    hedged = [r for r in done if r.stats[EXTRA_HEDGED] == 1.0]
    assert hedged
    for r in hedged:
        assert r.stats[EXTRA_REPLICA] != 0.0    # a healthy replica won
        assert r.service_s < 0.2                # beat the straggler's wall
    assert _acct(svc)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hedged_dispatch_is_replay_exact(backend):
    """Injected clock (timer) + seeded jitter RNG => two runs produce
    identical routing, hedge decisions, and per-ticket timelines."""
    X, Q = _data(nq=16)

    def run():
        pol = ReplicaPolicy(hedge=True, hedge_factor=2.0,
                            hedge_min_delay_s=0.02, seed=5)
        svc = _tier(X, backend, mode="replicate", slots=2,
                    replica_policy=pol, timer=_slow_timer(1))
        _submit_all(svc, Q)
        done = _by_rid(svc.drain(now=1.0))
        h = svc.health()
        return ([(r.rid, r.t_done, r.service_s, r.stats[EXTRA_REPLICA],
                  r.stats[EXTRA_HEDGED]) for r in done],
                (h["hedges"], h["hedge_wins"], h["hedge_losses"],
                 h["retries"]))
    t1, c1 = run()
    t2, c2 = run()
    assert t1 == t2 and c1 == c2


def test_no_hedge_when_primary_is_fast():
    X, Q = _data(nq=8)
    svc = _tier(X, "host", mode="replicate", slots=2,
                replica_policy=ReplicaPolicy(hedge=True, hedge_factor=3.0),
                timer=lambda idx, wall: 0.01)
    _submit_all(svc, Q)
    svc.drain(now=1.0)
    assert svc.health()["hedges"] == 0


# ------------------------------------------- shard loss: spatial coverage ---
@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_loss_matches_surviving_union_oracle(backend):
    """Degraded answers equal brute force over the union of surviving
    shards, with coverage < 1 and certificates withdrawn."""
    X, Q = _data(n=903)                   # not divisible by 3: uneven shards
    svc = _tier(X, backend, mode="shard", replicas=3)
    dead = 1
    lo = svc.replicas[dead].id_offset
    hi = lo + svc.replicas[dead].rows
    surviving = np.concatenate([X[:lo], X[hi:]])
    surviving_ids = np.concatenate([np.arange(lo), np.arange(hi, X.shape[0])])
    with faults.inject(dead_replica=dead):
        _submit_all(svc, Q)
        done = _by_rid(svc.drain(now=1.0))
    assert len(done) == len(Q)
    ref = surviving_ids[_oracle(surviving, Q, 8)]
    got = np.stack([r.ids for r in done])
    assert np.array_equal(got, ref)
    want_cov = surviving.shape[0] / X.shape[0]
    for r in done:
        assert r.certified is False
        assert r.coverage == pytest.approx(want_cov)
        assert r.stats[EXTRA_DEGRADED] == 1.0
        assert r.stats[EXTRA_REPLICA] == -1.0
    h = svc.health()
    assert h["degraded"] == len(Q) and h["failures"] == 0
    assert _acct(svc)


@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_revival_restores_full_coverage(backend):
    X, Q = _data(nq=18)
    pol = ReplicaPolicy(eject_after=1, probe_after=1, promote_after=1,
                        max_retries=0)
    svc = _tier(X, backend, mode="shard", replicas=3, slots=3,
                replica_policy=pol)
    plan = faults.install(FaultPlan(dead_replica=2))
    try:
        _submit_all(svc, Q[:9])
        degraded = _by_rid(svc.drain(now=1.0))
    finally:
        faults.install(plan)
    assert all(r.coverage < 1.0 and not r.certified for r in degraded)
    _submit_all(svc, Q[9:], t0=2.0)
    healed = _by_rid(svc.drain(now=3.0))
    # probes re-admit the shard, after which answers are full-coverage again
    assert svc.replicas[2].state == "closed"
    assert any(r.coverage == 1.0 and r.certified for r in healed)
    ref = _single(X, backend).search(Q[9:], 8)
    full = [r for r in healed if r.coverage == 1.0]
    assert np.array_equal(np.stack([r.ids for r in full]),
                          ref.ids[-len(full):])
    assert _acct(svc)


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_shards_down_fails_batch(backend):
    X, Q = _data(nq=3)
    svc = _tier(X, backend, mode="shard", replicas=2, slots=3,
                replica_policy=ReplicaPolicy(max_retries=0, eject_after=1))
    _kill_sessions(svc)
    _submit_all(svc, Q)
    out = svc.drain(now=1.0)
    assert all(r.status == "failed" for r in out)
    assert _acct(svc)


# ------------------------------------------------------------------- writes --
@pytest.mark.parametrize("backend", BACKENDS)
def test_replicate_add_fans_out_and_serves_new_rows(backend):
    X, Q = _data()
    svc = _tier(X, backend, mode="replicate")
    Xn = X[:1] + 1e-3
    svc.add(Xn)
    assert all(rs.session.n == X.shape[0] + 1 for rs in svc.replicas)
    assert svc.health()["rows_inserted"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_add_appends_to_tail_shard_with_contiguous_ids(backend):
    X, Q = _data(n=900)
    svc = _tier(X, backend, mode="shard", replicas=3)
    rng = np.random.default_rng(0)
    Xn = rng.normal(size=(5, X.shape[1])).astype(np.float32)
    svc.add(Xn)
    last = max(svc.replicas, key=lambda rs: rs.id_offset)
    assert last.rows == 300 + 5
    Xall = np.concatenate([X, Xn])
    _submit_all(svc, Q)
    done = _by_rid(svc.drain(now=1.0))
    ref = _oracle(Xall, Q, 8)
    assert np.array_equal(np.stack([r.ids for r in done]), ref)
    assert all(r.n_visible == 905 for r in done)


# ------------------------------------------------------------- validation ---
def test_tier_rejects_bad_construction():
    X, _ = _data(n=64)
    with pytest.raises(ValueError, match="mode"):
        open_replicated(X, mode="nope")
    with pytest.raises(ValueError, match="replicas"):
        open_replicated(X, replicas=0)
    with pytest.raises(ValueError, match="non-empty"):
        open_replicated(X[:2], replicas=3, mode="shard", device="cpu")
    s1 = _single(X, "torch")
    s2 = _single(X[:, :12], "torch")
    with pytest.raises(ValueError, match="disagree on D"):
        ReplicatedService([s1, s2])
    with pytest.raises(ValueError, match="at least one"):
        ReplicatedService([])


@pytest.mark.parametrize("backend", BACKENDS)
def test_accounting_exact_under_churn(backend):
    """Kill, shed, timeout, revive — the invariant never drifts."""
    X, Q = _data(nq=30)
    svc = _tier(X, backend, mode="replicate", slots=2, max_queue=4,
                admission="shed_oldest", deadline_s=0.5,
                replica_policy=ReplicaPolicy(max_retries=1, eject_after=1))
    plan = faults.install(FaultPlan(dead_replica=0, fail_replica_after=4))
    try:
        t = 0.0
        for j, q in enumerate(Q):
            svc.submit(q, now=t)
            if j % 3 == 2:
                svc.step(now=t)
            t += 0.05
        svc.drain(now=t)
    finally:
        faults.install(plan)
    assert svc.pending == 0
    assert _acct(svc)


# ------------------------------------------------------- cross-package ----
def _chaos(svc, Q, faults_mod, plan_cls):
    """Healthy batches, replica 0 dead after its third dispatch, then
    revived; returns per-batch (replica, hedged, degraded, ids) and the
    tier's counters and transition logs."""
    batches = []

    def serve(lo, hi, t0):
        _submit_all(svc, Q[lo:hi], t0=t0)
        for r in _by_rid(svc.drain(now=t0 + 1.0)):
            batches.append((r.rid, r.stats[EXTRA_REPLICA],
                            r.stats[EXTRA_HEDGED], r.stats[EXTRA_DEGRADED],
                            r.coverage, r.certified, tuple(r.ids)))

    serve(0, 8, 0.0)
    prev = faults_mod.install(plan_cls(dead_replica=0, fail_replica_after=1))
    try:
        serve(8, 20, 2.0)
    finally:
        faults_mod.install(prev)
    serve(20, 32, 4.0)
    h = svc.health()
    return batches, {key: h[key] for key in (
        "retries", "hedges", "hedge_wins", "hedge_losses", "degraded",
        "failures", "completed")}, [
        [(t["batch"], t["from"], t["to"], t["reason"])
         for t in rs["transitions"]] for rs in h["replicas"]]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["replicate", "shard"])
def test_chaos_script_matches_reference(mode, backend):
    X, Q = _data(n=900, nq=32, seed=13)
    timer = _slow_timer(1, slow_s=0.2, fast_s=0.01)
    kw = dict(replicas=3, mode=mode, k=8, slots=2, timer=timer,
              rng=np.random.default_rng(21))
    pkw = dict(hedge=True, hedge_factor=2.0, hedge_min_delay_s=0.02,
               eject_after=2, probe_after=2, promote_after=2)
    ref = jax_open_replicated(
        X, backend="jax" if backend == "torch" else "host",
        replica_policy=JaxReplicaPolicy(**pkw), **kw)
    kw["rng"] = np.random.default_rng(21)
    port = open_replicated(X, backend=backend, device="cpu",
                           replica_policy=ReplicaPolicy(**pkw), **kw)
    rb, rc, rt = _chaos(ref, Q, jax_faults, JaxFaultPlan)
    pb, pc, pt = _chaos(port, Q, faults, FaultPlan)
    assert pc == rc and pt == rt
    assert [b[:6] for b in pb] == [b[:6] for b in rb]
    assert [b[6] for b in pb] == [b[6] for b in rb]
    if mode == "replicate":
        assert pc["hedges"] >= 1 and pc["retries"] >= 1
        assert any(t[2] == "closed" for t in pt[0])    # revived
    else:
        assert pc["degraded"] >= 1

"""The replica tier over mesh sessions against the reference's.

The reference serves ``ReplicatedService`` over sessions opened with
``open_index(..., backend="jax", mesh=make_host_mesh(2, 1))`` on 2 fake
CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``, in
one module-scoped subprocess).  The port serves the same tiers on two
gloo ranks (``launch.ranks.run_ranks``, one process a rank, every
process under a deadline): every rank builds the same sessions in the
same order and the same ``ReplicatedService``; rank 0 drives it with the
reference's explicit ``now`` stamps, timer, jitter seed and fault plans,
and rank 1 follows it (``SearchService.follow``).

Each case of ``CASES`` runs on both sides: replicate mode healthy
(round-robin over 2 replicas), a dead replica retried on the other, a
slow replica hedged (a win and a loss), a mid-run kill that is ejected,
probed and readmitted, a deadline batch (the mesh refuses it on every
replica), a tier mixing a mesh replica with a one-device one (each
first in turn: the channel opens for any mesh replica), and shard
mode over 3 shards (healthy, one shard dead, revived), then an add in
each mode.  Rank 0's tickets must equal the reference's: status, the
``replica``, ``hedged`` and ``degraded`` extras, certificate, coverage,
rows visible, error text and ids exactly, distances within rtol 1e-4;
and ``health()``'s tier counters and each replica's breaker log must be
the reference's.  The port alone is held to its followers: rank 1
searches once for each of rank 0's device dispatches, per replica and
hedges and shard fan-outs included, and never for a replica that the
fault plan refused; a fault armed on rank 1 alone fails that dispatch on
both ranks and the batch is served from the other replica, with no step
near the group's 60 s timeout; a world of one serves with no follower.

Run as a script (``python tests/test_torch_mesh_replica.py OUT``) this
file is one rank of the port's side: it imports torch and the port, never
jax nor the reference.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
K = 5
N0 = 900                    # rows at open; an add appends N_ADD more
N_ADD = 50
N_SHARDS = 3
SERVE = dict(slots=4, k=K)
#: a step that hit a failed rank must stay this far under the group's
#: timeout (60 s), which a rank waiting for a part that never came takes
STEP_LIMIT_S = 10.0
REFERENCE_TIMEOUT_S = 300
RANKS_TIMEOUT_S = 240
HEALTH = ("submitted", "completed", "failures", "steps", "retries",
          "hedges", "hedge_wins", "hedge_losses", "degraded",
          "rows_inserted")
REPLICA_HEALTH = ("state", "rows", "id_offset", "dispatches", "served",
                  "failures", "consecutive_failures", "probes",
                  "transitions")


def _data(d=32, nq=16, seed=5):
    """The corpus (N0 rows, then N_ADD to add, the first 4 of them each a
    step off a query, so the tickets after an add must find them) and
    the queries."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N0 + N_ADD, d)).astype(np.float32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    X[N0:N0 + 4] = Q[:4] + 0.1 * rng.normal(size=(4, d)).astype(np.float32)
    return X, Q


def _pol(cls, **kw):
    kw.setdefault("d1", 24)
    kw.setdefault("query_chunk", 4)
    kw.setdefault("row_block", 128)
    kw.setdefault("block_capacity", 128)
    return cls(**kw)


def _timer(idx, wall):
    """Every dispatch's wall, for replay-exact hedges on both sides."""
    return 0.01


def _batch(Q, b):
    return Q[4 * (b % 4):4 * (b % 4) + 4]


def _serve(svc, qs, t0, walls, **kw):
    """Submit ``qs`` at ``t0`` and step until the queue is empty, each
    step's real wall appended to ``walls``; returns the tickets."""
    reqs = [svc.submit(q, now=t0 + 1e-4 * j, **kw) for j, q in enumerate(qs)]
    t = t0 + 1.0
    while svc.pending:
        s = time.perf_counter()
        out = svc.step(now=t)
        walls.append(time.perf_counter() - s)
        t = max(r.t_done for r in out)
    return reqs


# each case: its sessions, the tier's mode, its ReplicaPolicy, its body
def _healthy(svc, X, Q, F, walls):
    return _serve(svc, Q[:12], 0.0, walls)


def _dead(svc, X, Q, F, walls):
    with F.inject(dead_replica=0):
        return _serve(svc, Q[:8], 0.0, walls)


def _hedged(slow_s):
    def body(svc, X, Q, F, walls):
        with F.inject(slow_replica=0, slow_replica_s=slow_s):
            return _serve(svc, Q, 0.0, walls)
    return body


def _kill(svc, X, Q, F, walls):
    """Replica 0 dies after 2 dispatches (8 batches), then is revived
    (6 more): ejected, probed and failed, then probed and readmitted."""
    reqs = []
    prev = F.install(F.FaultPlan(dead_replica=0, fail_replica_after=2))
    try:
        for b in range(8):
            reqs += _serve(svc, _batch(Q, b), 2.0 * b, walls)
    finally:
        F.install(prev)
    for b in range(8, 14):
        reqs += _serve(svc, _batch(Q, b), 2.0 * b, walls)
    return reqs


def _deadline(svc, X, Q, F, walls):
    return (_serve(svc, Q[:4], 0.0, walls, deadline_s=5.0)
            + _serve(svc, Q[4:8], 2.0, walls))


def _shard(svc, X, Q, F, walls):
    """Healthy, shard 1 dead for 2 batches, then revived for 5."""
    reqs = _serve(svc, Q[:4], 0.0, walls)
    with F.inject(dead_replica=1):
        reqs += _serve(svc, Q[4:8], 2.0, walls)
        reqs += _serve(svc, Q[8:12], 4.0, walls)
    for b in range(3, 8):
        reqs += _serve(svc, _batch(Q, b), 2.0 * b, walls)
    return reqs


def _add(svc, X, Q, F, walls):
    svc.add(X[N0:N0 + N_ADD])
    return _serve(svc, Q[:8], 0.0, walls)


NO_HEDGE = dict(hedge=False)
HEDGE = dict(hedge=True, hedge_factor=2.0, hedge_min_delay_s=0.005,
             jitter=0.0)
#: name -> (sessions, mode, ReplicaPolicy kwargs, body), in run order:
#: the adds come last, since they grow the sessions they write to
#: (the mixed tiers hold one mesh replica and one one-device replica,
#: the latter at ``ONE_DEVICE[sessions]``)
CASES = {
    "healthy": ("replicate", "replicate", NO_HEDGE, _healthy),
    "dead": ("replicate", "replicate", NO_HEDGE, _dead),
    "hedge_win": ("replicate", "replicate", HEDGE, _hedged(0.05)),
    "hedge_loss": ("replicate", "replicate", HEDGE, _hedged(0.015)),
    "kill": ("replicate", "replicate",
             dict(hedge=False, eject_after=2, probe_after=2,
                  promote_after=2), _kill),
    "deadline": ("replicate", "replicate", NO_HEDGE, _deadline),
    "mixed": ("mixed", "replicate", NO_HEDGE, _healthy),
    "mixed_one_device_first": ("mixed_rev", "replicate", NO_HEDGE,
                               _healthy),
    "shard": ("shard", "shard",
              dict(hedge=False, max_retries=1, eject_after=2,
                   probe_after=2, promote_after=1), _shard),
    "add_replicate": ("replicate", "replicate", NO_HEDGE, _add),
    "add_shard": ("shard", "shard", NO_HEDGE, _add),
}


ONE_DEVICE = {"mixed": 1, "mixed_rev": 0}


def _parts(X):
    """The shard row ranges of the first N0 rows (as open_replicated)."""
    b = np.linspace(0, N0, N_SHARDS + 1).astype(int)
    return [X[b[i]:b[i + 1]] for i in range(N_SHARDS)]


def _ticket(r) -> dict:
    return {"status": r.status, "rid": r.rid, "certified": r.certified,
            "coverage": r.coverage, "n_visible": r.n_visible,
            "error": r.error,
            "extras": {key: r.stats.get(key) for key in
                       ("replica", "hedged", "degraded")},
            "ids": None if r.ids is None else np.asarray(r.ids).tolist(),
            "dists": None if r.dists is None
            else np.asarray(r.dists, np.float64).tolist()}


def _health(svc) -> dict:
    h = svc.health()
    return {**{key: h[key] for key in HEALTH},
            "replicas": [{key: rs[key] for key in REPLICA_HEALTH}
                         for rs in h["replicas"]]}


#: the port's own case: replica 0's session fails its second search on
#: rank 1 alone (the healthy case's stream otherwise)
RANK1_FAULT = ("rank1_fault", "replicate", NO_HEDGE, _healthy)


def _tier(api, spec, sessions):
    """The ``spec``'s tier over ``sessions`` (``api`` holds either
    package's ``ReplicatedService``, ``ReplicaPolicy`` and ``faults``)."""
    _, mode, pol, _ = spec
    return api.ReplicatedService(
        sessions, mode=mode, replica_policy=api.ReplicaPolicy(**pol),
        timer=_timer, **SERVE)


def _play(api, spec, svc, X, Q) -> dict:
    """Serve the ``spec``'s body on ``svc``: its tickets, its health and
    each step's real wall."""
    walls = []
    reqs = spec[3](svc, X, Q, api.faults, walls)
    return {"tickets": [_ticket(r) for r in reqs], "health": _health(svc),
            "walls": walls}


# ------------------------------------------------------------ reference ---
REFERENCE = r'''
import importlib.util, json, os, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[2])
from repro.api import SchedulePolicy, open_index
from repro.launch.mesh import make_host_mesh
from repro.serving import ReplicaPolicy, ReplicatedService
from repro.testing import faults
spec = importlib.util.spec_from_file_location("cases", sys.argv[3])
T = importlib.util.module_from_spec(spec)
spec.loader.exec_module(T)

api = types.SimpleNamespace(ReplicatedService=ReplicatedService,
                            ReplicaPolicy=ReplicaPolicy, faults=faults)
mesh = make_host_mesh(2, 1)
X, Q = T._data()

def sess(rows, mesh=mesh):
    return open_index(rows, method="PDScanning+", backend="jax", mesh=mesh,
                      schedule=T._pol(SchedulePolicy))

rep = [sess(X[:T.N0]) for _ in range(2)]
one = sess(X[:T.N0], mesh=None)
sessions = {"replicate": rep, "shard": [sess(p) for p in T._parts(X)],
            "mixed": [rep[0], one], "mixed_rev": [one, rep[0]]}
out = {case: T._play(api, spec, T._tier(api, spec, sessions[spec[0]]), X, Q)
       for case, spec in T.CASES.items()}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference tier's record of every case."""
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                        str(ROOT / "src"), __file__], capture_output=True,
                       text=True, env=env, cwd=ROOT,
                       timeout=REFERENCE_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


# ----------------------------------------------------------------- port ---
def _count_searches(svc) -> list:
    """Count each replica's session.search calls on this rank (the
    dispatches that reached the device), and those that raised."""
    counts = [{"searches": 0, "failures": 0} for _ in svc.replicas]
    for rs in svc.replicas:
        def search(*a, _c=counts[rs.idx], _f=rs.session.search, **kw):
            _c["searches"] += 1
            try:
                return _f(*a, **kw)
            except Exception:
                _c["failures"] += 1
                raise
        rs.session.search = search
    return counts


def _rank_main(outdir: str) -> None:
    """One rank of the port's side: every case in one gloo group of 2,
    then (rank 0) a tier on a world of one."""
    sys.path.insert(0, str(ROOT / "src"))
    import types

    import torch.distributed as dist
    from repro_torch.api import SchedulePolicy, open_index
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import join
    from repro_torch.serving import ReplicaPolicy, ReplicatedService
    from repro_torch.testing import FaultPlan, faults

    api = types.SimpleNamespace(ReplicatedService=ReplicatedService,
                                ReplicaPolicy=ReplicaPolicy, faults=faults)
    rank, world = join("gloo")
    mesh = make_host_mesh(world, 1, device_type="cpu")
    X, Q = _data()

    def sess(rows, mesh=mesh, **pol):
        return open_index(rows, method="PDScanning+", mesh=mesh,
                          device="cpu", schedule=_pol(SchedulePolicy, **pol))

    rep = [sess(X[:N0]) for _ in range(2)]
    one = sess(X[:N0], mesh=None)
    sessions = {"replicate": rep, "shard": [sess(p) for p in _parts(X)],
                "mixed": [rep[0], one], "mixed_rev": [one, rep[0]]}
    # the fault armed on rank 1 alone: replica 0's second search there
    sessions["rank1_fault"] = [
        sess(X[:N0], **({"faults": FaultPlan(fail_search_after=1)}
                        if rank == 1 else {})), rep[1]]
    out = {}
    cases = dict(CASES)
    order = list(cases)
    order.insert(order.index("add_replicate"), "rank1_fault")
    cases["rank1_fault"] = RANK1_FAULT
    for case in order:
        spec = cases[case]
        svc = _tier(api, spec, sessions[spec[0]])
        if rank == 0:
            counts = _count_searches(svc)
            out[case] = _play(api, spec, svc, X, Q)
            out[case]["searches"] = counts
            t0 = time.perf_counter()
            svc.close()
            out[case]["close_s"] = time.perf_counter() - t0
            for s in sessions[spec[0]]:
                s.__dict__.pop("search")        # the counters go
            continue
        if case == "healthy":
            out["refusals"] = {}
            for op in ("submit", "step", "drain", "add", "health"):
                try:
                    (svc.submit(Q[0]) if op == "submit"
                     else svc.add(X[:2]) if op == "add"
                     else getattr(svc, op)())
                    out["refusals"][op] = ""
                except RuntimeError as exc:
                    out["refusals"][op] = str(exc)
        out[case] = svc.follow()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        # a world of one: the group of one make_host_mesh(1, 1) makes; the
        # tier opens no channel and has no follower
        solo = make_host_mesh(1, 1, device_type="cpu")
        svc = ReplicatedService([sess(X[:N0], mesh=solo) for _ in range(2)],
                                replica_policy=ReplicaPolicy(**NO_HEDGE),
                                **SERVE)
        reqs = _serve(svc, Q[:12], 0.0, [])
        out["one"] = {"ids": [r.ids.tolist() for r in reqs],
                      "statuses": [r.status for r in reqs],
                      "channel": svc._channel is not None,
                      "replicas": [r.stats["replica"] for r in reqs]}
        svc.close()
        dist.destroy_process_group()
    out["foreign"] = sorted(m for m in sys.modules if m == "jax" or
                            m.startswith(("jax.", "repro.")))
    with open(Path(outdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's record, from one gloo group of two."""
    from repro_torch.launch.ranks import run_ranks

    outdir = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    run_ranks([sys.executable, __file__, str(outdir)], 2, workdir=outdir,
              timeout_s=RANKS_TIMEOUT_S, env=env, cwd=ROOT)
    return [json.loads((outdir / f"rank{r}.json").read_text())
            for r in range(2)]


# ---------------------------------------------------------------- tests ---
@pytest.mark.parametrize("case", CASES)
def test_tickets_match_reference(case, reference, ranks):
    """Rank 0's tickets against the reference's, request by request:
    status, extras, certificate, coverage, rows visible and error text
    exactly, ids exactly, distances within rtol 1e-4."""
    got, want = ranks[0][case]["tickets"], reference[case]["tickets"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("status", "rid", "certified", "coverage", "n_visible",
                  "error", "extras"):
            assert a[f] == b[f], (case, a["rid"], f, a[f], b[f])
        if b["ids"] is None:
            assert a["ids"] is None and a["dists"] is None
            continue
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_allclose(a["dists"], b["dists"], rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_health_matches_reference(case, reference, ranks):
    """The tier's counters (retries, hedges, wins and losses, degraded,
    completions, failures) and each replica's breaker state, counters and
    transition log."""
    assert ranks[0][case]["health"] == reference[case]["health"]


@pytest.mark.parametrize("case", [*CASES, "rank1_fault"])
def test_follower_searches_once_per_device_dispatch(case, ranks):
    """Rank 1 made one search on replica i for each search rank 0 made
    on it (hedges, retries and shard fan-outs included; none for a
    one-device replica), failed the same ones, and made each add."""
    got, mine = ranks[1][case], ranks[0][case]
    adds = int(case.startswith("add_"))
    sessions = CASES.get(case, RANK1_FAULT)[0]
    for i, (f, c) in enumerate(zip(got["replicas"], mine["searches"])):
        on_mesh = ONE_DEVICE.get(sessions) != i
        want = c["searches"] if on_mesh else 0
        assert f["searches"] == want, (case, i, f, c)
        assert f["failures"] == (c["failures"] if on_mesh else 0)
    assert got["searches"] == sum(f["searches"] for f in got["replicas"])
    tail = len(got["replicas"]) - 1
    assert [f["adds"] for f in got["replicas"]] == [
        adds if case == "add_replicate" or i == tail and adds else 0
        for i in range(len(got["replicas"]))]
    assert mine["close_s"] < STEP_LIMIT_S


def test_refused_replica_costs_no_follower_search(ranks):
    """A replica the fault plan kills fails before the broadcast: rank 0
    dispatched to replica 0 but searched nothing there, nor did rank 1."""
    h = ranks[0]["dead"]["health"]["replicas"][0]
    assert h["dispatches"] == 2 and h["failures"] == 2
    assert ranks[0]["dead"]["searches"][0]["searches"] == 0
    assert ranks[1]["dead"]["replicas"][0]["searches"] == 0
    kill = ranks[0]["kill"]
    dispatched = kill["health"]["replicas"][0]["dispatches"]
    assert ranks[1]["kill"]["replicas"][0]["searches"] \
        == kill["searches"][0]["searches"] < dispatched


def test_cases_exercise_their_paths(ranks):
    """Each case did what it is for (so the comparisons above bite)."""
    r = {case: ranks[0][case] for case in CASES}
    ex = {case: [t["extras"]["replica"] for t in rec["tickets"][::4]]
          for case, rec in r.items()}
    assert ex["healthy"] == [0.0, 1.0, 0.0]
    assert ex["mixed"] == ex["mixed_one_device_first"] == [0.0, 1.0, 0.0]
    assert ex["dead"] == [1.0, 1.0]
    assert r["hedge_win"]["health"]["hedge_wins"] >= 1
    assert r["hedge_loss"]["health"]["hedge_losses"] >= 1
    kill = [t["to"] for t in r["kill"]["health"]["replicas"][0]
            ["transitions"]]
    assert kill[0] == "open" and kill[-1] == "closed"
    assert {t["status"] for t in r["deadline"]["tickets"][:4]} == {"failed"}
    assert r["deadline"]["tickets"][0]["error"].startswith(
        "ReplicaDispatchError: all replica dispatch attempts failed")
    assert "ValueError: anytime deadlines are single-device" \
        in r["deadline"]["tickets"][0]["error"]
    shard = r["shard"]["tickets"]
    assert r["shard"]["health"]["degraded"] == 8
    assert [t["certified"] for t in shard[4:12]] == [False] * 8
    assert shard[4]["coverage"] == pytest.approx(2 / 3)
    assert shard[-1]["certified"] and shard[-1]["coverage"] == 1.0
    for case in ("add_replicate", "add_shard"):
        t = r[case]["tickets"]
        assert [x["ids"][0] for x in t[:4]] == [N0 + j for j in range(4)]
        assert t[0]["n_visible"] == N0 + N_ADD


def test_shard_ids_rebase_to_global_rows(reference, ranks):
    """Healthy shard batches give the ids of one session over all rows:
    each shard's local ids are re-based by its mesh session's global row
    count."""
    full = reference["healthy"]["tickets"][:4]
    got = ranks[0]["shard"]["tickets"][:4]
    assert [t["ids"] for t in got] == [t["ids"] for t in full]


def test_fault_on_rank1_alone_is_retried_on_another_replica(reference,
                                                            ranks):
    """``fail_search_after`` armed on rank 1 for replica 0's session
    fails that replica's second dispatch on both ranks; rank 0 counts it
    against replica 0, retries on replica 1 and serves the reference's
    ids, with no step near the group's timeout."""
    rec, want = ranks[0]["rank1_fault"], reference["healthy"]["tickets"]
    assert [t["status"] for t in rec["tickets"]] == ["done"] * 12
    for a, b in zip(rec["tickets"], want):
        assert a["ids"] == b["ids"]
    assert [t["extras"]["replica"] for t in rec["tickets"][::4]] \
        == [0.0, 1.0, 1.0]
    h = rec["health"]
    assert h["retries"] == 1 and h["failures"] == 0
    assert h["replicas"][0]["failures"] == 1
    assert rec["searches"][0] == {"searches": 2, "failures": 1}
    assert ranks[1]["rank1_fault"]["replicas"][0] == {
        "searches": 2, "adds": 0, "failures": 1}
    assert max(rec["walls"]) < STEP_LIMIT_S


@pytest.mark.parametrize("op", ["submit", "step", "drain", "add", "health"])
def test_follower_refuses_to_drive(op, ranks):
    got = ranks[1]["refusals"][op]
    assert got.startswith(f"{op}() on rank 1") and "rank 0" in got


def test_world_of_one_tier_has_no_follower(reference, ranks):
    """A tier over mesh sessions of one rank opens no channel and serves
    the reference's ids, round-robin."""
    one = ranks[0]["one"]
    assert not one["channel"] and one["statuses"] == ["done"] * 12
    assert one["ids"] == [t["ids"] for t in reference["healthy"]["tickets"]]
    assert one["replicas"][::4] == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_load_neither_jax_nor_the_reference(rank, ranks):
    assert ranks[rank]["foreign"] == []


if __name__ == "__main__":
    _rank_main(sys.argv[1])

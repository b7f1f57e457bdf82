"""The serving front over a mesh session against the reference's.

The reference serves ``open_index(X, method="PDScanning+", backend="jax",
mesh=make_host_mesh(2, 1))`` through its ``SearchService`` on 2 fake CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``, in one
module-scoped subprocess).  The port serves the same session on two gloo
ranks (``launch.ranks.run_ranks``, one process a rank, every process
under a deadline): rank 0 drives its ``SearchService`` with the same
explicit request stream (``now`` stamps, a burst past the bounded queue,
adds between steps, a queued expiry, a deadline batch and the fourth
search failing under a fault plan), and rank 1 follows it
(``SearchService.follow``).  The stream runs three times, with the plan
armed on both ranks, on rank 0 alone and on rank 1 alone; each time rank
0's tickets must equal the reference's.  A loaded mesh session served
through ``open_index(path=, mesh=, serving=True)``, a step that only
expires queued requests, a follower's refusals and a world of one are
checked on the same ranks.

Run as a script (``python tests/test_torch_mesh_service.py OUT``) this
file is one rank of the port's side: it imports torch and the port, never
jax nor the reference.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
K = 5
N0 = 1000                   # rows at open; the stream adds 2 x 50
SERVE = dict(slots=4, k=K, max_queue=6, admission="shed_oldest")
#: where the stream's fault plan is armed on the port's side
FAULT_RANKS = ("both", "rank0", "rank1")
COUNTERS = ("submitted", "completed", "shed", "timeouts", "failures",
            "partials", "uncertified", "steps", "rows_inserted")
FOLLOWER_OPS = ("submit", "step", "drain", "add")
#: a subprocess that has not finished by then is killed and the test fails
REFERENCE_TIMEOUT_S = 300
RANKS_TIMEOUT_S = 240
#: a step's wall must stay this far under the group's timeout (60 s): a
#: rank waiting for a part that never comes would take all of it
STEP_LIMIT_S = 10.0


def _data(n=1100, d=32, nq=12, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(nq, d)).astype(np.float32))


def _pol(cls, **kw):
    kw.setdefault("d1", 24)
    kw.setdefault("query_chunk", 4)
    kw.setdefault("row_block", 256)
    kw.setdefault("block_capacity", 256)
    return cls(**kw)


def _stream(svc, X, Q, fault):
    """One explicit request stream: a burst past the bounded queue, adds
    between steps, a queued request that expires, and the fourth search
    failing (``fault`` arms the plan).  Returns every ticket in
    submission order."""
    reqs = []

    def sub(i, t, **kw):
        reqs.append(svc.submit(Q[i], now=t, **kw))

    with fault:
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


def _ticket(r) -> dict:
    return {"status": r.status, "rid": r.rid, "t_submit": r.t_submit,
            "t_deadline": r.t_deadline, "certified": r.certified,
            "coverage": r.coverage, "n_visible": r.n_visible,
            "batch_size": r.batch_size, "error": r.error,
            "service_s": r.service_s,
            "ids": None if r.ids is None else np.asarray(r.ids).tolist(),
            "dists": None if r.dists is None
            else np.asarray(r.dists, np.float64).tolist()}


def _served(svc, reqs) -> dict:
    """What rank 0 (or the reference) records of a served stream."""
    return {"tickets": [_ticket(r) for r in reqs], "health": svc.health(),
            "write_modes": svc.write_modes}


def _refuse(fn) -> list:
    """[exception type name, message] of what ``fn()`` raises."""
    try:
        fn()
    except Exception as exc:        # noqa: BLE001 - recorded, not hidden
        return [type(exc).__name__, str(exc)]
    return ["", ""]


# ------------------------------------------------------------ reference ---
REFERENCE = r'''
import importlib.util, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[2])
from repro.api import SchedulePolicy, open_index
from repro.launch.mesh import make_host_mesh
from repro.testing import faults
spec = importlib.util.spec_from_file_location("cases", sys.argv[3])
T = importlib.util.module_from_spec(spec)
spec.loader.exec_module(T)

X, Q = T._data()
svc = open_index(X[:T.N0], method="PDScanning+", backend="jax",
                 mesh=make_host_mesh(2, 1),
                 schedule=T._pol(SchedulePolicy)).serve(**T.SERVE)
reqs = T._stream(svc, X, Q, faults.inject(fail_search_after=3))
with open(sys.argv[1], "w") as f:
    json.dump(T._served(svc, reqs), f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference service's tickets, counters and write modes."""
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                        str(ROOT / "src"), __file__], capture_output=True,
                       text=True, env=env, cwd=ROOT,
                       timeout=REFERENCE_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


# ----------------------------------------------------------------- port ---
def _rank_main(outdir: str) -> None:
    """One rank of the port's side: every case, in one gloo group of 2,
    then (rank 0) a world of one."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.api import SchedulePolicy, open_index
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import join
    from repro_torch.testing import faults

    rank, world = join("gloo")
    mesh = make_host_mesh(world, 1, device_type="cpu")
    X, Q = _data()
    out = {}

    for case in FAULT_RANKS:
        svc = open_index(X[:N0], method="PDScanning+", mesh=mesh,
                         device="cpu", schedule=_pol(SchedulePolicy),
                         serving=True, serving_params=SERVE)
        armed = case in ("both", f"rank{rank}")
        fault = (faults.inject(fail_search_after=3) if armed
                 else contextlib.nullcontext())
        if rank == 0:
            out[case] = _served(svc, _stream(svc, X, Q, fault))
            svc.close()
        else:
            if case == "both":
                out["refusals"] = {op: _refuse(lambda op=op: (
                    svc.add(X[:2]) if op == "add"
                    else getattr(svc, op)(Q[0]) if op == "submit"
                    else getattr(svc, op)())) for op in FOLLOWER_OPS}
            with fault:
                out[case] = svc.follow()
    # a loaded session: snapshot, one WAL add, then served from the path
    snap = str(Path(outdir) / "mesh.snap")
    sess = open_index(X[:N0], method="PDScanning+", mesh=mesh, device="cpu",
                      schedule=_pol(SchedulePolicy), path=snap)
    sess.add(X[N0:N0 + 50])                     # logged by rank 0
    live = sess.search(Q[:8], K).ids
    svc = open_index(path=snap, mesh=mesh, device="cpu", serving=True,
                     serving_params={"slots": 4, "k": K})
    if rank == 0:
        first = svc.submit(Q[8], now=0.0, deadline_s=0.1)
        expired = svc.step(now=1.0)             # expires it, no search
        steps_after_expiry = svc.steps
        reqs = [svc.submit(q, now=2.0) for q in Q[:8]]
        svc.drain(now=2.0)
        out["loaded"] = {
            "live_ids": live.tolist(), "first": first.status,
            "expired": [r.rid for r in expired],
            "steps_after_expiry": steps_after_expiry,
            "ids": [r.ids.tolist() for r in reqs],
            "statuses": [r.status for r in reqs],
            "health": svc.health()}
        svc.close()
    else:
        out["loaded"] = svc.follow()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        # a world of one: the group of one make_host_mesh(1, 1) makes,
        # no follower and no broadcast
        one = make_host_mesh(1, 1, device_type="cpu")
        sess = open_index(X[:N0], method="PDScanning+", mesh=one,
                          device="cpu", schedule=_pol(SchedulePolicy))
        svc = sess.serve(slots=4, k=K)
        reqs = [svc.submit(q) for q in Q[:8]]
        svc.drain()
        flat = open_index(X[:N0], method="PDScanning+", device="cpu",
                          schedule=_pol(SchedulePolicy)).search(Q[:8], K)
        out["one"] = {"ids": [r.ids.tolist() for r in reqs],
                      "flat_ids": flat.ids.tolist(),
                      "statuses": [r.status for r in reqs],
                      "follow": _refuse(svc.follow)}
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
@pytest.mark.parametrize("case", FAULT_RANKS)
def test_stream_tickets_match_reference(case, reference, ranks):
    """Rank 0's tickets against the reference's, request by request:
    status, rid, stamps, certificate, coverage, rows visible, batch size
    and whether an error is set."""
    got, want = ranks[0][case]["tickets"], reference["tickets"]
    assert [t["status"] for t in got] == [t["status"] for t in want]
    assert {t["status"] for t in got} == {"done", "shed", "timeout",
                                          "failed"}
    for a, b in zip(got, want):
        for f in ("rid", "t_submit", "t_deadline", "certified", "coverage",
                  "n_visible", "batch_size"):
            assert a[f] == b[f], (case, a["rid"], f, a[f], b[f])
        assert (a["error"] is None) == (b["error"] is None)


@pytest.mark.parametrize("case", FAULT_RANKS)
def test_stream_results_match_reference(case, reference, ranks):
    """Every served ticket's ids exactly, its distances within rtol 1e-4."""
    for a, b in zip(ranks[0][case]["tickets"], reference["tickets"]):
        if b["ids"] is None:
            assert a["ids"] is None and a["dists"] is None
            continue
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_allclose(a["dists"], b["dists"], rtol=1e-4)


@pytest.mark.parametrize("case", FAULT_RANKS)
def test_stream_counters_match_reference(case, reference, ranks):
    """health()'s counters (not its walls) and the write modes: the mesh's
    adds rebuild, as the reference's do."""
    hp, hr = ranks[0][case]["health"], reference["health"]
    assert {c: hp[c] for c in COUNTERS} == {c: hr[c] for c in COUNTERS}
    assert ranks[0][case]["write_modes"] == reference["write_modes"] \
        == {"rebuild": 2}
    assert hp["submitted"] == (hp["completed"] + hp["shed"] + hp["timeouts"]
                               + hp["failures"] + hp["queue_depth"])


@pytest.mark.parametrize("case", FAULT_RANKS)
def test_deadline_batch_fails_with_reference_message(case, reference,
                                                     ranks):
    """The batch with a budget fails on the mesh with the reference's
    ValueError text: rank 0 raised it before any collective, and so did
    rank 1 on the broadcast budget."""
    got = [t for t in ranks[0][case]["tickets"] if t["rid"] in (8, 9)]
    want = [t for t in reference["tickets"] if t["rid"] in (8, 9)]
    assert [t["status"] for t in want] == ["failed", "failed"]
    assert [t["error"] for t in got] == [t["error"] for t in want]
    assert want[0]["error"].startswith("ValueError: anytime deadlines are "
                                       "single-device")


@pytest.mark.parametrize("case", FAULT_RANKS)
def test_follower_searched_once_per_step(case, ranks):
    """Rank 1 made one search for each of rank 0's device steps (none for
    the request that timed out in the queue), both adds, and failed the
    same three steps that rank 0 failed: the two with a budget and the
    fourth search."""
    follow, health = ranks[1][case], ranks[0][case]["health"]
    assert follow == {"searches": health["steps"], "adds": 2, "failures": 3}
    assert health["steps"] == 5 and health["timeouts"] == 1


@pytest.mark.parametrize("case", ["rank0", "rank1"])
def test_fault_on_one_rank_fails_that_batch_only(case, reference, ranks):
    """A fault plan armed in one rank's process fails the fourth search's
    batch on every rank, with the failing rank's error text on rank 0,
    and no other batch; no step waits for the group's timeout."""
    got = ranks[0][case]["tickets"]
    fault = [t for t in reference["tickets"]
             if t["error"] and t["error"].startswith("FaultError")]
    assert len(fault) == 4
    rids = {t["rid"] for t in fault}
    for t in got:
        if t["rid"] in rids:
            assert t["status"] == "failed"
            assert fault[0]["error"] in t["error"]
            if case == "rank1":
                assert t["error"].startswith("MeshSearchError: the mesh "
                                             "search failed on rank 1: ")
        elif t["error"] is not None:
            assert t["error"].startswith("ValueError")
    walls = [t["service_s"] for t in got if t["service_s"] is not None]
    assert walls and max(walls) < STEP_LIMIT_S


def test_loaded_mesh_session_serves_live_ids(ranks):
    """``open_index(path=, mesh=, serving=True)`` after a save and a WAL
    add: the WAL replays on both ranks, and the service's tickets carry
    the live session's ids; health() reports the WAL's bytes."""
    rec = ranks[0]["loaded"]
    assert rec["statuses"] == ["done"] * 8
    np.testing.assert_array_equal(rec["ids"], rec["live_ids"])
    assert rec["health"]["wal_bytes"] > 0
    assert rec["health"]["rows_inserted"] == 0


def test_queue_expiry_makes_no_search(ranks):
    """A step that finds only an expired request resolves it ``timeout``
    and searches on no rank."""
    rec = ranks[0]["loaded"]
    assert rec["first"] == "timeout" and rec["expired"] == [0]
    assert rec["steps_after_expiry"] == 0
    assert ranks[1]["loaded"] == {"searches": rec["health"]["steps"],
                                  "adds": 0, "failures": 0}
    assert rec["health"]["steps"] == 2


@pytest.mark.parametrize("op", FOLLOWER_OPS)
def test_follower_refuses_to_drive(op, ranks):
    """On a follower, ``submit``, ``step``, ``drain`` and ``add`` raise
    ``RuntimeError`` naming rank 0."""
    got = ranks[1]["refusals"][op]
    assert got[0] == "RuntimeError" and "rank 0" in got[1], got
    assert got[1].startswith(f"{op}() on rank 1")


def test_world_of_one_serves_without_follower(ranks):
    """A mesh of one rank serves with no follower and no broadcast: its
    tickets carry the one-device session's ids, and follow() refuses."""
    one = ranks[0]["one"]
    assert one["statuses"] == ["done"] * 8
    np.testing.assert_array_equal(one["ids"], one["flat_ids"])
    assert one["follow"][0] == "RuntimeError"


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_load_neither_jax_nor_the_reference(rank, ranks):
    assert ranks[rank]["foreign"] == []


if __name__ == "__main__":
    _rank_main(sys.argv[1])

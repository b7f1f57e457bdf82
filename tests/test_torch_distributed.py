"""The sharded global top-k against the reference's mesh.

``launch.mesh``, ``core.torch_engine.make_distributed_topk`` and the torch
backend's mesh path, run as gloo ranks on the CPU (one process a rank, a
file rendezvous under ``tmp_path``), against the reference's
``make_distributed_topk`` and its jax backend on 2 or 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in a subprocess,
as ``tests/test_search.py`` runs it).

To keep the file's wall short the reference runs once, in one
module-scoped subprocess that writes every case's outputs to one npz, and
the port's ranks start once per world size and run every case of that
world in one group, each rank writing its own npz; the assertions are
made here, one parametrized case at a time.  Every process started here
runs under a deadline and is killed past it.

Run as a script (``python tests/test_torch_distributed.py OUT WORLD``)
this file is one rank of the port's side: it imports torch and the port,
never jax nor the reference.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
K = 10
D1 = 48
#: a subprocess that has not finished by then is killed and the test fails
REFERENCE_TIMEOUT_S = 420
RANKS_TIMEOUT_S = 300
ENGINE_CASES = [(m, e) for m in ((2, 1), (2, 2)) for e in ("stream", "two_stage")]
#: case -> (method, engine, queries): the facade on a 2-rank mesh
FACADE_CASES = {
    "PDScanning+": ("PDScanning+", "stream", 8),
    "DDCres": ("DDCres", "stream", 8),
    "DADE": ("DADE", "stream", 8),
    "DDCopq": ("DDCopq", "stream", 8),      # the lower-bound fallback
    "ragged": ("PDScanning+", "stream", 13),
    "two_stage": ("PDScanning+", "two_stage", 8),
}
ADD_ROWS = (8, 40)          # 32 rows near Q[8:40]: 4,032 rows, 2 x 2,016
REFUSALS = ("ivf", "adaptive", "guardrails", "deadline", "host")


def _facade_policy(SchedulePolicy, engine="stream", **kw):
    return SchedulePolicy(d1=D1, capacity=512, query_chunk=8, engine=engine,
                          **kw)


def _added_rows(Q) -> np.ndarray:
    """The rows the add cases append: each a seeded offset (squared norm
    about 1) from one of the queries Q[8:40], so each is close to its
    query but not on it (a zero distance has no relative tolerance)."""
    lo, hi = ADD_ROWS
    off = np.random.default_rng(7).standard_normal((hi - lo, Q.shape[1]))
    return (Q[lo:hi] + off / np.sqrt(Q.shape[1])).astype(np.float32)


def _stats(res) -> dict:
    ex = res.stats.extra
    return {"ids": res.ids, "dists": res.dists,
            "n_dco": np.int64(res.stats.n_dco),
            "dims_scanned": np.float64(res.stats.dims_scanned),
            "survivors_mean": np.float64(ex["survivors_mean"]),
            "uncertified": np.float64(ex.get("uncertified_queries", 0.0)),
            "mask": np.asarray(ex.get("uncertified_mask",
                                      np.zeros(len(res.ids), bool)))}


def _put(out: dict, case: str, d: dict) -> None:
    out.update({f"{case}/{key}": np.asarray(v) for key, v in d.items()})


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
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[2])
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.vecdata import load_dataset
from repro.core.methods import make_method
from repro.core.jax_engine import DcoEngineConfig, make_distributed_topk
from repro.launch.mesh import make_host_mesh
from repro.api import open_index, SchedulePolicy
spec = importlib.util.spec_from_file_location("cases", sys.argv[3])
T = importlib.util.module_from_spec(spec)
spec.loader.exec_module(T)

out, errors = {}, {}
ds = load_dataset("sift", scale=0.04)
m = make_method("PDScanning+").fit(ds.X)
cfg = DcoEngineConfig(kind="lb", d1=T.D1, k=T.K, capacity=512, query_chunk=8)
W = jnp.asarray(m.state["pca"]["W"])
Q = jnp.asarray(ds.Q[:8]) @ W
xr = np.asarray(m.state["Xrot"], np.float32)
out["engine/xr"], out["engine/q"] = xr, np.asarray(Q)
for shape, engine in T.ENGINE_CASES:
    mesh = make_host_mesh(*shape)
    sh = NamedSharding(mesh, P(("data", "model")))
    a = [jax.device_put(v, sh) for v in (
        xr[:, :T.D1], xr[:, T.D1:], (xr[:, :T.D1] ** 2).sum(1),
        (xr[:, T.D1:] ** 2).sum(1))]
    fn = make_distributed_topk(mesh, cfg, engine=engine)
    d, i, s, dm = jax.device_get(fn(*a, Q[:, :T.D1], Q[:, T.D1:], {}))
    T._put(out, f"engine/{shape[0]}x{shape[1]}/{engine}",
           {"d": d, "i": i, "s": s, "dm": dm})
mesh = make_host_mesh(2, 1)
for case, (name, engine, nq) in T.FACADE_CASES.items():
    sess = open_index(ds.X, method=name, backend="jax", mesh=mesh,
                      schedule=T._facade_policy(SchedulePolicy, engine))
    T._put(out, f"facade/{case}", T._stats(sess.search(ds.Q[:nq], T.K)))
sess = open_index(ds.X, method="PDScanning+", backend="jax", mesh=mesh,
                  schedule=T._facade_policy(SchedulePolicy))
sess.search(ds.Q[:8], T.K)
sess.add(T._added_rows(ds.Q))
errors["add_mode"] = sess.last_write_mode
T._put(out, "facade/add", T._stats(sess.search(ds.Q[:16], T.K)))
errors.update(
    ivf=T._refuse(lambda: open_index(ds.X, index="ivf", method="PDScanning+",
                                     backend="jax", mesh=mesh)),
    adaptive=T._refuse(lambda: open_index(
        ds.X, method="PDScanning+", backend="jax", mesh=mesh,
        schedule=T._facade_policy(SchedulePolicy, adaptive=True))),
    guardrails=T._refuse(lambda: open_index(
        ds.X, method="PDScanning+", backend="jax", mesh=mesh,
        schedule=T._facade_policy(SchedulePolicy, guardrails=True))),
    deadline=T._refuse(lambda: sess.search(ds.Q[:8], T.K, deadline_s=1.0)),
    host=T._refuse(lambda: open_index(ds.X, method="PDScanning+",
                                      backend="host", mesh=mesh)))
out["errors"] = np.asarray(json.dumps(errors))
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference output of this file, from one subprocess."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                        str(ROOT / "src"), __file__], capture_output=True,
                       text=True,
                       env=env, cwd=ROOT, timeout=REFERENCE_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        out = dict(z)
    out["errors"] = json.loads(str(out["errors"]))
    return out


# ----------------------------------------------------------------- port ---
def _rank_main(outdir: str, world: int) -> None:
    """One rank of the port's side: every case of this world size."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.api import SchedulePolicy, SearchSession, open_index
    from repro_torch.core.torch_engine import (DcoEngineConfig,
                                               build_device_state,
                                               make_distributed_topk)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import join
    from repro_torch.vecdata import load_dataset

    rank, world = join("gloo")
    out, errors = {}, {}
    with np.load(Path(outdir) / "inputs.npz") as z:
        xr, q = z["xr"], torch.from_numpy(z["q"])
    cfg = DcoEngineConfig(kind="lb", d1=D1, k=K, capacity=512, query_chunk=8)
    shape = (2, 1) if world == 2 else (2, 2)
    mesh = make_host_mesh(*shape, device_type="cpu")
    per = xr.shape[0] // world
    state = build_device_state({"Xrot": xr[rank * per:(rank + 1) * per]},
                               D1, "cpu")
    for engine in ("stream", "two_stage"):
        fn = make_distributed_topk(mesh, cfg, engine=engine)
        d, i, s, dm = fn(state, q[:, :D1], q[:, D1:], {})
        _put(out, f"engine/{shape[0]}x{shape[1]}/{engine}",
             {"d": d.numpy(), "i": i.numpy(), "s": s.numpy(),
              "dm": dm.numpy()})
    if world == 2:
        ds = load_dataset("sift", scale=0.04)
        for case, (name, engine, nq) in FACADE_CASES.items():
            sess = open_index(ds.X, method=name, mesh=mesh, device="cpu",
                              schedule=_facade_policy(SchedulePolicy, engine))
            _put(out, f"facade/{case}", _stats(sess.search(ds.Q[:nq], K)))
        sess = open_index(ds.X, method="PDScanning+", mesh=mesh, device="cpu",
                          schedule=_facade_policy(SchedulePolicy))
        _put(out, "save/live", _stats(sess.search(ds.Q[:8], K)))
        sess.save(str(Path(outdir) / "mesh.snap"))
        loaded = SearchSession.load(str(Path(outdir) / "mesh.snap"),
                                    mesh=mesh, device="cpu")
        _put(out, "save/loaded", _stats(loaded.search(ds.Q[:8], K)))
        sess.add(_added_rows(ds.Q))                 # logged by rank 0
        errors["add_mode"] = sess.last_write_mode
        _put(out, "facade/add", _stats(sess.search(ds.Q[:16], K)))
        replayed = SearchSession.load(str(Path(outdir) / "mesh.snap"),
                                      mesh=mesh, device="cpu")
        _put(out, "save/replayed", _stats(replayed.search(ds.Q[:16], K)))
        errors.update(
            ivf=_refuse(lambda: open_index(
                ds.X, index="ivf", method="PDScanning+", mesh=mesh,
                device="cpu")),
            adaptive=_refuse(lambda: open_index(
                ds.X, method="PDScanning+", mesh=mesh, device="cpu",
                schedule=_facade_policy(SchedulePolicy, adaptive=True))),
            guardrails=_refuse(lambda: open_index(
                ds.X, method="PDScanning+", mesh=mesh, device="cpu",
                schedule=_facade_policy(SchedulePolicy, guardrails=True))),
            deadline=_refuse(lambda: sess.search(ds.Q[:8], K,
                                                 deadline_s=1.0)),
            host=_refuse(lambda: open_index(ds.X, method="PDScanning+",
                                            backend="host", mesh=mesh)),
            world=_refuse(lambda: make_host_mesh(4, 1, device_type="cpu")),
            device=_refuse(lambda: open_index(
                ds.X, method="PDScanning+", mesh=mesh, device="meta")),
            card=_refuse(lambda: open_index(ds.X, method="PDScanning+",
                                            mesh=mesh)))
    errors["foreign"] = sorted(m for m in sys.modules if m == "jax" or
                               m.startswith(("jax.", "repro.")))
    out["errors"] = np.asarray(json.dumps(errors))
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)


def _run_world(tmp_path_factory, reference, world: int) -> list:
    from repro_torch.launch.ranks import run_ranks

    outdir = tmp_path_factory.mktemp(f"world{world}")
    np.savez(outdir / "inputs.npz", xr=reference["engine/xr"],
             q=reference["engine/q"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    run_ranks([sys.executable, __file__, str(outdir), str(world)], world,
              workdir=outdir, timeout_s=RANKS_TIMEOUT_S, env=env, cwd=ROOT)
    outs = []
    for r in range(world):
        with np.load(outdir / f"rank{r}.npz") as z:
            out = dict(z)
        out["errors"] = json.loads(str(out["errors"]))
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory, reference):
    return _run_world(tmp_path_factory, reference, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, reference):
    return _run_world(tmp_path_factory, reference, 4)


# ---------------------------------------------------------------- tests ---
@pytest.mark.parametrize("per_shard,rb", [
    (96, 64), (128, 64), (97, 64), (10, 64), (1000, 48), (7, 3),
    (500_000, 4096), (1_000_000, 4096), (50_000, 4096), (2_000, 4096)])
def test_aligned_row_block_matches_reference(per_shard, rb):
    from repro.core.jax_engine import _aligned_row_block as ref
    from repro_torch.core.torch_engine import _aligned_row_block
    got = _aligned_row_block(per_shard, rb)
    assert got == ref(per_shard, rb)
    assert per_shard % got == 0 and 1 <= got <= rb


def _shape_mesh(**sizes):
    """Enough mesh for the build-time validation, which reads only the
    mesh's shape: the reference's (``shape`` a dict) and the port's."""
    ref = SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))
    port = SimpleNamespace(shape=tuple(sizes.values()),
                           mesh_dim_names=tuple(sizes))
    return ref, port


@pytest.mark.parametrize("sizes,kw", [
    ({"data": 4, "model": 2}, dict(n_rows=903)),            # not even
    ({"data": 4, "model": 2}, dict(n_rows=8 * 96)),         # 96 % 64
    ({"data": 4, "model": 2}, dict(n_rows=8 * 96, engine="two_stage")),
    ({"data": 4, "model": 2}, dict(n_rows=8 * 128)),        # aligned
    ({"data": 1, "model": 1}, dict(n_rows=None)),
    ({"data": 4, "model": 2}, dict(n_rows=903, engine="exhaustive")),
])
def test_distributed_topk_validates_as_reference(sizes, kw):
    """The reference's build-time checks (tests/test_search.py), with the
    same messages, on a mesh that has only a shape; the success cases
    build (the reference's need a real mesh to build its shard_map, so
    only its failures are compared)."""
    from repro.core.jax_engine import DcoEngineConfig as JCfg
    from repro.core.jax_engine import make_distributed_topk as ref_fn
    from repro_torch.core.torch_engine import (DcoEngineConfig,
                                               make_distributed_topk)
    ref_mesh, port_mesh = _shape_mesh(**sizes)
    cfg_kw = dict(kind="lb", d1=16, k=10, row_block=64)
    got = _refuse(lambda: make_distributed_topk(
        port_mesh, DcoEngineConfig(**cfg_kw), **kw))
    want = _refuse(lambda: ref_fn(ref_mesh, JCfg(**cfg_kw), **kw))
    if want[0] in ("ValueError",):
        assert got == want
    else:
        assert got == ["", ""], got


def test_adaptive_policy_refused_at_build():
    from repro_torch.core.policy import PolicyConfig
    from repro_torch.core.torch_engine import (DcoEngineConfig,
                                               make_distributed_topk)
    _, mesh = _shape_mesh(data=2, model=1)
    cfg = DcoEngineConfig(kind="lb", d1=16, k=10,
                          policy=PolicyConfig(adaptive=True))
    with pytest.raises(ValueError, match="adaptive DCO policy"):
        make_distributed_topk(mesh, cfg)


def test_make_host_mesh_world_mismatch_raises():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 2 ranks, have 1"):
        make_host_mesh(2, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    assert not dist.is_initialized()


def test_nccl_mesh_without_enough_cards_names_gloo():
    """NCCL holds one rank per card: a mesh that would put more NCCL ranks
    than there are cards is refused before any NCCL initialisation."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="gloo"):
        make_host_mesh(cards + 1, 1, device_type="cuda")
    assert not dist.is_initialized()


def _engine_key(shape, engine):
    return f"engine/{shape[0]}x{shape[1]}/{engine}"


@pytest.mark.parametrize("shape,engine", ENGINE_CASES)
def test_distributed_topk_matches_reference(shape, engine, reference,
                                            world2, world4):
    """Every rank's merged output against the reference's shard_map on
    the same fitted arrays: ids, survivors and certificate flags exactly,
    distances and dropped_min_est within rtol 1e-4; the ranks agree bit
    for bit."""
    outs = world2 if shape == (2, 1) else world4
    key = _engine_key(shape, engine)
    want = {f: reference[f"{key}/{f}"] for f in ("d", "i", "s", "dm")}
    got = {f: outs[0][f"{key}/{f}"] for f in ("d", "i", "s", "dm")}
    np.testing.assert_array_equal(got["i"], want["i"])
    np.testing.assert_allclose(got["d"], want["d"], rtol=1e-4)
    np.testing.assert_array_equal(got["s"], want["s"])
    np.testing.assert_allclose(got["dm"], want["dm"], rtol=1e-4)
    np.testing.assert_array_equal(got["dm"] > got["d"][:, -1],
                                  want["dm"] > want["d"][:, -1])
    for other in outs[1:]:
        for f in ("d", "i", "s", "dm"):
            np.testing.assert_array_equal(other[f"{key}/{f}"], got[f])


def _same_facade(got: dict, want: dict, case: str) -> None:
    g = {f: got[f"{case}/{f}"] for f in ("ids", "dists", "n_dco",
                                          "dims_scanned", "survivors_mean",
                                          "uncertified", "mask")}
    w = {f: want[f"{case}/{f}"] for f in g}
    np.testing.assert_array_equal(g["ids"], w["ids"])
    np.testing.assert_allclose(g["dists"], w["dists"], rtol=1e-4)
    np.testing.assert_array_equal(g["mask"], w["mask"])
    for f in ("n_dco", "dims_scanned", "survivors_mean", "uncertified"):
        assert g[f] == w[f], (case, f, g[f], w[f])


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_mesh_facade_matches_reference(case, reference, world2):
    """``open_index(X, mesh=make_host_mesh(2, 1, device_type="cpu"),
    device="cpu")`` on two gloo ranks against the reference facade on a
    2-device mesh: ids and certificate flags exactly, distances within
    rtol 1e-4, ``n_dco``, ``dims_scanned``, survivors mean and the
    uncertified share equal; both ranks give the same result."""
    _same_facade(world2[0], reference, f"facade/{case}")
    for f in ("ids", "dists", "mask"):
        np.testing.assert_array_equal(world2[1][f"facade/{case}/{f}"],
                                      world2[0][f"facade/{case}/{f}"])


def test_mesh_add_rebuilds_and_sees_new_rows(reference, world2):
    """``add()`` on a mesh session returns "rebuild" (no delta segment on
    the mesh) and the next search, re-sharded over 2 x 2,016 rows, equals
    the reference's after the same add; each query of Q[8:16] finds the
    row added beside it."""
    for out in world2:
        assert out["errors"]["add_mode"] == "rebuild"
    assert reference["errors"]["add_mode"] == "rebuild"
    _same_facade(world2[0], reference, "facade/add")
    ids = world2[0]["facade/add/ids"]
    n = reference["engine/xr"].shape[0]
    for j, qi in enumerate(range(ADD_ROWS[0], 16)):
        assert n + j in ids[qi], (qi, ids[qi])


def test_mesh_save_and_load(reference, world2):
    """``save()`` from rank 0 and ``load(path, mesh=)`` on every rank give
    the live session's ids, which are the reference's; the WAL that rank 0
    wrote for the later ``add()`` replays on both ranks."""
    for out in world2:
        np.testing.assert_array_equal(out["save/loaded/ids"],
                                      out["save/live/ids"])
        np.testing.assert_array_equal(out["save/replayed/ids"],
                                      out["facade/add/ids"])
    np.testing.assert_array_equal(world2[0]["save/live/ids"],
                                  reference["facade/PDScanning+/ids"])


@pytest.mark.parametrize("case", REFUSALS)
def test_mesh_refusals_match_reference(case, reference, world2):
    """IVF, the adaptive policy, guardrails, deadlines and the host
    backend on a mesh raise what the reference raises."""
    want = reference["errors"][case]
    for out in world2:
        got = out["errors"][case]
        assert got[0] == want[0] == "ValueError", (got, want)
        if case != "host":      # the reference names its jax backend
            assert got[1] == want[1]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_load_neither_jax_nor_the_reference(world, world2, world4):
    for out in (world2 if world == 2 else world4):
        assert out["errors"]["foreign"] == []


@pytest.mark.parametrize("case,exc,match", [
    ("world", "RuntimeError", "needs 4 ranks, have 2"),
    ("device", "ValueError", "'cpu' mesh cannot serve"),
    ("card", "RuntimeError", "runs on a CUDA device"),
])
def test_mesh_port_refusals(case, exc, match, world2):
    """What the port refuses on a mesh besides the reference's: a mesh
    larger than the world, and a device of another type than the mesh's;
    without ``device=`` a mesh session asks for the card, which this
    machine lacks."""
    for out in world2:
        got = out["errors"][case]
        assert got[0] == exc and match in got[1], got


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))

"""The port's facade (repro_torch.api) against the reference facade
(repro.api, backend="jax") for all 8 methods, the host backend against the
reference's (flat, IVF and HNSW), the options the port refuses and those
it now serves, its device rule, the fitted-state converters, and the guard that keeps the port free
of jax and of the reference package."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import open_index as jax_open_index
from repro.core.methods import make_method as ref_make_method
from repro.testing import FaultPlan as JaxFaultPlan
from repro.vecdata import load_dataset as ref_load_dataset
from repro_torch.api import METHODS, SchedulePolicy, open_index
from repro_torch.configs import smoke_config
from repro_torch.convert import method_from_reference, state_from_reference
from repro_torch.models import build_model
from repro_torch.serving import SearchService
from repro_torch.testing import FaultPlan
from repro_torch.vecdata import load_dataset, recall_at_k

K = 10
ROOT = Path(__file__).resolve().parents[1]
EXACT = ("FDScanning", "PDScanning", "PDScanning+")
STAT_KEYS = ("survivors_mean", "screen_pass_mean", "uncertified_queries",
             "dims_read_mean")
POLICY = dict(d1=48, query_chunk=8, capacity=512, row_block=512,
              block_capacity=128)


@pytest.mark.parametrize("name", METHODS)
def test_facade_matches_reference_jax_backend(name, sift_small):
    ds = sift_small
    rj = jax_open_index(ds.X, method=name, backend="jax",
                        schedule=JaxPolicy(**POLICY)).search(ds.Q[:8], K)
    rt = open_index(ds.X, method=name, backend="torch", device="cpu",
                    schedule=SchedulePolicy(**POLICY)).search(ds.Q[:8], K)
    assert rt.backend == "torch" and rt.ids.dtype == np.int64
    gt, _ = ds.ground_truth(K)
    if name in EXACT:
        np.testing.assert_array_equal(rt.ids, rj.ids)
    assert recall_at_k(rt.ids, gt[:8]) >= 0.9
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)
    for key in STAT_KEYS:
        assert (key in rt.stats.extra) == (key in rj.stats.extra), key
        if key in rj.stats.extra:
            assert rt.stats.extra[key] == rj.stats.extra[key], key
    assert rt.stats.n_dco == rj.stats.n_dco
    assert rt.stats.dims_scanned == rj.stats.dims_scanned


@pytest.mark.parametrize("n_codes,dtype", [(256, torch.uint8),
                                           (512, torch.int32)])
def test_facade_ddcopq_code_storage(n_codes, dtype, sift_small):
    """The backend holds PQ codes as uint8 when the codebooks have at most
    256 entries, else int32; either way DDCopq returns the reference
    facade's ids, and distances within rtol 1e-4."""
    X, Q = sift_small.X[:3000], sift_small.Q[:8]
    params = {"n_codes": n_codes}
    rj = jax_open_index(X, method="DDCopq", backend="jax",
                        method_params=params,
                        schedule=JaxPolicy(**POLICY)).search(Q, K)
    sess = open_index(X, method="DDCopq", device="cpu", method_params=params,
                      schedule=SchedulePolicy(**POLICY))
    rt = sess.search(Q, K)
    assert sess.method.state["pq"]["n_codes"] == n_codes
    assert sess.backend._blocks["codes"].dtype == dtype
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)


#: the methods whose layout groups (FDScanning and DDCopq force G = 1)
GROUPED = ("PDScanning", "PDScanning+", "ADSampling", "DADE", "DDCres",
           "DDCpca")


@pytest.mark.parametrize("name", GROUPED)
def test_facade_pdx_matches_reference_jax_backend(name, sift_small):
    """dim_groups = 4 on the CPU: the port's R-cut path against the
    reference facade's, ids and stats exact, distances within rtol 1e-4;
    early exit per group reads fewer dims than the flat layout."""
    ds = sift_small
    pol = dict(POLICY, dim_groups=4)
    rj = jax_open_index(ds.X, method=name, backend="jax",
                        schedule=JaxPolicy(**pol)).search(ds.Q[:8], K)
    sess = open_index(ds.X, method=name, device="cpu",
                      schedule=SchedulePolicy(**pol))
    rt = sess.search(ds.Q[:8], K)
    assert sess.backend._blocks["xl"].dim() == 4
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)
    for key in STAT_KEYS:
        assert rt.stats.extra[key] == rj.stats.extra[key], key
    assert rt.stats.dims_scanned == rj.stats.dims_scanned
    flat = open_index(ds.X, method=name, device="cpu",
                      schedule=SchedulePolicy(**POLICY)).search(ds.Q[:8], K)
    assert (rt.stats.extra["dims_read_mean"]
            < flat.stats.extra["dims_read_mean"])


def test_synthetic_data_matches_reference():
    """The port's copy of vecdata draws the same corpus from the same seed."""
    a, b = load_dataset("glove", scale=0.011), ref_load_dataset("glove",
                                                                 scale=0.011)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.Q, b.Q)


def test_convert_copies_fitted_state(sift_small):
    ref_m = ref_make_method("DDCopq").fit(sift_small.X[:1000])
    ref_m.train(sift_small.X[:24], K)
    m = method_from_reference(ref_m)
    assert type(m).__module__ == "repro_torch.core.methods"
    assert m.name == ref_m.name and m.params == ref_m.params
    np.testing.assert_array_equal(m.state["pq"]["codes"],
                                  ref_m.state["pq"]["codes"])
    assert m.state["pq"]["codes"] is not ref_m.state["pq"]["codes"]
    assert m.device_state()["theta"] == ref_m.device_state()["theta"]
    t = state_from_reference({"codes": ref_m.state["pq"]["codes"][:4]})
    assert isinstance(t["codes"], torch.Tensor) and t["codes"].shape[0] == 4


def test_add_rebuilds_and_serves_new_rows(sift_small):
    ds = sift_small
    sess = open_index(ds.X[:2000], method="PDScanning+", device="cpu",
                      schedule=SchedulePolicy(**POLICY))
    sess.search(ds.Q[:4], K)
    sess.add(ds.Q[:2])                  # the queries themselves join
    assert sess.last_write_mode == "delta" and sess.n == 2002
    res = sess.search(ds.Q[:2], K)
    np.testing.assert_array_equal(res.ids[:, 0], [2000, 2001])
    with pytest.raises(ValueError):
        sess.add(np.zeros((1, 3), np.float32))


@pytest.mark.parametrize("name,groups", [("DDCres", 1), ("DDCopq", 1),
                                         ("DDCres", 4), ("DDCopq", 4)])
def test_backend_holds_the_corpus_once(name, groups, sift_small):
    """The backend lays the blocks out on the host and keeps only them: no
    per-row tensor stays in its state, the blocks are whole, pad rows
    carry id -1, and ddcres reads the real rows' tail minimum.  With
    dim_groups = 4 the lead is the 4-D PDX layout (DDCopq stays flat)."""
    X = sift_small.X[:1300]                 # not a multiple of row_block
    sess = open_index(X, method=name, device="cpu",
                      schedule=SchedulePolicy(**POLICY, dim_groups=groups))
    sess.search(sift_small.Q[:2], K)
    be = sess.backend
    assert not set(be._state) & {"x_lead", "x_tail", "lead_sq", "tail_sq",
                                 "row_ids", "codes"}
    ids = be._blocks["ids"].reshape(-1).numpy()
    xl = be._blocks["xl"]
    if groups > 1 and name != "DDCopq":
        assert xl.shape == (3, 4, POLICY["row_block"], POLICY["d1"] // 4)
        assert be._blocks["lsg"].shape == (3, 4, POLICY["row_block"])
    else:
        assert xl.shape == (3, POLICY["row_block"], POLICY["d1"])
    np.testing.assert_array_equal(ids[:1300], np.arange(1300))
    assert (ids[1300:] == -1).all()
    assert float(be._state["tail_min"]) == float(
        be._blocks["tsq"].reshape(-1)[:1300].min())


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh="1x1"), "A7"),
    (dict(serving=True, serving_params={"slots": 4, "k": K}), "A6"),
    (dict(path="idx.bin"), "A6"),
])
def test_unsupported_options_raise(kwargs, item, sift_small, tmp_path):
    """The options the port once refused naming their ROADMAP items are
    served: a 1 x 1 mesh on the CPU (a one-rank gloo group) gives the
    single-device session's ids and distances bit for bit (A7; more ranks
    in tests/test_torch_distributed.py), the serving front answers a
    query as the session does, and a snapshot path arms the delta WAL,
    which logs the next add() (A6)."""
    X, Q = sift_small.X[:256], sift_small.Q[:1]
    if item == "A7":
        import torch.distributed as dist
        from repro_torch.launch import make_host_mesh
        mesh = make_host_mesh(1, 1, device_type="cpu")
        try:
            sess = open_index(X, method="PDScanning+", device="cpu",
                              mesh=mesh)
            got = sess.search(Q, K)
        finally:
            dist.destroy_process_group()
        want = open_index(X, method="PDScanning+", device="cpu").search(Q, K)
        assert sess.backend._mesh_row_block == 256
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
        return
    if "path" in kwargs:
        kwargs = dict(path=str(tmp_path / kwargs["path"]))
    out = open_index(X, method="PDScanning+", device="cpu", **kwargs)
    if "serving" in kwargs:
        assert isinstance(out, SearchService)
        req = out.submit(Q[0])
        out.drain()
        assert req.done and req.certified
        np.testing.assert_array_equal(req.ids,
                                      out.session.search(Q, K).ids[0])
        return
    assert out.wal is not None and out.wal.path == kwargs["path"] + ".wal"
    assert out.wal.total_bytes() == 0
    out.add(X[:2])
    assert out.wal.total_bytes() > 0 and out.n == 258


@pytest.mark.parametrize("backend,kw", [
    ("torch", dict(faults=FaultPlan(slow_block_s=0.0))),
    ("host", dict(adaptive=True)),
    ("torch", dict(adaptive=True)),
    ("torch", dict(guardrails=True)),
    ("torch", dict(dim_groups=4, adaptive=True)),
])
def test_unsupported_options_served(backend, kw, sift_small):
    """The schedule options the port once refused (a fault plan, the
    adaptive policy on either backend and on the PDX layout, the
    guardrail breaker) are served, with the reference facade's ids,
    distances within rtol 1e-4 and the same adaptive telemetry."""
    X, Q = sift_small.X[:1024], sift_small.Q[:4]
    jkw = dict(kw)
    if "faults" in kw:
        jkw["faults"] = JaxFaultPlan(slow_block_s=0.0)
    rj = jax_open_index(X, method="PDScanning+",
                        backend="jax" if backend == "torch" else "host",
                        schedule=JaxPolicy(**POLICY, **jkw)).search(Q, K)
    rt = open_index(X, method="PDScanning+", backend=backend,
                    device="cpu" if backend == "torch" else None,
                    schedule=SchedulePolicy(**POLICY, **kw)).search(Q, K)
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)
    assert set(rt.stats.extra) == set(rj.stats.extra)
    for key in ("fallback_blocks", "rule_timeline", "breaker_state"):
        assert rt.stats.extra.get(key) == rj.stats.extra.get(key), key


def test_deadline_search_served(sift_small):
    """A deadline search is served: with a generous budget the whole
    corpus is scanned, with the reference facade's ids and coverage."""
    X, Q = sift_small.X[:256], sift_small.Q[:2]
    sess = open_index(X, method="FDScanning", device="cpu")
    res = sess.search(Q, K, deadline_s=1.0)
    ref = jax_open_index(X, method="FDScanning", backend="jax").search(
        Q, K, deadline_s=1.0)
    np.testing.assert_array_equal(res.ids, ref.ids)
    np.testing.assert_array_equal(res.stats.extra["coverage"],
                                  ref.stats.extra["coverage"])
    assert (res.stats.extra["coverage"] == 1.0).all()


def test_default_device_needs_a_gpu(sift_small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        open_index(sift_small.X[:256], method="FDScanning")


def test_build_model_without_a_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(smoke_config("qwen3-4b"))


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"|from\s+repro[.\s]|import\s+benchmarks\b"
                     r"|from\s+benchmarks\b)", re.M)
    files = _port_files()
    assert len(files) > 10
    assert ROOT / "src" / "repro_torch" / "serving" / "replica.py" in files
    assert ROOT / "src" / "repro_torch" / "launch" / "mesh.py" in files
    assert ROOT / "src" / "repro_torch" / "serving" / "dco_attention.py" in files
    for mod in ("models/lm.py", "models/mamba2.py", "models/mla.py",
                "models/moe.py", "configs/base.py",
                "serving/engine.py", "launch/serve.py",
                "train/optimizer.py", "train/train_step.py",
                "train/checkpoint.py", "train/fault.py",
                "data/pipeline.py", "launch/train.py",
                "configs/sharding.py", "models/placement.py",
                "launch/hlo_cost.py", "launch/roofline.py",
                "launch/attribution.py", "launch/dryrun.py",
                "launch/reanalyze.py", "launch/summarize.py",
                "utils/trace.py"):
        assert ROOT / "src" / "repro_torch" / mod in files
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, (f, hits)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.kernels.ops, "
            "repro_torch.serving, repro_torch.api.persistence, "
            "repro_torch.launch.ranks, repro_torch.models, "
            "repro_torch.configs, repro_torch.launch.serve, "
            "repro_torch.train.fault, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.configs.sharding, "
            "repro_torch.models.placement, repro_torch.launch.hlo_cost, "
            "repro_torch.launch.roofline, repro_torch.launch.attribution, "
            "repro_torch.launch.dryrun, repro_torch.launch.reanalyze, "
            "repro_torch.launch.summarize, repro_torch.utils.trace; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ------------------------------------------------------------ host -------
HOST_METHODS = ("FDScanning", "PDScanning+", "DADE")
HOST_PARAMS = {"flat": None, "ivf": {"n_list": 16},
               "hnsw": {"m": 8, "ef_construction": 32}}


def _same_stats(a, b):
    assert b.n_dco == a.n_dco and b.n_true == a.n_true
    assert b.dims_scanned == a.dims_scanned
    assert b.dims_total == a.dims_total
    assert set(b.extra) == set(a.extra)
    for key, v in a.extra.items():
        np.testing.assert_array_equal(np.asarray(b.extra[key]),
                                      np.asarray(v), err_msg=key)


@pytest.mark.parametrize("index", ["flat", "ivf", "hnsw"])
@pytest.mark.parametrize("name", HOST_METHODS)
def test_host_backend_matches_reference(index, name, sift_small):
    """backend='host' against the reference's host backend on the same
    corpus and seed: the same ids, distances and ScanStats, extra keys
    included; an add() takes write mode "noop" and both sessions still
    agree."""
    X, Q = sift_small.X[:600], sift_small.Q[:6]
    params = HOST_PARAMS[index]
    sj = jax_open_index(X, index=index, method=name, backend="host",
                        index_params=params)
    st = open_index(X, index=index, method=name, backend="host",
                    index_params=params)
    assert st.backend_name == "host"
    for _ in range(2):
        rj = sj.search(Q, K, nprobe=4, ef=40)
        rt = st.search(Q, K, nprobe=4, ef=40)
        assert rt.backend == "host"
        np.testing.assert_array_equal(rt.ids, rj.ids)
        np.testing.assert_array_equal(rt.dists, rj.dists)
        _same_stats(rj.stats, rt.stats)
        sj.add(sift_small.X[600:650])
        st.add(sift_small.X[600:650])
        assert st.last_write_mode == "noop" and st.n == sj.n


@pytest.mark.parametrize("index", ["flat", "ivf"])
@pytest.mark.parametrize("name", ["FDScanning", "PDScanning+"])
def test_host_backend_equals_torch_backend_on_exact_rules(index, name,
                                                          sift_small):
    """On the exact rules the host scan and the torch engine on the CPU
    return the same ids, flat and IVF (at the same nprobe)."""
    X, Q = sift_small.X[:2000], sift_small.Q[:8]
    params = {"n_list": 16} if index == "ivf" else None
    pol = SchedulePolicy(**POLICY)
    host = open_index(X, index=index, method=name, backend="host",
                      schedule=pol, index_params=params).search(Q, K,
                                                               nprobe=5)
    dev = open_index(X, index=index, method=name, device="cpu", schedule=pol,
                     index_params=params).search(Q, K, nprobe=5)
    np.testing.assert_array_equal(np.sort(host.ids, 1), np.sort(dev.ids, 1))
    np.testing.assert_allclose(np.sort(host.dists, 1), np.sort(dev.dists, 1),
                               rtol=1e-3, atol=1e-2)


def test_torch_backend_refuses_hnsw(sift_small):
    """HNSW graph walks stay on the host, as the reference's device
    backend refuses them too."""
    from repro_torch.api import SearchSession
    X = sift_small.X[:256]
    with pytest.raises(ValueError, match="host"):
        open_index(X, index="hnsw", method="PDScanning+", device="cpu",
                   index_params={"m": 4, "ef_construction": 8})
    with pytest.raises(ValueError, match="host"):
        SearchSession(ref_make_method("PDScanning+"), index_kind="hnsw",
                      device="cpu")
    with pytest.raises(ValueError, match="backend"):
        open_index(X, method="PDScanning+", backend="jax")

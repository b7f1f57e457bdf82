"""The port's facade (repro_torch.api) against the reference facade
(repro.api, backend="jax") for all 8 methods, the options the port refuses,
its device rule, the fitted-state converters, and the guard that keeps the
port free of jax and of the reference package."""
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
from repro.vecdata import load_dataset as ref_load_dataset
from repro_torch.api import METHODS, SchedulePolicy, open_index
from repro_torch.convert import method_from_reference, state_from_reference
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
    assert sess.last_write_mode == "rebuild" and sess.n == 2002
    res = sess.search(ds.Q[:2], K)
    np.testing.assert_array_equal(res.ids[:, 0], [2000, 2001])
    with pytest.raises(ValueError):
        sess.add(np.zeros((1, 3), np.float32))


@pytest.mark.parametrize("name", ["DDCres", "DDCopq"])
def test_backend_holds_the_corpus_once(name, sift_small):
    """The backend pads the rows on the host and keeps only the blocked
    layout: no per-row tensor stays in its state, the blocks are whole,
    pad rows carry id -1, and ddcres reads the real rows' tail minimum."""
    X = sift_small.X[:1300]                 # not a multiple of row_block
    sess = open_index(X, method=name, device="cpu",
                      schedule=SchedulePolicy(**POLICY))
    sess.search(sift_small.Q[:2], K)
    be = sess.backend
    assert not set(be._state) & {"x_lead", "x_tail", "lead_sq", "tail_sq",
                                 "row_ids", "codes"}
    ids = be._blocks["ids"].reshape(-1).numpy()
    assert be._blocks["xl"].shape[:2] == (3, POLICY["row_block"])
    np.testing.assert_array_equal(ids[:1300], np.arange(1300))
    assert (ids[1300:] == -1).all()
    assert float(be._state["tail_min"]) == float(
        be._blocks["tsq"].reshape(-1)[:1300].min())


@pytest.mark.parametrize("kwargs,item", [
    (dict(index="ivf"), "A5"), (dict(index="hnsw"), "A4"),
    (dict(backend="host"), "A4"), (dict(mesh=object()), "A12"),
    (dict(serving=True), "A11"), (dict(path="idx.bin"), "A11"),
    (dict(schedule=SchedulePolicy(adaptive=True)), "A7"),
    (dict(schedule=SchedulePolicy(guardrails=True)), "A10"),
    (dict(schedule=SchedulePolicy(dim_groups=4)), "A9"),
    (dict(schedule=SchedulePolicy(engine="two_stage")), "A1"),
])
def test_unsupported_options_raise(kwargs, item, sift_small):
    with pytest.raises(NotImplementedError, match=item):
        open_index(sift_small.X[:256], method="PDScanning+", device="cpu",
                   **kwargs)


def test_deadline_search_raises(sift_small):
    sess = open_index(sift_small.X[:256], method="FDScanning", device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        sess.search(sift_small.Q[:2], K, deadline_s=1.0)


def test_default_device_needs_a_gpu(sift_small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        open_index(sift_small.X[:256], method="FDScanning")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"|from\s+repro[.\s])", re.M)
    files = _port_files()
    assert len(files) > 10
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, (f, hits)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.kernels.ops; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"

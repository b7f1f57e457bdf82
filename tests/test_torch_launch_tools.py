"""The port's analysis tools against the reference's (A10).

``repro_torch.launch.roofline``'s arithmetic against the reference's for
every arch and shape; ``launch.hlo_cost``'s counted matmul flops against
the dot flops the reference's ``launch.attribution`` reads from its
compiled HLO, at every family's smoke-config prefill; the counter's
counterpart of the reference's ``MINI`` case; ``attribution``'s source
lines; one ``dryrun`` cell on a fake (2, 2) group against the reference's
``lower_cell`` on 4 fake devices (each side a subprocess under a
deadline); ``reanalyze`` and ``summarize`` over a saved record.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, applicable_shapes,
                                 get_arch, smoke_config)
from repro_torch.launch import attribution as TAT
from repro_torch.launch import hlo_cost as THC
from repro_torch.launch import reanalyze as TRE
from repro_torch.launch import roofline as TRL
from repro_torch.launch import summarize as TSU
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
FLOP_RTOL = 2e-2
CELL_RTOL = 5e-2
FAMILIES = ("qwen3-4b", "paligemma-3b", "seamless-m4t-large-v2",
            "mamba2-130m", "deepseek-v2-236b", "jamba-v0.1-52b")
CELL = ("mamba2-130m", "decode_32k")
#: the lines that make a product in the port
PRODUCT = ("@", "einsum", "bmm", "matmul", "linear")


def _prefill_batch(cfg, b=2, s=16):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.prefix_len:
        batch["patches"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


def _port_prefill(arch):
    cfg = smoke_config(arch)
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = _prefill_batch(cfg)

    def run():
        with torch.no_grad():
            return api.prefill(params, batch)
    return run


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_roofline_arithmetic_is_the_reference(arch):
    """``active_params`` and ``model_flops_estimate`` equal the
    reference's exactly, for every shape the arch applies to."""
    from repro.configs import get_arch as ref_arch
    from repro.configs import SHAPES as REF_SHAPES
    from repro.launch import roofline as RL
    cfg, ref = get_arch(arch), ref_arch(arch)
    assert TRL.active_params(cfg) == RL.active_params(ref)
    for s in applicable_shapes(cfg):
        assert TRL.model_flops_estimate(cfg, SHAPES[s]) == \
            RL.model_flops_estimate(ref, REF_SHAPES[s]), s


@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_matmul_flops_match_the_reference_dots(arch):
    """The counter's matmul flops of a smoke-config prefill (B 2, S 16)
    against the dot flops of the reference's ``attribute`` on its
    compiled ``prefill``: within 2 %."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as ref_smoke
    from repro.launch import attribution as AT
    from repro.models import build_model as ref_build
    cfg = ref_smoke(arch)
    api = ref_build(cfg)
    params = api.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _prefill_batch(cfg).items()}
    hlo = jax.jit(api.prefill).lower(params, batch).compile().as_text()
    want = sum(v for _, v in AT.attribute(hlo, top=10**6)["flops"])
    with THC.CostCounter() as c:
        _port_prefill(arch)()
    got = c.totals()["matmul_flops"]
    print(f"{arch}: counted {got:.6e}, reference dots {want:.6e}, "
          f"gap {abs(got - want) / want:.2e}")
    assert abs(got - want) <= FLOP_RTOL * want


def test_counter_counts_every_step_of_a_loop():
    """The reference's ``MINI`` case: a 10-step loop of a 128^3 matmul is
    10 x 2 x 128^3 flops (no trip count to read: each step dispatches)."""
    a, b = torch.randn(128, 128), torch.randn(128, 128)

    def loop(x):
        for _ in range(10):
            x = x @ b
        return x
    _, c = THC.count(loop, a)
    tot = c.totals()
    assert tot["matmul_flops"] == tot["flops"] == 10 * 2 * 128 ** 3
    assert tot["bytes_upper"] == 10 * 3 * 128 * 128 * 4
    assert tot["collective_bytes"] == 0.0


def test_counter_counts_the_f32_result_gemm():
    """``bmm(..., out_dtype=)`` (the card's f32-result bf16 GEMM), whose
    overload ``flop_counter``'s formula cannot take, counts its product;
    on meta tensors, where it runs without a card."""
    a = torch.empty(3, 4, 5, dtype=torch.bfloat16, device="meta")
    b = torch.empty(3, 5, 6, dtype=torch.bfloat16, device="meta")
    with THC.CostCounter() as c:
        out = torch.bmm(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert c.totals()["matmul_flops"] == 2 * 3 * 4 * 5 * 6


@pytest.mark.parametrize("arch", ("qwen3-4b", "deepseek-v2-236b"))
def test_attribution_names_each_matmul_line(arch):
    """Every product of a smoke-config prefill is attributed to a line of
    ``src/repro_torch`` that makes a product, and they sum to the
    counter's matmul flops."""
    rep = TAT.attribute(_port_prefill(arch), top=10**6)
    _, c = THC.count(_port_prefill(arch))
    assert sum(v for _, v in rep["flops"]) == c.totals()["matmul_flops"]
    files = {p.name: p for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    for src, _ in rep["flops"]:
        name, _, line = src.split(":")
        text = files[name].read_text().splitlines()[int(line) - 1]
        assert any(p in text for p in PRODUCT), (src, text)
    assert rep["bytes"] and rep["bytes"][0][1] > 0


PORT_CELL = r'''
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_host_mesh(2, 2, device_type="meta")
rec = D.run_cell(sys.argv[1], sys.argv[2], "pod", sys.argv[3], mesh=mesh)
print(json.dumps(rec, default=str))
'''

REF_CELL = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import make_host_mesh
from repro.launch import attribution as AT
lowered, chips, mf = lower_cell(sys.argv[1], sys.argv[2], make_host_mesh(2, 2))
rep = AT.attribute(lowered.compile().as_text(), top=10**6)
print(sum(v for _, v in rep["flops"]), mf)
'''


def _run(code, *args, env=None):
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         capture_output=True, text=True, timeout=TIMEOUT_S,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """One dry-run cell on a fake (2, 2) group (a subprocess) and the
    reference's ``lower_cell`` of it on 4 fake devices (another)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    rec = json.loads(_run(PORT_CELL, *CELL, out, env=env))
    dots, mf = map(float, _run(REF_CELL, *CELL, env=env).split())
    return rec, dots, mf, out


def test_dryrun_cell_counts_the_reference_dots(cell):
    """``mamba2-130m`` ``decode_32k`` on (data 2, model 2): the cell runs
    on meta tensors and records its terms; the rank's matmul flops are
    the reference device's dots times the "model" dim (2) within 5 %: a
    port rank computes its DP rows' products whole, where GSPMD splits
    them over "model" too (ROADMAP A25, tensor-parallel compute)."""
    rec, dots, mf, _ = cell
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == 4 and rec["mesh_shape"] == {"data": 2, "model": 2}
    assert rec["model_flops"] == mf
    got = rec["matmul_flops_per_device"]
    print(f"rank matmul flops {got:.6e}, reference device dots {dots:.6e}")
    assert abs(got - 2 * dots) <= CELL_RTOL * 2 * dots
    assert set(rec["terms_s"]) == {"compute_s", "memory_s", "collective_s"}
    assert rec["dominant"] in rec["terms_s"]
    assert rec["collectives"]["all-gather"] > 0
    assert rec["memory"]["argument_bytes"] > 0


def test_reanalyze_round_trips_a_saved_record(cell):
    """``reanalyze`` brings a record's terms back from its saved count
    table, without running the model."""
    rec, _, _, out = cell
    path = next(p for p in out.glob("*.json"))
    stale = dict(rec, terms_s={}, dominant="-", hlo_flops_per_device=0.0)
    path.write_text(json.dumps(stale))
    TRE.main(str(out))
    back = json.loads(path.read_text())
    for key in ("terms_s", "dominant", "hlo_flops_per_device",
                "hlo_bytes_per_device", "collective_bytes_per_device",
                "useful_ratio"):
        assert back[key] == rec[key], key


def test_summarize_renders_the_records(cell, capsys):
    _, _, _, out = cell
    TSU.main(["--out", str(out)])
    text = capsys.readouterr().out
    assert "### Mesh `pod` (1 cells OK)" in text
    assert "| mamba2-130m | decode_32k |" in text
    assert "long_500k" in text          # the skipped cells

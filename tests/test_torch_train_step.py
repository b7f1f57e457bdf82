"""The port's train step, optimizer, schedule, checkpoints, fault
tolerance and training CLI (``repro_torch.train``,
``repro_torch.launch.train``) against the reference package on the CPU.

A step starts both packages from the reference's ``init_state`` (carried
across by ``convert.train_state_from_reference``) at a constant learning
rate of ``LR``; the references are compiled with
``xla_allow_excess_precision`` off (``exact_jit``, as in
``tests/test_torch_train.py``).  After one step: the loss within
``LOSS_RTOL`` (1e-3) relative (``ROUTED_TOL``, 4e-2, for the routed
families), ``gnorm`` within ``GNORM_RTOL`` (1e-2) relative, the first
moment within ``GRAD_TOL`` (5e-2) of each leaf's max, and the updated f32
masters within 1e-6 wherever the gradient is above ``GRAD_TOL`` of its
leaf's max and above 1e-4, far above AdamW's eps (there the step is ``lr *
sign(g)`` plus the decay on both sides) and within ``2 * LR`` + 1e-6
elsewhere (a sign may differ).
Measured on the CPU: losses within 3.3e-4 relative (seamless), gnorm
within 3.3e-3, the first moments within 3.5e-2 of their max, the masters
within 1.2e-7 where the gradient is clear.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.train import optimizer as ref_opt
from repro.train.fault import StepMonitor as RefStepMonitor
from repro.train.fault import plan_elastic_remesh as ref_remesh
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import lr_schedule as ref_lr_schedule
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import _model, reference_leaves, \
    train_state_from_reference
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.fault import StepMonitor, plan_elastic_remesh, \
    run_resumable
from repro_torch.train.train_step import init_state, lr_schedule, \
    make_train_step

ROUTED_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", "jamba-v0.1-52b")
FAMILY_ARCHS = ("olmo-1b", "paligemma-3b", "seamless-m4t-large-v2",
                "mamba2-130m", "deepseek-v3-671b", "jamba-v0.1-52b")
VOCAB = 500
LR = 1e-3
LOSS_RTOL = 1e-3
ROUTED_TOL = 4e-2
GNORM_RTOL = 1e-2
GRAD_TOL = 5e-2
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})


def make_batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.prefix_len:
        batch["patches"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (b, 10, cfg.d_model)).astype(np.float32)
    return batch


def ref_step(arch, batch, microbatches=1):
    """The reference's state and its state and metrics one step on."""
    rapi = ref_build_model(ref_smoke_config(arch).scaled(vocab=VOCAB))
    state = ref_init_state(rapi, jax.random.PRNGKey(0))
    step = exact_jit(ref_make_train_step(rapi, microbatches=microbatches,
                                         lr_fn=lambda s: LR))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, new, {k: float(v) for k, v in metrics.items()}


def port_step(arch, ref_state, batch, microbatches=1, remat="block"):
    cfg = smoke_config(arch).scaled(vocab=VOCAB)
    api = build_model(cfg, remat=remat, device="cpu")
    state = train_state_from_reference(cfg, ref_state, device="cpu")
    new, metrics = make_train_step(api, microbatches=microbatches,
                                   lr_fn=lambda s: LR)(state, batch)
    return cfg, state, new, {k: float(v) for k, v in metrics.items()}


def check_step(arch, cfg, ref_new, ref_m, new, m):
    tol = ROUTED_TOL if arch in ROUTED_ARCHS else LOSS_RTOL
    assert set(m) == set(ref_m)
    assert abs(m["loss"] - ref_m["loss"]) <= tol * abs(ref_m["loss"])
    assert abs(m["gnorm"] - ref_m["gnorm"]) <= GNORM_RTOL * ref_m["gnorm"]
    assert m["lr"] == pytest.approx(LR)
    assert int(new.step) == int(ref_new.step) == 1
    assert int(new.opt["step"]) == 1
    names = _model(cfg, "meta")
    want_p = {n: a for n, _, a in reference_leaves(cfg, names, ref_new.params)}
    want_m = {n: a for n, _, a in reference_leaves(cfg, names,
                                                  ref_new.opt["m"])}
    assert set(new.params) == set(want_p)
    for name, wp in want_p.items():
        wm, got_m = want_m[name], new.opt["m"][name].numpy()
        top = np.abs(wm).max()
        if top:
            assert np.abs(got_m - wm).max() <= GRAD_TOL * top, name
        # m = 0.1 x the clipped grad g: where g is above GRAD_TOL of its
        # max and above 1e-4 (1e4 x AdamW's eps, whose share of a step,
        # lr * eps / |g|, then differs between the sides by under 1e-7),
        # the step is lr * sign(g) on both sides
        clear = (np.abs(wm) > GRAD_TOL * top) & (np.abs(wm) > 1e-5)
        gap = np.abs(new.params[name].numpy() - wp)
        assert new.params[name].dtype == torch.float32
        assert gap[clear].max(initial=0) <= 1e-6, name
        assert gap.max() <= 2 * LR + 1e-6, name


# ------------------------------------------------------------ one step ---
def one_step_case(arch):
    """One step with ``remat="block"`` on both sides, from one state."""
    batch = make_batch(smoke_config(arch))
    state, ref_new, ref_m = ref_step(arch, batch)
    cfg, _, new, m = port_step(arch, state, batch)
    check_step(arch, cfg, ref_new, ref_m, new, m)


@pytest.mark.parametrize("arch", [a for a in FAMILY_ARCHS
                                  if a not in ROUTED_ARCHS])
def test_one_step_matches_reference(arch):
    """One step with ``remat="block"`` on both sides, from one state
    (the routed families': ``tests/test_torch_train_step_routed.py``)."""
    one_step_case(arch)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_microbatched_step_matches_reference(microbatches):
    """Four microbatches of 2 x 32 (grads summed and divided in bf16,
    the loss averaged in f32), and the whole batch in one."""
    cfg = smoke_config("olmo-1b")
    batch = make_batch(cfg, seed=3, b=8, s=32)
    state, ref_new, ref_m = ref_step("olmo-1b", batch, microbatches)
    cfg, _, new, m = port_step("olmo-1b", state, batch, microbatches)
    check_step("olmo-1b", cfg, ref_new, ref_m, new, m)


def test_microbatch_equals_full_batch_grads():
    """Gradient accumulation matches the single-shot step (the
    reference's own test, ``tests/test_train_fault.py``, at its bound)."""
    cfg = smoke_config("olmo-1b")
    batch = make_batch(cfg, seed=3, b=4, s=32)
    api = build_model(cfg, remat="none", device="cpu")
    state = init_state(api, torch.Generator().manual_seed(0))
    s1, m1 = make_train_step(api, microbatches=1)(state, batch)
    s4, m4 = make_train_step(api, microbatches=4)(state, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    assert max(float((s1.params[n] - s4.params[n]).abs().max())
               for n in s1.params) < 5e-3


def test_the_step_is_functional_and_refuses_f32_grads():
    cfg = smoke_config("mamba2-130m")
    api = build_model(cfg, device="cpu")
    state = init_state(api, torch.Generator().manual_seed(0))
    before = {n: p.clone() for n, p in state.params.items()}
    new, _ = make_train_step(api)(state, make_batch(cfg))
    assert all(torch.equal(before[n], state.params[n]) for n in before)
    assert any(not torch.equal(before[n], new.params[n]) for n in before)
    with pytest.raises(ValueError, match="bfloat16"):
        make_train_step(api, grad_dtype=torch.float32)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(api, microbatches=3)(state, make_batch(cfg))


def test_unreached_parameter_still_decays():
    """OLMo's ``final_norm`` under the non-parametric norm has a zero
    grad; AdamW still decays it: 1 - lr * 0.1 after one step."""
    cfg = smoke_config("olmo-1b")
    api = build_model(cfg, device="cpu")
    state = init_state(api, torch.Generator().manual_seed(0))
    new, _ = make_train_step(api, lr_fn=lambda s: LR)(state, make_batch(cfg))
    assert torch.equal(new.opt["m"]["final_norm"],
                       torch.zeros_like(new.opt["m"]["final_norm"]))
    np.testing.assert_allclose(new.params["final_norm"].numpy(),
                               1 - LR * 0.1, rtol=1e-7)


def test_loss_decreases():
    cfg = smoke_config("olmo-1b")
    api = build_model(cfg, remat="none", device="cpu")
    state = init_state(api, torch.Generator().manual_seed(0))
    step = make_train_step(api, lr_fn=lambda s: 3e-3)    # skip warm-up
    fixed = make_batch(cfg, b=4, s=32)
    losses = []
    for _ in range(12):
        state, m = step(state, fixed)                    # overfit one batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_state_masters_round_to_the_serving_init(arch):
    """f32 masters from the same generator calls: rounded to bf16 (the
    f32 leaves as they are) they are the serving init bit for bit; the
    moments are zero, the steps 0."""
    cfg = smoke_config(arch)
    api = build_model(cfg, device="cpu")
    state = init_state(api, torch.Generator().manual_seed(5))
    serving = api.init(torch.Generator().manual_seed(5))
    named = dict(serving.named_parameters())
    assert list(state.params) == list(named)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    for name, p in named.items():
        assert torch.equal(state.params[name].to(p.dtype), p), name
        assert not state.opt["m"][name].any() and not state.opt["v"][name].any()
    assert int(state.step) == int(state.opt["step"]) == 0
    bf16 = init_state(api, torch.Generator().manual_seed(5),
                      moment_dtype=torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in bf16.opt["m"].values())


# ------------------------------------------------------------- AdamW ---
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Two updates on identical bf16 grads from identical state, one of
    them clipped (norm above 1): params, moments and gnorm within 1e-6."""
    rng = np.random.default_rng(4)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jdt, tdt = getattr(jnp, moment_dtype), getattr(torch, moment_dtype)
    rp, rs = {k: jnp.asarray(v) for k, v in params.items()}, \
        ref_opt.adamw_init({k: jnp.asarray(v) for k, v in params.items()},
                           moment_dtype=jdt)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = topt.adamw_init(tp, moment_dtype=tdt)
    for scale in (0.01, 3.0):
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        rg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in grads.items()}
        tg = {k: torch.as_tensor(v).to(torch.bfloat16)
              for k, v in grads.items()}
        rp, rs, rn = ref_opt.adamw_update(rp, rg, rs, lr=1e-2)
        tp, ts, tn = topt.adamw_update(tp, tg, ts, lr=1e-2)
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       atol=1e-6, rtol=0)
            for mom in ("m", "v"):
                assert ts[mom][k].dtype == tdt
                np.testing.assert_allclose(
                    ts[mom][k].float().numpy(),
                    np.asarray(rs[mom][k]).astype(np.float32),
                    atol=1e-6, rtol=1e-6)
    assert int(ts["step"]) == int(rs["step"]) == 2


@pytest.mark.parametrize("step", [0, 99, 100, 10_000])
def test_lr_schedule_matches_reference(step):
    want = float(ref_lr_schedule(jnp.asarray(step, jnp.int32)))
    got = lr_schedule(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


# ------------------------------------------------ checkpoints and faults ---
def _setup(arch="olmo-1b"):
    cfg = smoke_config(arch)
    api = build_model(cfg, remat="none", device="cpu")
    state = init_state(api, torch.Generator().manual_seed(0))
    step = make_train_step(api)

    def batch_fn(s):
        return make_batch(cfg, seed=s, b=4, s=32)
    return cfg, api, state, step, batch_fn


def _leaves_equal(a, b) -> bool:
    la, lb = ckpt._flatten(a), ckpt._flatten(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    cfg, api, state, step, batch_fn = _setup()
    state, _ = step(state, batch_fn(0))
    ckpt.save(state, str(tmp_path), 1)
    assert sorted(p.name for p in (tmp_path / "step_0000000001").iterdir()) \
        == sorted([f"{i}.npy" for i in range(len(ckpt._flatten(state)))]
                  + ["manifest.json"])
    restored, s = ckpt.restore(state, str(tmp_path))
    assert s == 1 and _leaves_equal(state, restored)
    assert list(restored.params) == list(state.params)
    onto, _ = ckpt.restore(state, str(tmp_path), shardings="cpu")
    assert _leaves_equal(state, onto)
    # a placement tree of the template's structure (None: as the template
    # leaf) restores as the template; one of another structure is refused
    nones = dataclasses.replace(
        state, params=dict.fromkeys(state.params),
        opt={"m": dict.fromkeys(state.opt["m"]),
             "v": dict.fromkeys(state.opt["v"]), "step": None}, step=None)
    same, _ = ckpt.restore(state, str(tmp_path), shardings=nones)
    assert _leaves_equal(state, same)
    with pytest.raises(ValueError, match="shardings has"):
        ckpt.restore(state, str(tmp_path), shardings={"a": None})
    assert ckpt.restore(state, str(tmp_path / "none")) == (None, -1)


def test_checkpoint_keeps_bf16_moments(tmp_path):
    cfg = smoke_config("mamba2-130m")
    api = build_model(cfg, device="cpu")
    state = init_state(api, torch.Generator().manual_seed(0),
                       moment_dtype=torch.bfloat16)
    state, _ = make_train_step(api)(state, make_batch(cfg))
    ckpt.save(state, str(tmp_path), 0)
    restored, _ = ckpt.restore(state, str(tmp_path))
    assert _leaves_equal(state, restored)


def test_checkpoint_gc_and_async(tmp_path):
    cfg, api, state, step, batch_fn = _setup()
    for s in range(5):
        ckpt.save_async(state, str(tmp_path), s, keep_last=2)
    ckpt.wait_pending()
    steps = ckpt.latest_steps(str(tmp_path))
    assert sorted(steps) == [3, 4]
    # a save cut before its manifest is not a checkpoint
    (tmp_path / "step_0000000009.tmp").mkdir()
    (tmp_path / "step_0000000008").mkdir()
    assert sorted(ckpt.latest_steps(str(tmp_path))) == [3, 4]


def test_restart_is_bitwise_identical(tmp_path):
    """Crash at step 6, resume, and land on the same final state and
    loss as an uninterrupted run (deterministic data, stateless
    batch_fn)."""
    cfg, api, state0, step, batch_fn = _setup()
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref, last = run_resumable(step, state0, batch_fn, steps=10, ckpt_dir=d1,
                              ckpt_every=3)
    assert last == 9
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        run_resumable(step, state0, batch_fn, steps=10, ckpt_dir=d2,
                      ckpt_every=3, fail_at=6)
    assert max(ckpt.latest_steps(d2)) == 3       # the crash came before 6
    resumed, last = run_resumable(step, state0, batch_fn, steps=10,
                                  ckpt_dir=d2, ckpt_every=3)
    assert last == 9 and _leaves_equal(ref, resumed)
    _, m_ref = step(ref, batch_fn(10))
    _, m_res = step(resumed, batch_fn(10))
    assert torch.equal(m_ref["loss"], m_res["loss"])


def test_straggler_monitor_as_the_reference():
    mon, ref = StepMonitor(ratio=2.0), RefStepMonitor(ratio=2.0)
    for t, dt in enumerate([0.1] * 5 + [0.15, 1.0, 0.1]):
        assert mon.record(t, dt) == ref.record(t, dt)
    assert mon.stragglers == ref.stragglers and len(mon.stragglers) == 1


@pytest.mark.parametrize("shape,names,lost", [
    ((16, 16), ("data", "model"), 3), ((2, 16, 16), ("pod", "data", "model"),
                                       17), ((4, 8), ("data", "model"), 0)])
def test_plan_elastic_remesh_as_the_reference(shape, names, lost):
    assert plan_elastic_remesh(shape, names, lost) == \
        ref_remesh(shape, names, lost)
    with pytest.raises(RuntimeError):
        plan_elastic_remesh((1, 4), ("data", "model"), lost=999)


# ------------------------------------------------------------------- CLI ---
def test_cli_smoke_on_the_cpu(capsys):
    state = train_cli.main(["--smoke", "--device", "cpu", "--steps", "3",
                            "--batch", "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert "arch=olmo-1b" in out and "step    2 loss" in out
    assert int(state.step) == 3


def test_cli_crash_and_resume(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "8", "--batch", "2",
            "--seq", "32", "--microbatches", "2", "--ckpt-every", "2"]
    whole = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                               "--fail-at", "5"])
    resumed = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert "finished at step 7" in capsys.readouterr().out
    assert _leaves_equal(whole, resumed)

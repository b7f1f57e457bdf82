"""The port's LM serving path against the reference package on the CPU,
at the smoke configs of the Mamba-2 SSM, the DeepSeek MoE (MLA and routed
experts) and the Jamba hybrid: the cases of ``tests/test_torch_models.py``
(its ``Case`` helpers, tolerances and docstring hold here too) for these
families, in a file of their own so that neither file sets the test
suite's wall alone.  The references of the routed families are compiled
with ``xla_allow_excess_precision`` off (``exact_jit``, ROADMAP C11).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import lm as RLM
from repro.models import moe as RMOE
from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import lm as TLM
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from test_torch_models import (B, POSITION_KEYS, ROUTED_ARCHS, S, TOL,
                               _case, _cur_lens, _flat, _leaves, _loss_gap,
                               _np, _rel, exact_jit)


@pytest.fixture(params=("mamba2-130m",) + ROUTED_ARCHS)
def case(request):
    return _case(request.param)


def test_prefill_matches_reference(case):
    logits, cache = case.api.prefill(case.params(), case.batch)
    ref_logits, ref_cache = case.ref_prefill
    assert logits.shape == ref_logits.shape and logits.dtype == torch.float32
    got = _flat(cache)
    assert set(got) == set(ref_cache)
    # bf16 K/V and conv states, f32 SSM states, as the reference's
    assert {k: str(t.dtype).removeprefix("torch.")
            for k, t in _leaves(cache).items()} == case.ref_prefill_dtypes
    if "k" in cache:
        assert cache["len"] == ref_cache["k"].shape[2]
    assert _rel(ref_logits, _np(logits)) < TOL
    for key, ref in ref_cache.items():
        assert got[key].shape == ref.shape, key
        assert _rel(ref, got[key]) < TOL, key


@pytest.mark.parametrize("run", ["scalar", "vector"])
def test_decode_matches_reference_at_every_step(case, run):
    """Teacher-forced decode, 12 steps: the logits at every step and the
    caches after; ``vector`` puts the two slots at different lengths."""
    logits, cache = case.port_run(run)
    ref_logits, ref_cache = case.ref_runs[run]
    for t in range(S):
        assert _rel(ref_logits[t], logits[t]) < TOL, t
    assert set(cache) == set(ref_cache)
    for key, ref in ref_cache.items():
        assert _rel(ref, cache[key]) < TOL, key
    # nothing was written beyond each slot's last position
    last = _cur_lens(S - 1) if run == "vector" else np.full(B, S)
    for key in set(cache) & POSITION_KEYS:
        for b in range(B):
            assert not cache[key][:, b, last[b]:].any(), key


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b"])
def test_rope_one_position_late_fails_the_cache(arch, monkeypatch):
    """The tolerance has teeth: RoPE at cur_len instead of cur_len - 1
    barely moves smoke-size logits but moves the K cache far past TOL."""
    case = _case(arch)
    rope = TA.apply_rope
    monkeypatch.setattr(TA, "apply_rope",
                        lambda x, pos, theta, freqs=None:
                        rope(x, pos + 1, theta, freqs))
    _, cache = case.port_run("vector")
    key = next(k for k in ("k", "self.k", "kv.k") if k in cache)
    assert _rel(case.ref_runs["vector"][1][key], cache[key]) > 4 * TOL


@pytest.mark.parametrize("arch", ["mamba2-130m", "deepseek-v2-236b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b"])
def test_loss_of_the_new_families_names_the_training_item(arch):
    """Every family's ``loss`` is ported (ROADMAP A9 (c)): within TOL of
    the reference's on the case's weights, V3's with its MTP term."""
    assert _loss_gap(arch) < TOL


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_decode_past_the_cache_with_drop_matches_reference(arch):
    """ROADMAP C8: with ``past_cache="drop"`` a length past the cache is
    served as the reference serves it (RoPE at the true position, the
    write dropped, attention over every position): 12 steps through an
    8-position cache, one slot LAG steps behind, against the reference's
    logits at every step and its caches after."""
    case = _case(arch)
    params, smax = case.params(), 8
    ref, port = case.rapi.init_cache(B, smax), case.api.init_cache(B, smax)
    dec = case.ref_jit(case.rapi.decode_step)
    for t in range(S):
        tok, n = case.batch["tokens"][:, t], _cur_lens(t)
        want, ref = dec(case.rparams, ref, jnp.asarray(tok), jnp.asarray(n))
        got, port = case.api.decode_step(params, port, tok, n,
                                         past_cache="drop")
        assert _rel(want, _np(got)) < TOL, t
    want, got = _flat(ref), _flat(port)
    for key in want:
        assert _rel(want[key], got[key]) < TOL, key
    with pytest.raises(ValueError, match="past_cache"):
        case.api.decode_step(params, port, tok, n, past_cache="clip")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_drop_guards_the_write_only_past_the_cache(arch, monkeypatch):
    """``past_cache="drop"`` guards the K/V write only where a host length
    runs past the cache, or where the lengths are a tensor: a step inside
    the cache is the plain write, bit for bit, and a tensor of lengths
    past it gives what the host lengths give."""
    case = _case(arch)
    params, smax = case.params(), 8
    guards = []

    def spy(inner):
        def step(*args, drop=False, **kw):
            if not kw.get("cross"):
                guards.append(drop)
            return inner(*args, drop=drop, **kw)
        return step

    monkeypatch.setattr(TA, "attention_decode", spy(TA.attention_decode))
    monkeypatch.setattr(TMLA, "mla_decode", spy(TMLA.mla_decode))
    tok = case.batch["tokens"][:, 0]

    def step(lens, **kw):
        guards.clear()
        logits, cache = case.api.decode_step(
            params, case.api.init_cache(B, smax), tok, lens, **kw)
        return logits, _leaves(cache), set(guards)

    inside = np.array([smax, 3], np.int32)
    plain, plain_cache, seen = step(inside)
    dropped, dropped_cache, seen_drop = step(inside, past_cache="drop")
    assert seen == seen_drop == {False}
    assert torch.equal(plain, dropped)
    assert all(torch.equal(plain_cache[k], dropped_cache[k])
               for k in plain_cache)
    past = np.array([smax + 3, 3], np.int32)
    host, host_cache, seen = step(past, past_cache="drop")
    dev, dev_cache, seen_dev = step(torch.from_numpy(past),
                                    past_cache="drop")
    assert seen == seen_dev == {True}
    assert torch.equal(host, dev)
    assert all(torch.equal(host_cache[k], dev_cache[k]) for k in host_cache)


def test_params_from_reference_keeps_the_mixer_leaves_f32():
    """The mixer's conv, decay, skip and gain leaves keep the reference's
    f32 values bit for bit; in_proj, out_proj and the embedding are its
    values rounded once to bf16."""
    case = _case("mamba2-130m")
    params = case.params()
    mixer = case.rparams["layers"]["mixer"]
    for i, blk in enumerate(params.layers):
        for name in ("conv_w", "A_log", "D", "dt_bias", "norm"):
            leaf = getattr(blk.mixer, name)
            assert leaf.dtype == torch.float32, name
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(mixer[name][i]))
        for name in ("in_proj", "out_proj"):
            leaf = getattr(blk.mixer, name)
            assert leaf.dtype == torch.bfloat16, name
            want = torch.as_tensor(np.array(mixer[name][i])).to(
                torch.bfloat16)
            assert torch.equal(leaf, want), name
    assert params.embed.dtype == torch.bfloat16
    assert not hasattr(params, "lm_head")               # tied


def test_ssm_init_draws_the_reference_distributions():
    """in_proj and out_proj bf16 N(0, 1)/sqrt(d_in); conv_w f32
    N(0, 1) * 0.2; A_log log(linspace(1, 16, H)), D ones, dt_bias zeros
    and norm ones, f32, as the reference's init_mamba."""
    cfg = get_arch("mamba2-130m").scaled(n_layers=1, vocab=1000)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    mixer = params.layers[0].mixer
    d_inner = cfg.ssm.expand * cfg.d_model
    H = d_inner // cfg.ssm.head_dim
    assert mixer.in_proj.shape == (cfg.d_model,
                                   2 * d_inner + 2 * cfg.ssm.d_state + H)
    for w, d_in in ((mixer.in_proj, cfg.d_model), (mixer.out_proj, d_inner)):
        assert w.dtype == torch.bfloat16
        assert abs(float(w.float().std()) * np.sqrt(d_in) - 1.0) < 0.01
    assert mixer.conv_w.dtype == torch.float32
    assert abs(float(mixer.conv_w.std()) - 0.2) < 0.01
    np.testing.assert_allclose(
        mixer.A_log.numpy(), np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)
    assert torch.equal(mixer.D, torch.ones(H))
    assert torch.equal(mixer.dt_bias, torch.zeros(H))
    assert torch.equal(mixer.norm, torch.ones(d_inner))
    assert all(not p.requires_grad for p in params.parameters())


def _ref_mla_block(rcfg):
    return exact_jit(lambda lp, h: RLM._mla_block(lp, rcfg, h, mesh=None,
                                                  dp_axes=("data",)))


def _ref_hybrid_layer(rcfg):
    """The reference's group position i over the whole sequence, as its
    ``group_fwd`` computes it: (h, (k, v) or the Mamba-2 state)."""
    moe_pos = [i for i in range(rcfg.attn_every) if i % 2 == 1] \
        if rcfg.moe.every_other else list(range(rcfg.attn_every))
    off = rcfg.attn_offset

    def layer(rg, h, i):
        def at(tree, j):
            return jax.tree.map(lambda x: x[j], tree)
        if i == off:
            a, st = RA.attention_forward(
                rg["attn"]["attn"], rcfg, RL.rms_norm(h, rg["attn"]["n1"]),
                kind="causal", return_kv=True)
            h = h + a
        else:
            h, st = RLM._mamba_block(at(rg["mamba"], i if i < off else i - 1),
                                     rcfg, h, return_state=True)
        hn = RL.rms_norm(h, rg["ffn_norms"][i])
        if i in moe_pos:
            f, _ = RMOE.moe_forward(at(rg["moe"], moe_pos.index(i)), rcfg, hn)
        else:
            f = RL.mlp(at(rg["mlp"], i - sum(j < i for j in moe_pos)), rcfg,
                       hn)
        return h + f, st
    return exact_jit(layer, static_argnums=2)


@pytest.mark.parametrize("arch", ROUTED_ARCHS)
def test_prefill_past_32_tokens_takes_the_capacity_path(arch, monkeypatch):
    """B x S = 48 tokens: the MoE layers take the capacity path, as the
    reference's do.  Here one ulp upstream can move a token across an
    expert's capacity cut-off, so the prefill is held block by block: the
    port's prefill runs with each of its blocks fed the reference's input
    and passing the reference's output on; every block's output and cache
    is within TOL of the reference's, and so are the logits and caches
    the port's prefill assembles from them."""
    case = _case(arch)
    rcfg = ref_smoke_config(arch)
    tokens = np.random.default_rng(9).integers(
        0, case.cfg.vocab, (2, 24)).astype(np.int32)
    want, ref = case.ref_jit(case.rapi.prefill)(
        case.rparams, {"tokens": jnp.asarray(tokens)})
    stream = {"h": jnp.asarray(case.rparams["embed"])[tokens].astype(
        jnp.bfloat16), "n": 0}
    gaps, capacity = [], []

    def as_torch(x):
        return torch.as_tensor(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)

    def forced(inner, ref_step):
        def block(*args):
            args = list(args)
            args[2] = as_torch(stream["h"])
            out, *rest = inner(*args)
            want_out, *want_rest = ref_step(stream["n"], stream["h"], *args)
            gaps.append(_rel(want_out, _np(out)))
            for w, g in zip(jax.tree_util.tree_leaves(want_rest[-1]),
                            torch.utils._pytree.tree_leaves(rest[-1])):
                gaps.append(_rel(w, _np(g)))
            stream["h"], stream["n"] = want_out, stream["n"] + 1
            return (as_torch(want_out), *rest)
        return block

    if case.cfg.family == "moe":
        nd = case.cfg.moe.first_dense
        ref_block = _ref_mla_block(rcfg)
        stacks = [("dense_layers", i) for i in range(nd)] + [
            ("moe_layers", i) for i in range(case.cfg.n_layers - nd)]
        monkeypatch.setattr(TLM, "_mla_block", forced(
            TLM._mla_block, lambda n, h, *a: ref_block(jax.tree.map(
                lambda x: x[stacks[n][1]], case.rparams[stacks[n][0]]), h)))
    else:
        ref_layer = _ref_hybrid_layer(rcfg)
        per = case.cfg.attn_every
        monkeypatch.setattr(TLM, "_hybrid_layer", forced(
            TLM._hybrid_layer, lambda n, h, *a: ref_layer(jax.tree.map(
                lambda x: x[n // per], case.rparams["groups"]), h, a[3])))
    inner = TMOE._capacity
    monkeypatch.setattr(TMOE, "_capacity",
                        lambda *a: capacity.append(a[2].shape[0]) or inner(*a))
    logits, cache = case.api.prefill(case.params(), {"tokens": tokens})
    assert capacity and set(capacity) == {48}
    assert stream["n"] == case.cfg.n_layers
    assert max(gaps) < TOL
    assert _rel(want, _np(logits)) < TOL
    ref, got = _flat(ref), _flat(cache)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert _rel(ref[key], got[key]) < TOL, key


def test_moe_init_draws_the_reference_distributions():
    """MLA projections and experts bf16 N(0, 1)/sqrt(d_in), the router f32
    N(0, 1) * 0.02, gains f32 ones, lm_head always (the reference gives
    this family one), V3's MTP head; every tensor on the model's device."""
    cfg = smoke_config("deepseek-v3-671b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert len(params.dense_layers) == cfg.moe.first_dense
    assert len(params.moe_layers) == cfg.n_layers - cfg.moe.first_dense
    blk = params.moe_layers[0]
    assert not hasattr(blk, "mlp") and not hasattr(params.dense_layers[0],
                                                    "moe")
    wq_a = blk.attn.wq_a
    assert wq_a.dtype == torch.bfloat16
    assert abs(float(wq_a.float().std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    for name in ("q_norm", "kv_norm"):
        assert torch.equal(getattr(blk.attn, name),
                           torch.ones_like(getattr(blk.attn, name)))
    assert blk.moe.router.dtype == torch.float32
    assert abs(float(blk.moe.router.std()) - 0.02) < 2e-3
    wd = blk.moe.wd
    assert wd.dtype == torch.bfloat16
    assert abs(float(wd.float().std()) * np.sqrt(cfg.moe.d_expert) - 1) < 0.05
    assert params.lm_head.shape == (cfg.d_model, cfg.vocab_padded)
    assert params.mtp.proj.shape == (2 * cfg.d_model, cfg.d_model)
    assert hasattr(params.mtp.block, "mlp")
    assert params.mtp.norm.dtype == torch.float32
    assert all(not p.requires_grad for p in params.parameters())
    assert all(t.device.type == "cpu" for t in params.parameters())


def test_hybrid_init_lays_out_the_reference_group():
    """One group of attn_every layers: attn_every - 1 Mamba-2 blocks, one
    attention layer, MoE at the odd positions and dense MLPs at the even
    ones, ffn_norms (attn_every, d) f32 ones."""
    cfg = smoke_config("jamba-v0.1-52b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    per = cfg.attn_every
    assert len(params.groups) == cfg.n_layers // per
    grp = params.groups[0]
    assert len(grp.mamba) == per - 1
    assert len(grp.moe) == len(grp.mlp) == per // 2     # every_other
    assert grp.moe[0].router.dtype == torch.float32
    assert grp.moe[0].wg.dtype == torch.bfloat16
    assert grp.attn.attn.wq.dtype == torch.bfloat16
    assert torch.equal(grp.ffn_norms, torch.ones(per, cfg.d_model))
    assert params.lm_head.dtype == torch.bfloat16      # untied
    assert all(not p.requires_grad for p in params.parameters())


def test_params_from_reference_carries_mtp_and_keeps_the_router_f32():
    """DeepSeek-V3: the MTP head (not stacked) carried across, the routers
    and the gains bit for bit f32, the expert weights rounded once to
    bf16."""
    case = _case("deepseek-v3-671b")
    params = case.params()
    ref = case.rparams
    np.testing.assert_array_equal(params.mtp.norm.numpy(),
                                  np.asarray(ref["mtp"]["norm"]))
    want = torch.as_tensor(np.array(ref["mtp"]["proj"])).to(torch.bfloat16)
    assert torch.equal(params.mtp.proj, want)
    want = torch.as_tensor(np.array(
        ref["mtp"]["block"]["attn"]["wkv_a"])).to(torch.bfloat16)
    assert torch.equal(params.mtp.block.attn.wkv_a, want)
    for i, blk in enumerate(params.moe_layers):
        np.testing.assert_array_equal(
            blk.moe.router.numpy(),
            np.asarray(ref["moe_layers"]["moe"]["router"][i]))
        np.testing.assert_array_equal(
            blk.attn.kv_norm.numpy(),
            np.asarray(ref["moe_layers"]["attn"]["kv_norm"][i]))
        want = torch.as_tensor(np.array(
            ref["moe_layers"]["moe"]["wu"][i])).to(torch.bfloat16)
        assert torch.equal(blk.moe.wu, want)
        assert blk.moe.router.dtype == torch.float32


def test_params_from_reference_unstacks_the_hybrid_groups_twice():
    """``groups`` is stacked over the groups and, within a group, over its
    Mamba-2 blocks, MoEs and MLPs: every copied leaf is its reference
    slice."""
    case = _case("jamba-v0.1-52b")
    params = case.params()
    grp = case.rparams["groups"]
    for g, gp in enumerate(params.groups):
        for mi, blk in enumerate(gp.mamba):
            np.testing.assert_array_equal(
                blk.mixer.A_log.numpy(),
                np.asarray(grp["mamba"]["mixer"]["A_log"][g, mi]))
        for oi, moe in enumerate(gp.moe):
            np.testing.assert_array_equal(
                moe.router.numpy(), np.asarray(grp["moe"]["router"][g, oi]))
        for ei, mlp in enumerate(gp.mlp):
            want = torch.as_tensor(np.array(
                grp["mlp"]["wd"][g, ei])).to(torch.bfloat16)
            assert torch.equal(mlp.wd, want)
        np.testing.assert_array_equal(gp.ffn_norms.numpy(),
                                      np.asarray(grp["ffn_norms"][g]))


@pytest.mark.parametrize("arch,key,change", [
    ("deepseek-v2-236b", "wq_b", lambda c: dict(mla=dataclasses.replace(
        c.mla, nope_dim=8))),
    ("deepseek-v2-236b", "stacks 3 moe_layers", lambda c: dict(n_layers=3)),
    ("deepseek-v3-671b", "mtp", lambda c: dict(mtp=False)),
    ("jamba-v0.1-52b", "stacks 1 groups", lambda c: dict(n_layers=16)),
    ("jamba-v0.1-52b", "ffn_norms", lambda c: dict(attn_every=6,
                                                    n_layers=6)),
    ("jamba-v0.1-52b", "wg", lambda c: dict(moe=dataclasses.replace(
        c.moe, d_expert=16)))])
def test_params_from_reference_refuses_a_routed_tree_of_another_shape(
        arch, key, change):
    """A leaf of another shape, a stack of another depth, or a tree whose
    MTP head the config does not hold, is refused by name."""
    tree = _case(arch).rparams
    cfg = smoke_config(arch)
    with pytest.raises(ValueError, match=key):
        params_from_reference(cfg.scaled(**change(cfg)), tree, device="cpu")

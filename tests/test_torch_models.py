"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.models``)
against the reference package on the CPU, at the families' smoke configs:
the dense and VLM decoders, the encoder-decoder and the Mamba-2 SSM.

Both packages run on the same weights: the reference's ``init`` with its
norm gains (and the Mamba-2 mixer's ``D`` and ``dt_bias``) redrawn from a
seed (so a missing gain shows), converted by ``params_from_reference``.
Inputs are seeded numpy.  Caches are compared leaf by leaf: K and V
(``self.*`` and ``cross.*`` for the encoder-decoder), or the SSM's
``h`` and ``conv`` states.  The bf16 compute
of the two frameworks is not bit-identical: XLA's bf16 ``silu``/``gelu``
and the transcendentals round differently from torch's in a large share
of elements, and those few-ulp differences travel through the layers, so
logits and caches are held to ``TOL`` of their largest magnitude: the
worst gap measured across the five dense and VLM archs was 1.72e-2
(decode logits, qwen3-32b; the K cache 1.52e-2), and ``TOL`` is about
2.3x that; the encoder-decoder's worst is 1.06e-2 (decode logits), and
the mamba2 smoke model's logits and conv states equal the reference's
(its f32 SSM state within 1.5e-7).  The
two mutants below (RoPE one position late, qk-norm without its gains)
land far outside it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_arch as ref_get_arch
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as RA
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro_torch.configs import ARCH_NAMES, get_arch, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import layers as TL

TOL = 4e-2
ATTN_ARCHS = ("qwen3-4b", "qwen3-32b", "olmo-1b", "starcoder2-7b",
              "paligemma-3b", "seamless-m4t-large-v2")
ARCHS = ATTN_ARCHS + ("mamba2-130m",)
B, S, SMAX = 2, 12, 16
S_ENC = 10          # the encoder-decoder's source frames
LAG = 3             # the vector run's second slot starts LAG steps later
GAINS = ("q_gamma", "k_gamma", "n1", "nx", "n2", "final_norm", "enc_norm",
         "norm", "D", "dt_bias")


def _rel(ref, got) -> float:
    """max |got - ref| over max |ref| (max |got| where ref is all zero,
    as the engine's cross K/V are)."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    top = np.abs(ref).max()
    return float(np.abs(got - ref).max() / top if top else np.abs(got).max())


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _redraw_gains(tree, rng):
    """The reference's tree with every norm gain drawn from 1 + N(0, 0.5)."""
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(1.0 + 0.5 * rng.standard_normal(np.shape(v)),
                            jnp.float32)
                if k in GAINS and v is not None else _redraw_gains(v, rng))
            for k, v in tree.items()}


def _leaves(cache) -> dict:
    """A cache's tensors by name: ``k``/``v``, ``self.k`` ... ``cross.v``,
    or the SSM's ``h``/``conv``."""
    if isinstance(cache, (tuple, list)):
        cache = {"h": cache[0], "conv": cache[1]}
    out = {}
    for key, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{key}.{k}": x for k, x in v.items()})
        elif key != "len":
            out[key] = v
    return out


def _flat(cache) -> dict:
    """``_leaves`` as f32 numpy arrays."""
    return {k: _np(v) if torch.is_tensor(v) else np.asarray(v, np.float32)
            for k, v in _leaves(cache).items()}


def _cur_lens(t):
    """Step t's (B,) lengths of the vector run: slot 1 replays position 1
    until it starts LAG steps after slot 0, as an engine's idle slot does."""
    return np.array([t + 1, max(t + 1 - LAG, 1)], np.int32)


def _run_decode(decode, cache, tokens, lens_of):
    logits = []
    for t in range(S):
        out, cache = decode(cache, tokens[:, t], lens_of(t))
        logits.append(np.asarray(out, np.float32) if not torch.is_tensor(out)
                      else _np(out))
    return logits, cache


class Case:
    """One arch on shared weights: the reference's prefill and its decode
    runs (scalar and per-slot lengths), computed once."""

    def __init__(self, arch):
        self.cfg = smoke_config(arch)
        self.rapi = ref_build_model(ref_smoke_config(arch), remat="none")
        self.rparams = _redraw_gains(self.rapi.init(jax.random.PRNGKey(0)),
                                     np.random.default_rng(1))
        self.api = build_model(self.cfg, device="cpu")
        rng = np.random.default_rng(0)
        self.batch = {"tokens": rng.integers(0, self.cfg.vocab, (B, S)
                                             ).astype(np.int32)}
        if self.cfg.prefix_len:
            self.batch["patches"] = rng.standard_normal(
                (B, self.cfg.prefix_len, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "encdec":
            self.batch["src_embeds"] = rng.standard_normal(
                (B, S_ENC, self.cfg.d_model)).astype(np.float32)
        logits, cache = jax.jit(self.rapi.prefill)(
            self.rparams, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.ref_prefill = (np.asarray(logits), _flat(cache))
        self.ref_prefill_dtypes = {k: str(v.dtype)
                                   for k, v in _leaves(cache).items()}
        self.ref_prefill_cache = cache
        dec = jax.jit(self.rapi.decode_step)
        self.ref_runs = {}
        for name, lens_of in (("scalar", lambda t: t + 1),
                              ("vector", _cur_lens)):
            logits, cache = _run_decode(
                lambda c, tok, n: dec(self.rparams, c, jnp.asarray(tok),
                                      jnp.asarray(n)),
                self.rapi.init_cache(B, SMAX), self.batch["tokens"], lens_of)
            self.ref_runs[name] = (logits, _flat(cache))

    def params(self):
        return params_from_reference(self.cfg, self.rparams, device="cpu")

    def port_run(self, name, params=None):
        params = self.params() if params is None else params
        lens_of = (lambda t: t + 1) if name == "scalar" else _cur_lens
        logits, cache = _run_decode(
            lambda c, tok, n: self.api.decode_step(params, c, tok, n),
            self.api.init_cache(B, SMAX), self.batch["tokens"], lens_of)
        return logits, _flat(cache)


_CASES: dict = {}


def _case(arch) -> Case:
    if arch not in _CASES:
        _CASES[arch] = Case(arch)
    return _CASES[arch]


@pytest.fixture(params=ARCHS)
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
    for key in set(cache) & {"k", "v", "self.k", "self.v"}:
        for b in range(B):
            assert not cache[key][:, b, last[b]:].any(), key


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_rope_one_position_late_fails_the_cache(arch, monkeypatch):
    """The tolerance has teeth: RoPE at cur_len instead of cur_len - 1
    barely moves smoke-size logits but moves the K cache far past TOL."""
    case = _case(arch)
    rope = TA.apply_rope
    monkeypatch.setattr(TA, "apply_rope",
                        lambda x, pos, theta, freqs=None:
                        rope(x, pos + 1, theta, freqs))
    _, cache = case.port_run("vector")
    key = "k" if "k" in cache else "self.k"
    assert _rel(case.ref_runs["vector"][1][key], cache[key]) > 4 * TOL


def test_encdec_decode_runs_from_the_prefill_cross_cache():
    """The reference's own test skips this (its engine decodes against
    zero cross K/V): decode from prefill's cross K/V and a zero self cache
    gives the reference's logits at every step, and its last step the
    logits of prefill over the same tokens."""
    case = _case("seamless-m4t-large-v2")
    params = case.params()
    pre_logits, pre_cache = case.api.prefill(params, case.batch)
    port = {"self": case.api.init_cache(B, SMAX)["self"],
            "cross": pre_cache["cross"]}
    ref = {"self": case.rapi.init_cache(B, SMAX)["self"],
           "cross": case.ref_prefill_cache["cross"]}
    dec = jax.jit(case.rapi.decode_step)
    for t in range(S):
        tok = case.batch["tokens"][:, t]
        want, ref = dec(case.rparams, ref, jnp.asarray(tok), t + 1)
        got, port = case.api.decode_step(params, port, tok, t + 1)
        assert _rel(want, _np(got)) < TOL, t
    assert _rel(_np(pre_logits), _np(got)) < TOL
    assert _rel(case.ref_prefill[0], _np(got)) < TOL


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-32b"])
def test_qk_norm_without_its_gains_fails_the_logits(arch):
    case = _case(arch)
    params = case.params()
    for blk in params.layers:
        blk.attn.q_gamma.fill_(1.0)
        blk.attn.k_gamma.fill_(1.0)
    logits, _ = case.port_run("scalar", params)
    ref_logits = case.ref_runs["scalar"][0]
    assert max(_rel(r, g) for r, g in zip(ref_logits, logits)) > 4 * TOL


# ---------------------------------------------------------------- layers ---
def _bf16(rng, *shape):
    """Seeded values exactly representable in bf16, as (jax, torch)."""
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), x


def test_rms_norm_and_nonparam_layer_norm_match_reference():
    rng = np.random.default_rng(3)
    xj, xt = _bf16(rng, 3, 5, 64)
    g = rng.standard_normal(64).astype(np.float32)
    got = TL.rms_norm(xt, torch.as_tensor(g))
    assert got.dtype == torch.bfloat16
    assert _rel(RL.rms_norm(xj, jnp.asarray(g)), _np(got)) < 1e-2
    assert _rel(RL.rms_norm(xj), _np(TL.rms_norm(xt))) < 1e-2
    assert _rel(RL.nonparam_layer_norm(xj),
                _np(TL.nonparam_layer_norm(xt))) < 1e-2
    x32 = rng.standard_normal((4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.as_tensor(x32), torch.as_tensor(g))),
        np.asarray(RL.rms_norm(jnp.asarray(x32), jnp.asarray(g))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 40_000, (2, 7))
    np.testing.assert_allclose(
        _np(TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(
        TL.rope_table(16, theta).numpy(),
        np.asarray(jnp.asarray(RL.rope_freqs(16, theta), jnp.float32)))


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_decode_attention_matches_reference(hkv):
    """Masked by a per-slot vector cur_len (and a scalar), GQA and MQA."""
    rng = np.random.default_rng(5 + hkv)
    Bq, smax, H, hd = 3, 20, 4, 16
    qj, qt = _bf16(rng, Bq, 1, H, hd)
    kj, kt = _bf16(rng, Bq, smax, hkv, hd)
    vj, vt = _bf16(rng, Bq, smax, hkv, hd)
    for cur in (np.array([1, 9, 20], np.int32), 13):
        ref = RL.decode_attention(qj, kj, vj, jnp.asarray(cur))
        got = TL.decode_attention(qt, kt, vt, torch.as_tensor(cur))
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        # f32 scores and softmax; one bf16 rounding of the output
        assert _rel(ref, _np(got)) < 1e-2


@pytest.mark.parametrize("kind,prefix", [("causal", 0), ("prefix", 5),
                                          ("full", 0)])
def test_blockwise_attention_matches_reference(kind, prefix):
    """Several q and KV blocks (24 positions in blocks of 8 and 6)."""
    rng = np.random.default_rng(6)
    qj, qt = _bf16(rng, 2, 24, 4, 16)
    kj, kt = _bf16(rng, 2, 24, 2, 16)
    vj, vt = _bf16(rng, 2, 24, 2, 16)
    ref = RL.blockwise_attention(qj, kj, vj, kind=kind, prefix_len=prefix,
                                 block_q=8, block_kv=7)
    got = TL.blockwise_attention(qt, kt, vt, kind=kind, prefix_len=prefix,
                                 block_q=8, block_kv=7)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _rel(ref, _np(got)) < 1e-2
    assert TL._pick(24, 7) == 6 and TL._pick(24, 8) == 8


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    cfg = dataclasses.replace(smoke_config("qwen3-4b"), act=act)
    ref = RL.init_mlp(jax.random.PRNGKey(2), cfg)
    port = TL.MLP(cfg)
    with torch.no_grad():
        for name, w in ref.items():
            getattr(port, name).copy_(torch.as_tensor(np.array(w)))
    xj, xt = _bf16(np.random.default_rng(7), 2, 3, cfg.d_model)
    assert _rel(RL.mlp(ref, cfg, xj), _np(TL.mlp(port, cfg, xt))) < TOL


def test_cross_attention_matches_reference():
    """Cross attention (no RoPE, full mask): the forward pass over a
    memory and a decode step against static K/V."""
    cfg = smoke_config("qwen3-4b")
    ref = RA.init_attention(jax.random.PRNGKey(3), cfg)
    port = TA.Attention(cfg)
    with torch.no_grad():
        for name, w in ref.items():
            getattr(port, name).copy_(torch.as_tensor(np.array(w)))
    rng = np.random.default_rng(8)
    xj, xt = _bf16(rng, 2, 5, cfg.d_model)
    mj, mt = _bf16(rng, 2, 7, cfg.d_model)
    want, (rk, rv) = RA.attention_forward(ref, cfg, xj, memory=mj,
                                          return_kv=True)
    got, (k, v) = TA.attention_forward(port, cfg, xt, memory=mt,
                                       return_kv=True)
    assert _rel(want, _np(got)) < TOL
    assert _rel(rk, _np(k)) < TOL and _rel(rv, _np(v)) < TOL
    cache = {"k": k, "v": v}
    want, _ = RA.attention_decode(ref, cfg, xj[:, :1], {"k": rk, "v": rv},
                                  3, cross=True)
    got, same = TA.attention_decode(port, cfg, xt[:, :1], cache, 3,
                                    cross=True)
    assert _rel(want, _np(got)) < TOL and same is cache


# --------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_configs_equal_reference(arch):
    assert ARCH_NAMES == REF_ARCH_NAMES
    assert dataclasses.asdict(get_arch(arch)) == \
        dataclasses.asdict(ref_get_arch(arch))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(ref_smoke_config(arch))


def test_retrieval_config_equals_reference():
    from repro.configs import dco_bench as ref_bench
    from repro_torch.configs import dco_bench
    assert dataclasses.asdict(dco_bench.CONFIG) == \
        dataclasses.asdict(ref_bench.CONFIG)


@pytest.mark.parametrize("arch,family", [
    ("deepseek-v2-236b", "moe"), ("jamba-v0.1-52b", "hybrid")])
def test_unported_families_name_their_item(arch, family):
    with pytest.raises(NotImplementedError, match=rf"{family}.*A9 \(b\)"):
        build_model(smoke_config(arch), device="cpu")


def test_loss_names_the_training_item():
    api = build_model(smoke_config("qwen3-4b"), device="cpu")
    with pytest.raises(NotImplementedError, match=r"A9 \(c\)"):
        api.loss(None, {})


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "mamba2-130m"])
def test_loss_of_the_new_families_names_the_training_item(arch):
    api = build_model(smoke_config(arch), device="cpu")
    with pytest.raises(NotImplementedError, match=r"A9 \(c\)"):
        api.loss(None, {})


def test_decode_refuses_a_length_outside_the_cache():
    cfg = smoke_config("olmo-1b")
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    cache = api.init_cache(2, 8)
    for bad in (0, 9, np.array([3, 0])):
        with pytest.raises(ValueError, match="cur_len"):
            api.decode_step(params, cache, np.zeros(2, np.int32), bad)


def test_init_draws_the_reference_distributions():
    """bf16 weights N(0, 1)/sqrt(d_in), the embedding N(0, 1) * 0.02 over
    vocab_padded rows, gains f32 ones; every tensor on the model's device."""
    cfg = get_arch("olmo-1b").scaled(n_layers=1, vocab=1000)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert params.embed.shape == (cfg.vocab_padded, cfg.d_model)
    assert params.embed.dtype == torch.bfloat16
    assert abs(float(params.embed.float().std()) - 0.02) < 1e-3
    wq = params.layers[0].attn.wq
    assert wq.dtype == torch.bfloat16
    assert abs(float(wq.float().std()) * np.sqrt(cfg.d_model) - 1.0) < 0.01
    assert params.layers[0].n1 is None                  # nonparam_ln
    assert params.final_norm.dtype == torch.float32
    assert not hasattr(params, "lm_head")               # tied
    assert all(not p.requires_grad for p in params.parameters())


def test_params_from_reference_refuses_a_tree_of_another_shape():
    tree = _case("qwen3-4b").rparams
    with pytest.raises(ValueError, match="wg"):
        params_from_reference(smoke_config("qwen3-4b").scaled(d_ff=96), tree,
                              device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        params_from_reference(
            smoke_config("qwen3-4b").scaled(tie_embeddings=False), tree,
            device="cpu")


@pytest.mark.parametrize("arch,key,change", [
    ("seamless-m4t-large-v2", "w1", dict(d_ff=96)),
    ("seamless-m4t-large-v2", "stacks 2 enc", dict(enc_layers=1)),
    ("mamba2-130m", "conv_w", dict(ssm=dataclasses.replace(
        smoke_config("mamba2-130m").ssm, d_conv=3)))])
def test_params_from_reference_refuses_a_new_family_tree_of_another_shape(
        arch, key, change):
    tree = _case(arch).rparams
    with pytest.raises(ValueError, match=key):
        params_from_reference(smoke_config(arch).scaled(**change), tree,
                              device="cpu")


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


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-large-v2"])
def test_decode_past_the_cache_with_drop_matches_reference(arch):
    """ROADMAP C8: with ``past_cache="drop"`` a length past the cache is
    served as the reference serves it (RoPE at the true position, the
    write dropped, attention over every position): 12 steps through an
    8-position cache, one slot LAG steps behind, against the reference's
    logits at every step and its caches after."""
    case = _case(arch)
    params, smax = case.params(), 8
    ref, port = case.rapi.init_cache(B, smax), case.api.init_cache(B, smax)
    dec = jax.jit(case.rapi.decode_step)
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


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-large-v2"])
def test_drop_guards_the_write_only_past_the_cache(arch, monkeypatch):
    """``past_cache="drop"`` guards the K/V write only where a host length
    runs past the cache, or where the lengths are a tensor: a step inside
    the cache is the plain write, bit for bit, and a tensor of lengths
    past it gives what the host lengths give."""
    case = _case(arch)
    params, smax = case.params(), 8
    guards = []
    inner = TA.attention_decode

    def spy(*args, drop=False, **kw):
        if not kw.get("cross"):
            guards.append(drop)
        return inner(*args, drop=drop, **kw)

    monkeypatch.setattr(TA, "attention_decode", spy)
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


def test_params_from_reference_names_the_item_of_an_unported_family():
    with pytest.raises(NotImplementedError, match=r"moe.*A9 \(b\)"):
        params_from_reference(smoke_config("deepseek-v2-236b"), {},
                              device="cpu")

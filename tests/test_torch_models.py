"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.models``)
against the reference package on the CPU, at the families' smoke configs:
the dense and VLM decoders and the encoder-decoder here; the Mamba-2 SSM,
the DeepSeek MoE (MLA and routed experts) and the Jamba hybrid in
``tests/test_torch_models_routed.py``, which runs this file's ``Case``
on those families (the two files split the cases so that neither sets
the test suite's wall alone).

Both packages run on the same weights: the reference's ``init`` with its
norm gains (and the Mamba-2 mixer's ``D`` and ``dt_bias``) redrawn from a
seed (so a missing gain shows), converted by ``params_from_reference``.
Inputs are seeded numpy.  Caches are compared leaf by leaf: K and V
(``self.*`` and ``cross.*`` for the encoder-decoder), or the SSM's
``h`` and ``conv`` states (``dense.c_kv`` ... ``moe.k_rope`` for the
MoE, ``kv.*`` and ``ssm.*`` for the hybrid).  The bf16 compute of the
two frameworks is not bit-identical: under a plain ``jax.jit`` XLA keeps
f32 inside fused bf16 ops, its ``gelu`` and transcendentals round
otherwise than torch's, and those few-ulp differences travel through the
layers, so logits and caches are held to ``TOL`` of their largest
magnitude: the worst gap measured across the five dense and VLM archs
is 1.97e-2 (decode logits, qwen3-32b; the K cache 2.52e-2), and ``TOL``
is about 1.6x that; the encoder-decoder's worst is 1.06e-2 (decode
logits), and the mamba2 smoke model's logits and conv states equal the
reference's (its f32 SSM state within 1.5e-7).  The two mutants below
(RoPE one position late, qk-norm without its gains) land far outside
it.

The MoE and hybrid families run the reference compiled with
``xla_allow_excess_precision`` off (``exact_jit``), so its bf16 ops round
one by one as its code is written, as the port's do (``layers.silu`` is
``jax.nn.silu`` op by op): with excess precision, on these smoke models,
the reference moves by up to 0.59 of max |logits| against its own eager
run, where a one-ulp change flips a near-tied expert
(``tests/test_torch_moe.py``).  Against it the port's prefill is equal
or within 1.94e-2 and its decode within 2.45e-2 (jamba; the caches
within 2.40e-2, DeepSeek-V2's equal).  Past 32 tokens the capacity
cut-off is a second discontinuity, and that prefill is held block by
block (``test_prefill_past_32_tokens_takes_the_capacity_path``).
"""
import dataclasses
import functools

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
from repro.models import lm as RLM
from repro.models import moe as RMOE
from repro_torch.configs import ARCH_NAMES, get_arch, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE

TOL = 4e-2
ATTN_ARCHS = ("qwen3-4b", "qwen3-32b", "olmo-1b", "starcoder2-7b",
              "paligemma-3b", "seamless-m4t-large-v2")
ROUTED_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", "jamba-v0.1-52b")
ARCHS = ATTN_ARCHS + ("mamba2-130m",) + ROUTED_ARCHS
B, S, SMAX = 2, 12, 16
S_ENC = 10          # the encoder-decoder's source frames
LAG = 3             # the vector run's second slot starts LAG steps later
GAINS = ("q_gamma", "k_gamma", "n1", "nx", "n2", "final_norm", "enc_norm",
         "norm", "D", "dt_bias", "q_norm", "kv_norm", "ffn_norms")
#: the references of the routed families: bf16 ops rounded one by one
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})
#: the caches that hold positions (written only up to each slot's length)
POSITION_KEYS = {"k", "v", "self.k", "self.v", "kv.k", "kv.v", "dense.c_kv",
                 "dense.k_rope", "moe.c_kv", "moe.k_rope"}


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
    the SSM's ``h``/``conv``, the MoE's ``dense.c_kv`` ... ``moe.k_rope``
    or the hybrid's ``kv.k``, ``kv.v``, ``ssm.h``, ``ssm.conv``."""
    if isinstance(cache, (tuple, list)):
        cache = {"h": cache[0], "conv": cache[1]}
    out = {}
    for key, v in cache.items():
        if isinstance(v, (tuple, list)):
            v = {"h": v[0], "conv": v[1]}
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
        self.ref_jit = exact_jit if arch in ROUTED_ARCHS else jax.jit
        rng = np.random.default_rng(0)
        self.batch = {"tokens": rng.integers(0, self.cfg.vocab, (B, S)
                                             ).astype(np.int32)}
        if self.cfg.prefix_len:
            self.batch["patches"] = rng.standard_normal(
                (B, self.cfg.prefix_len, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "encdec":
            self.batch["src_embeds"] = rng.standard_normal(
                (B, S_ENC, self.cfg.d_model)).astype(np.float32)
        logits, cache = self.ref_jit(self.rapi.prefill)(
            self.rparams, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.ref_prefill = (np.asarray(logits), _flat(cache))
        self.ref_prefill_dtypes = {k: str(v.dtype)
                                   for k, v in _leaves(cache).items()}
        self.ref_prefill_cache = cache
        dec = self.ref_jit(self.rapi.decode_step)
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


@pytest.fixture(params=ATTN_ARCHS)
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
    key = next(k for k in ("k", "self.k", "kv.k") if k in cache)
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


@pytest.mark.parametrize("scale", [0.5, 4.0])
def test_silu_equals_the_reference_bit_for_bit_in_bf16(scale):
    """``layers.silu`` rounds each of ``jax.nn.silu``'s bf16 ops as the
    reference does (``F.silu``, which rounds once, differs in about 40 %
    of elements); in f32 the two agree to an ulp."""
    rng = np.random.default_rng(11)
    xj, xt = _bf16(rng, 64, 512)
    xj, xt = xj * scale, (xt.float() * scale).to(torch.bfloat16)
    want = np.asarray(exact_jit(jax.nn.silu)(xj).astype(jnp.float32))
    np.testing.assert_array_equal(_np(TL.silu(xt)), want)
    assert (_np(torch.nn.functional.silu(xt)) != want).mean() > 0.2
    np.testing.assert_allclose(
        _np(TL.silu(xt.float())),
        np.asarray(jax.nn.silu(xj.astype(jnp.float32))), rtol=1e-6,
        atol=1e-7)


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
    ("deepseek-v2-236b", "mixture"), ("jamba-v0.1-52b", "transformer")])
def test_an_unknown_family_raises(arch, family):
    """Every family of the reference is served; another name is refused."""
    cfg = dataclasses.replace(smoke_config(arch), family=family)
    with pytest.raises(ValueError, match=rf"unknown model family '{family}'"):
        build_model(cfg, device="cpu")


def _loss_gap(arch) -> float:
    """The port's loss against the reference's on the bf16 cast of the
    case's weights (the train step's cast of every f32 leaf), on the
    prefill batch; both references compiled with excess precision off."""
    case = _case(arch)
    half = jax.tree.map(lambda p: p.astype(jnp.bfloat16), case.rparams)
    want, _ = exact_jit(case.rapi.loss)(
        half, {k: jnp.asarray(v) for k, v in case.batch.items()})
    params = case.params()
    for p in params.parameters():
        p.data = p.data.to(torch.bfloat16)
    with torch.no_grad():
        got, _ = case.api.loss(params, case.batch)
    return abs(float(got) - float(want)) / abs(float(want))


def test_loss_names_the_training_item():
    """``loss`` is ported (ROADMAP A9 (c)): qwen3-4b's within TOL of the
    reference's (``tests/test_torch_train.py`` holds every family's loss
    and grads to 1e-3)."""
    assert _loss_gap("qwen3-4b") < TOL


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2"])
def test_loss_of_the_new_families_names_the_training_item(arch):
    """Every family's ``loss`` is ported (ROADMAP A9 (c)): within TOL of
    the reference's on the case's weights, V3's with its MTP term."""
    assert _loss_gap(arch) < TOL


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


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-large-v2"])
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


def test_params_from_reference_refuses_an_unknown_family():
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              family="mixture")
    with pytest.raises(ValueError, match="unknown model family 'mixture'"):
        params_from_reference(cfg, {}, device="cpu")


# ------------------------------------------------- moe and hybrid families ---

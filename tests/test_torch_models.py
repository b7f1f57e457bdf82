"""The port's LM serving path (``repro_torch.configs``, ``repro_torch.models``)
against the reference package on the CPU, at the families' smoke configs.

Both packages run on the same weights: the reference's ``init`` with its
norm gains redrawn from a seed (so a missing gain shows), converted by
``params_from_reference``.  Inputs are seeded numpy.  The bf16 compute
of the two frameworks is not bit-identical: XLA's bf16 ``silu``/``gelu``
and the transcendentals round differently from torch's in a large share
of elements, and those few-ulp differences travel through the layers, so
logits and caches are held to ``TOL`` of their largest magnitude: the
worst gap measured across the five archs was 1.72e-2 (decode logits,
qwen3-32b; the K cache 1.52e-2), and ``TOL`` is about 2.3x that.  The
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
ARCHS = ("qwen3-4b", "qwen3-32b", "olmo-1b", "starcoder2-7b", "paligemma-3b")
B, S, SMAX = 2, 12, 16
LAG = 3             # the vector run's second slot starts LAG steps later
GAINS = ("q_gamma", "k_gamma", "n1", "n2", "final_norm")


def _rel(ref, got) -> float:
    """max |got - ref| over max |ref|."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


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
        logits, cache = jax.jit(self.rapi.prefill)(
            self.rparams, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.ref_prefill = (np.asarray(logits), np.asarray(cache["k"],
                                                           np.float32),
                            np.asarray(cache["v"], np.float32))
        dec = jax.jit(self.rapi.decode_step)
        self.ref_runs = {}
        for name, lens_of in (("scalar", lambda t: t + 1),
                              ("vector", _cur_lens)):
            logits, cache = _run_decode(
                lambda c, tok, n: dec(self.rparams, c, jnp.asarray(tok),
                                      jnp.asarray(n)),
                self.rapi.init_cache(B, SMAX), self.batch["tokens"], lens_of)
            self.ref_runs[name] = (logits, np.asarray(cache["k"], np.float32),
                                   np.asarray(cache["v"], np.float32))

    def params(self):
        return params_from_reference(self.cfg, self.rparams, device="cpu")

    def port_run(self, name, params=None):
        params = self.params() if params is None else params
        lens_of = (lambda t: t + 1) if name == "scalar" else _cur_lens
        logits, cache = _run_decode(
            lambda c, tok, n: self.api.decode_step(params, c, tok, n),
            self.api.init_cache(B, SMAX), self.batch["tokens"], lens_of)
        return logits, _np(cache["k"]), _np(cache["v"])


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
    ref_logits, ref_k, ref_v = case.ref_prefill
    assert logits.shape == ref_logits.shape and logits.dtype == torch.float32
    assert cache["k"].shape == ref_k.shape and cache["k"].dtype == TL.CDTYPE
    assert cache["len"] == ref_k.shape[2]
    assert _rel(ref_logits, _np(logits)) < TOL
    assert _rel(ref_k, _np(cache["k"])) < TOL
    assert _rel(ref_v, _np(cache["v"])) < TOL


@pytest.mark.parametrize("run", ["scalar", "vector"])
def test_decode_matches_reference_at_every_step(case, run):
    """Teacher-forced decode, 12 steps: the logits at every step and the
    caches after; ``vector`` puts the two slots at different lengths."""
    logits, k, v = case.port_run(run)
    ref_logits, ref_k, ref_v = case.ref_runs[run]
    for t in range(S):
        assert _rel(ref_logits[t], logits[t]) < TOL, t
    assert _rel(ref_k, k) < TOL and _rel(ref_v, v) < TOL
    # nothing was written beyond each slot's last position
    last = _cur_lens(S - 1) if run == "vector" else np.full(B, S)
    for b in range(B):
        assert not k[:, b, last[b]:].any() and not v[:, b, last[b]:].any()


def test_rope_one_position_late_fails_the_cache(case, monkeypatch):
    """The tolerance has teeth: RoPE at cur_len instead of cur_len - 1
    barely moves smoke-size logits but moves the K cache far past TOL."""
    rope = TA.apply_rope
    monkeypatch.setattr(TA, "apply_rope",
                        lambda x, pos, theta, freqs=None:
                        rope(x, pos + 1, theta, freqs))
    _, k, _ = case.port_run("vector")
    assert _rel(case.ref_runs["vector"][1], k) > 4 * TOL


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-32b"])
def test_qk_norm_without_its_gains_fails_the_logits(arch):
    case = _case(arch)
    params = case.params()
    for blk in params.layers:
        blk.attn.q_gamma.fill_(1.0)
        blk.attn.k_gamma.fill_(1.0)
    logits, _, _ = case.port_run("scalar", params)
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
    ("deepseek-v2-236b", "moe"), ("mamba2-130m", "ssm"),
    ("jamba-v0.1-52b", "hybrid"), ("seamless-m4t-large-v2", "encdec")])
def test_unported_families_name_their_item(arch, family):
    with pytest.raises(NotImplementedError, match=rf"{family}.*A9 \(b\)"):
        build_model(smoke_config(arch), device="cpu")


def test_loss_names_the_training_item():
    api = build_model(smoke_config("qwen3-4b"), device="cpu")
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

"""The port's training losses (``ModelApi.loss`` of every family, the
chunked cross entropy) and their gradients against the reference package
on the CPU, at every smoke config, and the two repairs the backward
needed (the Mamba-2 SSD's in-place decay, the f32-result GEMM's
derivative).

Both packages start from the reference's ``init_state`` (its f32 tree
carried across by ``convert.train_state_from_reference``) at a vocabulary
of 500 padded to 512, so the CE's mask of the padded columns is always
exercised, and both differentiate the loss on the bf16 cast of every
master, as both train steps do.  Every reference is compiled with
``xla_allow_excess_precision`` off (``exact_jit``), so its bf16 ops round
one by one as its code is written and as the port's do: under a plain
``jax.jit`` the f32 kept between fused bf16 ops alone moves qwen3-4b's
q_gamma grad by 5.3e-2 of its max, and the routed families' routing is
discontinuous (ROADMAP C11).  Tolerances: the loss within
``LOSS_RTOL`` (1e-3) relative for the dense, VLM, encoder-decoder and SSM
families and ``ROUTED_TOL`` (4e-2, the routed prefill tests' tolerance)
for the routed ones; every gradient leaf within ``GRAD_TOL`` (5e-2) of
that leaf's largest reference magnitude.  Measured on the CPU: losses
within 5.7e-4 relative (seamless; the routed ones within 9.3e-5),
gradients within 4.5e-2 (paligemma's embedding) of their leaf's max.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.train.train_step import init_state as ref_init_state
from repro_torch.configs import smoke_config
from repro_torch.convert import _model, reference_leaves, \
    train_state_from_reference
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import mamba2 as TM

ATTN_ARCHS = ("qwen3-4b", "qwen3-32b", "olmo-1b", "starcoder2-7b",
              "paligemma-3b", "seamless-m4t-large-v2")
ROUTED_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", "jamba-v0.1-52b")
ARCHS = ATTN_ARCHS + ("mamba2-130m",) + ROUTED_ARCHS
FAMILY_ARCHS = ("olmo-1b", "paligemma-3b", "seamless-m4t-large-v2",
                "mamba2-130m", "deepseek-v3-671b", "jamba-v0.1-52b")
VOCAB = 500                 # padded to 512 by the smoke configs' multiple
B, S = 2, 16                # 32 tokens: the MoE layers' dropless path
LOSS_RTOL = 1e-3
ROUTED_TOL = 4e-2
GRAD_TOL = 5e-2
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})


def cfgs(arch):
    """(the port's config, the reference's) at VOCAB."""
    return (smoke_config(arch).scaled(vocab=VOCAB),
            ref_smoke_config(arch).scaled(vocab=VOCAB))


def make_batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.prefix_len:
        batch["patches"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (b, 10, cfg.d_model)).astype(np.float32)
    return batch


def half_module(api, masters):
    """The port's module with every parameter the bf16 cast of its master,
    requiring grad (what ``make_train_step`` builds)."""
    model = api.init(None)
    for name, p in model.named_parameters():
        p.data = masters[name].to(torch.bfloat16)
        p.requires_grad_(True)
    return model


def port_loss_and_grads(api, masters, batch):
    model = half_module(api, masters)
    named = dict(model.named_parameters())
    loss, metrics = api.loss(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {k: float(v) for k, v in metrics.items()}, {
        n: (torch.zeros_like(p) if g is None else g).float().numpy()
        for (n, p), g in zip(named.items(), grads)}


class Ref:
    """An arch's reference state and its loss and gradients on the bf16
    cast of the masters, computed once."""

    def __init__(self, arch):
        self.cfg, rcfg = cfgs(arch)
        self.rapi = ref_build_model(rcfg, remat="none")
        self.state = ref_init_state(self.rapi, jax.random.PRNGKey(0))
        self.batch = make_batch(self.cfg)
        half = jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                            self.state.params)
        (loss, metrics), grads = exact_jit(jax.value_and_grad(
            self.rapi.loss, has_aux=True))(
            half, {k: jnp.asarray(v) for k, v in self.batch.items()})
        self.loss = float(loss)
        self.metrics = {k: float(v) for k, v in metrics.items()}
        names = _model(self.cfg, "meta")
        self.grads = {n: g for n, _, g in
                      reference_leaves(self.cfg, names, grads)}

    def port(self, remat="none"):
        api = build_model(self.cfg, remat=remat, device="cpu")
        return api, train_state_from_reference(self.cfg, self.state,
                                               device="cpu")


_REFS: dict = {}


def ref_of(arch) -> Ref:
    if arch not in _REFS:
        _REFS[arch] = Ref(arch)
    return _REFS[arch]


def grad_gap(want: dict, got: dict) -> tuple:
    """The worst leaf's max |got - want| over that leaf's max |want|."""
    worst = (0.0, None)
    for name, w in want.items():
        top = np.abs(w).max()
        gap = np.abs(got[name] - w).max() / top if top else \
            np.abs(got[name]).max()
        worst = max(worst, (float(gap), name))
    return worst


# ------------------------------------------------------- loss and grads ---
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    ref = ref_of(arch)
    api, state = ref.port()
    loss, metrics, grads = port_loss_and_grads(api, state.params, ref.batch)
    tol = ROUTED_TOL if arch in ROUTED_ARCHS else LOSS_RTOL
    assert set(metrics) == set(ref.metrics)
    assert abs(float(loss) - ref.loss) <= tol * abs(ref.loss)
    for key, want in ref.metrics.items():
        assert abs(metrics[key] - want) <= tol * abs(want) + 1e-6, key
    assert set(grads) == set(ref.grads)
    gap, name = grad_gap(ref.grads, grads)
    assert gap < GRAD_TOL, (name, gap)


def test_v3_loss_runs_the_mtp_head():
    """V3's loss is ce + aux + 0.3 mtp_ce, and its MTP head has grads."""
    ref = ref_of("deepseek-v3-671b")
    api, state = ref.port()
    loss, m, grads = port_loss_and_grads(api, state.params, ref.batch)
    assert set(m) == {"ce", "aux", "mtp_ce"}
    assert float(loss) == pytest.approx(m["ce"] + m["aux"] + 0.3 * m["mtp_ce"],
                                        rel=1e-6)
    assert np.abs(grads["mtp.proj"]).max() > 0
    assert np.abs(grads["mtp.block.attn.wq_a"]).max() > 0


def test_ce_without_the_vocab_mask_fails(monkeypatch):
    """The mutant: the padded vocabulary's 12 columns left in the
    logsumexp move the loss past LOSS_RTOL (by 3.8x here)."""
    ref = ref_of("olmo-1b")
    api, state = ref.port()
    monkeypatch.setattr(TLM, "_masked_logits", lambda hs, w, vocab: (
        hs.to(TL.CDTYPE) @ w).to(torch.float32))
    loss, _, _ = port_loss_and_grads(api, state.params, ref.batch)
    assert abs(float(loss) - ref.loss) > 3 * LOSS_RTOL * abs(ref.loss)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_block_equals_none(arch):
    """Checkpointing each layer (or hybrid group) recomputes the same
    numbers: the loss and every grad bit for bit."""
    ref = ref_of(arch)
    out = {}
    for remat in ("block", "none"):
        api, state = ref.port(remat)
        out[remat] = port_loss_and_grads(api, state.params, ref.batch)
    assert torch.equal(out["block"][0], out["none"][0])
    for name, g in out["none"][2].items():
        np.testing.assert_array_equal(out["block"][2][name], g, err_msg=name)


def test_build_model_refuses_an_unknown_remat():
    with pytest.raises(ValueError, match="remat"):
        build_model(smoke_config("olmo-1b"), remat="full", device="cpu")


# ------------------------------------------------------------ chunked CE ---
def _plain_ce(h, w, tgt, mask, vocab):
    """The reference's chunked_ce written over the whole sequence at
    once, with plain autograd: the oracle of the chunked Function."""
    logits = (h.to(torch.bfloat16) @ w).to(torch.float32)
    logits = torch.where(torch.arange(w.shape[1]) < vocab, logits, -1e30)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@pytest.mark.parametrize("S_,chunk", [(64, 16), (48, 48), (40, 8)])
def test_chunked_ce_equals_the_whole_sequence_form(S_, chunk):
    """Value within f32 rounding; grads of h and of the head within one
    bf16 rounding of the plain form's (its head grad is rounded once
    from an f32 sum, the plain form's per product)."""
    cfg = smoke_config("qwen3-4b").scaled(vocab=VOCAB, tie_embeddings=False)
    rng = np.random.default_rng(1)
    h = torch.as_tensor(rng.standard_normal((3, S_, cfg.d_model)),
                        dtype=torch.bfloat16).requires_grad_(True)
    w = torch.as_tensor(0.2 * rng.standard_normal(
        (cfg.d_model, cfg.vocab_padded)), dtype=torch.bfloat16)
    w.requires_grad_(True)
    tgt = torch.as_tensor(rng.integers(0, cfg.vocab, (3, S_)))
    mask = torch.as_tensor(rng.random((3, S_)) < 0.8, dtype=torch.float32)
    params = type("P", (), {"lm_head": w})()
    got = TLM.chunked_ce(params, cfg, h, tgt, mask, chunk=chunk)
    gh, gw = torch.autograd.grad(got, (h, w))
    want = _plain_ce(h, w, tgt, mask, cfg.vocab)
    wh, ww = torch.autograd.grad(want, (h, w))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    for a, b in ((gh, wh), (gw, ww)):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b.float()).abs().max()) <= \
            1e-2 * float(b.float().abs().max())


def test_chunked_ce_refuses_a_ragged_chunk():
    cfg = smoke_config("starcoder2-7b")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunk"):
        TLM.chunked_ce(params, cfg, torch.zeros(1, 20, cfg.d_model),
                       torch.zeros(1, 20, dtype=torch.long),
                       torch.ones(1, 20), chunk=8)


def test_chunked_ce_keeps_one_chunk_of_logits():
    """The forward saves h, the head, the targets, the mask and each
    position's logsumexp: nothing of (B, S, Vp) size."""
    cfg = smoke_config("qwen3-4b").scaled(tie_embeddings=False)
    h = torch.randn(2, 64, cfg.d_model, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn(cfg.d_model, cfg.vocab_padded, dtype=torch.bfloat16,
                    requires_grad=True)
    params = type("P", (), {"lm_head": w})()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        TLM.chunked_ce(params, cfg, h, torch.zeros(2, 64, dtype=torch.long),
                       torch.ones(2, 64), chunk=16)
    assert saved and max(saved) < 2 * 64 * cfg.vocab_padded


# --------------------------------------------------------- the two repairs ---
def test_ssd_backward_runs_and_serving_stays_in_place():
    """(F1) Under autograd the decay's exp and its product are out of
    place, so the backward runs; without it the output is the same
    tensor of numbers as before."""
    rng = np.random.default_rng(2)
    Bsz, S_, H, P, N = 2, 32, 3, 4, 5
    x = torch.as_tensor(rng.standard_normal((Bsz, S_, H, P)),
                        dtype=torch.float32)
    dt = torch.as_tensor(rng.random((Bsz, S_, H)) * 0.5, dtype=torch.float32)
    A = torch.as_tensor(rng.standard_normal(H), dtype=torch.float32)
    Bm = torch.as_tensor(rng.standard_normal((Bsz, S_, N)),
                         dtype=torch.float32)
    Cm = torch.as_tensor(rng.standard_normal((Bsz, S_, N)),
                         dtype=torch.float32)
    with torch.no_grad():
        y0, h0 = TM.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y1, h1 = TM.ssd_chunked(*leaves, chunk=8)
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())
    (y1.sum() + h1.sum()).backward()
    # the naive scan's autograd is the oracle of every input's grad
    naive = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y2, h2 = TM.ssd_naive(*naive)
    (y2.sum() + h2.sum()).backward()
    for a, b in zip(leaves, naive):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_ssm_families_backward_through_prefill(arch):
    """(F1) The serving prefill of both SSM families differentiates."""
    cfg = smoke_config(arch)
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    for p in params.parameters():
        p.requires_grad_(True)
    logits, _ = api.prefill(params, make_batch(cfg, s=64))
    logits.sum().backward()
    assert all(p.grad is not None for p in params.parameters())


def _meta_bf16(*shape):
    return torch.empty(*shape, dtype=torch.bfloat16,
                       device="meta").requires_grad_(True)


def test_f32_result_gemm_has_a_derivative():
    """(F2) ``torch.bmm(..., out_dtype=float32)`` has no derivative (on
    meta tensors here, as on the card); ``bmm_out_f32`` gives each bf16
    operand a bf16 cotangent of its shape.  The card tests hold its
    numbers against the widened f32 form."""
    a, b = _meta_bf16(2, 3, 4), _meta_bf16(2, 4, 5)
    with pytest.raises(RuntimeError, match="not implemented"):
        torch.bmm(a, b, out_dtype=torch.float32).sum().backward()
    out = TL.bmm_out_f32(a, b)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(out.sum(), (a, b))
    assert (ga.dtype, ga.shape) == (torch.bfloat16, a.shape)
    assert (gb.dtype, gb.shape) == (torch.bfloat16, b.shape)
    qg, k = _meta_bf16(2, 2, 3, 8), _meta_bf16(2, 5, 2, 8)
    s = TL.grouped_scores_bmm(qg, k)
    p = torch.empty(2, 2, 3, 5, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    r = TL.grouped_mix_bmm(p, k)
    assert s.shape == (2, 2, 3, 5) and r.shape == (2, 2, 3, 8)
    grads = torch.autograd.grad(s.sum() + r.sum(), (qg, k, p))
    assert [g.shape for g in grads] == [qg.shape, k.shape, p.shape]


def test_attention_backward_keeps_no_score_tile(monkeypatch):
    """Under autograd each query chunk is checkpointed, as the
    reference's ``jax.checkpoint``: the forward keeps no tensor of a
    score tile's size (B x Hkv x G x bq x bk = 8,192 here; the largest
    input is 4,096), and the output and grads equal an uncheckpointed
    pass's bit for bit."""
    rng = np.random.default_rng(3)

    def leaf(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.bfloat16).requires_grad_(True)

    q, k, v = leaf(1, 128, 4, 8), leaf(1, 128, 2, 8), leaf(1, 128, 2, 8)

    def run():
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            out = TL.blockwise_attention(q, k, v, block_q=32, block_kv=64)
        return out, torch.autograd.grad(out.float().sum(), (q, k, v)), saved

    out, grads, saved = run()
    assert max(saved, default=0) < 8192
    monkeypatch.setattr(TL, "checkpoint", lambda fn, *a, **kw: fn(*a))
    out2, grads2, saved2 = run()
    assert max(saved2) >= 8192          # the tiles, kept without it
    assert torch.equal(out, out2)
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)


def test_a_checkpointed_layer_recomputes_its_attention_once(monkeypatch):
    """Inside ``remat_region`` (a layer ``remat="block"`` checkpoints
    whole) the query chunks are not checkpointed again: the layer's
    recompute is the only one."""
    calls = []
    inner = TL.checkpoint
    monkeypatch.setattr(TL, "checkpoint",
                        lambda fn, *a, **kw: calls.append(fn) or
                        inner(fn, *a, **kw))
    q, k, v = (torch.randn(1, 64, 2, 8, requires_grad=True)
               for _ in range(3))
    TL.blockwise_attention(q, k, v, block_q=16, block_kv=32)
    assert len(calls) == 4
    calls.clear()
    with TL.remat_region():
        TL.blockwise_attention(q, k, v, block_q=16, block_kv=32)
    assert not calls

"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the reference package's mesh-free ``moe_forward`` on the CPU, at the
smoke configs' widths (8 experts, top-2, d_expert 32).

The layer is the reference's ``init_moe`` tree loaded into ``MoE``;
inputs are seeded values exactly representable in bf16.  Both paths are
held: the dropless one (T <= 32 tokens) and the capacity one (T > 32),
with tokens dropped, with two identical sequences whose tied gates at
the cut-off must keep the reference's (lower) token, and uncapped against
a plain dense-routing oracle.

The reference is compiled with ``xla_allow_excess_precision`` off: its
bf16 ops then round one by one as its code is written, and the port's do
the same (``layers.silu`` is ``jax.nn.silu`` op by op).  Under a plain
``jax.jit`` XLA keeps f32 inside its fused bf16 ops, which moves the
reference's own smoke models by up to 0.59 of max |logits| against its
eager run: a one-ulp change at a near-tied router choice flips an expert.

Tolerances: ``TOL`` 4e-2 of the reference's largest output magnitude
(``tests/test_torch_models.py``'s; the gaps measured against the
reference are 0 on both paths, and against the oracle, whose SwiGLU is
bf16 where the capacity path's is f32, at most 5.3e-3), and ``F32_RTOL`` 1e-4 for the router
probabilities and the auxiliary loss, f32 on both sides.  Two mutants
must fail: a bf16 router (the probabilities move by up to 5e-4 of
the largest) and gates that
are not renormalised.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import moe as RMOE
from repro_torch.configs import smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE

TOL, F32_RTOL = 4e-2, 1e-4
ARCH = "deepseek-v2-236b"
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _cfgs(n_shared=None, capacity_factor=None):
    """(port cfg, reference cfg) at the smoke config, with the MoE's
    ``n_shared`` or ``capacity_factor`` replaced."""
    kw = {k: v for k, v in (("n_shared", n_shared),
                            ("capacity_factor", capacity_factor))
          if v is not None}
    cfg, rcfg = smoke_config(ARCH), ref_smoke_config(ARCH)
    return (dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw)),
            dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                **kw)))


def _layer(cfg, rcfg, seed=0):
    """(reference params, port MoE) on shared weights."""
    ref = RMOE.init_moe(jax.random.PRNGKey(seed), rcfg)
    port = TMOE.MoE(cfg)
    with torch.no_grad():
        for name, p in port.named_parameters():
            leaf = ref
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.as_tensor(np.array(leaf)))
    return ref, port


def _bf16(rng, *shape):
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), x


def _both(ref, port, cfg, rcfg, xj, xt):
    """(reference out, aux), (port out, aux) on the same input."""
    want, waux = exact_jit(lambda p, x: RMOE.moe_forward(p, rcfg, x))(ref, xj)
    got, aux = TMOE.moe_forward(port, cfg, xt)
    return (np.asarray(want, np.float32), float(waux)), (_np(got), float(aux))


def _dropped(probs, top_k, cap) -> int:
    """(token, expert) assignments past an expert's capacity."""
    idx = np.argsort(-probs, 1, kind="stable")[:, :top_k]
    per_expert = np.bincount(idx.ravel(), minlength=probs.shape[1])
    return int(np.clip(per_expert - cap, 0, None).sum())


def test_layer_holds_an_f32_router_and_bf16_experts():
    cfg, rcfg = _cfgs()
    port = TMOE.MoE(cfg, torch.Generator().manual_seed(0))
    mc = cfg.moe
    assert port.router.dtype == torch.float32
    assert port.router.shape == (cfg.d_model, mc.n_experts)
    assert abs(float(port.router.std()) - 0.02) < 2e-3
    for name, d_in in (("wg", cfg.d_model), ("wu", cfg.d_model),
                       ("wd", mc.d_expert)):
        w = getattr(port, name)
        assert w.dtype == torch.bfloat16 and w.shape[0] == mc.n_experts
        assert abs(float(w.float().std()) * np.sqrt(d_in) - 1.0) < 0.05
    assert port.shared.wg.shape == (cfg.d_model, mc.n_shared * mc.d_expert)
    assert port.shared.wg.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 8), (2, 16)])
def test_dropless_path_matches_reference(shape):
    """T = 8 and T = 32: the per-token expert gather, bf16 SwiGLU."""
    cfg, rcfg = _cfgs()
    ref, port = _layer(cfg, rcfg)
    xj, xt = _bf16(np.random.default_rng(1), *shape, cfg.d_model)
    (want, waux), (got, aux) = _both(ref, port, cfg, rcfg, xj, xt)
    assert got.shape == want.shape
    assert _rel(want, got) < TOL
    np.testing.assert_allclose(aux, waux, rtol=F32_RTOL)


@pytest.mark.parametrize("shape", [(1, 33), (2, 24)])
def test_capacity_path_matches_reference_with_drops(shape):
    """T = 33 and T = 48: past 32 tokens each expert takes its
    ``int(T * top_k / E * 1.25)`` highest-gated tokens, and this input
    overfills at least one expert, so tokens are dropped."""
    cfg, rcfg = _cfgs()
    ref, port = _layer(cfg, rcfg)
    xj, xt = _bf16(np.random.default_rng(2), *shape, cfg.d_model)
    T = shape[0] * shape[1]
    mc = cfg.moe
    cap = max(1, int(T * mc.top_k / mc.n_experts * mc.capacity_factor))
    probs = _np(TMOE.router_probs(port, xt.reshape(T, -1)))
    assert _dropped(probs, mc.top_k, cap) > 0
    (want, waux), (got, aux) = _both(ref, port, cfg, rcfg, xj, xt)
    assert _rel(want, got) < TOL
    np.testing.assert_allclose(aux, waux, rtol=F32_RTOL)


def test_ties_at_the_capacity_cut_off_keep_the_reference_token():
    """Two identical 24-token sequences (T = 48): their tokens tie at every
    expert's cut-off, and ``lax.top_k`` keeps the copy with the lower
    index, so some rows of the second copy lose an expert the first
    keeps.  The port drops the same rows."""
    cfg, rcfg = _cfgs()
    ref, port = _layer(cfg, rcfg)
    _, one = _bf16(np.random.default_rng(3), 1, 24, cfg.d_model)
    xt = one.expand(2, 24, cfg.d_model).contiguous()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    (want, _), (got, _) = _both(ref, port, cfg, rcfg, xj, xt)
    ref_rows = np.nonzero((want[0] != want[1]).any(-1))[0]
    got_rows = np.nonzero((got[0] != got[1]).any(-1))[0]
    assert len(ref_rows) > 0
    np.testing.assert_array_equal(got_rows, ref_rows)
    assert _rel(want, got) < TOL


def _dense_oracle(port, cfg, x):
    """sum over each token's top-k experts of gate * expert(x), every
    expert in a plain loop, no capacity: (T, D) f32."""
    mc = cfg.moe
    probs = torch.softmax(x.float() @ port.router.float(), -1)
    vals, idx = probs.topk(mc.top_k, -1)
    vals = vals / vals.sum(-1, keepdim=True)
    xc = x.to(torch.bfloat16)
    out = torch.zeros(x.shape, dtype=torch.float32)
    for e in range(mc.n_experts):
        gate = torch.where(idx == e, vals, 0.0).sum(-1)
        h = TL.silu(xc @ port.wg[e]) * (xc @ port.wu[e])
        out += gate[:, None] * (h @ port.wd[e]).float()
    return out


@pytest.mark.parametrize("shape", [(2, 8), (2, 24)])
def test_uncapped_layer_equals_dense_routing(shape):
    """With a capacity factor of 100 no token is dropped: both paths are
    the dense-routing sum (the reference's own oracle test, on the
    port), the shared experts taken out."""
    cfg, _ = _cfgs(capacity_factor=100.0)
    port = TMOE.MoE(cfg, torch.Generator().manual_seed(4))
    _, xt = _bf16(np.random.default_rng(4), *shape, cfg.d_model)
    got, _ = TMOE.moe_forward(port, cfg, xt.float())
    sp = port.shared
    xc = xt.to(torch.bfloat16)
    shared = (TL.silu(xc @ sp.wg) * (xc @ sp.wu)) @ sp.wd
    got = got - shared.float()
    want = _dense_oracle(port, cfg, xt.reshape(-1, cfg.d_model))
    assert _rel(_np(want), _np(got.reshape(-1, cfg.d_model))) < TOL


@pytest.mark.parametrize("n_shared", [0, 1, 2])
@pytest.mark.parametrize("shape", [(2, 8), (2, 24)])
def test_shared_experts_match_reference(n_shared, shape):
    cfg, rcfg = _cfgs(n_shared=n_shared)
    ref, port = _layer(cfg, rcfg, seed=5)
    assert hasattr(port, "shared") == bool(n_shared)
    xj, xt = _bf16(np.random.default_rng(5), *shape, cfg.d_model)
    (want, waux), (got, aux) = _both(ref, port, cfg, rcfg, xj, xt)
    assert _rel(want, got) < TOL
    np.testing.assert_allclose(aux, waux, rtol=F32_RTOL)


def test_router_probabilities_and_aux_are_the_reference_f32():
    cfg, rcfg = _cfgs()
    ref, port = _layer(cfg, rcfg)
    xj, xt = _bf16(np.random.default_rng(6), 64, cfg.d_model)
    want = jax.nn.softmax(xj.astype(jnp.float32)
                          @ ref["router"].astype(jnp.float32), -1)
    got = TMOE.router_probs(port, xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_RTOL)
    np.testing.assert_allclose(float(TMOE._aux_loss(got)),
                               float(RMOE._aux_loss(want)), rtol=F32_RTOL)


def test_a_bf16_router_fails_the_probabilities():
    """The mutant the port avoids: the router held in bf16 like the other
    matmul weights moves the probabilities far past F32_RTOL."""
    cfg, rcfg = _cfgs()
    ref, port = _layer(cfg, rcfg)
    xj, xt = _bf16(np.random.default_rng(6), 64, cfg.d_model)
    want = np.asarray(jax.nn.softmax(xj.astype(jnp.float32)
                                     @ ref["router"].astype(jnp.float32), -1))
    port.router = TL._weight(port.router.to(torch.bfloat16))
    got = _np(TMOE.router_probs(port, xt))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=F32_RTOL)


@pytest.mark.parametrize("shape", [(2, 8), (2, 24)])
def test_gates_not_renormalised_fail_the_output(shape, monkeypatch):
    cfg, rcfg = _cfgs()
    ref, port = _layer(cfg, rcfg)
    xj, xt = _bf16(np.random.default_rng(7), *shape, cfg.d_model)
    (want, _), _ = _both(ref, port, cfg, rcfg, xj, xt)
    monkeypatch.setattr(TMOE, "_gates", lambda vals: vals)
    got, _ = TMOE.moe_forward(port, cfg, xt)
    assert _rel(want, _np(got)) > 4 * TOL


@pytest.mark.parametrize("shape", [(2, 8), (2, 24)])
def test_a_mesh_without_a_model_dim_runs_the_mesh_free_code(shape):
    """A mesh the expert-parallel branch cannot use (no ``"model"`` dim)
    falls back to the mesh-free paths, as the reference's does: the
    output and the aux equal those of no mesh, dropless and capacity
    (the mesh's placements: ``tests/test_torch_placement.py``)."""
    from types import SimpleNamespace
    cfg, rcfg = _cfgs()
    _, port = _layer(cfg, rcfg)
    _, xt = _bf16(np.random.default_rng(9), *shape, cfg.d_model)
    mesh = SimpleNamespace(shape={"data": 1}, axis_names=("data",))
    want, want_aux = TMOE.moe_forward(port, cfg, xt)
    got, aux = TMOE.moe_forward(port, cfg, xt, mesh=mesh)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_routing_hook_records_and_imposes_the_experts():
    """``repro_torch.testing.routing``: recorded choices imposed on the same
    input change nothing; another token's choices imposed change the
    output and are counted, and a wrong shape is refused."""
    from repro_torch.testing.routing import routing
    cfg, rcfg = _cfgs()
    _, port = _layer(cfg, rcfg)
    _, xt = _bf16(np.random.default_rng(8), 1, 8, cfg.d_model)
    with routing() as rec:
        want, _ = TMOE.moe_forward(port, cfg, xt)
    assert len(rec["calls"]) == 1 and rec["calls"][0].shape == (8, 2)
    with routing(rec["calls"]) as same:
        got, _ = TMOE.moe_forward(port, cfg, xt)
    assert same["moved"] == 0 and torch.equal(got, want)
    swapped = [rec["calls"][0].roll(1, 0)]
    moved = int((swapped[0].sort(-1).values
                 != rec["calls"][0].sort(-1).values).any(-1).sum())
    with routing(swapped) as other:
        got, _ = TMOE.moe_forward(port, cfg, xt)
    assert other["moved"] == moved > 0 and not torch.equal(got, want)
    with pytest.raises(ValueError, match="forced routing"):
        with routing([rec["calls"][0][:4]]):
            TMOE.moe_forward(port, cfg, xt)

"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the reference package's on the CPU, at DeepSeek-V2's smoke
config.

The module is the reference's ``init_mla`` tree (its two gains redrawn,
so a dropped one shows) loaded into ``MLA``; inputs are seeded values
exactly representable in bf16.  The reference is compiled with
``xla_allow_excess_precision`` off, so its bf16 ops round one by one as
its code is written and as the port's do (``tests/test_torch_moe.py``
says why that matters for the models).  Tolerances, relative to the
largest magnitude of the reference's output or cache:

* ``TOL`` 4e-2 (``tests/test_torch_models.py``'s) for the bf16 outputs
  and caches; the gaps measured are at most a few bf16 ulps;
* ``ABSORB_TOL`` 4e-2 for the absorbed decode against the port's own
  expanded forward pass: the two round the latent products at other
  points (the reference's own test of the same holds them to 0.08).

The mutant, ``k_rope`` rotated one position late, lands far outside.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import mla as RMLA
from repro_torch.configs import smoke_config
from repro_torch.models import mla as TMLA

TOL = ABSORB_TOL = 4e-2
ARCH = "deepseek-v2-236b"
B, S, SMAX = 2, 9, 12
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _bf16(rng, *shape):
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), x


@functools.lru_cache(maxsize=None)
def _module():
    """(cfg, reference params, port module) on shared weights."""
    cfg = smoke_config(ARCH)
    ref = RMLA.init_mla(jax.random.PRNGKey(5), ref_smoke_config(ARCH))
    rng = np.random.default_rng(6)
    for name in ("q_norm", "kv_norm"):
        ref[name] = jnp.asarray(1.0 + 0.5 * rng.standard_normal(
            ref[name].shape), jnp.float32)
    port = TMLA.MLA(cfg)
    with torch.no_grad():
        for name, w in ref.items():
            getattr(port, name).copy_(torch.as_tensor(np.array(w)))
    return cfg, ref, port


def _lens(t, run):
    """Step t's lengths: a scalar, or per slot with slot 1 two behind."""
    if run == "scalar":
        return t + 1
    return np.array([t + 1, max(t - 1, 1)], np.int32)


def test_module_holds_bf16_projections_and_f32_gains():
    cfg, _, port = _module()
    m = cfg.mla
    for name in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
        assert getattr(port, name).dtype == torch.bfloat16, name
    for name in ("q_norm", "kv_norm"):
        assert getattr(port, name).dtype == torch.float32, name
    assert port.wk_b.shape == (m.kv_lora, cfg.n_heads * m.nope_dim)
    assert port.freqs.shape == (m.rope_dim // 2,)


def test_mla_forward_matches_reference():
    cfg, ref, port = _module()
    xj, xt = _bf16(np.random.default_rng(0), B, S, cfg.d_model)
    want, (rc, rk) = exact_jit(lambda p, x: RMLA.mla_forward(
        p, ref_smoke_config(ARCH), x))(ref, xj)
    got, (c_kv, k_rope) = TMLA.mla_forward(port, cfg, xt)
    assert got.dtype == c_kv.dtype == k_rope.dtype == torch.bfloat16
    assert c_kv.shape == rc.shape and k_rope.shape == rk.shape
    assert _rel(want, _np(got)) < TOL
    assert _rel(rc, _np(c_kv)) < TOL
    assert _rel(rk, _np(k_rope)) < TOL


def _ref_decode_run(ref, xj, run, smax=SMAX, steps=S):
    rcfg = ref_smoke_config(ARCH)
    dec = exact_jit(lambda p, x, c, n: RMLA.mla_decode(p, rcfg, x, c, n))
    cache = RMLA.init_mla_cache(rcfg, B, smax)
    outs = []
    for t in range(steps):
        out, cache = dec(ref, xj[:, t % S:t % S + 1], cache,
                         jnp.asarray(_lens(t, run)))
        outs.append(np.asarray(out, np.float32))
    return outs, cache


def _port_decode_run(port, cfg, xt, run, smax=SMAX, steps=S, drop=False):
    cache = TMLA.init_mla_cache(cfg, B, smax)
    outs = []
    for t in range(steps):
        out, same = TMLA.mla_decode(port, cfg, xt[:, t % S:t % S + 1], cache,
                                    torch.as_tensor(_lens(t, run)),
                                    drop=drop)
        assert same is cache
        outs.append(_np(out))
    return outs, cache


@pytest.mark.parametrize("run", ["scalar", "vector"])
def test_mla_decode_matches_reference_at_every_step(run):
    """The absorbed decode step by step from a zero latent cache: every
    step's output, and the caches after (written in place)."""
    cfg, ref, port = _module()
    xj, xt = _bf16(np.random.default_rng(1), B, S, cfg.d_model)
    want, rcache = _ref_decode_run(ref, xj, run)
    got, cache = _port_decode_run(port, cfg, xt, run)
    for t in range(S):
        assert _rel(want[t], got[t]) < TOL, t
    for key in ("c_kv", "k_rope"):
        assert cache[key].dtype == torch.bfloat16
        assert _rel(rcache[key], _np(cache[key])) < TOL, key
    # nothing was written past each slot's last position
    last = np.broadcast_to(_lens(S - 1, run), (B,))
    for b in range(B):
        assert not cache["c_kv"][b, last[b]:].any()


def test_absorbed_decode_equals_expanded_forward():
    """The port's own form of the reference's test: decode token by token
    (bf16 latent cache) against the expanded forward pass over every
    prefix, and the latent caches against the forward pass's."""
    cfg, _, port = _module()
    _, xt = _bf16(np.random.default_rng(2), B, S, cfg.d_model)
    cache = TMLA.init_mla_cache(cfg, B, S)
    for t in range(S):
        dec, cache = TMLA.mla_decode(port, cfg, xt[:, t:t + 1], cache, t + 1)
        full, (c_kv, k_rope) = TMLA.mla_forward(port, cfg, xt[:, :t + 1])
        assert _rel(_np(full[:, -1]), _np(dec[:, 0])) < ABSORB_TOL, t
    assert _rel(_np(c_kv), _np(cache["c_kv"])) < TOL
    assert _rel(_np(k_rope), _np(cache["k_rope"])) < TOL


def test_drop_past_the_cache_matches_reference():
    """ROADMAP C8: 14 steps through a 6-position cache, slot 1 two behind:
    the reference's scatter drops the out-of-range write and attends over
    every position; ``drop`` does the same, with the lengths a tensor."""
    cfg, ref, port = _module()
    xj, xt = _bf16(np.random.default_rng(3), B, S, cfg.d_model)
    want, rcache = _ref_decode_run(ref, xj, "vector", smax=6, steps=14)
    got, cache = _port_decode_run(port, cfg, xt, "vector", smax=6, steps=14,
                                  drop=True)
    for t in range(14):
        assert np.isfinite(got[t]).all()
        assert _rel(want[t], got[t]) < TOL, t
    for key in ("c_kv", "k_rope"):
        assert _rel(rcache[key], _np(cache[key])) < TOL, key


def test_k_rope_one_position_late_fails_the_cache(monkeypatch):
    """The tolerance has teeth: the latent key rotated at cur_len instead
    of cur_len - 1 moves the k_rope cache far past TOL."""
    cfg, ref, port = _module()
    xj, xt = _bf16(np.random.default_rng(1), B, S, cfg.d_model)
    _, rcache = _ref_decode_run(ref, xj, "vector")
    inner = TMLA._project_kv_latent
    monkeypatch.setattr(TMLA, "_project_kv_latent",
                        lambda p, c, x, pos: inner(p, c, x, pos + 1))
    _, cache = _port_decode_run(port, cfg, xt, "vector")
    assert _rel(rcache["k_rope"], _np(cache["k_rope"])) > 4 * TOL

"""DCO-screened decode attention against the reference.

``repro_torch.serving.dco_attention`` (plain PyTorch on the CPU) against
``repro.serving.dco_attention`` (jax on the CPU) on the same seeded
numpy inputs, at the reference test's shapes (``tests/test_search.py``:
B 2, S 256, Hkv 2, G 2, hd 32, keys with a decaying spectrum).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import dco_attention as ref
from repro_torch.serving import (dco_decode_attention, exact_decode_attention,
                                 fit_key_rotation)
from repro_torch.serving.dco_attention import _top_c

B, S, HKV, G, HD = 2, 256, 2, 2, 32
H = HKV * G
LENS = {"scalar": S, "ragged": np.array([200, 256], np.int32)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    scale = (np.arange(1, HD + 1) ** -0.7).astype(np.float32)
    k = (rng.standard_normal((B, S, HKV, HD)) * scale).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, HD)).astype(np.float32)
    q = (rng.standard_normal((B, H, HD)) * scale).astype(np.float32)
    rot = fit_key_rotation(k.reshape(-1, HD))
    k_rot = np.einsum("bshd,de->bshe", k, rot).astype(np.float32)
    return dict(q=q, k=k, v=v, rot=rot, k_rot=k_rot)


def _cast(a, dtype):
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _f32(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.to(torch.float32).numpy()
    return np.asarray(out.astype(jnp.float32))


def test_fit_key_rotation_bit_for_bit(inputs):
    keys = inputs["k"].reshape(-1, HD)
    got, want = fit_key_rotation(keys), ref.fit_key_rotation(keys)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


#: (rtol, atol) against the reference: f32 to the summation order; bf16
#: to the cast of the probabilities and the output
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("lens", list(LENS))
@pytest.mark.parametrize("d1,cap", [(8, S), (16, 96)])
def test_dco_decode_attention_matches_reference(inputs, dtype, lens, d1, cap):
    """The screened attention on the reference's inputs, f32 and bf16
    caches (the rotation stays f32), ``cur_len`` a scalar and (B,)."""
    (qj, qt), (kj, kt), (vj, vt) = (_cast(inputs[n], dtype)
                                    for n in ("q", "k_rot", "v"))
    rot = inputs["rot"]
    cur = LENS[lens]
    want = ref.dco_decode_attention(qj, kj, vj, jnp.asarray(rot),
                                    jnp.asarray(cur), d1=d1, cap=cap)
    got = dco_decode_attention(qt, kt, vt, torch.from_numpy(rot), cur,
                               d1=d1, cap=cap)
    assert got.dtype == qt.dtype and got.shape == (B, H, HD)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("lens", list(LENS))
def test_exact_decode_attention_matches_reference(inputs, dtype, lens):
    (qj, qt), (kj, kt), (vj, vt) = (_cast(inputs[n], dtype)
                                    for n in ("q", "k", "v"))
    cur = LENS[lens]
    want = ref.exact_decode_attention(qj, kj, vj, jnp.asarray(cur))
    got = exact_decode_attention(qt, kt, vt, cur)
    assert got.dtype == qt.dtype
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("lens", list(LENS))
def test_screen_close_to_exact(inputs, lens):
    """The reference test's bounds: at cap = S the screen is exact
    attention within 2e-2; at (d1, cap) = (16, 96) the error stays under
    0.25."""
    t = {n: torch.from_numpy(inputs[n]) for n in inputs}
    cur = LENS[lens]
    exact = exact_decode_attention(t["q"], t["k"], t["v"], cur)
    full = dco_decode_attention(t["q"], t["k_rot"], t["v"], t["rot"], cur,
                                d1=8, cap=S)
    np.testing.assert_allclose(full.numpy(), exact.numpy(), rtol=2e-2,
                               atol=2e-2)
    approx = dco_decode_attention(t["q"], t["k_rot"], t["v"], t["rot"], cur,
                                  d1=16, cap=96)
    assert float((approx - exact).abs().max()) < 0.25


@pytest.mark.parametrize("case", ["ties", "signed_zeros", "masked",
                                  "all_equal"])
def test_top_c_selects_as_lax_top_k(case):
    """The top-C of the stage-1 scores picks what ``lax.top_k`` picks:
    largest first, the lower position first among equal scores, masked
    -inf positions last in position order."""
    rng = np.random.default_rng(3)
    s1 = rng.integers(-3, 4, (2, 2, 2, 64)).astype(np.float32)
    if case == "signed_zeros":
        s1 = np.where(s1 > 0, 0.0, -0.0).astype(np.float32)
    elif case == "masked":
        s1[..., 20:] = -np.inf
    elif case == "all_equal":
        s1[:] = 1.5
    for C in (1, 16, 40, 64):
        _, want = jax.lax.top_k(jnp.asarray(s1), C)
        got = _top_c(torch.from_numpy(s1), C)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tied_keys_select_as_reference(inputs):
    """Duplicated keys give equal stage-1 scores: the screened attention
    keeps the same positions, so its output equals the reference's."""
    k_rot = inputs["k_rot"].copy()
    k_rot[:, 1::2] = k_rot[:, 0::2]                 # every key twice
    t = torch.from_numpy
    cur = LENS["ragged"]
    want = ref.dco_decode_attention(
        jnp.asarray(inputs["q"]), jnp.asarray(k_rot), jnp.asarray(inputs["v"]),
        jnp.asarray(inputs["rot"]), jnp.asarray(cur), d1=16, cap=33)
    got = dco_decode_attention(t(inputs["q"]), t(k_rot), t(inputs["v"]),
                               t(inputs["rot"]), cur, d1=16, cap=33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)

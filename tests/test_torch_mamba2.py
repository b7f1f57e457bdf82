"""The port's Mamba-2 SSD block (``repro_torch.models.mamba2``) against the
reference package's on the CPU, at the smoke config's widths.

Inputs are seeded numpy; the mixer is the reference's ``init_mamba`` tree
(its ``D``, ``dt_bias`` and ``norm`` redrawn, so a dropped one shows)
loaded into ``Mamba2Mixer``.  Tolerances, relative to the largest
magnitude of the reference's output:

* ``SSD_TOL`` 1e-4 for the SSD scans, f32 end to end (the reference's
  einsums and ours sum in other orders; the worst gap measured is below
  1e-6);
* ``CONV_TOL`` 1e-5 for the causal conv, whose taps are the same f32
  products summed in the same order (only ``silu`` may round otherwise);
  its state is compared exactly;
* ``TOL`` 4e-2 (``tests/test_torch_models.py``'s) for the mixer's bf16
  output, and ``STATE_TOL`` 1e-4 for its f32 state.

Two mutants must fail: the decay masked after its ``exp`` (by a
product, which meets 0 * inf on a stiff chunk) and ``conv_w`` rounded to
bf16 (the reference keeps it f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import mamba2 as RM
from repro_torch.configs import smoke_config
from repro_torch.models import mamba2 as TM

SSD_TOL, CONV_TOL, TOL, STATE_TOL = 1e-4, 1e-5, 4e-2, 1e-4
ARCH = "mamba2-130m"


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _ssd_inputs(seed, B=2, S=32, H=3, P=4, N=5, *, stiff=False,
                init=False):
    """(x, dt, A, Bm, Cm, init_state) as f32 numpy.  ``stiff`` steps are
    large enough that exp(seg_q - seg_k) overflows for q < k within a
    chunk of 8, as at the full config's chunk of 256."""
    rng = np.random.default_rng(seed)
    dt = (rng.uniform(0.5, 2.0, (B, S, H)) if stiff
          else rng.uniform(0.01, 0.2, (B, S, H)))
    A = np.log(rng.uniform(4.0, 16.0, H) if stiff else rng.uniform(0.5, 4.0, H))
    out = [rng.standard_normal((B, S, H, P)), dt, A,
           rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
           rng.standard_normal((B, H, P, N)) if init else None]
    return [None if a is None else np.asarray(a, np.float32) for a in out]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.as_tensor(a) for a in args]


# ------------------------------------------------------------------ conv ---
def _conv_inputs(seed, state):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((2, 7, 24)),
                        dtype=torch.float32).to(torch.bfloat16)
    w = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
    st = (torch.as_tensor(rng.standard_normal((2, 3, 24)),
                          dtype=torch.float32).to(torch.bfloat16)
          if state else None)
    return x, w, st


def _ref_conv(x, w, st):
    return RM._causal_conv(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                           jnp.asarray(w),
                           None if st is None else
                           jnp.asarray(st.float().numpy()).astype(jnp.bfloat16))


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_matches_reference(state):
    """bf16 inputs, f32 taps summed in f32: the output and the carried
    bf16 state, with and without a state carried in."""
    x, w, st = _conv_inputs(1, state)
    want, want_state = _ref_conv(x, w, st)
    got, got_state = TM._causal_conv(x, torch.as_tensor(w), st)
    assert got.dtype == torch.float32 and got_state.dtype == torch.bfloat16
    assert _rel(want, _np(got)) < CONV_TOL
    np.testing.assert_array_equal(np.asarray(want_state, np.float32),
                                  _np(got_state))


def test_conv_weights_rounded_to_bf16_fail():
    """The mutant: conv_w rounded to bf16 (every other weight's dtype)."""
    x, w, st = _conv_inputs(1, True)
    want, _ = _ref_conv(x, w, st)
    got, _ = TM._causal_conv(x, torch.as_tensor(w).to(torch.bfloat16)
                             .to(torch.float32), st)
    assert _rel(want, _np(got)) > 10 * CONV_TOL


# ------------------------------------------------------------------- SSD ---
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference(chunk, init):
    args = _ssd_inputs(2, init=init)
    *a, h0 = args
    want_y, want_h = RM.ssd_chunked(*_jax(a), chunk=chunk,
                                    init_state=_jax([h0])[0])
    got_y, got_h = TM.ssd_chunked(*_torch(a), chunk=chunk,
                                  init_state=_torch([h0])[0])
    assert got_y.dtype == got_h.dtype == torch.float32
    assert _rel(want_y, _np(got_y)) < SSD_TOL
    assert _rel(want_h, _np(got_h)) < SSD_TOL


@pytest.mark.parametrize("init", [False, True])
def test_ssd_naive_matches_reference(init):
    *a, h0 = _ssd_inputs(3, init=init)
    want_y, want_h = RM.ssd_naive(*_jax(a), init_state=_jax([h0])[0])
    got_y, got_h = TM.ssd_naive(*_torch(a), init_state=_torch([h0])[0])
    assert _rel(want_y, _np(got_y)) < SSD_TOL
    assert _rel(want_h, _np(got_h)) < SSD_TOL


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_equals_naive(chunk, init):
    """The port's two scans agree (chunk 32 is the whole sequence)."""
    *a, h0 = _torch(_ssd_inputs(4, init=init))
    y1, h1 = TM.ssd_chunked(*a, chunk=chunk, init_state=h0)
    y2, h2 = TM.ssd_naive(*a, init_state=h0)
    assert _rel(_np(y2), _np(y1)) < SSD_TOL
    assert _rel(_np(h2), _np(h1)) < SSD_TOL


def test_ssd_chunked_rejects_a_ragged_sequence():
    *a, _ = _torch(_ssd_inputs(4, S=12))
    with pytest.raises(ValueError, match="chunk"):
        TM.ssd_chunked(*a, chunk=8)


def test_ssd_masks_the_decay_before_its_exp(monkeypatch):
    """A stiff chunk: the q < k differences overflow exp, so the mask must
    come first.  The port stays finite and equal to the naive scan; the
    mutant that masks after the exp (by a product) meets 0 * inf."""
    *a, _ = _torch(_ssd_inputs(5, stiff=True))
    y1, h1 = TM.ssd_chunked(*a, chunk=8)
    y2, h2 = TM.ssd_naive(*a)
    assert torch.isfinite(y1).all() and torch.isfinite(h1).all()
    assert _rel(_np(y2), _np(y1)) < SSD_TOL
    assert _rel(_np(h2), _np(h1)) < SSD_TOL

    def after_exp(seg):
        Q = seg.shape[2]
        causal = torch.ones((Q, Q), dtype=torch.bool).tril()
        rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]
        return torch.exp(rel) * causal[:, :, None]

    monkeypatch.setattr(TM, "_intra_decay", after_exp)
    y3, _ = TM.ssd_chunked(*a, chunk=8)
    assert not torch.isfinite(y3).all()


# ----------------------------------------------------------------- mixer ---
@pytest.fixture(scope="module")
def mixer_pair():
    """The reference's init_mamba tree (D, dt_bias, norm redrawn) and the
    port's Mamba2Mixer holding it."""
    cfg = smoke_config(ARCH)
    tree = dict(RM.init_mamba(jax.random.PRNGKey(4), ref_smoke_config(ARCH)))
    rng = np.random.default_rng(5)
    for name in ("D", "dt_bias", "norm"):
        tree[name] = jnp.asarray(
            1.0 + 0.5 * rng.standard_normal(tree[name].shape), jnp.float32)
    mixer = TM.Mamba2Mixer(cfg)
    with torch.no_grad():
        for name, w in tree.items():
            getattr(mixer, name).copy_(torch.as_tensor(np.array(w)))
    return cfg, tree, mixer


def _u(seed, B, S, d):
    x = np.random.default_rng(seed).standard_normal((B, S, d))
    t = torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def test_mamba_forward_matches_reference(mixer_pair):
    """Two chunks of the smoke config's 32, the states returned."""
    cfg, tree, mixer = mixer_pair
    uj, ut = _u(6, 2, 2 * cfg.ssm.chunk, cfg.d_model)
    want, (wh, wc) = RM.mamba_forward(tree, cfg, uj, return_state=True)
    got, (gh, gc) = TM.mamba_forward(mixer, cfg, ut, return_state=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert gh.dtype == torch.float32 and gc.dtype == torch.bfloat16
    assert _rel(want, _np(got)) < TOL
    assert _rel(wh, _np(gh)) < STATE_TOL
    assert _rel(np.asarray(wc, np.float32), _np(gc)) < STATE_TOL


def test_mamba_decode_matches_reference(mixer_pair):
    """Eight decode steps from a zero state (the engine's bf16 conv)."""
    cfg, tree, mixer = mixer_pair
    uj, ut = _u(7, 2, 8, cfg.d_model)
    ref = RM.init_mamba_state(ref_smoke_config(ARCH), 2, jnp.bfloat16)
    port = TM.init_mamba_state(cfg, 2, torch.bfloat16)
    for t in range(8):
        want, ref = RM.mamba_decode(tree, cfg, uj[:, t:t + 1], ref)
        got, port = TM.mamba_decode(mixer, cfg, ut[:, t:t + 1], port)
        assert _rel(want, _np(got)) < TOL, t
    assert _rel(ref[0], _np(port[0])) < STATE_TOL
    assert port[1].dtype == torch.bfloat16
    assert _rel(np.asarray(ref[1], np.float32), _np(port[1])) < STATE_TOL


def test_prefill_then_decode_equals_the_full_forward_pass(mixer_pair):
    """forward(S-1) then decode(1) on the carried state equals one pass
    over S with the whole sequence as a chunk (the counterpart of the
    reference's test_mamba_prefill_then_decode_matches_full), here held
    to TOL of max |output| instead of its rtol = atol = 0.05."""
    cfg, _, mixer = mixer_pair
    _, u = _u(8, 2, 33, cfg.d_model)
    _, state = TM.mamba_forward(mixer, cfg, u[:, :32], return_state=True)
    y_dec, _ = TM.mamba_decode(mixer, cfg, u[:, 32:], state)
    whole = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                             chunk=33))
    y_all = TM.mamba_forward(mixer, whole, u)
    assert _rel(_np(y_all[:, -1]), _np(y_dec[:, 0])) < TOL


def test_init_state_has_the_reference_shapes():
    cfg = smoke_config(ARCH)
    h, conv = TM.init_mamba_state(cfg, 3, torch.bfloat16)
    rh, rconv = RM.init_mamba_state(ref_smoke_config(ARCH), 3, jnp.bfloat16)
    assert h.shape == rh.shape and h.dtype == torch.float32
    assert conv.shape == rconv.shape and conv.dtype == torch.bfloat16
    assert not h.any() and not conv.any()

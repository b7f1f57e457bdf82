"""The port's kernels (repro_torch.kernels) against the reference Pallas
kernels (interpret mode on the CPU) and against the port's own oracles.

On the CPU the port's ops run the plain PyTorch versions; the CUDA kernels
are held against those plain versions in tests/test_torch_cuda.py.
Tolerances: keep, counts and dims exact; partial and
adist within rtol 1e-4, atol 1e-3 (float32 sums taken in another order).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import dco_scan_op as jax_dco_scan_op
from repro.kernels.ops import pq_lookup_op as jax_pq_lookup_op
from repro_torch.kernels import dco_scan as dco_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pq_lookup as pq_mod

DCO_CASES = [(256, 128, 128), (300, 17, 130), (64, 8, 96), (1000, 5, 256),
             (128, 1, 32)]
PQ_CASES = [(300, 9, 16, 256), (128, 8, 8, 64), (65, 3, 4, 16)]


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode()) % 2 ** 31


def _dco_inputs(n, q, d1, kind, tau_lo=0.5, tau_hi=2.5):
    rng = np.random.default_rng(_seed(n, q, d1, kind))
    x = rng.standard_normal((n, d1)).astype(np.float32)
    qq = rng.standard_normal((q, d1)).astype(np.float32)
    tau = rng.uniform(d1 * tau_lo, d1 * tau_hi, q).astype(np.float32)
    return x, qq, tau


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("n,q,d1", DCO_CASES)
@pytest.mark.parametrize("kind", ["lb", "adsampling", "ratio"])
def test_dco_scan_matches_jax_and_ref(n, q, d1, kind):
    x, qq, tau = _dco_inputs(n, q, d1, kind)
    jsc = jref.make_dco_scales(kind, d1, 128, D=2 * d1, theta=0.8)
    tsc = ref.make_dco_scales(kind, d1, 128, D=2 * d1, theta=0.8)
    np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy())
    jp, jk, jc, jd = (np.asarray(a) for a in jax_dco_scan_op(
        jnp.asarray(x), jnp.asarray(qq), jnp.asarray(tau), jsc))
    tp, tk, tc, td = (a.numpy() for a in ops.dco_scan_op(*_t(x, qq, tau), tsc))
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    rp, rk = ref.dco_scan_ref(*_t(x, qq, tau), tsc, 128)
    np.testing.assert_allclose(tp, rp.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tk, rk.numpy())
    np.testing.assert_array_equal(tc, ref.block_keep_counts_ref(rk, 256).numpy())


def test_dco_scan_nrows_masks_padding():
    """Rows at or beyond nrows never keep and never count — the streaming
    engine relies on this for its last (ragged) corpus block."""
    n, q, d1, nvalid = 300, 9, 64, 210
    x, qq, tau = _dco_inputs(n, q, d1, "nrows", 1.0, 3.0)
    sc = ref.make_dco_scales("lb", d1, 64, D=d1)
    xt, qt, taut = _t(x, qq, tau)
    _, k_full, _, _ = ops.dco_scan_op(xt, qt, taut, sc, block_d=64)
    _, k_cut, c_cut, d_cut = ops.dco_scan_op(
        xt, qt, taut, sc, torch.tensor([nvalid], dtype=torch.int32),
        block_d=64)
    np.testing.assert_array_equal(k_cut[:nvalid], k_full[:nvalid])
    assert (k_cut[nvalid:] == 0).all()
    np.testing.assert_array_equal(c_cut.sum(0), k_cut.sum(0, dtype=torch.int32))
    _, jk, jc, jd = (np.asarray(a) for a in jax_dco_scan_op(
        jnp.asarray(x), jnp.asarray(qq), jnp.asarray(tau),
        jref.make_dco_scales("lb", d1, 64, D=d1), nvalid, block_d=64))
    np.testing.assert_array_equal(k_cut.numpy(), jk)
    np.testing.assert_array_equal(c_cut.numpy(), jc)
    np.testing.assert_array_equal(d_cut.numpy(), jd)


@pytest.mark.parametrize("n,q,d1,block_d,nrows", [
    (300, 9, 130, 64, None), (300, 9, 130, 64, 257), (512, 16, 256, 128, 400),
])
def test_dco_scan_dims_matches_oracle(n, q, d1, block_d, nrows):
    """The dims output (dims entered per row block) equals the port's
    oracle and the reference kernel, exactly."""
    x, qq, tau = _dco_inputs(n, q, d1, "dims", 0.3, 1.5)
    sc = ref.make_dco_scales("lb", d1, block_d, D=d1)
    xt, qt, taut = _t(x, qq, tau)
    nr = n if nrows is None else nrows
    _, _, _, dims = ops.dco_scan_op(xt, qt, taut, sc, nr, block_n=128,
                                    block_d=block_d)
    want = ref.dco_scan_dims_ref(xt, qt, taut, sc, block_d, 128, nrows=nr)
    np.testing.assert_array_equal(dims.numpy(), want.numpy())
    jwant = jref.dco_scan_dims_ref(jnp.asarray(x), jnp.asarray(qq),
                                   jnp.asarray(tau),
                                   jref.make_dco_scales("lb", d1, block_d, D=d1),
                                   block_d, 128, nrows=nr)
    np.testing.assert_array_equal(dims.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("n,q,m,k", PQ_CASES)
def test_pq_lookup_matches_jax_and_ref(n, q, m, k):
    rng = np.random.default_rng(_seed(n, q, m, k))
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    lut = rng.standard_normal((q, m, k)).astype(np.float32)
    got = ops.pq_lookup_op(*_t(codes, lut)).numpy()
    want = np.asarray(jax_pq_lookup_op(jnp.asarray(codes), jnp.asarray(lut)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        got, ref.pq_lookup_ref(*_t(codes, lut)).numpy(), rtol=1e-4, atol=1e-3)


def test_cpu_tensors_never_launch_a_kernel():
    """On CPU tensors the ops take the plain versions, which never count a
    launch."""
    before = (dco_mod.launches, pq_mod.launches)
    x, qq, tau = _dco_inputs(64, 4, 32, "count")
    ops.dco_scan_op(*_t(x, qq, tau), ref.make_dco_scales("lb", 32, 32, D=32))
    ops.pq_lookup_op(torch.zeros((8, 2), dtype=torch.int32),
                     torch.ones((3, 2, 4)))
    assert (dco_mod.launches, pq_mod.launches) == before

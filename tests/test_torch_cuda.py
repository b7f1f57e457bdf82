"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These tests need a CUDA card and skip without one; the module
imports no jax, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import dco_scan as dco_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pq_lookup as pq_mod

DCO_CASES = [(256, 128, 128), (300, 17, 130), (64, 8, 96), (1000, 5, 256),
             (128, 1, 32), (4096, 16, 128)]
PQ_CASES = [(300, 9, 16, 256), (128, 8, 8, 64), (65, 3, 4, 16),
            (4096, 16, 16, 256), (1000, 21, 4, 16)]
#: (n, q, G, dg, d1): the PDX main path's shape (4 groups of 32), ragged
#: dg (not a multiple of the kernel's 32-dim slice, down to 1), a ragged
#: last group, G = 5, and G = 1
GROUPED_CASES = [(4096, 16, 4, 32, 128), (300, 17, 4, 10, 38),
                 (257, 128, 5, 33, 161), (64, 5, 3, 1, 3),
                 (1000, 16, 1, 48, 48)]


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode()) % 2 ** 31


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")



@pytest.mark.cuda
@pytest.mark.parametrize("n,q,d1", DCO_CASES)
@pytest.mark.parametrize("kind", ["lb", "adsampling", "ratio"])
def test_dco_scan_kernel_matches_plain(cuda_device, n, q, d1, kind):
    """Integer-valued inputs make every sum exact in float32, so the kernel
    and the plain version agree bit for bit whatever their summation
    order."""
    rng = np.random.default_rng(_seed("cuda", n, q, d1, kind))
    x = rng.integers(-4, 5, (n, d1)).astype(np.float32)
    qq = rng.integers(-4, 5, (q, d1)).astype(np.float32)
    tau = rng.uniform(d1 * 2.0, d1 * 10.0, q).astype(np.float32)
    tau[::5] = -1.0                       # padded queries prune everything
    sc = ref.make_dco_scales(kind, d1, 128, D=2 * d1, theta=0.8,
                             device=cuda_device)
    xt, qt, taut = _t(x, qq, tau, device=cuda_device)
    nr = torch.tensor([n - n // 7], dtype=torch.int32, device=cuda_device)
    before = dco_mod.launches
    got = ops.dco_scan_op(xt, qt, taut, sc, nr)
    assert dco_mod.launches == before + 1
    want = ops.dco_scan_op(xt.cpu(), qt.cpu(), taut.cpu(), sc.cpu(), nr.cpu())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,m,k", PQ_CASES)
def test_pq_lookup_kernel_matches_plain(cuda_device, n, q, m, k):
    rng = np.random.default_rng(_seed("cuda", n, q, m, k))
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    lut = rng.standard_normal((q, m, k)).astype(np.float32)
    before = pq_mod.launches
    got = ops.pq_lookup_op(*_t(codes, lut, device=cuda_device))
    assert pq_mod.launches == before + 1
    want = ops.pq_lookup_op(*_t(codes, lut))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)


def _grouped_inputs(rng, n, q, G, dg, d1, device):
    """Integer-valued x (G, n, dg) and q (G, q, dg) whose dims past d1 are
    zero (the layout's padding), their logical widths, and tau."""
    x = np.zeros((G, n, dg), np.float32)
    qq = np.zeros((G, q, dg), np.float32)
    for g in range(G):
        w = min(dg, d1 - g * dg)
        x[g, :, :w] = rng.integers(-4, 5, (n, w))
        qq[g, :, :w] = rng.integers(-4, 5, (q, w))
    widths = np.array([min(dg, d1 - g * dg) for g in range(G)], np.float32)
    tau = rng.uniform(d1 * 2.0, d1 * 10.0, q).astype(np.float32)
    tau[::5] = -1.0                       # padded queries prune everything
    return _t(x, qq, tau, widths, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,G,dg,d1", GROUPED_CASES)
@pytest.mark.parametrize("kind", ["lb", "adsampling"])
def test_dco_scan_grouped_kernel_matches_plain(cuda_device, n, q, G, dg, d1,
                                               kind):
    """Integer-valued inputs: every float32 sum is exact in any order, so
    the grouped kernel and its plain version agree bit for bit."""
    rng = np.random.default_rng(_seed("cuda-grouped", n, q, G, dg, kind))
    xt, qt, taut, wt = _grouped_inputs(rng, n, q, G, dg, d1, cuda_device)
    sc = ref.make_dco_scales(kind, G * dg, dg, D=2 * d1,
                             device=cuda_device)
    nr = torch.tensor([n - n // 7], dtype=torch.int32, device=cuda_device)
    before = (dco_mod.launches, dco_mod.grouped_launches)
    got = ops.dco_scan_grouped_op(xt, qt, taut, sc, wt, nr)
    assert (dco_mod.launches, dco_mod.grouped_launches) == (
        before[0], before[1] + 1)
    want = ops.dco_scan_grouped_op(xt.cpu(), qt.cpu(), taut.cpu(), sc.cpu(),
                                   wt.cpu(), nr.cpu())
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,dg", [(4096, 16, 128), (300, 17, 40)])
def test_dco_scan_grouped_one_group_is_the_flat_kernel(cuda_device, n, q,
                                                       dg):
    """G = 1 at dg == block_d reads the same dims in the same order as the
    flat kernel: Gaussian inputs, all four outputs equal bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(_seed(n, q, dg))
    x = torch.randn(n, dg, device=cuda_device, generator=gen)
    qq = torch.randn(q, dg, device=cuda_device, generator=gen)
    tau = torch.rand(q, device=cuda_device, generator=gen) * 3 * dg
    sc = torch.ones(1, device=cuda_device)
    flat = ops.dco_scan_op(x, qq, tau, sc, block_d=dg)
    grouped = ops.dco_scan_grouped_op(x[None], qq[None], tau, sc,
                                      torch.full((1,), float(dg),
                                                 device=cuda_device))
    torch.cuda.synchronize()
    for f, g in zip(flat, grouped):
        assert torch.equal(f, g)

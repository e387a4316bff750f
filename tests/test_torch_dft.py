r"""The port's RealDFT2 and DFT kernel wrappers against the JAX package.

The five cases of ``tests/test_pallas_dft.py`` with its tolerances (1e-3
forward, 1e-4 inverse and round trip, 1e-2 gradients, 5e-3 one solver step),
against JAX ``RealDFT2(method='pallas')`` in interpret mode and
``method='matmul'``. On the CPU the port's ``'kernel'`` method runs each
kernel's plain version; the kernels themselves are held against those plain
versions on the card (``test_torch_dft_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.ops import RealDFT2 as JRealDFT2
from sda_tpu_torch.ops import RealDFT2, dft_kernels


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def dfts():
    n, m = 32, 11
    mat = JRealDFT2(n, n, method='matmul', h_modes=m, w_modes=m)
    pal = JRealDFT2(n, n, method='pallas', h_modes=m, w_modes=m)
    ker = RealDFT2(n, n, method='kernel', h_modes=m, w_modes=m, device='cpu')
    return mat, pal, ker


def test_rfft2_matches_jax(dfts):
    mat, pal, ker = dfts
    x = randn(0, 3, 32, 32)

    r2, i2 = ker.rfft2(t(x))
    for ref in (mat, pal):
        r1, i1 = ref.rfft2(jnp.asarray(x))
        np.testing.assert_allclose(r2.numpy(), np.asarray(r1), atol=1e-3)
        np.testing.assert_allclose(i2.numpy(), np.asarray(i1), atol=1e-3)


def test_irfft2_matches_jax(dfts):
    mat, pal, ker = dfts
    x = randn(1, 2, 32, 32)

    re, im = mat.rfft2(jnp.asarray(x))
    y2 = ker.irfft2(t(re), t(im)).numpy()

    for ref in (mat, pal):
        np.testing.assert_allclose(y2, np.asarray(ref.irfft2(re, im)), atol=1e-4)


def test_roundtrip_with_extra_batch_axes(dfts):
    mat, _, ker = dfts
    x = randn(2, 2, 3, 32, 32)

    re, im = ker.rfft2(t(x))
    assert re.shape == (2, 3, 21, 11)

    want = mat.irfft2(*mat.rfft2(jnp.asarray(x)))
    np.testing.assert_allclose(ker.irfft2(re, im).numpy(), np.asarray(want), atol=1e-4)


def test_gradients_match_jax(dfts):
    mat, pal, ker = dfts
    x = randn(3, 1, 32, 32)

    def jloss(dft, x):
        re, im = dft.rfft2(x)
        y = dft.irfft2(re * 0.5 + 1.0, im * 2.0)
        return jnp.sum(y**2) + jnp.sum(re * im)

    xt = t(x).requires_grad_(True)
    re, im = ker.rfft2(xt)
    y = ker.irfft2(re * 0.5 + 1.0, im * 2.0)
    (torch.sum(y**2) + torch.sum(re * im)).backward()

    for ref in (mat, pal):
        g = jax.grad(lambda x: jloss(ref, x))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), atol=1e-2)


def test_solver_step_with_kernel_method_matches_jax():
    from sda_tpu.dynamics import KolmogorovFlow as JKolmogorovFlow
    from sda_tpu_torch.dynamics import KolmogorovFlow

    ref = JKolmogorovFlow(size=32, dt=0.05, dft_method='matmul')
    pal = JKolmogorovFlow(size=32, dt=0.05, dft_method='pallas')
    ker = KolmogorovFlow(size=32, dt=0.05, dft_method='kernel', device='cpu')

    x = ref.prior(jax.random.key(0), ())
    y = ker.transition(t(x)).numpy()

    np.testing.assert_allclose(y, np.asarray(ref.transition(None, x)), atol=5e-3)
    np.testing.assert_allclose(y, np.asarray(pal.transition(None, x)), atol=5e-3)


@pytest.mark.parametrize('size, modes', [(32, None), (24, 9)])
def test_full_and_truncated_spectra_match_numpy(size, modes):
    r"""Untruncated, the pair is ``numpy.fft.rfft2``; truncated, its kept
    rows and columns (float32 sums over ``size^2`` terms of magnitude ~1)."""

    x = randn(4, 2, size, size)
    dft = RealDFT2(size, size, method='matmul', h_modes=modes, w_modes=modes, device='cpu')
    re, im = dft.rfft2(t(x))

    want = np.fft.rfft2(x)
    if modes is not None:
        rows = np.r_[0:modes, size - modes + 1:size]
        want = want[:, rows, :modes]
    np.testing.assert_allclose(re.numpy(), want.real, atol=1e-4)
    np.testing.assert_allclose(im.numpy(), want.imag, atol=1e-4)

    if modes is None:
        np.testing.assert_allclose(dft.irfft2(re, im).numpy(), x, atol=1e-5)


def test_kernel_gradients_are_the_transposed_maps(monkeypatch):
    r"""The autograd Functions around the kernels, with the launches swapped
    for the plain versions: their hand-written backward passes
    (``_rfft2_bwd``/``_irfft2_bwd``) against autograd through the plain
    contractions (float32 sums over 32 x 32 terms)."""

    monkeypatch.setattr(dft_kernels, 'launch_rfft2', dft_kernels.rfft2_plain)
    monkeypatch.setattr(dft_kernels, 'launch_irfft2', dft_kernels.irfft2_plain)
    dft = RealDFT2(32, 32, method='matmul', h_modes=11, w_modes=11, device='cpu')
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    x = t(randn(5, 2, 32, 32))
    gre, gim, gx = t(randn(6, 2, 21, 11)), t(randn(7, 2, 21, 11)), t(randn(8, 2, 32, 32))

    def vjp_rfft2(fn):
        xi = x.clone().requires_grad_(True)
        re, im = fn(xi, *bases)
        torch.autograd.backward((re, im), (gre, gim))
        return xi.grad

    def vjp_irfft2(fn):
        re = gre.clone().requires_grad_(True)
        im = gim.clone().requires_grad_(True)
        fn(re, im, *bases, dft.weight_w).backward(gx)
        return re.grad, im.grad

    np.testing.assert_allclose(
        vjp_rfft2(dft_kernels._RFFT2.apply), vjp_rfft2(dft_kernels.rfft2_plain), atol=1e-4,
    )
    for got, want in zip(vjp_irfft2(dft_kernels._IRFFT2.apply), vjp_irfft2(dft_kernels.irfft2_plain)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_auto_method_and_cpu_dispatch():
    dft = RealDFT2(16, 16, h_modes=6, w_modes=6, device='cpu')
    assert dft.method == 'matmul'
    with pytest.raises(ValueError):
        RealDFT2(16, 16, method='fft', device='cpu')

    # On a CPU tensor the wrappers run the plain versions and launch nothing.
    dft_kernels.reset_launches()
    x = t(randn(9, 1, 16, 16))
    re, im = dft_kernels.rfft2(x, dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    dft_kernels.irfft2(re, im, dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h, dft.weight_w)
    assert dft_kernels.launches == {'rfft2': 0, 'irfft2': 0}


def test_nvcc_command_targets_hopper(tmp_path):
    cmd = dft_kernels.nvcc_command(tmp_path / 'lib.so')

    assert cmd[1:3] == ['-gencode', 'arch=compute_90a,code=sm_90a']
    assert '-shared' in cmd and str(dft_kernels.SOURCE) == cmd[-1]
    assert 'torch/extension.h' not in dft_kernels.SOURCE.read_text()


@pytest.mark.parametrize('n', [1, 4, 5, 16, 65535])
def test_default_tiles_are_built_into_the_library(n):
    r"""Each batch's default tile is one the C launchers dispatch on, and
    the wrapper's tile lists are exactly the launchers' cases."""

    import re

    source = dft_kernels.SOURCE.read_text()
    forward = source[source.index('int sda_rfft2('):source.index('int sda_irfft2(')]
    inverse = source[source.index('int sda_irfft2('):]
    cases = lambda text: tuple(int(c) for c in re.findall(r'case (\d+):', text))

    assert cases(forward) == dft_kernels.RFFT2_TILES
    assert cases(inverse) == dft_kernels.IRFFT2_TILES
    assert dft_kernels.rfft2_tile(n) in dft_kernels.RFFT2_TILES
    assert dft_kernels.irfft2_tile(n) in dft_kernels.IRFFT2_TILES

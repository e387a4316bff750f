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

    dft = RealDFT2(32, 32, method='kernel', h_modes=11, w_modes=11, device='cpu')
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    monkeypatch.setattr(dft_kernels, 'launch_rfft2', lambda x, plan: dft_kernels.rfft2_plain(x, *bases))
    monkeypatch.setattr(
        dft_kernels, 'launch_irfft2',
        lambda re, im, dw, plan: dft_kernels.irfft2_plain(re, im, *bases, dw),
    )
    plain_rfft2 = lambda x, *bases: dft_kernels.rfft2_plain(x, *bases[:4])
    plain_irfft2 = lambda re, im, *bases: dft_kernels.irfft2_plain(re, im, *bases[:5])
    x = t(randn(5, 2, 32, 32))
    gre, gim, gx = t(randn(6, 2, 21, 11)), t(randn(7, 2, 21, 11)), t(randn(8, 2, 32, 32))

    def vjp_rfft2(fn):
        xi = x.clone().requires_grad_(True)
        re, im = fn(xi, *bases, dft.plan)
        torch.autograd.backward((re, im), (gre, gim))
        return xi.grad

    def vjp_irfft2(fn):
        re = gre.clone().requires_grad_(True)
        im = gim.clone().requires_grad_(True)
        fn(re, im, *bases, dft.weight_w, dft.plan).backward(gx)
        return re.grad, im.grad

    np.testing.assert_allclose(
        vjp_rfft2(dft_kernels._RFFT2.apply), vjp_rfft2(plain_rfft2), atol=1e-4,
    )
    for got, want in zip(vjp_irfft2(dft_kernels._IRFFT2.apply), vjp_irfft2(plain_irfft2)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_auto_method_and_cpu_dispatch():
    dft = RealDFT2(16, 16, h_modes=6, w_modes=6, device='cpu')
    assert dft.method == 'matmul'
    with pytest.raises(ValueError):
        RealDFT2(16, 16, method='pallas', device='cpu')
    assert RealDFT2(16, 16, method='fft', device='cpu').method == 'fft'

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
def test_default_clusters_are_built_into_the_library(n):
    r"""Each batch's default cluster size is one the C launchers take, and
    the wrapper's cluster list is exactly each launcher's cases."""

    import re

    source = dft_kernels.SOURCE.read_text()
    forward = source[source.index('int sda_rfft2('):source.index('int sda_irfft2(')]
    inverse = source[source.index('int sda_irfft2('):]
    cases = lambda text: tuple(int(c) for c in re.findall(r'case (\d+):', text))

    assert cases(forward) == cases(inverse) == dft_kernels.CLUSTERS
    assert dft_kernels.cluster_size(n) in dft_kernels.CLUSTERS
    c = dft_kernels.cluster_size(n)
    assert n * c <= dft_kernels.WAVE_BLOCKS or c == min(dft_kernels.CLUSTERS)  # one wave if it can


# -- The kernels' algorithm, replayed with torch on the CPU ---------------------
#
# csrc/dft.cu cannot run here. These functions apply the Plan's tables with
# the kernels' own index arithmetic (Stockham stages, row packing, bands of a
# cluster), so the tables and the indexing are tested where no kernel runs.


def _table(t):
    return torch.complex(t[:, 0].double(), t[:, 1].double()).to(torch.complex64)


def _dft4(v):
    r"""``dft4`` of csrc/dft.cu over the last axis."""

    a0, a1 = v[..., 0] + v[..., 2], v[..., 0] - v[..., 2]
    a2, a3 = v[..., 1] + v[..., 3], v[..., 1] - v[..., 3]
    return torch.stack((a0 + a2, a1 - 1j * a3, a0 - a2, a1 + 1j * a3), -1)


def _fft(z, plan, table):
    r"""``fft`` of csrc/dft.cu on ``z (count, n)``."""

    plan, table = plan.tolist(), _table(table)
    n, stages = plan[0], plan[1]
    ns = 1
    for s in range(stages):
        r, tw, mat = plan[2 + s], plan[2 + stages + s], plan[2 + 2 * stages + s]
        m = n // r
        j = torch.arange(m)
        k = j % ns
        q = torch.arange(r)
        v = z[:, j[:, None] + q * m] * table[tw + q * ns + k[:, None]]  # (count, m, r)
        if r == 16:  # 4 x 4 in registers: X_{p1 + 4 p2} lands in v[4 p1 + p2]
            v = _dft4(v.unflatten(-1, (4, 4)).transpose(-1, -2)).transpose(-1, -2)  # over q1
            p1 = torch.arange(4)
            v = v * torch.exp(-2j * np.pi * p1[:, None] * p1 / 16).to(v.dtype)
            y = _dft4(v).flatten(-2)  # over q2: y[4 p1 + p2]
            y = y[..., 4 * (q % 4) + q // 4]
        elif r == 4:
            y = _dft4(v)
        elif r == 2:
            y = torch.stack((v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]), -1)
        else:
            y = v @ table[mat:mat + r * r].reshape(r, r).T
        out = torch.empty_like(z)
        out[:, ((j - k) * r + k)[:, None] + q * ns] = y
        z, ns = out, ns * r
    return z


def _bands(length, cluster):
    band = -(-length // cluster)
    return [(b * band, min(length, (b + 1) * band)) for b in range(cluster) if b * band < length]


def emulate_rfft2(x, plan, cluster):
    height, width = plan.height, plan.width
    kh, fw = plan.spectral_shape
    rows = plan.rows_h.long()
    out = []
    for field in x:
        slice_ = torch.empty(height, fw, dtype=torch.complex64)
        for r0, r1 in _bands(height, cluster):
            band = field[r0:r1]
            if len(band) % 2:
                band = torch.cat((band, torch.zeros(1, width)))
            z = _fft(torch.complex(band[0::2], band[1::2]), plan.plan_w, plan.table)
            f = torch.arange(fw)
            zk, zm = z[:, f], z[:, (width - f) % width]
            a, b = (zk + zm.conj()) / 2, -0.5j * (zk - zm.conj())
            slice_[r0:r1] = torch.stack((a, b), 1).reshape(-1, fw)[:r1 - r0]
        y = _fft(slice_.T.contiguous(), plan.plan_h, plan.table)  # (fw, height)
        out.append(y[:, rows].T)
    out = torch.stack(out)
    return out.real, out.imag


def emulate_irfft2(re, im, dw, plan, cluster):
    height, width = plan.height, plan.width
    kh, fw = plan.spectral_shape
    rows = plan.rows_h.long()
    out = []
    for spec in torch.complex(re, im):
        z = torch.zeros(fw, height, dtype=torch.complex64)
        z[:, rows] = spec.T.conj()
        slice_ = _fft(z, plan.plan_h, plan.table).conj().T  # (height, fw)
        field = torch.empty(height, width)
        k = torch.arange(width)
        m = (width - k) % width
        for r0, r1 in _bands(height, cluster):
            band = slice_[r0:r1]
            if len(band) % 2:
                band = torch.cat((band, torch.zeros(1, fw, dtype=band.dtype)))
            ya, yb = band[0::2], band[1::2]
            pad = lambda y: torch.cat((y * dw / 2, torch.zeros(len(y), width - fw)), 1)
            za, zb = pad(ya), pad(yb)
            zsum = (za + 1j * zb) + (za[:, m].conj() + 1j * zb[:, m].conj())
            y = _fft(zsum.conj(), plan.plan_w, plan.table).conj()
            field[r0:r1] = torch.stack((y.real, y.imag), 1).reshape(-1, width)[:r1 - r0]
        out.append(field / (height * width))
    return torch.stack(out)


@pytest.mark.parametrize('h, w, hm, wm, cluster', [
    (256, 256, 86, 86, 8), (256, 256, 86, 86, 16), (45, 80, 12, 22, 8), (45, 80, 12, 22, 2),
    (32, 32, 11, 11, 8), (37, 50, 13, 17, 4), (64, 64, None, None, 16), (64, 64, None, None, 2),
    (128, 128, 43, 43, 16), (128, 128, 43, 43, 4), (128, 128, 43, 43, 2),
])
def test_factorised_tables_match_plain(h, w, hm, wm, cluster):
    r"""The kernels' algorithm with the Plan's tables against the plain
    contractions, at the card tests' tolerances."""

    dft = RealDFT2(h, w, method='kernel', h_modes=hm, w_modes=wm, device='cpu')
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    x = t(randn(10, 2, h, w))

    re0, im0 = dft_kernels.rfft2_plain(x, *bases)
    re, im = emulate_rfft2(x, dft.plan, cluster)
    tol = 1e-3 * np.sqrt(h * w / 32**2)
    np.testing.assert_allclose(re.numpy(), re0.numpy(), atol=tol)
    np.testing.assert_allclose(im.numpy(), im0.numpy(), atol=tol)

    y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
    y = emulate_irfft2(re0, im0, dft.weight_w, dft.plan, cluster)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-4)


@pytest.mark.parametrize('n', [256, 128, 80, 45, 37, 50, 32, 1])
def test_axis_plan_is_an_fft(n):
    r"""One axis's plan and table, applied as the kernel applies them, is the
    DFT (float32 tables, float32 sums over ``n`` terms of size ~1)."""

    plan, table = (torch.as_tensor(a) for a in dft_kernels.axis_plan(n))
    z = randn(11, 3, n) + 1j * randn(12, 3, n)

    assert int(np.prod(dft_kernels.factorise(n))) == n
    np.testing.assert_allclose(
        _fft(torch.as_tensor(z.astype(np.complex64)), plan, table).numpy(), np.fft.fft(z), atol=1e-4 * n,
    )

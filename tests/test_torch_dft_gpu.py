r"""The CUDA DFT kernels against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device. The card's machine
has no JAX, so run this file there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_dft_gpu.py

This file imports only the port and torch. The plain versions run in true
float32 (``allow_tf32`` off), like ``Precision.HIGHEST`` in the JAX package.
Tolerances are ``tests/test_pallas_dft.py``'s (1e-3 forward, 1e-4 inverse
and round trip, 1e-2 gradients, 5e-3 one solver step); the forward one is
scaled by ``sqrt(H W / 32^2)``, because spectra of unit white noise grow as
``sqrt(H W)`` and that test's fields are 32^2.
"""

import math

import pytest
import torch

from sda_tpu_torch.ops import RealDFT2, dft_kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def randn(seed, *shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device)


# (batch, height, width, h_modes, w_modes): the solver's shapes at 256^2 and
# 64^2, the Pallas tests' 32^2, and a rectangle whose odd height leaves the
# inverse kernel's last row tile partial.
SHAPES = [(1, 256, 256, 86, 86), (4, 256, 256, 86, 86), (4, 64, 64, 22, 22),
          (3, 32, 32, 11, 11), (2, 45, 80, 12, 22)]


@pytest.mark.parametrize('n, h, w, hm, wm', SHAPES)
def test_kernels_match_plain(cuda, n, h, w, hm, wm):
    dft = RealDFT2(h, w, method='kernel', h_modes=hm, w_modes=wm, device=cuda)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    x = randn(0, n, h, w, device=cuda)

    re, im = dft_kernels.rfft2(x, *bases)
    re0, im0 = (t.contiguous() for t in dft_kernels.rfft2_plain(x, *bases))
    tol = 1e-3 * math.sqrt(h * w / 32**2)
    torch.testing.assert_close(re, re0, atol=tol, rtol=0)
    torch.testing.assert_close(im, im0, atol=tol, rtol=0)

    y = dft_kernels.irfft2(re0, im0, *bases, dft.weight_w)
    y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
    torch.testing.assert_close(y, y0, atol=1e-4, rtol=0)

    torch.testing.assert_close(dft.irfft2(*dft.rfft2(x)), y0, atol=1e-4, rtol=0)
    torch.cuda.synchronize()


@pytest.mark.parametrize('n, h, w, hm, wm', [(2, 256, 256, 86, 86), (2, 45, 80, 12, 22)])
def test_every_tile_matches_plain(cuda, n, h, w, hm, wm):
    dft = RealDFT2(h, w, method='kernel', h_modes=hm, w_modes=wm, device=cuda)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    x = randn(4, n, h, w, device=cuda)
    re0, im0 = (t.contiguous() for t in dft_kernels.rfft2_plain(x, *bases))
    y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
    tol = 1e-3 * math.sqrt(h * w / 32**2)

    for tile in dft_kernels.RFFT2_TILES:
        re, im = dft_kernels.launch_rfft2(x, *bases, tile=tile)
        torch.testing.assert_close(re, re0, atol=tol, rtol=0)
        torch.testing.assert_close(im, im0, atol=tol, rtol=0)
    for tile in dft_kernels.IRFFT2_TILES:
        y = dft_kernels.launch_irfft2(re0, im0, *bases, dft.weight_w, tile=tile)
        torch.testing.assert_close(y, y0, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        dft_kernels.launch_rfft2(x, *bases, tile=3)


def test_gradients_match_plain(cuda):
    ker = RealDFT2(32, 32, method='kernel', h_modes=11, w_modes=11, device=cuda)
    mat = RealDFT2(32, 32, method='matmul', h_modes=11, w_modes=11, device=cuda)
    x = randn(1, 2, 32, 32, device=cuda)

    def grad(dft):
        xi = x.clone().requires_grad_(True)
        re, im = dft.rfft2(xi)
        y = dft.irfft2(re * 0.5 + 1.0, im * 2.0)
        (torch.sum(y**2) + torch.sum(re * im)).backward()
        return xi.grad

    torch.testing.assert_close(grad(ker), grad(mat), atol=1e-2, rtol=0)


def test_solver_step_matches_plain(cuda):
    from sda_tpu_torch.dynamics import KolmogorovFlow

    ker = KolmogorovFlow(size=64, dt=0.2, device=cuda)
    mat = KolmogorovFlow(size=64, dt=0.2, dft_method='matmul', device=cuda)
    assert ker.dft.method == 'kernel'  # 'auto' on the card

    x = ker.prior((2,), generator=torch.Generator(device=cuda).manual_seed(0))
    torch.testing.assert_close(ker.transition(x), mat.transition(x), atol=5e-3, rtol=0)


def test_launches_are_counted(cuda):
    dft = RealDFT2(64, 64, h_modes=22, w_modes=22, device=cuda)
    x = randn(2, 3, 64, 64, device=cuda)

    dft_kernels.reset_launches()
    re, im = dft.rfft2(x)
    dft.irfft2(re, im)
    dft.irfft2(re, im)
    dft_kernels.rfft2_plain(x, dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)

    assert dft_kernels.launches == {'rfft2': 1, 'irfft2': 2}


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    dft = RealDFT2(32, 32, h_modes=11, w_modes=11, device=cuda)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    x = randn(3, 2, 32, 32, device=cuda)

    with pytest.raises(ValueError):
        dft_kernels.rfft2(x.double(), *bases)
    with pytest.raises(ValueError):
        dft_kernels.rfft2(x.transpose(1, 2), *bases)
    with pytest.raises(ValueError):
        dft_kernels.rfft2(x[..., :16].contiguous(), *bases)
    with pytest.raises(ValueError):
        dft_kernels.rfft2(x, dft.cos_w.cpu(), *bases[1:])

r"""The port's two-layer quasi-geostrophic solver and ``RealDFT2('fft')``
against the JAX package, float32 on the CPU.

JAX's ``QuasiGeostrophic`` takes ``dft_method='auto'``, which on the CPU
resolves to ``'fft'`` and then, the spectrum being truncated, to
``'matmul'`` at ``Precision.HIGHEST`` (tests/conftest.py); the port's
``'auto'`` resolves to ``'matmul'`` on the CPU. Both are float32 with only
the summation order differing. The prior takes JAX's own white noise.
Tolerances: the setup constants are equal to float32 rounding (rtol 1e-6);
a transition and short trajectories within a relative L2 of 1e-5 (measured:
2.8e-7 at 32^2 and 2.4e-7 at 64^2 after one transition, 3.5e-7 after four);
the prior, the inversion and the streamfunction within atol 1e-5 on fields
of magnitude ~5 and ~0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.dynamics import QuasiGeostrophic as JQuasiGeostrophic
from sda_tpu.ops import RealDFT2 as JRealDFT2
from sda_tpu_torch.dynamics import QuasiGeostrophic
from sda_tpu_torch.experiments.qg.utils import make_chain
from sda_tpu_torch.ops import RealDFT2, dft_kernels


def t(a):
    return torch.from_numpy(np.array(a))


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# -- RealDFT2('fft') ------------------------------------------------------------


@pytest.mark.parametrize('h, w', [(32, 32), (24, 18), (16, 20)])
def test_fft_method_matches_jax(h, w):
    r"""Untruncated ``'fft'`` against JAX's XLA FFT method, both ways."""

    jdft = JRealDFT2(h, w, method='fft')
    dft = RealDFT2(h, w, method='fft', device='cpu')
    assert dft.method == jdft.method == 'fft'
    assert dft.spectral_shape == jdft.spectral_shape

    x = randn(h * w, 3, 2, h, w)
    jre, jim = jdft.rfft2(jnp.asarray(x))
    re, im = dft.rfft2(t(x))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-4)

    want = np.asarray(jdft.irfft2(jre, jim))
    np.testing.assert_allclose(dft.irfft2(t(jre), t(jim)).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(want, x, atol=1e-5)


def test_truncated_fft_falls_back_to_matmul():
    jdft = JRealDFT2(32, 32, method='fft', h_modes=11, w_modes=11)
    dft = RealDFT2(32, 32, method='fft', h_modes=11, w_modes=11, device='cpu')
    assert dft.method == jdft.method == 'matmul'

    x = randn(0, 2, 32, 32)
    jre, jim = jdft.rfft2(jnp.asarray(x))
    re, im = dft.rfft2(t(x))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-4)
    np.testing.assert_allclose(dft.irfft2(re, im).numpy(), np.asarray(jdft.irfft2(jre, jim)), atol=1e-5)


# -- QuasiGeostrophic -------------------------------------------------------------


@pytest.fixture(scope='module', params=[32, 64])
def chains(request):
    size = request.param
    return JQuasiGeostrophic(size=size, dt=0.1), QuasiGeostrophic(size=size, dt=0.1, device='cpu')


@pytest.fixture(scope='module')
def x0(chains):
    jq, _ = chains
    return np.asarray(jq.prior(jax.random.key(0), (2,)))


def test_setup_matches(chains):
    jq, tq = chains

    assert tq.dft.method == jq.dft.method == 'matmul'
    assert tq.dft.spectral_shape == jq.dft.spectral_shape
    assert (tq.steps, tq.q1y, tq.q2y, tq.kd2, tq.u1, tq.u2) == (jq.steps, jq.q1y, jq.q2y, jq.kd2, jq.u1, jq.u2)
    assert tq.h == jq.h and tq.nu4 == jq.nu4
    for name in ('ky', 'kx', 'k2'):
        np.testing.assert_array_equal(getattr(tq, name).numpy(), np.asarray(getattr(jq, name)), err_msg=name)
    for name in ('inv_aa', 'inv_ab', 'exp_full', 'exp_half'):
        np.testing.assert_allclose(getattr(tq, name).numpy(), np.asarray(getattr(jq, name)), rtol=1e-6,
                                   err_msg=name)
    # The k = 0 mode is in the inversion's null space in both.
    assert tq.inv_aa[0, 0] == 0 and tq.inv_ab[0, 0] == 0


def test_make_chain_is_the_experiment_chain():
    chain = make_chain(128, device='cpu')

    assert (chain.size, chain.dt, chain.steps) == (128, 0.1, 23)
    assert chain.dft.method == 'matmul'  # 'auto' on the CPU
    assert chain.dft.spectral_shape == (85, 43)


def test_prior_with_jax_noise(chains, x0):
    jq, tq = chains
    noise = jax.random.normal(jax.random.key(0), (2, 2, tq.size, tq.size))

    got = tq.prior((2,), noise=t(noise))

    np.testing.assert_allclose(got.numpy(), x0, atol=1e-5)
    np.testing.assert_allclose(got.square().mean(dim=(-2, -1)).sqrt().numpy(), 5.0, rtol=1e-5)


def test_invert_matches_jax(chains, x0):
    jq, tq = chains
    q = jq.to_spectral(jnp.asarray(x0))

    jp = jq._invert(q)
    p = tq._invert((t(q[0]), t(q[1])))

    for a, b in zip(p, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_inversion_roundtrip(chains, x0):
    r"""q -> psi -> q is the identity on the modes with k > 0
    (``tests/test_quasigeostrophic.py::test_inversion_roundtrip``)."""

    _, tq = chains
    q = tq.to_spectral(t(x0))
    pr, pi = tq._invert(q)
    f = tq.kd2 / 2

    def apply_a(a):
        a1, a2 = a[..., 0, :, :], a[..., 1, :, :]
        return torch.stack(((-tq.k2 - f) * a1 + f * a2, f * a1 + (-tq.k2 - f) * a2), dim=-3)

    mask = (tq.k2 > 0).numpy()
    np.testing.assert_allclose(apply_a(pr).numpy()[..., mask], q[0].numpy()[..., mask], atol=1e-2)
    np.testing.assert_allclose(apply_a(pi).numpy()[..., mask], q[1].numpy()[..., mask], atol=1e-2)


def test_transition_matches_jax(chains, x0):
    jq, tq = chains

    want = np.asarray(jq.transition(None, jnp.asarray(x0)))
    got = tq.transition(t(x0)).numpy()

    assert got.shape == want.shape == (2, 2, tq.size, tq.size)
    assert rel_l2(got, want) < 1e-5


@pytest.mark.parametrize('last', [False, True])
def test_trajectory_matches_jax(chains, x0, last):
    jq, tq = chains

    want = np.asarray(jq.trajectory(None, jnp.asarray(x0), 4, last=last))
    got = tq.trajectory(t(x0), 4, last=last).numpy()

    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-5


def test_streamfunction_matches_jax(chains, x0):
    jq, tq = chains

    want = np.asarray(jq.streamfunction(jnp.asarray(x0)))
    got = tq.streamfunction(t(x0)).numpy()

    assert got.shape == x0.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_barotropic_rossby_wave_dispersion():
    r"""A barotropic zonal wave with no shear, drag or hyperviscosity moves
    westward at the Rossby phase speed ``-beta / k^2``, and both layers stay
    equal (``tests/test_quasigeostrophic.py``, same tolerances)."""

    n, beta, kx = 64, 5.0, 2
    chain = QuasiGeostrophic(size=n, dt=0.05, beta=beta, shear=0.0, drag=0.0, deformation_wavenumber=4.0,
                             hyperviscosity=0.0, device='cpu')

    b = 2 * np.pi / n * np.arange(n)
    q0 = 0.1 * np.cos(kx * b)
    y = torch.as_tensor(np.broadcast_to(q0, (2, n, n)).copy(), dtype=torch.float32)

    steps = 4
    for _ in range(steps):
        y = chain.transition(y)

    omega = -beta * kx / kx**2
    expected = 0.1 * np.cos(kx * (b - omega / kx * steps * chain.dt))
    np.testing.assert_allclose(y[0, 0].numpy(), expected, atol=5e-3)
    np.testing.assert_allclose(y[0].numpy(), y[1].numpy(), atol=5e-4)


def test_baroclinic_turbulence_is_bounded():
    r"""The forced-dissipative regime stays finite and of the initial order
    over 50 transitions (``tests/test_quasigeostrophic.py``)."""

    chain = QuasiGeostrophic(size=64, dt=0.1, device='cpu')
    x = chain.prior((), generator=torch.Generator().manual_seed(1))
    xs = chain.trajectory(x, length=50)

    assert xs.shape == (50, 2, 64, 64)
    assert bool(torch.isfinite(xs).all())
    rms = xs.square().mean(dim=(1, 2, 3)).sqrt()
    assert 0.01 < rms[-1] < 100.0


@pytest.mark.parametrize('site, calls', [
    ('to_spectral', {'rfft2': 1, 'irfft2': 0}),
    ('to_physical', {'rfft2': 0, 'irfft2': 1}),
    ('_tendency', {'rfft2': 1, 'irfft2': 1}),
    ('substep', {'rfft2': 3, 'irfft2': 3}),
    ('prior', {'rfft2': 1, 'irfft2': 1}),
])
def test_one_transform_call_per_direction(monkeypatch, site, calls):
    r"""Each call site of the solver makes one ``rfft2``/``irfft2`` call
    through RealDFT2 whatever the number of fields and layers (so one kernel
    launch per direction on the card): the tendency's four inverse
    transforms go in one call."""

    chain = QuasiGeostrophic(32, dt=0.1, dft_method='kernel', device='cpu')
    x = t(randn(0, 3, 2, 32, 32))
    q = chain.to_spectral(x)

    counted = {'rfft2': 0, 'irfft2': 0}
    for name in counted:
        def counting(*args, name=name, fn=getattr(dft_kernels, name)):
            counted[name] += 1
            return fn(*args)
        monkeypatch.setattr(dft_kernels, name, counting)

    {
        'to_spectral': lambda: chain.to_spectral(x),
        'to_physical': lambda: chain.to_physical(q),
        '_tendency': lambda: chain._tendency(q),
        'substep': lambda: chain.substep(q),
        'prior': lambda: chain.prior((3,)),
    }[site]()

    assert counted == calls


def test_tendency_with_kernel_method_matches_matmul():
    r"""The stacked tendency through the ``'kernel'`` method (its plain
    version on the CPU) equals the ``'matmul'`` one."""

    a = QuasiGeostrophic(32, dt=0.1, dft_method='kernel', device='cpu')
    b = QuasiGeostrophic(32, dt=0.1, dft_method='matmul', device='cpu')
    q = b.to_spectral(t(randn(1, 2, 2, 32, 32)) * 5)

    for x, y in zip(a._tendency(q), b._tendency(q)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-4)

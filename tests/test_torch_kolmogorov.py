r"""The port's Kolmogorov solver and grid operators against the JAX package.

JAX runs ``dft_method='matmul'`` at ``Precision.HIGHEST`` (tests/conftest.py),
the port its ``'kernel'`` method, which on the CPU is the plain float32
contraction: both are float32 with only the summation order differing. The
prior takes JAX's own white noise. Tolerances are absolute on fields of
magnitude ~3 (the prior's peak speed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.dynamics import KolmogorovFlow as JKolmogorovFlow
from sda_tpu.dynamics import coarsen as jcoarsen
from sda_tpu.dynamics import vorticity as jvorticity
from sda_tpu_torch.dynamics import KolmogorovFlow, coarsen, vorticity
from sda_tpu_torch.experiments.kolmogorov.generate import simulate
from sda_tpu_torch.experiments.kolmogorov.utils import make_chain


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def flows():
    return (
        JKolmogorovFlow(64, dt=0.2, dft_method='matmul'),
        KolmogorovFlow(64, dt=0.2, dft_method='kernel', device='cpu'),
    )


@pytest.fixture(scope='module')
def x0(flows):
    return np.asarray(flows[0].prior(jax.random.key(0), (2,)))


def test_setup_matches(flows):
    jk, tk = flows

    assert tk.steps == jk.steps == 21
    assert tk.h == pytest.approx(jk.h)
    np.testing.assert_allclose(tk.exp_full.numpy(), np.asarray(jk.exp_full), rtol=1e-6)
    np.testing.assert_allclose(tk.forcing_re.numpy(), np.asarray(jk.forcing_re), atol=1e-3)
    np.testing.assert_allclose(tk.forcing_im.numpy(), np.asarray(jk.forcing_im), atol=1e-3)


def test_prior_with_jax_noise(flows, x0):
    _, tk = flows
    noise = jax.random.normal(jax.random.key(0), (2, 2, 64, 64))

    np.testing.assert_allclose(tk.prior((2,), noise=t(noise)).numpy(), x0, atol=1e-5)


def test_transition(flows, x0):
    jk, tk = flows

    want = np.asarray(jk.transition(None, jnp.asarray(x0)))
    np.testing.assert_allclose(tk.transition(t(x0)).numpy(), want, atol=1e-4)


@pytest.mark.parametrize('last', [False, True])
def test_trajectory(flows, x0, last):
    jk, tk = flows

    want = np.asarray(jk.trajectory(None, jnp.asarray(x0), 3, last=last))
    got = tk.trajectory(t(x0), 3, last=last).numpy()

    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_spectral_roundtrip(flows, x0):
    jk, tk = flows

    w, mean = tk.to_spectral(t(x0))
    jw, jmean = jk.to_spectral(jnp.asarray(x0))
    np.testing.assert_allclose(w[0].numpy(), np.asarray(jw[0]), atol=1e-3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6)

    np.testing.assert_allclose(tk.to_velocity(w, mean).numpy(), np.asarray(jk.to_velocity(jw, jmean)), atol=1e-4)


def test_simulate_matches_generate(flows):
    r"""``generate.py``'s recipe: prior, rollout, keep the tail, coarsen."""

    jk, tk = flows
    key = jax.random.key(1)
    xs = jk.trajectory(None, jk.prior(key, (1,)), 4)[1:]
    want = np.moveaxis(np.asarray(jcoarsen(xs, 4)), 0, 1)

    noise = jax.random.normal(key, (1, 2, 64, 64))
    got = simulate(tk, batch=1, length=4, keep=3, coarse=4, noise=t(noise)).numpy()

    assert got.shape == (1, 3, 2, 16, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_grid_operators():
    x = np.random.RandomState(0).randn(3, 2, 16, 16).astype(np.float32)

    np.testing.assert_allclose(coarsen(t(x), 4).numpy(), np.asarray(jcoarsen(jnp.asarray(x), 4)), atol=1e-6)
    np.testing.assert_allclose(vorticity(t(x)).numpy(), np.asarray(jvorticity(jnp.asarray(x))), atol=1e-6)


def test_make_chain_is_the_experiment_chain():
    chain = make_chain(64, device='cpu')

    assert (chain.size, chain.dt, chain.steps) == (64, 0.2, 21)
    assert chain.dft.method == 'matmul'  # 'auto' on the CPU
    assert chain.dft.spectral_shape == (43, 22)


@pytest.mark.parametrize('site, calls', [
    ('to_spectral', {'rfft2': 1, 'irfft2': 0}),
    ('to_velocity', {'rfft2': 0, 'irfft2': 1}),
    ('_nonlinear', {'rfft2': 1, 'irfft2': 1}),
    ('prior', {'rfft2': 1, 'irfft2': 1}),
])
def test_one_transform_call_per_direction(monkeypatch, site, calls):
    r"""Each call site of the solver makes one ``rfft2``/``irfft2`` call through
    RealDFT2, whatever the number of fields it transforms (so one kernel
    launch per direction on the card)."""

    from sda_tpu_torch.ops import dft_kernels

    chain = KolmogorovFlow(32, dt=0.2, dft_method='kernel', device='cpu')
    x = t(np.random.RandomState(0).randn(3, 2, 32, 32).astype(np.float32))
    w, mean = chain.to_spectral(x)

    counted = {'rfft2': 0, 'irfft2': 0}
    for name in counted:
        def counting(*args, name=name, fn=getattr(dft_kernels, name)):
            counted[name] += 1
            return fn(*args)
        monkeypatch.setattr(dft_kernels, name, counting)

    {
        'to_spectral': lambda: chain.to_spectral(x),
        'to_velocity': lambda: chain.to_velocity(w, mean),
        '_nonlinear': lambda: chain._nonlinear(w),
        'prior': lambda: chain.prior((3,)),
    }[site]()

    assert counted == calls

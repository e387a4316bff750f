r"""The port's sampler options and guidance variants against the JAX
package, float32 on the CPU: the ``dpm2m`` solver, ``SubVPSDE`` and
``SubSubVPSDE``, segmented sampling (bitwise equal to one run within the
port), the sampler's argument errors, per-chunk and outer remat (equal
values and gradients), and DPS guidance with its whole-batch
normalisation.

JAX's draws reach the port through the sampler's ``init``/``noise`` hook,
and the JAX samplers run under ``jax.disable_jit()``: under ``jit`` XLA
evaluates ``sigma(0)`` as 9.766e-4 instead of 1.000e-3 (``ROADMAP.md``,
faults, item 1). Unless a test says otherwise the tolerance is
``atol=1e-4`` on samples of unit scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu.diffusion import DPSGaussianScore as JDPSGaussianScore
from sda_tpu.diffusion import GaussianScore as JGaussianScore
from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
from sda_tpu.diffusion import MCScoreNet as JMCScoreNet
from sda_tpu.diffusion import SubSubVPSDE as JSubSubVPSDE
from sda_tpu.diffusion import SubVPSDE as JSubVPSDE
from sda_tpu.diffusion import bind_eps as jbind_eps
from sda_tpu.dynamics import coarsen as jcoarsen
from sda_tpu_torch.diffusion import VPSDE, DPSGaussianScore, GaussianScore, MCScoreNet, SubSubVPSDE, SubVPSDE
from sda_tpu_torch.diffusion import bind_eps, chunked_eval
from sda_tpu_torch.dynamics import coarsen
from sda_tpu_torch.experiments.kolmogorov.utils import make_score
from sda_tpu_torch.train import params_from_flax

NARROW = dict(window=5, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1), activation='SiLU', size=16)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_noise(key, shape):
    r"""JAX's initial state and ``z(i, j)`` of ``VPSDE.sample(key, ...)``."""

    k_init, k_scan = jax.random.split(key)

    def noise(i, j):
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), j), shape))

    return t(jax.random.normal(k_init, shape)), noise


def gaussian_eps(sde, x, tt):
    r"""The exact eps of unit-variance Gaussian data (keeps the first steps
    cancelling as a trained network would)."""

    mu, sigma = sde.mu(tt), sde.sigma(tt)
    return sigma * x / (mu**2 + sigma**2)


@pytest.fixture(scope='module')
def nets():
    r"""The narrow Kolmogorov window kernel in both packages, random weights
    at flax's shapes, composed over trajectories (order 2)."""

    module = JLocalScoreUNet(
        channels=10, size=16, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1), activation=jax.nn.silu,
    )
    shapes = jax.eval_shape(module.init, jax.random.key(1), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1] or (10,))), jnp.float32),
        shapes['params'],
    )
    kernel = bind_eps(make_score(**NARROW), params_from_flax(jax.tree_util.tree_map(np.asarray, params)))

    return jbind_eps(module, params), kernel


# -- Solvers and schedules ---------------------------------------------------


@pytest.mark.parametrize('kind', ['vp', 'subvp', 'subsubvp'])
def test_sigma_matches_jax(kind):
    jcls, tcls = {'vp': (JVPSDE, VPSDE), 'subvp': (JSubVPSDE, SubVPSDE), 'subsubvp': (JSubSubVPSDE, SubSubVPSDE)}[kind]
    tt = np.linspace(0, 1, 17).astype(np.float32)

    for alpha in ('lin', 'cos', 'exp'):
        jsde, tsde = jcls(shape=(2,), alpha=alpha), tcls(shape=(2,), alpha=alpha)
        np.testing.assert_allclose(tsde.sigma(t(tt)).numpy(), np.asarray(jsde.sigma(jnp.asarray(tt))), atol=1e-6)
        np.testing.assert_allclose(tsde.mu(t(tt)).numpy(), np.asarray(jsde.mu(jnp.asarray(tt))), atol=1e-6)


@pytest.mark.parametrize('kind,solver,corrections', [
    ('vp', 'dpm2m', 0), ('vp', 'dpm2m', 1), ('subvp', 'ddim', 1), ('subsubvp', 'ddim', 0), ('subvp', 'dpm2m', 0),
])
def test_sampler_matches_jax(kind, solver, corrections):
    r"""The sampler with an analytic eps, JAX's noise fed in: ``dpm2m`` is
    second order without corrections and ddim with them."""

    jcls, tcls = {'vp': (JVPSDE, VPSDE), 'subvp': (JSubVPSDE, SubVPSDE), 'subsubvp': (JSubSubVPSDE, SubSubVPSDE)}[kind]
    jsde, tsde = jcls(shape=(3, 4)), tcls(shape=(3, 4))

    def jeps(x, tt, c):
        return gaussian_eps(jsde, x, tt) + 0.01 * jnp.tanh(x)

    def teps(x, tt, c):
        return gaussian_eps(tsde, x, tt) + 0.01 * torch.tanh(x)

    key = jax.random.key(3)
    with jax.disable_jit():
        want = jsde.sample(key, (5,), steps=8, corrections=corrections, tau=0.5, eps=jeps, solver=solver)

    init, noise = jax_noise(key, (5, 3, 4))
    got = tsde.sample((5,), steps=8, corrections=corrections, tau=0.5, eps=teps, init=init, noise=noise,
                      solver=solver)

    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_dpm2m_differs_from_ddim_without_corrections_only():
    sde = VPSDE(shape=(3,))
    init = t(randn(0, 4, 3))

    def eps(x, tt, c):
        return gaussian_eps(sde, x, tt) + 0.1 * torch.sin(3 * x)

    def run(solver, corrections):
        g = torch.Generator().manual_seed(0)
        return sde.sample((4,), steps=6, corrections=corrections, eps=eps, init=init, solver=solver, generator=g)

    assert not torch.equal(run('ddim', 0), run('dpm2m', 0))
    assert torch.equal(run('ddim', 1), run('dpm2m', 1))


@pytest.mark.parametrize('solver,corrections', [('ddim', 1), ('dpm2m', 0)])
def test_segments_match_jax(solver, corrections):
    r"""JAX's segmented run, segment by segment, with the global step index
    in its noise."""

    jsde, tsde = JVPSDE(shape=(3,)), VPSDE(shape=(3,))
    key = jax.random.key(5)
    init, noise = jax_noise(key, (4, 3))

    def jeps(x, tt, c):
        return gaussian_eps(jsde, x, tt) + 0.05 * jnp.cos(x)

    def teps(x, tt, c):
        return gaussian_eps(tsde, x, tt) + 0.05 * torch.cos(x)

    want, got = None, None
    for segment in ((0, 3), (3, 5), (5, 8)):
        with jax.disable_jit():
            want = jsde.sample(key, (4,), steps=8, corrections=corrections, tau=0.5, eps=jeps, solver=solver,
                               init=want, segment=segment)
        got = tsde.sample((4,), steps=8, corrections=corrections, tau=0.5, eps=teps, solver=solver,
                          init=init if got is None else got, noise=noise, segment=segment)

    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('corrections', [0, 2])
def test_segmented_sampling_is_bitwise_one_run(nets, corrections):
    r"""With the default noise (seeded per global step from the generator's
    seed), consecutive segments give exactly one run's result."""

    _, kernel = nets
    sde = VPSDE(eps=MCScoreNet(kernel, order=2), shape=(6, 2, 16, 16))

    def run(bounds):
        g = torch.Generator().manual_seed(11)
        xs = None
        for i0, i1 in zip(bounds[:-1], bounds[1:]):
            xs = sde.sample((2,), steps=8, corrections=corrections, tau=0.5, generator=g, init=xs, segment=(i0, i1))
        return xs

    one = run((0, 8))
    assert torch.equal(run((0, 2, 4, 6, 8)), one)
    assert torch.equal(run((0, 5, 8)), one)


def test_default_noise_depends_on_the_generator_seed():
    sde = VPSDE(shape=(3,))

    def run(seed):
        return sde.sample((2,), steps=4, corrections=1, eps=lambda x, tt, c: 0.1 * x,
                          generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_sampler_errors():
    sde = VPSDE(eps=lambda x, tt, c: x, shape=(2,))

    with pytest.raises(ValueError, match='mid-grid'):
        sde.sample((1,), steps=8, segment=(4, 8))
    with pytest.raises(ValueError, match="unknown solver 'euler'"):
        sde.sample((1,), steps=8, solver='euler')


# -- Remat ---------------------------------------------------------------------


@pytest.mark.parametrize('chunk', [None, 3])
def test_remat_equal_values_and_gradients(nets, chunk):
    r"""Per-chunk checkpointing (chunked) and the guidance's outer
    checkpoint (unchunked) change neither the guided eps nor the gradient
    of a loss through it."""

    _, kernel = nets
    x = t(randn(0, 2, 9, 2, 16, 16))
    y = coarsen(t(randn(1, 3, 2, 16, 16)), 4)

    def A(x):
        return coarsen(x[..., ::4, :, :, :], 4)

    def guided(remat):
        sde = VPSDE(eps=MCScoreNet(kernel, order=2, chunk=chunk), shape=())
        return GaussianScore(y, A, 0.1, sde, remat=remat)

    def value_and_grad(score):
        xi = x.clone().requires_grad_(True)
        out = score(xi, torch.tensor(0.6))
        with torch.enable_grad():
            e = score.sde.eps(xi, torch.tensor(0.6), None)
            (g,) = torch.autograd.grad((e**2).sum(), xi)
        return out, g

    plain, remat = guided(False), guided(True)
    if chunk is not None:
        assert remat.sde.eps.remat and remat.sde.eps.chunk == chunk and not plain.sde.eps.remat

    (a, ga), (b, gb) = value_and_grad(plain), value_and_grad(remat)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-6, atol=1e-6)


def test_chunked_eval_remat_matches_jax(nets):
    r"""The chunked, rematerialised score over 7 windows in chunks of 3 (the
    last chunk padded with copies of the last window), against JAX's
    ``MCScoreNet(chunk=3, remat=True)``, and its input gradient."""

    jkernel, kernel = nets
    x = randn(2, 2, 11, 2, 16, 16)
    tt = np.float32(0.4)

    jscore = JMCScoreNet(jkernel, order=2, chunk=3, remat=True)
    want = np.asarray(jscore(jnp.asarray(x), jnp.asarray(tt)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jscore(v, jnp.asarray(tt)) ** 2))(jnp.asarray(x)))

    score = MCScoreNet(kernel, order=2, chunk=3, remat=True)
    xi = t(x).requires_grad_(True)
    out = score(xi, torch.tensor(tt))
    (g,) = torch.autograd.grad((out**2).sum(), xi)

    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4, atol=1e-3)


def test_chunked_eval_pads_with_the_last_window():
    seen = []

    def kernel(x, tt, c):
        seen.append(x.clone())
        return x * 2

    x = torch.arange(7.0).reshape(1, 7, 1)
    out = chunked_eval(kernel, x, torch.tensor(0.5), None, chunk=3)

    assert torch.equal(out, x * 2)
    assert torch.equal(seen[-1].flatten(), torch.tensor([6.0, 6.0, 6.0]))


@pytest.mark.parametrize('remat', [False, True])
def test_gaussian_score_remat_matches_jax(nets, remat):
    jkernel, kernel = nets
    y = randn(3, 2, 2, 4, 4)
    x = randn(4, 2, 6, 2, 16, 16)

    def jA(x):
        return jcoarsen(x[..., ::4, :, :, :], 4)

    def A(x):
        return coarsen(x[..., ::4, :, :, :], 4)

    jguided = JGaussianScore(y, jA, 0.1, JVPSDE(eps=JMCScoreNet(jkernel, order=2, chunk=2)), remat=remat)
    want = np.asarray(jguided(jnp.asarray(x), jnp.asarray(0.7)))
    tguided = GaussianScore(t(y), A, 0.1, VPSDE(eps=MCScoreNet(kernel, order=2, chunk=2)), remat=remat)
    got = tguided(t(x), torch.tensor(0.7)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-4)


# -- DPS -------------------------------------------------------------------------


@pytest.mark.parametrize('zeta', [1.0, 0.3])
def test_dps_matches_jax(nets, zeta):
    jkernel, kernel = nets
    y = randn(5, 2, 2, 4, 4)
    x = randn(6, 3, 6, 2, 16, 16)

    def jA(x):
        return jcoarsen(x[..., ::4, :, :, :], 4)

    def A(x):
        return coarsen(x[..., ::4, :, :, :], 4)

    jguided = JDPSGaussianScore(y, jA, JVPSDE(eps=JMCScoreNet(jkernel, order=2)), zeta=zeta)
    want = np.asarray(jguided(jnp.asarray(x), jnp.asarray(0.5)))
    tguided = DPSGaussianScore(t(y), A, VPSDE(eps=MCScoreNet(kernel, order=2)), zeta=zeta)
    got = tguided(t(x), torch.tensor(0.5)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-4)


def test_dps_normalises_over_the_whole_batch(nets):
    r"""DPS divides by the square root of the squared error summed over the
    batch: a sample's guided eps changes when another sample joins it, as
    in the JAX package."""

    jkernel, kernel = nets
    y = randn(5, 2, 2, 4, 4)
    x = randn(7, 2, 6, 2, 16, 16)

    def A(x):
        return coarsen(x[..., ::4, :, :, :], 4)

    def jA(x):
        return jcoarsen(x[..., ::4, :, :, :], 4)

    tguided = DPSGaussianScore(t(y), A, VPSDE(eps=MCScoreNet(kernel, order=2)))
    jguided = JDPSGaussianScore(y, jA, JVPSDE(eps=JMCScoreNet(jkernel, order=2)))

    alone = tguided(t(x[:1]), torch.tensor(0.5))
    together = tguided(t(x), torch.tensor(0.5))[:1]
    want_alone = np.asarray(jguided(jnp.asarray(x[:1]), jnp.asarray(0.5)))

    assert (alone - together).abs().max() > 1e-3
    np.testing.assert_allclose(alone.numpy(), want_alone, atol=1e-4)

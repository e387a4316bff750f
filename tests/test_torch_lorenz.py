r"""The port's Lorenz family against the JAX package, float32 on the CPU: the
ODE systems, the noisy Lorenz chain's moments and log-density, the MLP
``ScoreNet``, ``MCScoreWrapper``, the experiment's factories and
likelihoods, the 9 committed Lorenz checkpoints against JAX and their golden
entries, the data simulation, and the replay of JAX's PRNG that rebuilds the
golden probes without JAX.

Unless a test says otherwise the tolerance is ``atol=1e-5``: both sides run
float32 and differ only by summation order.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sda_tpu.diffusion import MCScoreWrapper as JMCScoreWrapper
from sda_tpu.diffusion import ScoreNet as JScoreNet
from sda_tpu.diffusion import ScoreUNet as JScoreUNet
from sda_tpu.dynamics import DampedSpring as JDampedSpring
from sda_tpu.dynamics import Lorenz63 as JLorenz63
from sda_tpu.dynamics import Lorenz96 as JLorenz96
from sda_tpu.dynamics import LotkaVolterra as JLotkaVolterra
from sda_tpu.dynamics import NoisyLorenz63 as JNoisyLorenz63
from sda_tpu.dynamics.ode import rk4 as jrk4
from sda_tpu.train import load_params as jload_params
from sda_tpu_torch import prng
from sda_tpu_torch.diffusion import MCScoreWrapper, ScoreNet, ScoreUNet, bind_eps
from sda_tpu_torch.dynamics import DampedSpring, Lorenz63, Lorenz96, LotkaVolterra, NoisyLorenz63, rk4
from sda_tpu_torch.experiments.lorenz import utils as lu
from sda_tpu_torch.experiments.lorenz.generate import simulate
from sda_tpu_torch.train import params_from_flax

REPO = Path(__file__).resolve().parents[1]
RUNS = ['global_0', 'global_1', 'global_2', 'local_k1_0', 'local_k2_0', 'local_k2_1', 'local_k2_2',
        'local_k3_0', 'local_k4_0']
GOLDEN = json.loads((REPO / 'tests/golden/committed_artifacts.json').read_text())


@pytest.fixture(autouse=True)
def one_thread():
    r"""One torch thread per test: the tensors here are small, and the suite
    runs several worker processes at once, whose thread pools would
    otherwise compete for the cores."""

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


@pytest.fixture(scope='module')
def pack():
    r"""The JAX pack's ``experiments/lorenz/utils.py``, under a name of its
    own (every pack calls its helper module ``utils``)."""

    path = REPO / 'experiments/lorenz/utils.py'
    spec = importlib.util.spec_from_file_location('lorenz_pack_utils_for_torch', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_params(module, *args, seed=0):
    r"""Random flax parameters at ``init``'s shapes: weights ~ N(0, 1/fan_in),
    biases ~ N(0, 0.1^2)."""

    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)['params']
    rng = np.random.RandomState(seed)

    def fill(s):
        if len(s.shape) == 1:
            return jnp.asarray(0.1 * rng.randn(*s.shape), jnp.float32)
        return jnp.asarray(rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1])), jnp.float32)

    return jax.tree_util.tree_map(fill, shapes)


def port(module, params):
    return bind_eps(module, params_from_flax(jax.tree_util.tree_map(np.asarray, params)))


# -- Dynamics -------------------------------------------------------------

SYSTEMS = {
    'lorenz63': (lambda: JLorenz63(dt=0.025), lambda: Lorenz63(dt=0.025, device='cpu'), (5, 3), 8.0),
    'lorenz96': (lambda: JLorenz96(n=8, dt=0.01, steps=2), lambda: Lorenz96(n=8, dt=0.01, steps=2, device='cpu'),
                 (4, 8), 3.0),
    'lotka_volterra': (lambda: JLotkaVolterra(dt=0.1, steps=3), lambda: LotkaVolterra(dt=0.1, steps=3, device='cpu'),
                       (6, 2), 0.5),
}


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_ode_systems(name):
    r"""The drift, one RK4 step and a rollout of 5 transitions (rtol 1e-5 on
    the drift and step, 1e-4 after 5 chaotic transitions)."""

    jmake, tmake, shape, scale = SYSTEMS[name]
    jsys, tsys = jmake(), tmake()
    x = randn(0, *shape) * scale + (np.array([0, 0, 25], np.float32) if name == 'lorenz63' else 0)

    np.testing.assert_allclose(tsys.f(t(x)).numpy(), np.asarray(jsys.f(jnp.asarray(x))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(rk4(tsys.f, t(x), 0.01).numpy(), np.asarray(jrk4(jsys.f, jnp.asarray(x), 0.01)),
                               rtol=1e-5, atol=1e-5)

    want = np.asarray(jsys.trajectory(jax.random.key(0), jnp.asarray(x), 5))
    got = tsys.trajectory(t(x), 5).numpy()
    assert got.shape == (5,) + shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    prior = tsys.prior((3,), generator=torch.Generator().manual_seed(0))
    assert prior.shape == (3,) + shape[1:]


def test_noisy_lorenz63():
    r"""The prior through JAX's own noise, the transition's moments, the
    exact log-density, standardization and its inverse."""

    jchain, chain = JNoisyLorenz63(dt=0.025), NoisyLorenz63(dt=0.025, device='cpu')
    key = jax.random.key(1)

    want = np.asarray(jchain.prior(key, (4, 2)))
    got = chain.prior((4, 2), noise=t(jax.random.normal(key, (4, 2, 3))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    x1, x2 = want, want + randn(2, 4, 2, 3)
    mean_j, std_j = jchain.moments(jnp.asarray(x1))
    mean, std = chain.moments(t(x1))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-5)
    assert std.item() == pytest.approx(float(std_j), rel=1e-7)

    np.testing.assert_allclose(chain.log_prob(t(x1), t(x2)).numpy(), np.asarray(jchain.log_prob(jnp.asarray(x1),
                               jnp.asarray(x2))), rtol=1e-5, atol=1e-3)

    z = chain.preprocess(t(x1))
    np.testing.assert_allclose(z.numpy(), np.asarray(JNoisyLorenz63.preprocess(jnp.asarray(x1))), atol=1e-6)
    np.testing.assert_allclose(chain.postprocess(z).numpy(), x1, atol=1e-5)

    g = torch.Generator().manual_seed(0)
    step = chain.transition(t(x1), generator=g) - mean
    assert step.shape == x1.shape and 0.05 < step.std().item() < 0.35  # scale sqrt(0.025) = 0.158


def test_damped_spring():
    r"""The linear-Gaussian chain's matrices, and its draws' moments over
    20,000 samples (5 standard errors)."""

    jchain, chain = JDampedSpring(dt=0.01), DampedSpring(dt=0.01, device='cpu')
    for name in ('mu_0', 'sigma_0', 'A', 'b', 'sigma_x'):
        np.testing.assert_allclose(getattr(chain, name).numpy(), np.asarray(getattr(jchain, name)), rtol=1e-6)

    g = torch.Generator().manual_seed(0)
    n = 20000
    x0 = chain.prior((n,), generator=g)
    np.testing.assert_allclose(x0.mean(0).numpy(), [1, 0, 0, 0], atol=5 / np.sqrt(n))
    np.testing.assert_allclose(torch.cov(x0.T).numpy(), np.eye(4), atol=5 * np.sqrt(2 / n))

    x = torch.ones(n, 4)
    x1 = chain.transition(x, generator=g)
    mean = (x @ chain.A.T)[0]
    std = torch.sqrt(torch.diag(chain.sigma_x))
    np.testing.assert_allclose(((x1 - mean) / std).mean(0).numpy(), 0, atol=5 / np.sqrt(n))
    np.testing.assert_allclose(((x1 - mean) / std).std(0).numpy(), 1, atol=5 / np.sqrt(2 * n))


# -- Score networks -------------------------------------------------------------

@pytest.mark.parametrize('context', [False, True])
def test_score_net(context):
    x = randn(3, 4, 5, 9)
    c = randn(4, 5, 2) if context else None
    tt = randn(5, 4, 1) ** 2  # per leading element, broadcast over the second axis
    module = JScoreNet(features=9, embedding=6, hidden_features=(16, 12), activation=jax.nn.silu)
    args = (jnp.asarray(x), jnp.asarray(tt)) + ((jnp.asarray(c),) if context else ())
    params = jax_params(module, *args, seed=6)

    want = np.asarray(jax.jit(module.apply)({'params': params}, *args))
    net = port(ScoreNet(9, context=2 if context else 0, embedding=6, hidden_features=(16, 12), activation=F.silu),
               params)
    with torch.no_grad():
        got = net(t(x), t(tt), None if c is None else t(c)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mc_score_wrapper():
    r"""A 1-D ScoreUNet over channels with time as space, as the global
    Lorenz model (flax SAME padding at every depth)."""

    x = randn(7, 3, 16, 3)  # (B, L, C)
    module = JScoreUNet(channels=3, embedding=8, hidden_channels=(8, 12), hidden_blocks=(1, 2),
                        activation=jax.nn.silu, spatial=1)
    params = jax_params(module, jnp.asarray(x).swapaxes(1, 2), jnp.float32(0.4), seed=8)
    apply = jax.jit(module.apply)

    want = np.asarray(JMCScoreWrapper(lambda x, t, c=None: apply({'params': params}, x, t, c))(
        jnp.asarray(x), jnp.float32(0.4)))
    net = port(ScoreUNet(3, embedding=8, hidden_channels=(8, 12), hidden_blocks=(1, 2), activation=F.silu,
                         spatial=1), params)
    with torch.no_grad():
        got = MCScoreWrapper(net)(t(x), torch.tensor(0.4)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)


# -- The committed checkpoints ------------------------------------------------

def probe_shape(run, config):
    return (2, 3 * config['window']) if run.startswith('local') else (2, 3, 32)


@pytest.mark.parametrize('run', RUNS)
def test_committed_checkpoint(run, pack):
    r"""Each committed Lorenz run through the port's ``load_score`` on the
    golden probe (rebuilt by :mod:`sda_tpu_torch.prng`): against JAX's eps
    (atol 1e-5) and the golden entry (rtol 1e-3, atol 1e-4, float32)."""

    rundir = REPO / 'experiments/lorenz/storage/runs' / run
    local = run.startswith('local')
    module, config = lu.load_score(rundir, local=local, device='cpu')
    shape = probe_shape(run, config)

    x_j = jax.random.normal(jax.random.key(0), shape, dtype=jnp.float32)
    x = prng.normal(0, shape)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-6, atol=1e-6)

    jmodule = pack.make_local_score(**config) if local else pack.make_global_score(**config)
    template = jax.eval_shape(jmodule.init, jax.random.key(0), x_j, jnp.ones((2,)))['params']
    jparams = jload_params(template, rundir / 'state.msgpack')
    want = np.asarray(jax.jit(jmodule.apply)({'params': jparams}, x_j, 0.5 * jnp.ones((2,))))
    with torch.no_grad():
        got = module(x, 0.5 * torch.ones(2)).numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, atol=1e-5)

    golden = GOLDEN[f'experiments/lorenz/storage/runs/{run}']
    assert golden['bf16'] is False
    np.testing.assert_allclose(got.mean(), golden['mean'], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.std(), golden['std'], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.ravel()[:4], golden['head'], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('run', ['local_k2_0', 'global_0'])
def test_trajectory_eps(run, pack):
    r"""The committed runs scoring whole trajectories ``(B, L, 3)``:
    windowed for the local kernel, time as space for the global model."""

    rundir = REPO / 'experiments/lorenz/storage/runs' / run
    local = run.startswith('local')
    x = randn(9, 2, 32, 3)

    module, config = lu.load_score(rundir, local=local, device='cpu')
    jmodule = pack.make_local_score(**config) if local else pack.make_global_score(**config)
    probe = jnp.zeros((1, 3 * config['window']) if local else (1, 3, 32))
    template = jax.eval_shape(jmodule.init, jax.random.key(0), probe, jnp.ones((1,)))['params']
    jparams = jload_params(template, rundir / 'state.msgpack')
    jeps = pack.make_trajectory_eps(jmodule, jparams, local, config.get('window', 5))
    want = np.asarray(jeps(jnp.asarray(x), jnp.float32(0.3)))
    with torch.no_grad():
        got = lu.make_trajectory_eps(module, local, config.get('window', 5))(t(x), torch.tensor(0.3)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)


def test_log_prior_and_likelihood(pack):
    x = np.asarray(JNoisyLorenz63(dt=0.025).trajectory(jax.random.key(2), jnp.asarray(randn(10, 3, 3) * 5), 12))
    x = np.moveaxis(x, 0, 1)  # (B, L, 3)
    y = x[:, ::3, :1] + randn(11, 3, 4, 1)

    np.testing.assert_allclose(lu.log_prior(t(x)).numpy(), np.asarray(pack.log_prior(jnp.asarray(x))), rtol=1e-5)

    want = pack.log_likelihood(jnp.asarray(y), jnp.asarray(x), A=lambda x: x[..., :1], sigma=0.5, step=3)
    got = lu.log_likelihood(t(y), t(x), A=lambda x: x[..., :1], sigma=0.5, step=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# -- Data and the PRNG replay ------------------------------------------------

def test_simulate_splits():
    r"""``simulate`` at a small size: 80/10/10 splits of standardized
    trajectories on the attractor, reproducible from the seed."""

    splits = simulate(chains=20, length=64, burnin=32, seed=3, device='cpu')
    assert {k: tuple(v.shape) for k, v in splits.items()} == {
        'train': (16, 64, 3), 'valid': (2, 64, 3), 'test': (2, 64, 3)}
    x = torch.cat(list(splits.values()))
    assert torch.isfinite(x).all() and x.abs().max() < 5
    assert 0.5 < x.std().item() < 1.5

    chain = lu.make_chain(device='cpu')
    log_p = chain.log_prob(chain.postprocess(x[:, :-1]), chain.postprocess(x[:, 1:]))
    assert log_p.mean().item() > 0  # the recorded states follow the noisy dynamics

    again = simulate(chains=20, length=64, burnin=32, seed=3, device='cpu')
    assert all(torch.equal(splits[k], again[k]) for k in splits)


@pytest.mark.parametrize('seed, shape', [(0, (2, 15)), (0, (2, 3, 32)), (3, (1, 10, 64, 64)), (2**31 - 1, (5,))])
def test_prng_replays_jax(seed, shape):
    r"""The bits exactly; the normals to float32 rounding of ``erfinv``
    (near ``u = +-1`` the slope of ``erfinv`` amplifies a last-bit
    difference, so the bound is relative to each value)."""

    bits = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
    np.testing.assert_array_equal(prng.random_bits(seed, shape), bits)

    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    np.testing.assert_allclose(prng.normal(seed, shape).numpy(), want, rtol=1e-5, atol=1e-6)

    with pytest.raises(ValueError):
        prng.random_bits(-1, shape)

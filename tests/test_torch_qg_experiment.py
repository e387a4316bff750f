r"""The port's QG experiment pack, the Kolmogorov ``generate`` command line and
``validate_solver`` against the JAX packs, float32 on the CPU.

- ``qg_0`` and ``qg_1`` through the port's ``load_score`` on the golden probe
  against JAX's eps (atol 1e-5) and their golden entries (rtol 1e-3, atol
  1e-4; both checkpoints are float32);
- ``generate`` at a tiny size (32^2, 4 trajectories in chunks of 2, 2
  burn-in transitions, 4 kept frames) with JAX's per-chunk draws fed through
  the noise hook: the splits within a relative L2 of 1e-5, the scale within
  rtol 1e-5; the Kolmogorov ``main`` with ``--only test`` likewise;
- the scenarios' ``y`` (atol 1e-5), and ``assimilate`` and ``eval.py``'s
  rows with small random networks and JAX's draws through the sampler's
  ``init``/``noise`` hook: the samples within the guided-sample tolerance of
  ``tests/test_torch_scenarios.py``,
  ``atol = 1e-4 + 1e-5 max|x|``, the residual and RMSE within rtol 1e-4,
  the CSV rows (printed to 4 decimals) within rtol 1e-3, atol 1e-4;
- ``train`` for 2 epochs, whose ``state.msgpack`` the JAX package reads;
- ``validate_solver`` at 64^2 with a short spin-up: the report's keys and
  verdicts equal, its numbers within rtol 1e-3.

The JAX samplers run compiled, with ``VPSDE.sigma`` written
``sqrt((1 - alpha)(1 + alpha) + eta^2)`` as in ``tests/test_torch_scenarios.py``
(``ROADMAP.md``, faults, item 1).
"""

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu.diffusion import GaussianScore as JGaussianScore
from sda_tpu.diffusion import MCScoreNet as JMCScoreNet
from sda_tpu.diffusion import ScoreUNet as JScoreUNet
from sda_tpu.diffusion import bind_eps as jbind_eps
from sda_tpu.train import load_h5
from sda_tpu.train import load_params as jload_params
from sda_tpu.train import save_params as jsave_params
from sda_tpu_torch import prng
from sda_tpu_torch.diffusion import VPSDE
from sda_tpu_torch.experiments.kolmogorov import generate as kgenerate
from sda_tpu_torch.experiments.kolmogorov import validate_solver
from sda_tpu_torch.experiments.qg import eval as qeval
from sda_tpu_torch.experiments.qg.assimilate import SCENARIOS, assimilate, get_scenario
from sda_tpu_torch.experiments.qg.assimilate import main as assimilate_main
from sda_tpu_torch.experiments.qg.generate import generate
from sda_tpu_torch.experiments.qg.generate import main as generate_main
from sda_tpu_torch.experiments.qg.utils import load_score, make_score, make_trajectory_eps
from sda_tpu_torch.train import params_from_flax
from sda_tpu_torch.viz import draw

REPO = Path(__file__).resolve().parents[1]
QG_PACK = REPO / 'experiments/qg'
KOLMOGOROV_PACK = REPO / 'experiments/kolmogorov'
GOLDEN = json.loads((REPO / 'tests/golden/committed_artifacts.json').read_text())
NARROW = dict(window=5, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1), activation='SiLU', size=16)


def load_pack(name, pack=QG_PACK):
    r"""A module of a JAX pack, loaded by path under a name of its own
    (every pack calls its helpers ``utils``/``assimilate``)."""

    saved = {n: sys.modules.pop(n, None) for n in ('utils', 'assimilate')}
    sys.path.insert(0, str(pack))
    try:
        spec = importlib.util.spec_from_file_location(f'{pack.name}_{name}_for_torch', pack / f'{name}.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
        for n, m in saved.items():
            sys.modules.pop(n, None)
            if m is not None:
                sys.modules[n] = m
    return module


JUTILS = load_pack('utils')
JASSIM = load_pack('assimilate')


class JStableVPSDE(JVPSDE):
    r"""The JAX package's ``VPSDE`` with ``sigma`` free of the float32
    cancellation at ``t = 0`` (see the module's docstring)."""

    def sigma(self, t):
        a = self.alpha(t)
        return jnp.sqrt((1 - a) * (1 + a) + self.eta**2)


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


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def jax_noise(key, shape):
    k_init, k_scan = jax.random.split(key)

    def noise(i, j):
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), j), shape))

    return t(jax.random.normal(k_init, shape)), noise


def narrow_params(seed=1, scale=1.0):
    module = JScoreUNet(channels=10, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1),
                        activation=jax.nn.silu, spatial=2, circular=True)
    shapes = jax.eval_shape(module.init, jax.random.key(1), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(scale * rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1] or (10,))), jnp.float32),
        shapes['params'],
    )
    return module, params


# -- The committed checkpoints --------------------------------------------------


@pytest.mark.parametrize('run', ['qg_0', 'qg_1'])
def test_committed_checkpoint(run):
    r"""A plain circular ScoreUNet (no forcing channel): ``params_from_flax``
    maps every key, and the eps equals JAX's."""

    rundir = QG_PACK / 'storage/runs' / run
    module, config = load_score(rundir, device='cpu')
    assert not config.get('bf16', False) and config['window'] == 5

    # The card rebuilds the probe with prng.normal: the same threefry bits,
    # its inverse error function within 6e-6 of JAX's in the tails (40,960
    # draws).
    x_j = jax.random.normal(jax.random.key(0), (1, 10, 64, 64), dtype=jnp.float32)
    x = prng.normal(0, (1, 10, 64, 64))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-5, atol=1e-6)

    jmodule, jparams, _ = JUTILS.load_score(rundir)
    want = np.asarray(jax.jit(jmodule.apply)({'params': jparams}, x_j, 0.5 * jnp.ones((1,))))
    with torch.no_grad():
        np.testing.assert_allclose(module(t(x_j), 0.5 * torch.ones(1)).numpy(), want, atol=1e-5)
        got = module(x, 0.5 * torch.ones(1)).numpy().astype(np.float64)

    golden = GOLDEN[f'experiments/qg/storage/runs/{run}']
    assert golden['bf16'] is False
    np.testing.assert_allclose(got.mean(), golden['mean'], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.std(), golden['std'], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.ravel()[:4], golden['head'], rtol=1e-3, atol=1e-4)


# -- Data generation ------------------------------------------------------------


def qg_chunk_noise(seed, chunks, chunk, size):
    r"""The QG pack's prior noise per chunk: ``key, sub = split(key)``, then
    the first of ``split(sub, 3)``."""

    key, out = jax.random.key(seed), []
    for _ in range(chunks):
        key, sub = jax.random.split(key)
        out.append(t(jax.random.normal(jax.random.split(sub, 3)[0], (chunk, 2, size, size))))
    return out


def test_generate_matches_jax(tmp_path, monkeypatch):
    jgen = load_pack('generate')
    monkeypatch.setattr(jgen, 'PATH', tmp_path / 'jax')
    settings = dict(trajectories=4, size=32, burnin=2, keep=4, coarse=2, chunk=2, seed=0)
    jgen.main(**settings)

    noises = qg_chunk_noise(0, 2, 2, 32)
    splits, scale = generate(**settings, device='cpu', noise=lambda i: noises[i])

    want = json.loads((tmp_path / 'jax/data/scale.json').read_text())['scale']
    np.testing.assert_allclose(scale.numpy(), want, rtol=1e-5)
    for name, n in (('train', 3), ('valid', 0), ('test', 1)):
        jx = load_h5(tmp_path / f'jax/data/{name}.h5')
        assert splits[name].shape == jx.shape == (n, 4, 2, 16, 16)
        if n:
            assert rel_l2(splits[name].numpy(), jx) < 1e-5

    # The command line writes what the JAX pack's writes.
    generate_main(**settings, device='cpu', path=tmp_path / 'torch', noise=lambda i: noises[i])
    got = json.loads((tmp_path / 'torch/data/scale.json').read_text())
    assert list(got) == ['scale'] and len(got['scale']) == 2
    np.testing.assert_allclose(got['scale'], want, rtol=1e-5)
    for name in ('train', 'valid', 'test'):
        jx, tx = load_h5(tmp_path / f'jax/data/{name}.h5'), load_h5(tmp_path / f'torch/data/{name}.h5')
        assert tx.shape == jx.shape and tx.dtype == jx.dtype == np.float32


def test_kolmogorov_generate_only_test_matches_jax(tmp_path, monkeypatch):
    r"""``--only test`` simulates the last chunk alone and writes the split
    the JAX pack's ``main`` writes, and no other."""

    jgen = load_pack('generate', KOLMOGOROV_PACK)
    monkeypatch.setattr(jgen, 'PATH', tmp_path / 'jax')
    settings = dict(trajectories=10, size=32, length=4, keep=2, coarse=2, chunk=2, seed=0, only='test')
    jgen.main(**settings)

    key, noises = jax.random.key(0), []
    for _ in range(5):
        key, sub = jax.random.split(key)
        noises.append(t(jax.random.normal(jax.random.split(sub)[0], (2, 2, 32, 32))))
    asked = []

    def noise(i):
        asked.append(i)
        return noises[i]

    kgenerate.main(**settings, device='cpu', path=tmp_path / 'torch', noise=noise)

    assert asked == [4]  # trajectories 8-9; the test split is trajectory 9
    jx, tx = load_h5(tmp_path / 'jax/data/test.h5'), load_h5(tmp_path / 'torch/data/test.h5')
    assert tx.shape == jx.shape == (1, 2, 2, 16, 16)
    assert rel_l2(tx, jx) < 1e-5
    assert sorted(p.name for p in (tmp_path / 'torch/data').iterdir()) == ['test.h5']


def test_kolmogorov_generate_only_is_a_full_run_split(tmp_path):
    r"""Each chunk has its own generator, so a split made alone is the same
    split of a full run, bit for bit."""

    settings = dict(trajectories=6, size=16, length=3, keep=2, coarse=2, chunk=2, seed=3, device='cpu')
    kgenerate.main(**settings, path=tmp_path / 'full')
    kgenerate.main(**settings, only='valid,test', path=tmp_path / 'only')

    for name in ('valid', 'test'):
        np.testing.assert_array_equal(load_h5(tmp_path / f'only/data/{name}.h5'),
                                      load_h5(tmp_path / f'full/data/{name}.h5'))
    assert not (tmp_path / 'only/data/train.h5').exists()


# -- Scenarios and assimilation --------------------------------------------------


@pytest.mark.parametrize('size', [64, 16])
@pytest.mark.parametrize('name', SCENARIOS)
def test_scenario_matches_jax(name, size):
    x_star = randn(size, 16, 2, size, size)
    jA, jy, jstd, jlength, jgamma = JASSIM.get_scenario(name, x_star, np.random.RandomState(0))
    A, y, std, length, gamma = get_scenario(name, t(x_star), np.random.RandomState(0))

    assert (std, length, gamma) == (jstd, jlength, jgamma)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)

    x = randn(1, 2, length, 2, size, size)
    np.testing.assert_allclose(A(t(x)).numpy(), np.asarray(jA(jnp.asarray(x))), atol=1e-5)


def test_upper_is_blind_to_the_bottom_layer():
    x_star = t(randn(0, 16, 2, 64, 64))
    A, y, std, length, gamma = get_scenario('upper', x_star, np.random.RandomState(0))
    x2 = x_star[:length].clone()
    x2[:, 1] += 123.0

    assert y.shape == (8, 1, 16, 16)
    assert torch.equal(A(x_star[:length]), A(x2))
    with pytest.raises(ValueError):
        get_scenario('rings', x_star, np.random.RandomState(0))


@pytest.fixture(scope='module')
def nets():
    module, params = narrow_params()
    kernel = make_score(**NARROW)
    kernel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return JMCScoreNet(jbind_eps(module, params), order=2), make_trajectory_eps(kernel, window=5)


def gaussian_eps(sde, x, tt):
    mu, sigma = sde.mu(tt), sde.sigma(tt)
    return sigma * x / (mu**2 + sigma**2)


@pytest.mark.parametrize('name', SCENARIOS)
def test_assimilate_matches_jax(nets, name):
    r"""Two samples, 4 steps, 1 correction: ``experiments/qg/assimilate.py``'s
    sampler with the JAX components (its own ``assimilate`` reads files)."""

    jnet, tnet = nets
    x_star = randn(3, 16, 2, 16, 16)

    A, y, std, length, gamma = JASSIM.get_scenario(name, x_star, np.random.RandomState(0))
    jsde = JStableVPSDE(shape=())

    def jscore(x, tt, c=None):
        return gaussian_eps(jsde, x, tt) + 0.01 * jnet(x, tt, c)

    guided = JGaussianScore(y=y, A=A, std=std, sde=JStableVPSDE(eps=jscore, shape=()), gamma=gamma)
    key = jax.random.key(4)
    want = np.asarray(JStableVPSDE(eps=guided, shape=(length, 2, 16, 16)).sample(
        key, (2,), steps=4, corrections=1, tau=0.5))
    want_residual = float(jnp.std(A(want) - y))

    tsde = VPSDE(shape=())

    def tscore(x, tt, c=None):
        return gaussian_eps(tsde, x, tt) + 0.01 * tnet(x, tt, c)

    init, noise = jax_noise(key, (2, length, 2, 16, 16))
    got, residual, rmse = assimilate(tscore, t(x_star), name, samples=2, steps=4, corrections=1, tau=0.5,
                                     seed=0, init=init, noise=noise)

    assert got.shape == (2, length, 2, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 + 1e-5 * np.abs(want).max())
    np.testing.assert_allclose(residual, want_residual, rtol=1e-4)
    if name == 'upper':
        want_rmse = float(jnp.sqrt(jnp.mean((jnp.mean(want, axis=0) - x_star[:length]) ** 2, axis=(0, 2, 3)))[1])
        np.testing.assert_allclose(rmse, want_rmse, rtol=1e-4)
    else:
        assert rmse is None


def test_cli_refusals():
    r"""Nothing is refused any more: ``assimilate`` renders by default and
    takes the JAX pack's ``--no-render`` (``tests/test_torch_figures.py``
    holds the rendering); without a mesh, or without an ``'sp'`` axis, the
    score is the plain ``MCScoreNet`` (``tests/test_torch_parallel.py`` runs
    the sharded one), and ``train --mesh`` is an option of the command
    line."""

    assert inspect.signature(assimilate_main).parameters['render'].default is True
    done = subprocess.run([sys.executable, '-m', 'sda_tpu_torch.experiments.qg.assimilate', '--help'],
                          cwd=REPO, capture_output=True, text=True)
    assert done.returncode == 0 and '--no-render' in done.stdout and 'refused' not in done.stdout
    score = make_trajectory_eps(make_score(**NARROW), window=5, chunk=4, mesh=None)
    assert type(score).__name__ == 'MCScoreNet' and score.chunk == 4

    done = subprocess.run([sys.executable, '-m', 'sda_tpu_torch.experiments.qg.train', '--help'],
                          cwd=REPO, capture_output=True, text=True)
    assert done.returncode == 0 and '--mesh' in done.stdout and 'refused' not in done.stdout


def test_parse_indices():
    assert qeval.parse_indices('0-3,7') == [0, 1, 2, 3, 7]
    assert qeval.parse_indices('5') == [5]


# -- Evaluation -----------------------------------------------------------------


@pytest.fixture(scope='module')
def eval_storage(tmp_path_factory):
    r"""A storage directory both packages' ``eval.main`` read: a narrow run
    (JAX weights in flax's msgpack) and a 3 x 16-frame test set at 16^2."""

    import h5py

    path = tmp_path_factory.mktemp('qg_storage')
    run = path / 'runs/narrow'
    run.mkdir(parents=True)
    (run / 'config.json').write_text(json.dumps(dict(NARROW, hidden_channels=[8, 16], hidden_blocks=[1, 1])))
    _, params = narrow_params(seed=2, scale=0.1)
    jsave_params(params, run / 'state.msgpack')

    (path / 'data').mkdir()
    with h5py.File(path / 'data/test.h5', 'w') as f:
        f.create_dataset('x', data=randn(7, 3, 16, 2, 16, 16) * 0.5)
    return path


def test_eval_main_matches_jax(eval_storage, tmp_path, monkeypatch):
    r"""``main`` on index 1 at 2 samples x 4 steps x 1 correction with the
    generative row at 2 windows x 4 steps, both packages with the same
    weights and JAX's draws: the rows have the JAX pack's columns and
    agree, and a second run skips them."""

    import shutil

    jeval = load_pack('eval')
    jpath, tpath = tmp_path / 'jax', tmp_path / 'torch'
    shutil.copytree(eval_storage, jpath)
    shutil.copytree(eval_storage, tpath)
    monkeypatch.setattr(jeval, 'PATH', jpath)
    monkeypatch.setattr(jeval, 'VPSDE', JStableVPSDE)

    settings = dict(indices=[1], samples=2, steps=4, corrections=1, tau=0.5, seed=0, gen_batch=2, gen_steps=4)
    jeval.main('narrow', 'upper', **settings)

    init_g = t(jax.random.normal(jax.random.split(jax.random.key(0))[0], (2, 10, 16, 16)))
    draws = {'generative': init_g, 'posterior': {1: jax_noise(jax.random.key(101), (2, 16, 2, 16, 16))}}
    rows = qeval.main('narrow', 'upper', **settings, device='cpu', path=tpath, draws=draws)

    want = [line.split(',') for line in (jpath / 'results/eval.csv').read_text().splitlines()]
    got = [line.split(',') for line in (tpath / 'results/eval.csv').read_text().splitlines()]
    assert [r[:4] for r in got] == [r[:4] for r in want] == [
        ['generative', 'narrow', 'upper', ''], ['posterior', 'narrow', 'upper', '1']]
    for g, w in zip(got, want):
        assert len(g) == len(w) == 9
        assert [v == '' for v in g] == [v == '' for v in w]
        values = [(float(a), float(b)) for a, b in zip(g[4:], w[4:]) if b]
        assert all(np.isfinite(b) for _, b in values)
        np.testing.assert_allclose(*zip(*values), rtol=1e-3, atol=1e-4)
    assert set(rows) == {tuple(r[:4]) for r in got}

    assert qeval.main('narrow', 'upper', **settings, device='cpu', path=tpath) == {}
    assert len((tpath / 'results/eval.csv').read_text().splitlines()) == 2


# -- Training -----------------------------------------------------------------


def test_train_entry_point(tmp_path, monkeypatch):
    r"""``train``, narrowed, on 8^2 fields for two epochs: the run directory
    holds the JAX pack's files, and JAX reads its weights."""

    from sda_tpu_torch.experiments.qg.train import CONFIG, train

    monkeypatch.setitem(CONFIG, 'embedding', 8)
    monkeypatch.setitem(CONFIG, 'hidden_channels', (4, 8, 16))
    monkeypatch.setitem(CONFIG, 'hidden_blocks', (1, 1, 1))
    monkeypatch.setitem(CONFIG, 'size', 8)

    data = randn(0, 3, 6, 2, 8, 8)
    x = train(0, epochs=2, device='cpu', path=tmp_path, trainset=data[:2], validset=data[2:])
    assert x.shape == (2, 5, 2, 8, 8) and torch.isfinite(x).all()

    run = tmp_path / 'runs/qg_0'
    w = x[:, -1].numpy()  # the last frame, both layers, on a symmetric scale
    scale = float(np.abs(w).max())
    with Image.open(run / 'samples.png') as png:
        np.testing.assert_array_equal(np.asarray(png), np.asarray(draw(w, vmin=-scale, vmax=scale)))
    config = json.loads((run / 'config.json').read_text())
    assert config == {**json.loads(json.dumps(CONFIG)), 'epochs': 2}
    records = [json.loads(line) for line in (run / 'metrics.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records] == [1, 2] and all(np.isfinite(r['loss_train']) for r in records)

    module = JUTILS.make_score(**config)
    template = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 10, 8, 8)), jnp.ones((1,)))['params']
    params = jload_params(template, run / 'state.msgpack')
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(jax.tree_util.tree_leaves(template))
    assert all(np.isfinite(np.asarray(v)).all() for v in leaves)


# -- The Kolmogorov solver gate -------------------------------------------------


def test_validate_solver_matches_jax(tmp_path, monkeypatch):
    r"""At 64^2, 2 fields, 6 spin-up and 6 recorded transitions from JAX's
    prior noise: the same report keys, the same verdicts, and numbers within
    rtol 1e-3."""

    jval = load_pack('validate_solver', KOLMOGOROV_PACK)
    monkeypatch.setattr(jval, 'PATH', tmp_path / 'jax')
    settings = dict(size=64, spinup=6, window=6, ensemble=2)

    try:
        want = jval.main(**settings)
    except SystemExit:
        want = json.loads((tmp_path / 'jax/results/solver_validation.json').read_text())
    noise = jax.random.normal(jax.random.split(jax.random.key(0), 3)[0], (2, 2, 64, 64))
    try:
        got = validate_solver.main(**settings, device='cpu', path=tmp_path / 'torch', noise=t(noise))
    except SystemExit as e:
        assert 'FAILED' in str(e)
        got = json.loads((tmp_path / 'torch/results/solver_validation.json').read_text())

    assert list(got) == list(want)
    assert got['checks'] == want['checks'] and got['passed'] == want['passed']
    for key, value in want.items():
        if key not in ('checks', 'passed', 'finite'):
            np.testing.assert_allclose(got[key], value, rtol=1e-3, err_msg=key)

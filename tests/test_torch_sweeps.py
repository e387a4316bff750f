r"""The port's sweeps and memory probe against the JAX package's scripts.

The guided sample is stubbed in both packages with the same draws from a
seed, so these tests hold the sweeps' own logic (grids, keys, row formats,
skips, the spectrum distance through ``RealDFT2``); the sampler itself is
held in ``tests/test_torch_scenarios.py`` and ``test_torch_sampler.py``.
The JAX scripts run from ``experiments/`` as they are, on the CPU.
"""

import contextlib
import importlib.util
import io
import json
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.train import save_h5
from sda_tpu_torch.experiments.kolmogorov import hbm_probe, sweep_guidance, sweep_methods, sweep_solver
from sda_tpu_torch.experiments.lorenz import sweep_solver as lorenz_sweep

REPO = Path(__file__).resolve().parents[1]
PACK_NAMES = ('utils', 'assimilate', 'eval')


def load_pack(pack, name):
    r"""A script of ``experiments/<pack>``, loaded by path under a name of
    its own with the pack's helpers (``utils``, ``assimilate``, ``eval``)
    imported fresh, so that each reads the ``SCRATCH`` of the moment."""

    saved = {n: sys.modules.pop(n, None) for n in PACK_NAMES}
    sys.path.insert(0, str(REPO / 'experiments' / pack))
    try:
        spec = importlib.util.spec_from_file_location(f'{pack}_{name}_for_sweeps', REPO / 'experiments' / pack / f'{name}.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
        for n, m in saved.items():
            sys.modules.pop(n, None)
            if m is not None:
                sys.modules[n] = m
    return module


def seed_of(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def stub_assimilate(array):
    r"""An ``assimilate(run, scenario, ...)`` that returns ``(residual,
    std, xs)`` drawn from a seed of its arguments: ``xs`` is ``(2, 8, 2,
    64, 64)``, wrapped by ``array``."""

    stds = {'extrapolate': 0.01, 'patch': 0.05, 'saturation': 0.05}

    def assimilate(run, scenario, **kw):
        key = (run, scenario, kw['steps'], kw['corrections'], kw.get('tau'), kw.get('gamma'), kw.get('method'),
               kw.get('solver'), kw.get('stride'), kw.get('offset'), kw['seed'], kw['samples'])
        rng = np.random.RandomState(seed_of(*key))
        std = stds.get(scenario, 0.1)
        residual = float(std * (1 + rng.rand()))
        xs = rng.standard_normal((2, 8, 2, 64, 64)).astype(np.float32)
        assert kw['render'] is False
        return residual, std, array(xs)

    return assimilate


@pytest.fixture()
def kolmogorov_storage(tmp_path):
    r"""The same small ``data/test.h5`` (2 trajectories of 16 frames at
    64^2) in a storage of each package."""

    x = np.random.RandomState(0).standard_normal((2, 16, 2, 64, 64)).astype(np.float32)
    paths = {}
    for name in ('jax', 'torch'):
        paths[name] = tmp_path / name
        save_h5(paths[name] / 'data/test.h5', x)
    return paths


def rows(csv):
    return [line.split(',') for line in Path(csv).read_text().splitlines()]


def assert_rows_equal(got, want, spec, skip=()):
    r"""Equal rows, but column ``spec`` (a spectrum distance printed with
    4 decimals) within one unit of its last place and the ``skip`` columns
    not compared."""

    assert len(got) == len(want) and len(got) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for i, (u, v) in enumerate(zip(a, b)):
            if i == spec:
                assert abs(float(u) - float(v)) <= 1e-4 + 1e-9, (a, b)
            elif i not in skip:
                assert u == v, (i, a, b)


SWEEPS = {
    # name: (port module, its call, the JAX call, CSV, spectrum column, skipped columns, rows)
    'methods': (sweep_methods, dict(run='narrow', samples=2, steps=8, corrections=1, seed=0),
                lambda m: m.main('narrow', 2, 8, 1, 0), 'method_sweep.csv', 6, (), 14),
    'guidance': (sweep_guidance, dict(run='narrow', scenario='coarse', samples=2, steps=8, seed=0),
                 lambda m: m.main('narrow', 'coarse', 2, 8, 0), 'guidance_sweep.csv', 9, (), 9),
    'solver': (sweep_solver, dict(run='narrow', scenario='coarse', samples=2, seed=0, steps_grid=[32, 64]),
               lambda m: m.main('narrow', 'coarse', 2, 0, [32, 64]), 'solver_sweep.csv', 7, (8,), 4),
}


@pytest.mark.parametrize('name', SWEEPS)
def test_kolmogorov_sweep_matches_jax(name, kolmogorov_storage, monkeypatch, capsys):
    r"""The rows the port writes equal the JAX script's (``wall_s`` apart;
    the spectrum distance within 1e-4), in the same order; a second run of
    either skips every row."""

    module, kwargs, jax_main, csv_name, spec, skip, count = SWEEPS[name]
    jsweep = load_pack('kolmogorov', f'sweep_{name}')
    monkeypatch.setattr(jsweep, 'PATH', kolmogorov_storage['jax'])
    monkeypatch.setattr(jsweep, 'assimilate', stub_assimilate(jnp.asarray))
    monkeypatch.setattr(module, 'assimilate', stub_assimilate(torch.from_numpy))

    for _ in range(2):
        jax_main(jsweep)
        module.main(**kwargs, path=kolmogorov_storage['torch'], device='cpu')

    want = rows(kolmogorov_storage['jax'] / f'results/{csv_name}')
    got = rows(kolmogorov_storage['torch'] / f'results/{csv_name}')
    assert len(want) == count
    assert_rows_equal(got, want, spec, skip)
    out = capsys.readouterr().out
    assert out.count('(done)') == 2 * count


def test_sweep_methods_only_and_given_trajectories(kolmogorov_storage, monkeypatch):
    r"""``only`` selects scenarios by label; ``x_test`` replaces the test
    file (the card has no ``h5py``) and gives the same rows."""

    from sda_tpu_torch.train import load_h5

    monkeypatch.setattr(sweep_methods, 'assimilate', stub_assimilate(torch.from_numpy))
    kwargs = dict(run='narrow', samples=2, steps=8, corrections=1, seed=0, only='subsample_s8,patch', device='cpu')
    sweep_methods.main(**kwargs, path=kolmogorov_storage['torch'])
    given = kolmogorov_storage['torch'].parent / 'given'
    sweep_methods.main(**kwargs, path=given, x_test=torch.from_numpy(load_h5(kolmogorov_storage['torch'] / 'data/test.h5')))

    want = rows(kolmogorov_storage['torch'] / 'results/method_sweep.csv')
    assert [r[:2] for r in want] == [['subsample_s8', 'sda'], ['subsample_s8', 'dps'], ['patch', 'sda'], ['patch', 'dps']]
    assert rows(given / 'results/method_sweep.csv') == want


class StubVPSDE:
    r"""A ``VPSDE`` whose ``sample`` returns ``(samples, 65, 3)`` normal
    draws from a seed of the step count and the solver; ``framework`` wraps
    them."""

    framework = None

    def __init__(self, eps=None, shape=()):
        self.shape = shape

    def sample(self, *args, steps, solver='ddim', **kwargs):
        shape = args[-1]
        x = np.random.RandomState(seed_of(steps, solver)).standard_normal(tuple(shape) + self.shape)
        return self.framework(x.astype(np.float32))


class StubGaussianScore:
    def __init__(self, **kwargs):
        pass


def test_lorenz_sweep_solver_matches_jax(tmp_path, monkeypatch, capsys):
    r"""Index 0 of ``lo`` at 16 and 32 steps, 64 samples, from a small
    particle-filter cache and the committed ``local_k2_0``: the same keys
    and row format; log-prior, log-likelihood and W1 (printed in full)
    within rtol 1e-4, float32 sums in two frameworks. A second run skips
    every row."""

    storage = REPO / 'experiments/lorenz/storage'
    (tmp_path / 'results/bpf_lo').mkdir(parents=True)
    (tmp_path / 'results/obs.h5').symlink_to(storage / 'results/obs.h5')
    (tmp_path / 'runs').symlink_to(storage / 'runs')
    rng = np.random.RandomState(1)
    np.savez(tmp_path / 'results/bpf_lo/idx0.npz', x=rng.standard_normal((64, 65, 3)).astype(np.float32) * 8,
             x_=rng.standard_normal((64, 65, 3)).astype(np.float32) * 8)

    monkeypatch.setenv('SCRATCH', str(tmp_path / 'scratch'))
    jsweep = load_pack('lorenz', 'sweep_solver')
    monkeypatch.setattr(jsweep, 'PATH', tmp_path)
    monkeypatch.setitem(jsweep.ensure_bpf.__globals__, 'PATH', tmp_path)
    monkeypatch.setattr(jsweep, 'VPSDE', type('JStub', (StubVPSDE,), {'framework': staticmethod(jnp.asarray)}))
    monkeypatch.setattr(jsweep, 'GaussianScore', StubGaussianScore)
    monkeypatch.setattr(lorenz_sweep, 'VPSDE', type('TStub', (StubVPSDE,), {'framework': staticmethod(torch.from_numpy)}))
    monkeypatch.setattr(lorenz_sweep, 'GaussianScore', StubGaussianScore)

    jax_csv = tmp_path / 'results/solver_sweep.csv'
    for _ in range(2):
        jsweep.main('local_k2_0', True, 0, 64, [16, 32])
    want = rows(jax_csv)
    jax_csv.rename(tmp_path / 'jax_solver_sweep.csv')
    for _ in range(2):
        lorenz_sweep.main('local_k2_0', True, 0, 64, [16, 32], path=tmp_path, device='cpu')
    got = rows(jax_csv)

    assert [r[:4] for r in got] == [r[:4] for r in want] == [
        ['0', 'local_k2_0', solver, steps] for steps in ('16', '32') for solver in ('ddim', 'dpm2m')]
    np.testing.assert_allclose(np.array([r[4:] for r in got], float), np.array([r[4:] for r in want], float),
                               rtol=1e-4)
    assert capsys.readouterr().out.count('(done)') == 8


@pytest.fixture(scope='module')
def narrow_run(tmp_path_factory):
    r"""A storage holding a narrow Kolmogorov run (JAX-initialised weights
    in flax's msgpack) and a small ``data/test.h5``, at 16^2."""

    import jax

    from sda_tpu.train import save_params

    path = tmp_path_factory.mktemp('probe_storage')
    config = dict(window=5, embedding=8, hidden_channels=[8, 16], hidden_blocks=[1, 1], activation='SiLU', size=16)
    (path / 'runs/narrow').mkdir(parents=True)
    (path / 'runs/narrow/config.json').write_text(json.dumps(config))
    jutils = load_pack('kolmogorov', 'utils')
    module = jutils.make_score(**config)
    params = module.init(jax.random.key(0), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))['params']
    save_params(params, path / 'runs/narrow/state.msgpack')
    save_h5(path / 'data/test.h5', np.random.RandomState(0).standard_normal((2, 16, 2, 16, 16)).astype(np.float32))
    return path


def run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        main(argv)
    return exit_.value.code, json.loads(out.getvalue().strip().splitlines()[-1])


CONFIGURATION = ('run', 'scenario', 'samples', 'length', 'chunk', 'remat', 'steps')


def test_hbm_probe_line(narrow_run, monkeypatch):
    r"""At 16^2, 2 samples, 1 step, chunks of 2 windows with remat, on the
    CPU: the JSON line has the JAX script's keys (and the port's
    ``peak_memory_gb``, not measured here) with ``status: executed``.

    The JAX script's own ``loop`` path, its default, fails before it runs
    (``get_scenario`` reads the shape of the absent reference trajectory),
    so its line is taken on ``coarse``; the port runs both."""

    common = ['--run', 'narrow', '--samples', '2', '--chunk', '2', '--remat', '--steps', '1']
    jprobe = load_pack('kolmogorov', 'hbm_probe')
    monkeypatch.setattr(jprobe, 'PATH', narrow_run)
    monkeypatch.setattr(hbm_probe, 'PATH', narrow_run)

    monkeypatch.setattr(sys, 'argv', ['hbm_probe.py'] + common + ['--length', '8'])
    with pytest.raises(AttributeError):
        jprobe.main()

    monkeypatch.setattr(sys, 'argv', ['hbm_probe.py'] + common + ['--scenario', 'coarse'])
    code, want = run_main(lambda _: jprobe.main(), None)
    assert code == 0 and want['status'] == 'executed'

    code, got = run_main(hbm_probe.main, common + ['--scenario', 'coarse', '--device', 'cpu'])
    assert code == 0
    assert set(got) == set(want) | {'peak_memory_gb'}
    assert got['status'] == 'executed' and got['finite'] is True and got['peak_memory_gb'] is None
    assert {k: got[k] for k in CONFIGURATION} == {k: want[k] for k in CONFIGURATION}

    code, got = run_main(hbm_probe.main, common + ['--length', '8', '--device', 'cpu'])
    assert code == 0 and set(got) == set(want) | {'peak_memory_gb'}
    assert (got['scenario'], got['length'], got['status'], got['finite']) == ('loop', 8, 'executed', True)


def test_hbm_probe_refuses_compile_only(capsys):
    with pytest.raises(SystemExit) as exit_:
        hbm_probe.main(['--compile-only', '--device', 'cpu'])
    assert exit_.value.code == 2
    assert 'eager PyTorch has no compile step' in capsys.readouterr().err

r"""The 256^2-native configuration of the Kolmogorov experiment in the port
against the JAX package, on the CPU.

- ``unet256_0`` (the committed run of ``train.py --size 256 --bf16 --batch
  16``): its ``state.msgpack`` through the port's reader against flax's, and
  its eps at full width on the golden probe of
  ``tests/test_committed_artifacts.py`` at 256^2, through the port's
  ``load_score``:

  - float32 against the JAX package's float32 (atol 1e-4); the golden entry
    was evaluated with the config's bf16 compute (its head values are bf16
    numbers), so the float32 eps is held to it at the golden test's bf16
    tolerances, as ``tests/test_torch_nn.py`` holds ``unet_0``'s;
  - bf16 against the golden entry at those tolerances (rtol 2e-2, atol
    2e-2; the mean, ~3e-4, to within half a bf16 unit, 2e-3, as for
    ``unet_0``), and against the JAX package's bf16 within twice the JAX
    package's own bf16-against-float32 gap, measured in the same test.
    ``unet_0``'s fixed rule (rms <= 0.015, max <= 0.08) does not carry over
    to these weights: with them the JAX package's own bf16 is rms 0.0248,
    max 0.116 from its float32 at 256^2, and the port's bf16 was rms 0.0252,
    max 0.133 from the JAX package's when the rule was set;
  - ``unet256_0``'s config with ``unet_0``'s parameters, what the card runs
    (the same shapes: the two configs differ in ``size``, ``batch_size`` and
    ``epochs`` only), bf16 against the JAX package's bf16 under ``unet_0``'s
    rule. At the same 256^2 the JAX package's own bf16 gap is rms 0.0069
    with these parameters: the larger gap above comes with ``unet256_0``'s
    weights, not with the grid.

  ``pytest -s`` prints the gaps.

- ``generate`` with ``coarse`` 1 (32^2, 10 trajectories in chunks of 2) against
  the JAX pack's ``main`` through the same prior noise, and the split
  arithmetic of data256 (128 trajectories, test from 115, in chunk 7);
- ``train`` at ``--size 16 --bf16 --batch 2`` through its command line: the
  run ``unet16_0``, the default data directory ``data16`` and the config's
  ``size``, with the JAX package's ``load_params`` reading the weights back;
- ``assimilate.main`` with a narrow random ``LocalScoreUNet`` at 32^2, chunks
  of 2 windows, per-chunk remat and 16 segments, against the JAX pack's
  ``assimilate`` (run as one segment) through the same draws (``atol = 1e-4 +
  1e-5 max|x|``, as in ``tests/test_torch_scenarios.py``), and bitwise against
  one unsegmented run of its own;
- ``hbm_probe`` taking its grid from the run's config;
- the FLOP count of a 256^2 window and of the card's guided sample.

The JAX samplers run compiled, with ``VPSDE.sigma`` written as in
``tests/test_torch_scenarios.py``.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch.utils.flop_counter import FlopCounterMode

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu.nn import flops as jflops
from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
from sda_tpu.train import load_h5
from sda_tpu.train import load_params as jload_params
from sda_tpu.train import save_params as jsave_params
from sda_tpu_torch.experiments.kolmogorov import generate as kgenerate
from sda_tpu_torch.experiments.kolmogorov import hbm_probe
from sda_tpu_torch.experiments.kolmogorov.assimilate import main as assimilate_main
from sda_tpu_torch.experiments.kolmogorov.utils import load_score, make_score
from sda_tpu_torch.nn import guided_sampler_flops, score_unet_flops
from sda_tpu_torch.train import checkpoint, load_params, params_from_flax

REPO = Path(__file__).resolve().parents[1]
PACK = REPO / 'experiments/kolmogorov'
RUNS = PACK / 'storage/runs'
UNET256_0, UNET_0 = RUNS / 'unet256_0', RUNS / 'unet_0'
GOLDEN = json.loads((REPO / 'tests/golden/committed_artifacts.json').read_text())
NARROW = dict(window=5, embedding=8, hidden_channels=[8, 16], hidden_blocks=[1, 1], activation='SiLU')


def load_pack(name):
    r"""A module of the JAX Kolmogorov pack, loaded by path under a name of
    its own (every pack calls its helpers ``utils``/``assimilate``)."""

    saved = {n: sys.modules.pop(n, None) for n in ('utils', 'assimilate')}
    sys.path.insert(0, str(PACK))
    try:
        spec = importlib.util.spec_from_file_location(f'kolmogorov_{name}_for_native256', PACK / f'{name}.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
        for n, m in saved.items():
            sys.modules.pop(n, None)
            if m is not None:
                sys.modules[n] = m
    return module


class JStableVPSDE(JVPSDE):
    r"""The JAX package's ``VPSDE`` with ``sigma`` free of the float32
    cancellation at ``t = 0`` (``tests/test_torch_scenarios.py``)."""

    def sigma(self, t):
        a = self.alpha(t)
        return jnp.sqrt((1 - a) * (1 + a) + self.eta**2)


def t(a):
    return torch.from_numpy(np.array(a))


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def rms_max(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d**2))), float(np.abs(d).max())


def jax_noise(key, shape):
    r"""``VPSDE.sample``'s draws from ``key``: the initial state and the
    corrector's noise of global step ``i``, correction ``j``."""

    k_init, k_scan = jax.random.split(key)

    def noise(i, j):
        return t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), j), shape))

    return t(jax.random.normal(k_init, shape)), noise


# -- unet256_0 at full width, 256^2 ----------------------------------------------

PROBE_X = jax.random.normal(jax.random.key(0), (1, 10, 256, 256), dtype=jnp.float32)
PROBE_T = 0.5 * jnp.ones((1,), dtype=jnp.float32)


def jax_eps(config, weights, bf16):
    r"""The JAX package's eps of the window kernel built from ``config`` with
    the parameters in ``weights``, on the golden probe, compiled."""

    module = JLocalScoreUNet(
        channels=10, size=config['size'], embedding=config['embedding'],
        hidden_channels=tuple(config['hidden_channels']), hidden_blocks=tuple(config['hidden_blocks']),
        activation=jax.nn.silu, dtype=jnp.bfloat16 if bf16 else None,
    )
    template = jax.eval_shape(module.init, jax.random.key(0), PROBE_X, PROBE_T)['params']
    params = jload_params(template, weights)
    return np.asarray(jax.jit(module.apply)({'params': params}, PROBE_X, PROBE_T), np.float64)


def port_eps(score):
    with torch.no_grad():
        return score(t(PROBE_X), t(PROBE_T)).numpy().astype(np.float64)


@pytest.fixture(scope='module')
def unet256_config():
    return json.loads((UNET256_0 / 'config.json').read_text())


@pytest.fixture(scope='module')
def jax_unet256(unet256_config):
    return {bf16: jax_eps(unet256_config, UNET256_0 / 'state.msgpack', bf16) for bf16 in (False, True)}


def test_unet256_0_state_reads_as_flax_reads_it(unet256_config):
    data = (UNET256_0 / 'state.msgpack').read_bytes()
    got, want = checkpoint.msgpack_restore(data), serialization.msgpack_restore(data)

    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert sum(v.size for _, v in flat_want) == 22_874_922

    module = make_score(**unet256_config)
    assert tuple(module.forcing.shape) == (1, 256, 256)  # the forcing context at the run's size
    module.load_state_dict(params_from_flax(got))  # strict: every key and shape


def test_unet256_0_float32_matches_jax_and_golden(jax_unet256):
    score, config = load_score(UNET256_0, device='cpu', bf16=False)
    assert config['size'] == 256 and config['bf16'] is False
    got = port_eps(score)

    assert got.shape == (1, 10, 256, 256)
    np.testing.assert_allclose(got, jax_unet256[False], atol=1e-4)

    golden = GOLDEN['experiments/kolmogorov/storage/runs/unet256_0']
    assert golden['bf16'] is True
    np.testing.assert_allclose(got.std(), golden['std'], rtol=2e-2)
    np.testing.assert_allclose(got.ravel()[:4], golden['head'], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.mean(), golden['mean'], atol=2e-3)


def test_unet256_0_bf16_matches_golden_and_jax_bf16(jax_unet256):
    score, config = load_score(UNET256_0, device='cpu')
    assert config['bf16'] is True and score.score.unet.convs[0].compute_dtype == torch.bfloat16
    got = port_eps(score)

    golden = GOLDEN['experiments/kolmogorov/storage/runs/unet256_0']
    np.testing.assert_allclose(got.std(), golden['std'], rtol=2e-2)
    np.testing.assert_allclose(got.ravel()[:4], golden['head'], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.mean(), golden['mean'], atol=2e-3)

    own_rms, own_max = rms_max(jax_unet256[True], jax_unet256[False])
    rms, err = rms_max(got, jax_unet256[True])
    print(f'unet256_0 at 256^2: JAX bf16 against JAX float32 rms {own_rms:.4f}, max {own_max:.4f}; '
          f'the port\'s bf16 against JAX bf16 rms {rms:.4f}, max {err:.4f}')
    assert rms <= 2 * own_rms, (rms, own_rms)
    assert err <= 2 * own_max, (err, own_max)


def test_unet_0_weights_in_the_256_config_bf16_matches_jax(unet256_config):
    r"""What the card runs: ``unet256_0``'s config, ``unet_0``'s parameters."""

    unet_0 = json.loads((UNET_0 / 'config.json').read_text())
    differ = {k for k in unet256_config if unet256_config[k] != unet_0.get(k)}
    assert differ == {'size', 'batch_size', 'epochs'}

    module = make_score(**unet256_config)
    module.load_state_dict(params_from_flax(load_params(UNET_0 / 'state.msgpack')))
    got = port_eps(module)
    want = {bf16: jax_eps(unet256_config, UNET_0 / 'state.msgpack', bf16) for bf16 in (False, True)}

    own_rms, own_max = rms_max(want[True], want[False])
    rms, err = rms_max(got, want[True])
    print(f'unet_0\'s parameters at 256^2: JAX bf16 against JAX float32 rms {own_rms:.4f}, max {own_max:.4f}; '
          f'the port\'s bf16 against JAX bf16 rms {rms:.4f}, max {err:.4f}')
    assert rms <= 0.015, rms
    assert err <= 0.08, err


def test_flops_at_256(unet256_config):
    r"""The analytic count of one 256^2 window against ``FlopCounterMode``
    (on the meta device: shapes only) and the JAX package's count, and the
    card's guided sample (2 samples x 28 windows x 16 steps x 1 correction)."""

    sizes = {k: unet256_config[k] for k in ('embedding', 'hidden_channels', 'hidden_blocks', 'kernel_size', 'size')}
    window = score_unet_flops(10, 1, **sizes)
    with torch.device('meta'):
        module = make_score(**unet256_config)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            module(torch.zeros(1, 10, 256, 256), torch.full((1,), 0.5))

    assert window == counter.get_total_flops() == jflops.score_unet_flops(10, 1, **sizes) == 448_115_810_304
    assert guided_sampler_flops(window, 28, 2, 16, 1) == jflops.guided_sampler_flops(window, 28, 2, 16, 1)


# -- generate --coarse 1 ------------------------------------------------------------


def test_generate_coarse_1_matches_jax(tmp_path, monkeypatch):
    jgen = load_pack('generate')
    monkeypatch.setattr(jgen, 'PATH', tmp_path / 'jax')
    settings = dict(trajectories=10, size=32, length=4, keep=3, coarse=1, chunk=2, seed=0, data='data32')
    jgen.main(**settings)

    key, noises = jax.random.key(0), []
    for _ in range(5):
        key, sub = jax.random.split(key)
        noises.append(t(jax.random.normal(jax.random.split(sub)[0], (2, 2, 32, 32))))
    kgenerate.main(**settings, device='cpu', path=tmp_path / 'torch', noise=lambda i: noises[i])

    for name, n in (('train', 8), ('valid', 1), ('test', 1)):
        jx, tx = load_h5(tmp_path / f'jax/data32/{name}.h5'), load_h5(tmp_path / f'torch/data32/{name}.h5')
        assert tx.shape == jx.shape == (n, 3, 2, 32, 32) and tx.dtype == jx.dtype == np.float32
        assert rel_l2(tx, jx) < 1e-5


def test_data256_split_arithmetic():
    r"""data256 (``--trajectories 128 --chunk 16``): the split bounds of the
    JAX pack's ``main`` and the chunk that holds the first test trajectory."""

    bounds = kgenerate.split_bounds(128)
    assert bounds == {'train': (0, 102), 'valid': (102, 115), 'test': (115, 128)}
    assert (int(0.8 * 128), int(0.9 * 128)) == (102, 115)  # the JAX pack's i, j
    assert bounds['test'][0] // 16 == 7


# -- train --size ------------------------------------------------------------------


def test_train_command_line_at_another_size(tmp_path):
    r"""``train.py --size 16 --bf16 --batch 2``: the run is ``unet16_0``, its
    data ``data16``, its config says so, and the JAX package reads the
    weights back into its own template."""

    (tmp_path / 'sda_tpu/kolmogorov/data16').mkdir(parents=True)
    for name, n in (('train', 2), ('valid', 1)):
        with h5py.File(tmp_path / f'sda_tpu/kolmogorov/data16/{name}.h5', 'w') as f:
            f.create_dataset('x', data=randn(n, n, 6, 2, 16, 16) * 0.5)

    env = dict(os.environ, SCRATCH=str(tmp_path), OMP_NUM_THREADS='2')
    done = subprocess.run(
        [sys.executable, '-m', 'sda_tpu_torch.experiments.kolmogorov.train', '--size', '16', '--bf16',
         '--batch', '2', '--epochs', '1', '--device', 'cpu'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr[-2000:]
    assert 'unet16_0: done' in done.stdout

    run = tmp_path / 'sda_tpu/kolmogorov/runs/unet16_0'
    config = json.loads((run / 'config.json').read_text())
    assert (config['size'], config['bf16'], config['batch_size'], config['epochs']) == (16, True, 2, 1)
    assert (run / 'samples.png').exists()

    module = JLocalScoreUNet(
        channels=10, size=16, embedding=config['embedding'], hidden_channels=tuple(config['hidden_channels']),
        hidden_blocks=tuple(config['hidden_blocks']), activation=jax.nn.silu, dtype=jnp.bfloat16,
    )
    template = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 10, 16, 16)), jnp.ones((1,)))['params']
    params = jload_params(template, run / 'state.msgpack')

    score, _ = load_score(run, device='cpu')
    state = score.state_dict()
    for name, value in params_from_flax(jax.tree_util.tree_map(np.asarray, params)).items():
        assert torch.equal(value, state[name]), name


# -- assimilate with chunks, remat and segments --------------------------------------


def narrow_params(size, seed=2):
    module = JLocalScoreUNet(channels=10, size=size, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1),
                             activation=jax.nn.silu)
    shapes = jax.eval_shape(module.init, jax.random.key(1), jnp.zeros((1, 10, size, size)), jnp.ones((1,)))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.1 * rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1] or (10,))), jnp.float32),
        shapes['params'],
    )


@pytest.fixture(scope='module')
def storage32(tmp_path_factory):
    r"""A storage both packages read: a narrow run at 32^2 (JAX weights in
    flax's msgpack) and a test set of 2 trajectories of 8 frames."""

    path = tmp_path_factory.mktemp('kolmogorov_storage32')
    run = path / 'runs/narrow32'
    run.mkdir(parents=True)
    (run / 'config.json').write_text(json.dumps(dict(NARROW, size=32)))
    jsave_params(narrow_params(32), run / 'state.msgpack')

    (path / 'data32').mkdir()
    with h5py.File(path / 'data32/test.h5', 'w') as f:
        f.create_dataset('x', data=randn(5, 2, 8, 2, 32, 32) * 0.5)
    return path


def test_assimilate_chunk_remat_segments_matches_jax(storage32, tmp_path, monkeypatch, capsys):
    jassim = load_pack('assimilate')
    monkeypatch.setattr(jassim, 'PATH', storage32)
    monkeypatch.setattr(jassim, 'VPSDE', JStableVPSDE)
    args = dict(run='narrow32', scenario='coarse', samples=2, steps=16, corrections=1, seed=0, render=False,
                chunk=2, remat=True, save=True, data='data32', segments=16)

    # The JAX side runs the grid in one program: each of its segments is a
    # program compiled anew (52 s for 16 here), and its tests/test_sde.py
    # holds its segmented sampling bitwise to one run.
    residual_j, std_j, want = jassim.assimilate(**dict(args, segments=1))
    want = np.asarray(want)
    capsys.readouterr()

    init, noise = jax_noise(jax.random.key(0), (2, 8, 2, 32, 32))
    residual, std, got = port_assimilate(storage32, tmp_path, args, init, noise)

    out = capsys.readouterr().out
    assert [line.split(' done')[0] for line in out.splitlines() if line.startswith('segment ')] == \
        [f'segment {i}:{i + 1}' for i in range(16)]
    assert got.shape == want.shape == (2, 8, 2, 32, 32) and std == std_j == 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 + 1e-5 * np.abs(want).max())
    np.testing.assert_allclose(residual, residual_j, rtol=1e-4)

    saved = np.load(tmp_path / 'results/samples_coarse_narrow32.npz')
    assert saved['xs'].shape == (2, 8, 2, 32, 32) and saved['x_star'].shape == (8, 2, 32, 32)

    one = port_assimilate(storage32, tmp_path, dict(args, segments=1, save=False), init, noise)
    assert torch.equal(one[2], got) and one[0] == residual


def port_assimilate(storage, out, args, init, noise):
    r"""The port's ``main`` on the run and data of ``storage``, writing its
    results under ``out``."""

    for name in ('runs', 'data32'):
        if not (out / name).exists():
            (out / name).symlink_to(storage / name)
    return assimilate_main(**args, device='cpu', path=out, init=init, noise=noise)


# -- hbm_probe -------------------------------------------------------------------------


def test_hbm_probe_reads_the_size_from_the_config(storage32):
    out = hbm_probe.probe('narrow32', samples=1, length=8, chunk=2, remat=True, steps=1, path=storage32,
                          device='cpu')
    assert out['status'] == 'executed' and out['finite'] is True and out['peak_memory_gb'] is None

    for scenario, length in (('loop', 8), ('coarse', 8)):
        program = hbm_probe.build('narrow32', 1, length, 2, True, 1, 0, scenario, 'data32', storage32, 'cpu')
        assert tuple(program(0).shape) == (1, 8, 2, 32, 32)

    jprobe = load_pack('hbm_probe')
    jprobe.PATH = storage32
    jprogram = jprobe.build('narrow32', 1, 8, 2, True, 1, 0, scenario='coarse', data='data32')
    assert jax.eval_shape(jprogram, jax.random.key(0)).shape == (1, 8, 2, 32, 32)

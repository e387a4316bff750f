r"""The port's training I/O and entry points against the JAX package, on
the CPU: ``state.msgpack`` read both ways and written byte for byte as flax
writes it, the run logger, configs, flax's initialisers, both experiments'
training entry points, and the port's imports. Tolerances are stated at
each comparison.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image
from test_torch_train import MODELS, event_shape, flat, init_both

from sda_tpu.train import RunLogger as JRunLogger
from sda_tpu.train import append_csv as jappend_csv
from sda_tpu.train import existing_csv_keys as jexisting_csv_keys
from sda_tpu.train import load_params as jload_params
from sda_tpu.train import save_params as jsave_params
from sda_tpu.utils import random_config as jrandom_config
from sda_tpu.utils import save_config as jsave_config
from sda_tpu_torch.nn import reset_parameters
from sda_tpu_torch.train import (
    RunLogger,
    append_csv,
    existing_csv_keys,
    load_params,
    params_from_flax,
    params_to_flax,
    save_params,
)
from sda_tpu_torch.train import checkpoint as ck
from sda_tpu_torch.utils import random_config, save_config
from sda_tpu_torch.viz import draw

REPO = Path(__file__).resolve().parents[1]


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


# -- Checkpoints both ways --------------------------------------------------

@pytest.mark.parametrize('name', ['lorenz_local', 'lorenz_global', 'kolmogorov'])
def test_save_params_is_read_both_ways(name, tmp_path):
    r"""The port writes the bytes flax writes; JAX reads them; the port
    reads what JAX writes (exact)."""

    port, jmod, params, _, _ = init_both(name, seed=4)
    save_params(port, tmp_path / 'port.msgpack')
    assert not (tmp_path / 'port.msgpack.tmp').exists()

    data = (tmp_path / 'port.msgpack').read_bytes()
    assert data == serialization.to_bytes(params_to_flax(port.state_dict()))

    template = jax.tree_util.tree_map(jnp.zeros_like, params)
    read = flat(jload_params(template, tmp_path / 'port.msgpack'))
    for k, v in flat(params).items():
        np.testing.assert_array_equal(read[k], v)

    jparams = jax.tree_util.tree_map(lambda a: a * 2 + 1, params)
    jsave_params(jparams, tmp_path / 'jax.msgpack')
    state = params_from_flax(load_params(tmp_path / 'jax.msgpack'))
    assert state.keys() == port.state_dict().keys()
    for k, v in flat(params_to_flax(state)).items():
        np.testing.assert_array_equal(v, flat(jparams)[k])


def test_writer_matches_msgpack_on_every_type():
    r"""The port's encoder gives msgpack's bytes (with flax's ext types) for
    every type it writes, and the reader inverts it."""

    tree = {
        'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128, -129, -2**31 - 1, -2**40],
        'floats': [0.5, -1.25e300],
        'flags': [True, False, None],
        'text': 'x' * 40,
        'long_text': 'y' * 300,
        'longer_text': 'z' * 70000,
        'raw': b'\x00\x01' * 200,
        'nested': {str(i): i for i in range(20)},
        'f32': np.arange(12, dtype=np.float32).reshape(3, 4),
        'i64': np.arange(3, dtype=np.int64),
        'u8': np.arange(200, dtype=np.uint8),
        'scalar': np.float32(2.5),
        'zero_d': np.array(3.0, np.float32),
        'tiny': np.zeros((0,), np.float32),
        'complex': 1.0 + 2.0j,
    }
    want = msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True)
    assert ck.packb(tree) == want
    assert ck.msgpack_restore(want).keys() == tree.keys()

    with pytest.raises(TypeError):
        ck.packb({'a': object()})
    with pytest.raises(ValueError):
        ck.packb(2**64)


# -- Logging and configs ----------------------------------------------------

def test_logging_and_configs_match_jax(tmp_path):
    r"""The same ``metrics.jsonl`` records (``time`` aside), CSV rows and
    keys, ``config.json`` bytes and random configs; wandb quietly off."""

    for name, logger_cls in (('jax', JRunLogger), ('port', RunLogger)):
        logger = logger_cls(tmp_path / name, use_wandb=True)
        assert logger.wandb_run is None
        logger.log({'loss_train': 0.5, 'lr': 1e-3}, step=1)
        logger.log({'log_p': 2.25})
        logger.finish()

    records = {}
    for name in ('jax', 'port'):
        lines = (tmp_path / name / 'metrics.jsonl').read_text().splitlines()
        records[name] = [json.loads(line) for line in lines]
        for r in records[name]:
            assert r.pop('time') >= 0
    assert records['port'] == records['jax']

    for name, append in (('jax', jappend_csv), ('port', append_csv)):
        append(tmp_path / f'{name}.csv', 'a,1,2.5\n')
        append(tmp_path / f'{name}.csv', 'b,2')
        append(tmp_path / f'{name}.csv', 'c')
    assert (tmp_path / 'port.csv').read_text() == (tmp_path / 'jax.csv').read_text()
    for columns in (1, 2, 3):
        assert existing_csv_keys(tmp_path / 'port.csv', columns) == jexisting_csv_keys(tmp_path / 'jax.csv', columns)
    assert existing_csv_keys(tmp_path / 'missing.csv', 2) == set()

    config = {'window': 5, 'hidden_channels': [96, 192], 'bf16': True, 'learning_rate': 2e-4}
    jsave_config(config, tmp_path / 'jax_run')
    save_config(config, tmp_path / 'port_run')
    assert (tmp_path / 'port_run/config.json').read_bytes() == (tmp_path / 'jax_run/config.json').read_bytes()
    with pytest.raises(FileExistsError):
        save_config(config, tmp_path / 'port_run')

    space = {'width': [64, 128, 256], 'depth': range(2, 7), 'activation': ['ReLU', 'SiLU', 'GELU']}
    for seed in (None, 0, 1, 7):
        if seed is not None:
            assert random_config(space, seed) == jrandom_config(space, seed)
        assert all(v in space[k] for k, v in random_config(space, seed).items())


# -- flax's initialisers ------------------------------------------------------

@pytest.mark.parametrize('name', ['lorenz_local', 'kolmogorov'])
def test_fresh_init_matches_flax_statistics(name):
    r"""Every kernel of a freshly initialised port model has flax's
    ``lecun_normal`` statistics and every bias is zero, as ``module.init``
    gives: the std of each kernel within 6 standard errors of
    ``1 / sqrt(fan_in)`` (std error of a std estimate: ``1 / sqrt(2 n)``),
    and no value beyond the truncation at 2 of the pre-truncation std."""

    port, jmod, data, _ = MODELS[name]()
    reset_parameters(port, torch.Generator().manual_seed(0))
    x = jnp.zeros((1,) + event_shape(data))
    jparams = jax.jit(jmod.init)(jax.random.key(0), x, jnp.ones((1,)))['params']

    got, want = flat(params_to_flax(port.state_dict())), flat(jparams)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith('bias'):
            assert not got[k].any() and not want[k].any(), k
            continue
        fan_in = np.prod(want[k].shape[:-1])
        target = 1 / np.sqrt(fan_in)
        tol = 6 / np.sqrt(2 * want[k].size)
        for side in (got[k], want[k]):
            assert abs(side.std() / target - 1) < tol, (k, side.std(), target)
            assert np.abs(side).max() <= 2 * target / 0.87962566 * (1 + 1e-6), k

    # The same generator seed redraws the same weights.
    again = reset_parameters(MODELS[name]()[0], torch.Generator().manual_seed(0))
    for a, b in zip(again.parameters(), port.parameters()):
        assert torch.equal(a, b)


# -- The experiments' training entry points ------------------------------------

def load_pack_utils(experiment):
    r"""The JAX pack's ``experiments/<experiment>/utils.py`` under a name of
    its own (every pack calls its helper module ``utils``)."""

    path = REPO / 'experiments' / experiment / 'utils.py'
    spec = importlib.util.spec_from_file_location(f'{experiment}_pack_utils_for_torch', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kolmogorov_train_entry_point(tmp_path, monkeypatch):
    r"""``train``, narrowed, on 8^2 fields for two epochs with bf16 compute:
    the run directory holds the JAX pack's files, and JAX reads its
    weights."""

    from sda_tpu_torch.experiments.kolmogorov.train import CONFIG, train

    monkeypatch.setitem(CONFIG, 'embedding', 8)
    monkeypatch.setitem(CONFIG, 'hidden_channels', (4, 8, 16))
    monkeypatch.setitem(CONFIG, 'hidden_blocks', (1, 1, 1))

    rng = np.random.RandomState(0)
    data = rng.randn(3, 6, 2, 8, 8).astype(np.float32)
    w = train(0, epochs=2, bf16=True, size=8, device='cpu', path=tmp_path, trainset=data[:2], validset=data[2:])
    assert w.shape == (2, 5, 8, 8) and torch.isfinite(w).all()

    run = tmp_path / 'runs/unet8_0'  # runs beyond 64^2 are named by their size
    with Image.open(run / 'samples.png') as png:
        np.testing.assert_array_equal(np.asarray(png), np.asarray(draw(w.numpy())))
    config = json.loads((run / 'config.json').read_text())
    assert config == {**json.loads(json.dumps(CONFIG)), 'epochs': 2, 'bf16': True, 'size': 8}
    records = [json.loads(line) for line in (run / 'metrics.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records] == [1, 2] and all(np.isfinite(r['loss_train']) for r in records)

    module = load_pack_utils('kolmogorov').make_score(**config)
    template = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 10, 8, 8)), jnp.ones((1,)))['params']
    params = flat(jload_params(template, run / 'state.msgpack'))
    assert params.keys() == flat(load_params(run / 'state.msgpack')).keys()
    assert all(np.isfinite(v).all() for v in params.values())


def test_lorenz_train_entry_point(tmp_path, monkeypatch):
    r"""``train`` of both models, narrow, for two epochs each on a small
    simulated set, then its final ``log_p`` over 4096 windows or 1024
    trajectories: the run directory holds the JAX pack's files."""

    from sda_tpu_torch.experiments.lorenz import train as lt
    from sda_tpu_torch.experiments.lorenz.generate import simulate

    monkeypatch.setitem(lt.LOCAL_CONFIG, 'width', 16)
    monkeypatch.setitem(lt.LOCAL_CONFIG, 'depth', 1)
    monkeypatch.setitem(lt.GLOBAL_CONFIG, 'hidden_channels', (4,))
    monkeypatch.setitem(lt.GLOBAL_CONFIG, 'hidden_blocks', (1,))

    splits = simulate(chains=10, length=40, burnin=8, seed=0, device='cpu')
    for model, window, run in (('local', 3, 'local_k1_0'), ('global', None, 'global_0')):
        log_p = lt.train(model, 0, epochs=2, window=window, device='cpu', path=tmp_path,
                         trainset=splits['train'], validset=splits['valid'])
        assert isinstance(log_p, float)
        records = (tmp_path / 'runs' / run / 'metrics.jsonl').read_text().splitlines()
        assert len(records) == 3 and 'log_p' in json.loads(records[-1])
        assert (tmp_path / 'runs' / run / 'state.msgpack').exists()


def test_port_imports_no_jax():
    r"""The port imports no JAX, flax, optax, msgpack, h5py or ``sda_tpu``
    at any depth, its experiment modules included, and no PIL, seaborn or
    matplotlib (the card's machine has none of them)."""

    modules = [
        'sda_tpu_torch.' + m for m in (
            'utils', 'prng', 'nn', 'diffusion', 'dynamics', 'dynamics.quasigeostrophic', 'ops', 'ops.spectral',
            'train', 'eval',
            'experiments.kolmogorov.utils', 'experiments.kolmogorov.generate',
            'experiments.kolmogorov.assimilate', 'experiments.kolmogorov.train', 'experiments.kolmogorov.eval',
            'experiments.kolmogorov.validate_solver',
            'experiments.lorenz.utils', 'experiments.lorenz.generate', 'experiments.lorenz.train',
            'experiments.lorenz.eval', 'experiments.lorenz.multimodal',
            'experiments.qg.utils', 'experiments.qg.generate', 'experiments.qg.train',
            'experiments.qg.assimilate', 'experiments.qg.eval',
            'viz', 'entry', 'nn.flops', 'experiments.kolmogorov.figures', 'experiments.kolmogorov.sweep_methods',
            'experiments.kolmogorov.sweep_guidance', 'experiments.kolmogorov.sweep_solver',
            'experiments.kolmogorov.hbm_probe', 'experiments.lorenz.figures', 'experiments.lorenz.sweep_solver',
        )
    ]
    code = (
        'import importlib, json, sys\n'
        f'for m in {modules!r}: importlib.import_module(m)\n'
        'print(json.dumps(sorted(sys.modules)))\n'
    )
    done = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, check=True)
    loaded = json.loads(done.stdout)
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'h5py', 'sda_tpu', 'PIL', 'seaborn', 'matplotlib')
    assert not [m for m in loaded if m.split('.')[0] in banned]

r"""The port's msgpack reader and flax-to-torch weight mapping against flax."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sda_tpu_torch.train import checkpoint as ck

REPO = Path(__file__).resolve().parents[1]


def assert_trees_equal(got, want, path=''):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            assert_trees_equal(got[key], want[key], f'{path}/{key}')
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, np.asarray(want, np.float32 if want.dtype == jnp.bfloat16 else want.dtype), err_msg=path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


@pytest.mark.parametrize('run', [
    'experiments/kolmogorov/storage/runs/unet_0',
    'experiments/lorenz/storage/runs/local_k2_0',
])
def test_reader_matches_flax_on_committed_runs(run):
    data = (REPO / run / 'state.msgpack').read_bytes()

    assert_trees_equal(ck.msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_matches_flax_on_every_type():
    tree = {
        'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -2**31 - 1],
        'floats': [0.5, -1.25e300],
        'flags': [True, False, None],
        'text': 'x' * 40,
        'long_text': 'y' * 300,
        'raw': b'\x00\x01' * 200,
        'nested': {str(i): i for i in range(20)},
        'f32': np.arange(12, dtype=np.float32).reshape(3, 4),
        'i64': np.arange(3, dtype=np.int64),
        'bf16': np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)),
        'scalar': np.float32(2.5),
        'tiny': np.zeros((0,), np.float32),
        'complex': 1.0 + 2.0j,
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)

    assert_trees_equal(ck.msgpack_restore(data), want)


def test_reader_rejects_malformed_input():
    data = serialization.msgpack_serialize({'a': np.ones(4, np.float32)})

    with pytest.raises(ValueError):
        ck.msgpack_restore(data[:-3])
    with pytest.raises(ValueError):
        ck.msgpack_restore(data + b'\x00')
    with pytest.raises(ValueError):
        ck.unpackb(b'\xc1')
    with pytest.raises(ValueError):
        ck.unpackb(b'\xd4\x07\x00')  # fixext 1 of a type flax never writes


def test_params_from_flax_transposes_kernels():
    rng = np.random.RandomState(0)
    dense = rng.randn(5, 7).astype(np.float32)  # (in, out)
    conv = rng.randn(3, 3, 4, 6).astype(np.float32)  # HWIO
    tree = {
        'UNet_0': {
            'Conv_1': {'kernel': conv, 'bias': np.zeros(6, np.float32)},
            'ModResidualBlock_12': {'Dense_0': {'kernel': dense, 'bias': np.ones(7, np.float32)}},
        },
    }

    sd = ck.params_from_flax(tree)

    assert sorted(sd) == [
        'unet.blocks.12.denses.0.bias', 'unet.blocks.12.denses.0.weight',
        'unet.convs.1.bias', 'unet.convs.1.weight',
    ]
    np.testing.assert_array_equal(sd['unet.blocks.12.denses.0.weight'].numpy(), dense.T)
    np.testing.assert_array_equal(sd['unet.convs.1.weight'].numpy(), conv.transpose(3, 2, 0, 1))
    assert all(v.dtype == torch.float32 for v in sd.values())

    with pytest.raises(KeyError):
        ck.params_from_flax({'Attention_0': {'bias': np.zeros(1, np.float32)}})

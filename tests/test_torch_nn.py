r"""Parity of the port's layers, U-Net, score networks and windowed
composition with the JAX package, in float32 on the CPU.

Random weights at the shapes flax ``init`` gives (and the committed
``unet_0``) cross through ``params_from_flax``; weights and inputs are drawn
with numpy from a seed. Unless a test says otherwise, the
tolerance is ``atol=1e-5``: both sides run float32 with products at full
precision, so they differ only by summation order.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
from sda_tpu.diffusion import MCScoreNet as JMCScoreNet
from sda_tpu.diffusion import ScoreUNet as JScoreUNet
from sda_tpu.diffusion.windowed import chunked_eval as jchunked_eval
from sda_tpu.diffusion.windowed import fold as jfold
from sda_tpu.diffusion.windowed import unfold as junfold
from sda_tpu.nn import ResMLP as JResMLP
from sda_tpu.nn import TimeEmbedding as JTimeEmbedding
from sda_tpu.nn import UNet as JUNet
from sda_tpu.nn import layer_norm as jlayer_norm
from sda_tpu_torch.diffusion import MCScoreNet, ScoreUNet, bind_eps, chunked_eval, fold, unfold
from sda_tpu_torch.experiments.kolmogorov.utils import load_score
from sda_tpu_torch.nn import ResMLP, TimeEmbedding, UNet, layer_norm
from sda_tpu_torch.train import params_from_flax
from sda_tpu_torch.utils import resolve_device

REPO = Path(__file__).resolve().parents[1]
UNET_0 = 'experiments/kolmogorov/storage/runs/unet_0'


def randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_params(module, *args, seed=0):
    r"""Random flax parameters for ``module`` at the shapes ``init`` gives,
    without compiling ``init``: weights ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2)."""

    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)['params']
    rng = np.random.RandomState(seed)

    def fill(s):
        if len(s.shape) == 1:
            return jnp.asarray(0.1 * rng.randn(*s.shape), jnp.float32)
        return jnp.asarray(rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1])), jnp.float32)

    return jax.tree_util.tree_map(fill, shapes)


def port(module, params):
    r"""Loads flax ``params`` into a port module."""

    return bind_eps(module, params_from_flax(jax.tree_util.tree_map(np.asarray, params)))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_layer_norm(dtype):
    x = randn(0, 4, 6, 5, 3) * 3 + 1
    x_j = jnp.asarray(x).astype(dtype)
    x_t = t(x).to(getattr(torch, dtype))

    for axis in (-1, 1):
        want = np.asarray(jlayer_norm(x_j, axis=axis).astype(jnp.float32))
        got = layer_norm(x_t, dim=axis).float().numpy()
        # bfloat16 outputs may round to neighbouring values (2^-8 relative).
        atol = 1e-5 if dtype == 'float32' else 2e-2
        np.testing.assert_allclose(got, want, atol=atol)


def test_time_embedding():
    tt = np.linspace(0, 1, 7).astype(np.float32)
    module = JTimeEmbedding(features=24)
    params = jax_params(module, jnp.asarray(tt))

    want = np.asarray(jax.jit(module.apply)({'params': params}, jnp.asarray(tt)))
    with torch.no_grad():
        got = port(TimeEmbedding(24), params)(t(tt)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)


def test_res_mlp():
    x = randn(1, 5, 12)
    module = JResMLP(out_features=7, hidden_features=(16, 16, 8), activation=jax.nn.silu)
    params = jax_params(module, jnp.asarray(x), seed=1)

    want = np.asarray(jax.jit(module.apply)({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(ResMLP(12, 7, (16, 16, 8), F.silu), params)(t(x)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize('spatial, size, circular', [
    (2, 16, True),
    (2, 16, False),  # non-circular multi-depth: flax SAME pads stride-2 convs (0, 1)
    (1, 32, False),
    (3, 8, True),
])
def test_unet(spatial, size, circular):
    x = randn(2, 2, *(size,) * spatial, 3)  # channels-last for flax
    y = randn(3, 2, 5)
    module = JUNet(
        out_channels=4, hidden_channels=(6, 8, 10), hidden_blocks=(1, 2, 1),
        activation=jax.nn.silu, spatial=spatial, circular=circular,
    )
    params = jax_params(module, jnp.asarray(x), jnp.asarray(y), seed=2)

    want = np.asarray(jax.jit(module.apply)({'params': params}, jnp.asarray(x), jnp.asarray(y)))
    torch_unet = UNet(
        3, 4, 5, hidden_channels=(6, 8, 10), hidden_blocks=(1, 2, 1),
        activation=F.silu, spatial=spatial, circular=circular,
    )
    with torch.no_grad():
        got = port(torch_unet, params)(t(np.moveaxis(x, -1, 1)), t(y)).numpy()

    np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), atol=1e-5)


def test_score_unet_with_context_and_batch_axes():
    x = randn(4, 2, 3, 2, 8, 8)
    c = randn(5, 1, 8, 8)
    tt = np.float32(0.3)
    module = JScoreUNet(channels=2, embedding=8, hidden_channels=(4, 6), hidden_blocks=(1, 1))
    params = jax_params(module, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(c), seed=3)

    want = np.asarray(jax.jit(module.apply)({'params': params}, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(c)))
    score = port(ScoreUNet(2, context=1, embedding=8, hidden_channels=(4, 6), hidden_blocks=(1, 1)), params)
    with torch.no_grad():
        got = score(t(x), torch.tensor(tt), t(c)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)


def test_unet_0_matches_jax_and_golden():
    r"""The committed ``unet_0`` at full width, float32, on the golden probe."""

    from sda_tpu.train import load_params as jload_params

    config = json.loads((REPO / UNET_0 / 'config.json').read_text())
    module = JLocalScoreUNet(
        channels=10, size=64, embedding=64, hidden_channels=tuple(config['hidden_channels']),
        hidden_blocks=tuple(config['hidden_blocks']), activation=jax.nn.silu,
    )
    x = jax.random.normal(jax.random.key(0), (1, 10, 64, 64), dtype=jnp.float32)
    tt = 0.5 * jnp.ones((1,), dtype=jnp.float32)
    template = jax.eval_shape(module.init, jax.random.key(0), x, tt)['params']
    params = jload_params(template, REPO / UNET_0 / 'state.msgpack')
    want = np.asarray(jax.jit(module.apply)({'params': params}, x, tt))

    score, _ = load_score(REPO / UNET_0, device='cpu', bf16=False)
    with torch.no_grad():
        got = score(t(x), t(tt)).numpy().astype(np.float64)

    # float32 against float32 through 26 convolutions of up to 384 channels.
    np.testing.assert_allclose(got, want, atol=1e-4)

    # The golden values were computed with bf16 compute (bf16: true), whose
    # rounding unit at |eps| ~ 1 is 2^-8: head and std at the golden test's
    # bf16 tolerance; the mean (~2e-3, so relative error means nothing) to
    # within half that unit.
    golden = json.loads((REPO / 'tests/golden/committed_artifacts.json').read_text())[UNET_0]
    np.testing.assert_allclose(got.std(), golden['std'], rtol=2e-2)
    np.testing.assert_allclose(got.ravel()[:4], golden['head'], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.mean(), golden['mean'], atol=2e-3)


def test_unet_0_bf16_matches_jax_bf16():
    r"""The committed ``unet_0`` with its config's bf16 compute, through the
    port's ``load_score``, against the JAX package's bf16 on the golden
    probe (``x ~ N(0, 1)`` from key 0, ``(1, 10, 64, 64)``, ``t = 0.5``).

    Each side rounds to bf16 (2^-8 relative) after every one of 26
    convolutions, in its own order: the JAX package's bf16 alone is rms
    0.0071 from its float32, and the port was rms 0.0080, max 0.031 from
    JAX bf16 when the bound was set. The bound is about twice that: rms
    0.015, max 0.08.
    """

    from sda_tpu.train import load_params as jload_params

    config = json.loads((REPO / UNET_0 / 'config.json').read_text())
    assert config['bf16'] is True
    module = JLocalScoreUNet(
        channels=10, size=64, embedding=64, hidden_channels=tuple(config['hidden_channels']),
        hidden_blocks=tuple(config['hidden_blocks']), activation=jax.nn.silu, dtype=jnp.bfloat16,
    )
    x = jax.random.normal(jax.random.key(0), (1, 10, 64, 64), dtype=jnp.float32)
    tt = 0.5 * jnp.ones((1,), dtype=jnp.float32)
    template = jax.eval_shape(module.init, jax.random.key(0), x, tt)['params']
    params = jload_params(template, REPO / UNET_0 / 'state.msgpack')
    want = np.asarray(jax.jit(module.apply)({'params': params}, x, tt))

    score, loaded = load_score(REPO / UNET_0, device='cpu')
    assert loaded['bf16'] is True and score.score.unet.convs[0].compute_dtype == torch.bfloat16
    with torch.no_grad():
        got = score(t(x), t(tt)).numpy()

    diff = got.astype(np.float64) - want
    assert np.sqrt(np.mean(diff**2)) <= 0.015, np.sqrt(np.mean(diff**2))
    assert np.abs(diff).max() <= 0.08, np.abs(diff).max()


@pytest.mark.parametrize('order', [1, 2])
def test_unfold_fold(order):
    x = randn(6, 2, 9, 3, 4, 4)

    np.testing.assert_array_equal(unfold(t(x), order).numpy(), np.asarray(junfold(jnp.asarray(x), order)))

    u = randn(7, 2, 9 - 2 * order, (2 * order + 1) * 3, 4, 4)
    np.testing.assert_array_equal(fold(t(u), order).numpy(), np.asarray(jfold(jnp.asarray(u), order)))


def test_mc_score_net_chunked():
    r"""Windowed composition, whole and in chunks (7 windows in chunks of 3
    pad with copies of the last window)."""

    x = randn(8, 2, 11, 2, 8, 8)
    kernel = JScoreUNet(channels=10, embedding=8, hidden_channels=(4, 6), hidden_blocks=(1, 1), circular=True)
    windows = junfold(jnp.asarray(x), 2)
    params = jax_params(kernel, windows, jnp.float32(0.5), seed=4)
    apply = jax.jit(kernel.apply)

    def jeps(xw, tt, c):
        return apply({'params': params}, xw, tt, c)

    want = np.asarray(JMCScoreNet(jeps, order=2)(jnp.asarray(x), jnp.float32(0.5)))
    want_chunked = np.asarray(jchunked_eval(jeps, windows, jnp.float32(0.5), None, 3))

    teps = port(ScoreUNet(10, embedding=8, hidden_channels=(4, 6), hidden_blocks=(1, 1), circular=True), params)
    with torch.no_grad():
        got = MCScoreNet(teps, order=2)(t(x), torch.tensor(0.5)).numpy()
        got_chunked = chunked_eval(teps, unfold(t(x), 2), torch.tensor(0.5), None, 3).numpy()
        got_mc_chunked = MCScoreNet(teps, order=2, chunk=3)(t(x), torch.tensor(0.5)).numpy()

    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_chunked, want_chunked, atol=1e-5)
    np.testing.assert_allclose(got_mc_chunked, want, atol=1e-5)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)

    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        load_score(REPO / UNET_0)
    assert resolve_device('cpu') == torch.device('cpu')

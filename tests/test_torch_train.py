r"""The port's training path against the JAX package, float32 (and bf16
where stated) on the CPU: the denoising loss, the dataset's crops and
batches, the LR schedules, the trainer step by step and resume
(``tests/test_torch_train_io.py`` holds checkpoints, logging and the entry
points).

Torch cannot reproduce JAX's PRNG streams, so the tests replay the JAX
trainer's draws (its key splits, permutations, crops, ``t`` and noise) and
feed them to the port through its ``draws`` hook and its ``t``/``z``
arguments. Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sda_tpu.diffusion import VPSDE as JVPSDE
from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
from sda_tpu.diffusion import MCScoreWrapper as JMCScoreWrapper
from sda_tpu.diffusion import ScoreNet as JScoreNet
from sda_tpu.diffusion import ScoreUNet as JScoreUNet
from sda_tpu.train import SCHEDULES as JSCHEDULES
from sda_tpu.train import TrajectoryDataset as JTrajectoryDataset
from sda_tpu.train import Trainer as JTrainer
from sda_tpu_torch.diffusion import VPSDE, LocalScoreUNet, MCScoreWrapper, ScoreNet, ScoreUNet
from sda_tpu_torch.nn import reset_parameters
from sda_tpu_torch.train import (
    SCHEDULES,
    TrajectoryDataset,
    Trainer,
    params_from_flax,
    params_to_flax,
    restore_checkpoint,
    save_checkpoint,
)


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


def flat(tree, prefix=''):
    r"""``{'a/b/kernel': array}`` of a parameter tree."""

    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f'{prefix}{key}/'))
        else:
            out[prefix + key] = np.asarray(value, np.float32)
    return out


# -- Models at the tests' sizes -------------------------------------------
# (port module, flax module, event shape of one training item, eps_wrapper)

def lorenz_local(bf16=False):
    r"""The Lorenz local kernel, narrow: window 5, width 32, depth 2."""

    dtype = (torch.bfloat16, jnp.bfloat16) if bf16 else (None, None)
    port = ScoreNet(15, embedding=8, hidden_features=(32, 32), activation=torch.nn.functional.silu, dtype=dtype[0])
    jmod = JScoreNet(features=15, embedding=8, hidden_features=(32, 32), activation=jax.nn.silu, dtype=dtype[1])
    return port, jmod, dict(window=5, flatten=True, item=(16, 3)), None


def lorenz_global():
    r"""The Lorenz global 1-D U-Net, narrow, through ``MCScoreWrapper``."""

    port = ScoreUNet(3, embedding=8, hidden_channels=(8,), hidden_blocks=(1,),
                     activation=torch.nn.functional.silu, spatial=1)
    jmod = JScoreUNet(channels=3, embedding=8, hidden_channels=(8,), hidden_blocks=(1,),
                      activation=jax.nn.silu, spatial=1)
    return port, jmod, dict(window=8, flatten=False, item=(12, 3)), (MCScoreWrapper, JMCScoreWrapper)


def kolmogorov(bf16=False):
    r"""A tiny forcing-conditioned window U-Net: window 3 at 8^2."""

    dtype = (torch.bfloat16, jnp.bfloat16) if bf16 else (None, None)
    port = LocalScoreUNet(6, size=8, embedding=8, hidden_channels=(4, 8), hidden_blocks=(1, 1),
                          activation=torch.nn.functional.silu, dtype=dtype[0])
    jmod = JLocalScoreUNet(channels=6, size=8, embedding=8, hidden_channels=(4, 8), hidden_blocks=(1, 1),
                           activation=jax.nn.silu, dtype=dtype[1])
    return port, jmod, dict(window=3, flatten=True, item=(5, 2, 8, 8)), None


MODELS = {
    'lorenz_local': lorenz_local,
    'lorenz_local_bf16': lambda: lorenz_local(bf16=True),
    'lorenz_global': lorenz_global,
    'kolmogorov': kolmogorov,
    'kolmogorov_bf16': lambda: kolmogorov(bf16=True),
}


def init_both(name, seed=0):
    r"""A model initialised by the port, and the same weights as a flax tree."""

    port, jmod, data, wrappers = MODELS[name]()
    reset_parameters(port, torch.Generator().manual_seed(seed))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(port.state_dict()))
    return port, jmod, params, data, wrappers


def event_shape(data):
    window, flatten, item = data['window'], data['flatten'], data['item']
    shape = (window,) + item[1:]
    if flatten:
        shape = (window * item[1],) + item[2:]
    return shape


# -- perturb and loss -----------------------------------------------------

@pytest.mark.parametrize('weighted', [False, True])
def test_perturb_and_loss_with_injected_draws(weighted):
    r"""JAX's own draws (``key_t``, ``key_eps``) through the port's ``t``/``z``
    arguments; float32, atol 1e-6 (the same elementwise operations)."""

    x = randn(0, 6, 4, 3)
    w = np.abs(randn(1, 6, 4, 3)) if weighted else None
    key = jax.random.key(7)
    jsde, sde = JVPSDE(shape=(4, 3)), VPSDE(shape=(4, 3))

    tt = np.linspace(0.05, 0.95, 6).astype(np.float32)
    xt_j, eps_j = jsde.perturb(key, jnp.asarray(x), jnp.asarray(tt), train=True)
    xt, z = sde.perturb(t(x), t(tt), train=True, z=t(eps_j))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xt_j), atol=1e-6)
    assert torch.equal(z, t(eps_j))

    def jeps(x, t, c=None):
        return jnp.tanh(x) * t[:, None, None]

    def teps(x, t, c=None):
        return torch.tanh(x) * t[:, None, None]

    want = jsde.loss(key, jnp.asarray(x), w=None if w is None else jnp.asarray(w), eps=jeps)
    key_t, key_eps = jax.random.split(key)
    t_j = jax.random.uniform(key_t, (6,))
    z_j = jax.random.normal(key_eps, x.shape)
    got = sde.loss(t(x), w=None if w is None else t(w), eps=teps, t=t(t_j), z=t(z_j))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)

    # The port's own draws: t in [0, 1) per batch element, then the noise.
    g = torch.Generator().manual_seed(0)
    loss = sde.loss(t(x), eps=teps, generator=g)
    g.manual_seed(0)
    t_p = torch.rand(6, generator=g)
    z_p = torch.randn(6, 4, 3, generator=g)
    assert loss.item() == sde.loss(t(x), eps=teps, t=t_p, z=z_p).item()


# -- TrajectoryDataset ----------------------------------------------------

@pytest.mark.parametrize('flatten', [False, True])
def test_dataset_crops_and_batches(flatten):
    r"""Crops, flattening and epoch batches against JAX with JAX's draws
    (exact: indexing only)."""

    data = randn(2, 7, 9, 2, 3)
    jset = JTrajectoryDataset(data, window=4, flatten=flatten)
    tset = TrajectoryDataset(data, window=4, flatten=flatten, device='cpu')
    assert len(tset) == 7 and tset.length == 9

    key = jax.random.key(3)
    x = jnp.asarray(data[:5])
    starts = jax.random.randint(key, (5,), 0, 9 - 4 + 1)
    want = np.asarray(jset.crop(key, x))
    got = tset.crop(t(data[:5]), starts=t(starts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((5, 8, 3) if flatten else (5, 4, 2, 3))

    # The port's own crops: each a contiguous window in range.
    g = torch.Generator().manual_seed(1)
    crops = tset.crop(t(data), generator=g).reshape(7, 4, 2, 3).numpy()
    for item, crop in zip(data, crops):
        assert any(np.array_equal(item[s:s + 4], crop) for s in range(6))

    for batch in (3, 7, 20):  # remainder dropped; a batch larger than the data shrinks
        idx_j, nb_j = jset.epoch_batches(key, batch)
        perm = jax.random.permutation(key, 7)
        idx, nb = tset.epoch_batches(batch, perm=t(perm))
        assert nb == nb_j == 7 // min(batch, 7)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        idx, _ = tset.epoch_batches(batch, generator=g)
        assert len(set(idx.flatten().tolist())) == idx.numel()

    assert TrajectoryDataset(data, device='cpu').crop(t(data)).shape == data.shape


# -- Schedules ------------------------------------------------------------

@pytest.mark.parametrize('name', sorted(JSCHEDULES))
def test_schedules_and_learning_rates(name):
    r"""Each schedule at every epoch of a short run, and the trainer's LR at
    every step (rtol 1e-6: JAX evaluates in float32)."""

    epochs = 5
    for e in range(epochs + 1):
        np.testing.assert_allclose(SCHEDULES[name](e, epochs), float(JSCHEDULES[name](e, epochs)), rtol=1e-6)

    port, jmod, params, data, _ = init_both('lorenz_local')
    trainset = randn(4, 7, 16, 3)
    jtrainer = JTrainer(JVPSDE(shape=(15,)), jmod, params, JTrajectoryDataset(trainset, 5, True),
                        JTrajectoryDataset(trainset, 5, True), epochs=epochs, batch_size=2, scheduler=name)
    trainer = Trainer(VPSDE(shape=(15,)), port, TrajectoryDataset(trainset, 5, True, 'cpu'),
                      TrajectoryDataset(trainset, 5, True, 'cpu'), epochs=epochs, batch_size=2, scheduler=name)
    assert trainer.steps_per_epoch == 3
    for step in range(epochs * 3):
        np.testing.assert_allclose(trainer.lr(step), float(jtrainer._lr_schedule(step)), rtol=1e-6)


# -- The trainer step by step ----------------------------------------------

def jax_draws(key, sizes, batch, event, crop_len, window, epochs):
    r"""The draws of ``epochs`` epochs of ``sda_tpu.train.Trainer`` started
    with ``key``, for the port's ``draws`` hook: the epoch key splits, the
    permutations, the crops' starts and the loss's ``t`` and noise."""

    @jax.jit
    def epoch(sub):
        k_perm, k_train, k_vperm, k_valid = jax.random.split(sub, 4)
        out = {}
        for split, n, k_p, k_s in (('train', sizes[0], k_perm, k_train), ('valid', sizes[1], k_vperm, k_valid)):
            b = min(batch, n)

            def one(k):
                k_crop, k_loss = jax.random.split(k)
                key_t, key_eps = jax.random.split(k_loss)
                return (jax.random.randint(k_crop, (b,), 0, crop_len - window + 1),
                        jax.random.uniform(key_t, (b,)), jax.random.normal(key_eps, (b,) + event))

            starts, t_, z = jax.vmap(one)(jax.random.split(k_s, n // b))
            out[split] = {'perm': jax.random.permutation(k_p, n), 'starts': starts, 't': t_, 'z': z}
        return out

    draws = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        draws.append(jax.tree_util.tree_map(t, epoch(sub)))
    return draws


# name -> (trainset size, batch size, whether a bf16 variant is run too).
TRAINER_CASES = {
    'lorenz_local': (2, 2, True),  # one step per epoch: compared after every step
    'lorenz_global': (6, 2, False),  # three steps per epoch
    'kolmogorov': (2, 2, True),
}


@pytest.mark.parametrize('name', sorted(TRAINER_CASES))
def test_trainer_matches_jax_step_by_step(name):
    r"""3 epochs of the port's ``Trainer`` against ``sda_tpu``'s, fed the
    same initial weights and the same draws, compared after every epoch, in
    float32 and, where the model has one, with bf16 compute.

    float32: parameters within 1e-2 lr and losses within 1e-4 relative. The
    packages differ only in summation order, and Adam's first steps move
    every parameter by about lr whatever the size of its gradient, so an
    update can differ only where a gradient is at float32 noise level.

    bf16 compute: gradients carry bf16 rounding (2^-8 relative), so Adam's
    normalised updates of small gradients differ by up to lr. The bound is
    set by the JAX package's own bf16 rounding, measured here against its
    float32 run: the rms difference of the updates (parameters minus initial
    ones) from JAX bf16 is at most 2x, and from JAX float32 at most 1.5x,
    JAX bf16's rms difference from JAX float32. Losses within 2e-2 relative.
    """

    n_train, batch, with_bf16 = TRAINER_CASES[name]
    _, _, params, data, wrappers = init_both(name)
    event = event_shape(data)
    rng = np.random.RandomState(5)
    train = rng.randn(n_train, *data['item']).astype(np.float32)
    valid = rng.randn(2, *data['item']).astype(np.float32)
    config = dict(epochs=4, batch_size=batch, learning_rate=1e-3, weight_decay=1e-3, scheduler='linear')
    lr = config['learning_rate']
    key = jax.random.key(11)
    draws = jax_draws(key, (n_train, 2), batch, event, data['item'][0], data['window'], 3)

    def trainers(variant):
        port, jmod, _, _ = MODELS[variant]()
        port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
        jtrainer = JTrainer(
            JVPSDE(shape=event), jmod, params,
            JTrajectoryDataset(train, data['window'], data['flatten']),
            JTrajectoryDataset(valid, data['window'], data['flatten']),
            key=key, eps_wrapper=None if wrappers is None else wrappers[1], **config,
        )
        trainer = Trainer(
            VPSDE(shape=event), port,
            TrajectoryDataset(train, data['window'], data['flatten'], 'cpu'),
            TrajectoryDataset(valid, data['window'], data['flatten'], 'cpu'),
            eps_wrapper=None if wrappers is None else wrappers[0], draws=lambda e: draws[e], **config,
        )
        return jtrainer, trainer

    variants = {'f32': trainers(name)}
    if with_bf16:
        variants['bf16'] = trainers(f'{name}_bf16')

    before = flat(params)

    def update(tree):
        return np.concatenate([(tree[k] - before[k]).ravel() for k in sorted(before)])

    def rms(a, b):
        return np.sqrt(np.mean((a - b) ** 2))

    for epoch in range(3):
        got, want = {}, {}
        for variant, (jtrainer, trainer) in variants.items():
            want_stats, got_stats = jtrainer.step_epoch(), trainer.step_epoch()
            assert got_stats['lr'] == pytest.approx(want_stats['lr'], rel=1e-6)
            for loss in ('loss_train', 'loss_valid'):
                np.testing.assert_allclose(got_stats[loss], want_stats[loss], rtol=2e-2 if variant == 'bf16' else 1e-4)
            want[variant], got[variant] = flat(jtrainer.params), flat(params_to_flax(trainer.module.state_dict()))
            assert got[variant].keys() == want[variant].keys() == before.keys()

        for k in before:
            np.testing.assert_allclose(got['f32'][k], want['f32'][k], atol=1e-2 * lr, err_msg=f'epoch {epoch}: {k}')
        if with_bf16:
            step_j, step_t, step_32 = update(want['bf16']), update(got['bf16']), update(want['f32'])
            rounding = rms(step_j, step_32)
            assert rms(step_t, step_j) <= 2 * rounding, (epoch, rms(step_t, step_j), rounding)
            assert rms(step_t, step_32) <= 1.5 * rounding, (epoch, rms(step_t, step_32), rounding)

    assert variants['f32'][1].step == 3 * max(n_train // batch, 1)


def test_resume_is_bitwise(tmp_path):
    r"""Two epochs in one go, or one epoch, a checkpoint, a new trainer
    restored from it and one more epoch: the same parameters, optimizer
    state and generator, bit for bit."""

    data = randn(6, 6, 16, 3)

    def make(seed):
        module = reset_parameters(lorenz_local()[0], torch.Generator().manual_seed(seed))
        return Trainer(VPSDE(shape=(15,)), module, TrajectoryDataset(data, 5, True, 'cpu'),
                       TrajectoryDataset(data[:2], 5, True, 'cpu'), epochs=8, batch_size=2,
                       generator=torch.Generator().manual_seed(3))

    straight = make(0)
    stats = [straight.step_epoch() for _ in range(2)]

    first = make(0)
    first.step_epoch()
    save_checkpoint(first, tmp_path / 'checkpoint.msgpack')
    second = make(1)  # other weights, restored over
    restore_checkpoint(second, tmp_path / 'checkpoint.msgpack')
    assert (second.epoch, second.step) == (1, 3)
    assert second.step_epoch() == stats[1]

    for a, b in zip(straight.module.parameters(), second.module.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(straight.optimizer.state.values(), second.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ('step', 'exp_avg', 'exp_avg_sq'))
    assert torch.equal(straight.generator.get_state(), second.generator.get_state())



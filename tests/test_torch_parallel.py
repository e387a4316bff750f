r"""The port's scale-out against ``sda_tpu.parallel``, on the CPU.

Mirrors ``tests/test_parallel.py``. The port's ranks are processes spawned
with ``torch.multiprocessing`` that talk over gloo; the JAX reference runs in
the pytest process on the 8 virtual devices of ``tests/conftest.py``, whose
meshes take the first 2 or 4 of them. Inputs come from numpy seeds, weights
from the port's draw of flax's initialisers carried across with
``params_to_flax``, and the sampler's noise and the trainer's draws are
JAX's, replayed through the port's hooks.

Each world size is spawned once, both at once (``ranks`` below): every rank
runs all the checks of :func:`checks` and writes its results, and the tests
compare them.
The pytest process never brings up a process group. This module imports JAX
only inside the fixture ``J``, so that the spawned ranks, which import it to
find :func:`checks`, stay light.
"""

import datetime
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sda_tpu_torch.diffusion import VPSDE, GaussianScore, LocalScoreUNet, ScoreNet
from sda_tpu_torch.experiments.kolmogorov import utils as kolmogorov_utils
from sda_tpu_torch.experiments.qg import utils as qg_utils
from sda_tpu_torch.parallel import (
    ShardedMCScoreNet,
    batch_constraint,
    host_sharded_array,
    init_multihost,
    make_mesh,
    replicate,
    shard_batch,
)
from sda_tpu_torch.parallel.demo import equal_on_all_ranks, free_port
from sda_tpu_torch.nn import reset_parameters
from sda_tpu_torch.train import TrajectoryDataset, Trainer, params_from_flax, params_to_flax

TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE = 120.0  # seconds for one spawn, start-up included

#: name -> (order, frames per shard, with context, chunk, remat)
EPS_CASES = {
    'order1': (1, 4, False, None, False),
    'order2': (2, 6, False, None, False),
    'context': (2, 6, True, None, False),
    'chunked': (2, 16, False, 4, False),
    'chunked_remat': (2, 16, False, 4, True),
}

#: world -> (chunk, remat) of the guided sampling run.
SAMPLING = {2: (None, False), 4: (2, True)}
SAMPLING_STEPS, SAMPLING_STOP, FIELD = 32, 24, 8

DP_ROWS, DP_LENGTH, DP_BATCH, DP_EPOCHS, DP_LR = 64, 12, 16, 3, 1e-3


# -- The kernels, written alike in both packages --------------------------------

def kernel(xw, t, c=None):
    return torch.tanh(xw) + 0.1 * torch.roll(xw, 1, dims=2) * t


def context_kernel(xw, t, c):
    return torch.tanh(xw) * (1 + c.sum()) + 0.05 * t


def gaussian_plus(prior, net):
    r"""The exact eps of unit Gaussian data plus 1% of ``net``'s: guidance
    through an untrained network alone diverges."""

    def eps(xw, t, c=None):
        mu, sigma = prior.mu(t), prior.sigma(t)
        return sigma * xw / (mu**2 + sigma**2) + 0.01 * net(xw, t, c)

    return eps


def tiny_unet():
    return LocalScoreUNet(6, size=FIELD, embedding=8, hidden_channels=(4, 8), hidden_blocks=(1, 1),
                          activation=torch.nn.functional.silu)


def tiny_scorenet():
    return ScoreNet(6, embedding=8, hidden_features=(16,), activation=torch.nn.functional.silu)


def observe(x):
    return x[..., ::4, :, :, :]


# -- What every rank runs ----------------------------------------------------------

def checks(rank, world, payload):
    r"""Every check of one world size, on one rank; returns numpy results."""

    out = {}

    # Meshes and placement.
    mesh = make_mesh(device='cpu')
    out['default'] = (mesh.mesh_dim_names, tuple(mesh.shape))
    mesh2 = make_mesh({'dp': 2, 'sp': -1}, 'cpu')
    out['2d'] = (mesh2.mesh_dim_names, tuple(mesh2.shape), mesh2.get_coordinate())
    small = make_mesh({'sp': 2}, 'cpu')
    out['small'] = small.get_coordinate()
    try:
        make_mesh({'dp': world + 1}, 'cpu')
    except ValueError as e:
        out['too_large'] = str(e)
    out['shard_batch'] = shard_batch(torch.arange(16.0).reshape(16, 1), mesh).numpy()
    out['batch_constraint'] = batch_constraint(torch.arange(10), mesh).numpy()
    x = replicate(torch.full((3,), float(rank)), mesh2)
    torch.manual_seed(rank)  # torch's own initialisation, different on each rank
    net = replicate(tiny_scorenet(), mesh)
    out['replicate'] = x.numpy()
    out['replicated_module'] = equal_on_all_ranks(torch.cat([p.reshape(-1) for p in net.parameters()]))
    rows = host_sharded_array(np.full((2, 3), rank, np.float32), mesh, device='cpu')
    out['host_sharded'] = (rows.offset, rows.shape, rows.local.numpy())

    # The sharded eps and its VJP.
    sp = make_mesh({'sp': world}, 'cpu')
    for name, case in payload['eps'].items():
        order, _, with_c, chunk, remat = EPS_CASES[name]
        fn = context_kernel if with_c else kernel
        c = torch.from_numpy(case['c']) if with_c else None
        x = torch.from_numpy(case['x']).requires_grad_(True)
        score = ShardedMCScoreNet(fn, order, mesh=sp, chunk=chunk, remat=remat)
        eps = score(x, torch.tensor(0.4), c)
        (grad,) = torch.autograd.grad(torch.sum(eps * torch.from_numpy(case['v'])), x)
        out[f'eps/{name}'] = eps.detach().numpy()
        out[f'vjp/{name}'] = grad.numpy()
        out[f'eps_equal/{name}'] = equal_on_all_ranks(eps.detach())

    # Guided sampling with a tiny LocalScoreUNet, JAX's noise replayed.
    s = payload['sampling']
    unet = tiny_unet()
    unet.load_state_dict(_tensors(s['params']))
    unet.requires_grad_(False)
    eps_fn = gaussian_plus(VPSDE(shape=()), unet)
    chunk, remat = SAMPLING[world]
    sde = VPSDE(
        eps=GaussianScore(
            y=torch.from_numpy(s['y']), A=observe, std=0.1, gamma=1e-2, remat=remat,
            sde=VPSDE(eps=ShardedMCScoreNet(eps_fn, 1, mesh=sp, chunk=chunk, remat=remat), shape=()),
        ),
        shape=s['init'].shape[1:],
    )
    noise = torch.from_numpy(s['noise'])
    x = sde.sample((2,), steps=SAMPLING_STEPS, corrections=1, tau=0.5, init=torch.from_numpy(s['init']),
                   noise=lambda i, j: noise[i], segment=(0, SAMPLING_STOP))
    out['sample'] = x.numpy()
    out['sample_equal'] = equal_on_all_ranks(x)

    # GaussianScore(remat=True) over an unchunked sharded score: the
    # checkpoint re-runs the all-gather while recomputing.
    x = torch.from_numpy(s['init'])
    guided = {
        remat: GaussianScore(y=torch.from_numpy(s['y']), A=observe, std=0.1, remat=remat,
                             sde=VPSDE(eps=ShardedMCScoreNet(eps_fn, 1, mesh=sp), shape=()))
        for remat in (False, True)
    }
    out['remat_unchunked'] = {r: g(x, torch.tensor(0.3)).numpy() for r, g in guided.items()}

    # make_trajectory_eps of both packs.
    for pack, utils, args in (('kolmogorov', kolmogorov_utils, dict(chunk=8, remat=True)),
                              ('qg', qg_utils, dict(chunk=8))):
        for axes in ({'sp': world}, {'dp': world}):
            score = utils.make_trajectory_eps(eps_fn, 5, mesh=make_mesh(axes, 'cpu'), **args)
            out[f'levers/{pack}/{next(iter(axes))}'] = (type(score).__name__, score.chunk, score.remat)

    # Data-parallel epochs against the JAX trainer's, with its draws.
    d = payload['dp']
    for layout in ('replicated', 'host_sharded'):
        net = tiny_scorenet()
        net.load_state_dict(_tensors(d['params']))
        if layout == 'replicated':
            train, valid = d['train'], d['valid']
        else:
            train, valid = (host_sharded_array(a[rank * len(a) // world:(rank + 1) * len(a) // world], mesh,
                                               device='cpu') for a in (d['train'], d['valid']))
        draws = [{k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in e.items()} for e in d['draws']]
        trainer = Trainer(
            VPSDE(shape=(6,)), net, TrajectoryDataset(train, 3, True, 'cpu'),
            TrajectoryDataset(valid, 3, True, 'cpu'), epochs=4, batch_size=DP_BATCH, learning_rate=DP_LR,
            weight_decay=1e-3, scheduler='linear', mesh=mesh, draws=lambda e: draws[e],
        )
        stats = [trainer.step_epoch() for _ in range(DP_EPOCHS)]
        out[f'dp/{layout}'] = {
            'stats': stats,
            'params': {k: v.numpy() for k, v in net.state_dict().items()},
            'replicas_equal': equal_on_all_ranks(torch.cat([p.detach().reshape(-1) for p in net.parameters()])),
        }

    return out


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _rank(rank, world, port, out):
    torch.set_num_threads(1)
    try:
        init_multihost(f'127.0.0.1:{port}', world, rank, device='cpu', timeout=TIMEOUT)
        result = checks(rank, world, torch.load(Path(out) / 'payload.pt', weights_only=False))
        torch.save(result, Path(out) / f'rank{rank}.pt')
    except BaseException:
        (Path(out) / f'rank{rank}.err').write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(jobs):
    r"""Runs :func:`checks` for each ``world: (payload, out)`` of ``jobs``,
    every world at once, each on its own port; returns each world's list of
    its ranks' results. Kills every rank at the first failure or at the
    deadline, and fails with their tracebacks."""

    ctx = mp.get_context('spawn')
    procs = []
    for world, (data, out) in jobs.items():
        # Through a file: a payload larger than a pipe's buffer would hold each
        # start() until its rank has imported this module, one after another.
        torch.save(data, Path(out) / 'payload.pt')
        port = free_port()
        procs += [ctx.Process(target=_rank, args=(r, world, port, str(out))) for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < end:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if any(code != 0 for code in codes):
        errors = '\n'.join(f.read_text() for _, out in jobs.values() for f in sorted(Path(out).glob('*.err')))
        pytest.fail(f'ranks exited {codes} (deadline {DEADLINE} s):\n{errors}')
    return {
        world: [torch.load(Path(out) / f'rank{r}.pt', weights_only=False) for r in range(world)]
        for world, (_, out) in jobs.items()
    }


# -- The JAX side ------------------------------------------------------------------

@pytest.fixture(scope='module')
def J():
    import jax
    import jax.numpy as jnp

    from sda_tpu.diffusion import VPSDE as JVPSDE
    from sda_tpu.diffusion import GaussianScore as JGaussianScore
    from sda_tpu.diffusion import LocalScoreUNet as JLocalScoreUNet
    from sda_tpu.diffusion import MCScoreNet as JMCScoreNet
    from sda_tpu.diffusion import ScoreNet as JScoreNet
    from sda_tpu.diffusion import bind_eps as jbind_eps
    from sda_tpu.parallel import ShardedMCScoreNet as JShardedMCScoreNet
    from sda_tpu.parallel import make_mesh as jmake_mesh
    from sda_tpu.train import TrajectoryDataset as JTrajectoryDataset
    from sda_tpu.train import Trainer as JTrainer

    return SimpleNamespace(**{k: v for k, v in locals().items()})


def jax_kernels(J):
    jnp = J.jnp

    def k(xw, t, c=None):
        return jnp.tanh(xw) + 0.1 * jnp.roll(xw, 1, axis=2) * t

    def kc(xw, t, c):
        return jnp.tanh(xw) * (1 + c.sum()) + 0.05 * t

    return k, kc


def jax_unet(J):
    return J.JLocalScoreUNet(channels=6, size=FIELD, embedding=8, hidden_channels=(4, 8), hidden_blocks=(1, 1),
                             activation=J.jax.nn.silu)


def jax_draws(J, key, sizes, epochs):
    r"""The draws of ``epochs`` epochs of ``sda_tpu.train.Trainer`` keyed
    ``key`` (window 3 crops of 12 frames, flattened events of 6)."""

    jax = J.jax

    @jax.jit
    def epoch(sub):
        k_perm, k_train, k_vperm, k_valid = jax.random.split(sub, 4)
        out = {}
        for split, n, k_p, k_s in (('train', sizes[0], k_perm, k_train), ('valid', sizes[1], k_vperm, k_valid)):
            def one(k):
                k_crop, k_loss = jax.random.split(k)
                key_t, key_eps = jax.random.split(k_loss)
                return (jax.random.randint(k_crop, (DP_BATCH,), 0, DP_LENGTH - 3 + 1),
                        jax.random.uniform(key_t, (DP_BATCH,)), jax.random.normal(key_eps, (DP_BATCH, 6)))

            starts, t_, z = jax.vmap(one)(jax.random.split(k_s, n // DP_BATCH))
            out[split] = {'perm': jax.random.permutation(k_p, n), 'starts': starts, 't': t_, 'z': z}
        return out

    draws = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        draws.append(jax.tree_util.tree_map(np.asarray, epoch(sub)))
    return draws


@pytest.fixture(scope='module')
def dp_payload(J):
    r"""The data-parallel run's weights, data and JAX draws (the same at
    every world size)."""

    net = reset_parameters(tiny_scorenet(), torch.Generator().manual_seed(0))
    data = np.random.RandomState(0).randn(DP_ROWS, DP_LENGTH, 2).astype(np.float32)
    return {
        'params': {k: v.numpy() for k, v in net.state_dict().items()},
        'train': data,
        'valid': data[:DP_BATCH],
        'draws': jax_draws(J, J.jax.random.key(7), (DP_ROWS, DP_BATCH), DP_EPOCHS),
    }


def flax_params(J, arrays):
    return J.jax.tree_util.tree_map(J.jnp.asarray, params_to_flax(_tensors(arrays)))


def payload(J, world, dp):
    jax, jnp = J.jax, J.jnp
    rng = np.random.RandomState(world)

    eps = {}
    for name, (_, per, with_c, _, _) in EPS_CASES.items():
        length = world * per
        eps[name] = {
            'x': rng.randn(3, length, 2).astype(np.float32),
            'v': rng.randn(3, length, 2).astype(np.float32),
            'c': np.asarray([0.3, -0.1], np.float32),
        }

    unet = reset_parameters(tiny_unet(), torch.Generator().manual_seed(world))
    length = 4 * world
    shape = (2, length, 2, FIELD, FIELD)
    k_init, k_scan = jax.random.split(jax.random.key(3))
    noise = jax.jit(jax.vmap(lambda i: jax.random.normal(jax.random.fold_in(jax.random.fold_in(k_scan, i), 0), shape)))
    sampling = {
        'params': {k: v.numpy() for k, v in unet.state_dict().items()},
        'y': np.full((length // 4, 2, FIELD, FIELD), 0.3, np.float32),
        'init': np.asarray(jax.random.normal(k_init, shape)),
        'noise': np.asarray(noise(jnp.arange(SAMPLING_STEPS))),
    }

    return {'eps': eps, 'sampling': sampling, 'dp': dp}


@pytest.fixture(scope='module')
def ranks(J, dp_payload, tmp_path_factory):
    r"""``ranks(world) -> (payload, [results of each rank])`` at 2 and 4 ranks,
    both spawned at once."""

    jobs = {world: (payload(J, world, dp_payload), tmp_path_factory.mktemp(f'world{world}')) for world in (2, 4)}
    results = spawn(jobs)

    return lambda world: (jobs[world][0], results[world])


# -- Meshes ------------------------------------------------------------------------

@pytest.mark.parametrize('world', [2, 4])
def test_make_mesh_default_dp(ranks, world):
    _, results = ranks(world)
    assert all(r['default'] == (('dp',), (world,)) for r in results)


def test_make_mesh_2d(ranks):
    r"""``{'dp': 2, 'sp': -1}`` on 4 ranks: the ``-1`` absorbs the rest, and
    the coordinates are row-major."""

    _, results = ranks(4)
    for rank, r in enumerate(results):
        assert r['2d'] == (('dp', 'sp'), (2, 2), (rank // 2, rank % 2))


def test_mesh_smaller_than_world_takes_the_first_ranks(ranks):
    _, results = ranks(4)
    assert [r['small'] for r in results] == [(0,), (1,), None, None]


@pytest.mark.parametrize('world', [2, 4])
def test_mesh_larger_than_world_is_refused(ranks, world):
    _, results = ranks(world)
    for r in results:
        assert r['too_large'] == f"mesh {{'dp': {world + 1}}} needs {world + 1} ranks, have {world}"


def test_shard_batch_layout(ranks):
    _, results = ranks(4)
    for rank, r in enumerate(results):
        np.testing.assert_array_equal(r['shard_batch'], np.arange(16.0).reshape(16, 1)[4 * rank:4 * rank + 4])


def test_batch_constraint_covers_an_uneven_batch(ranks):
    _, results = ranks(4)
    np.testing.assert_array_equal(np.concatenate([r['batch_constraint'] for r in results]), np.arange(10))
    assert [len(r['batch_constraint']) for r in results] == [2, 3, 2, 3]


@pytest.mark.parametrize('world', [2, 4])
def test_replicate_broadcasts_the_first_rank(ranks, world):
    _, results = ranks(world)
    for r in results:
        np.testing.assert_array_equal(r['replicate'], np.zeros(3))
        assert r['replicated_module']


def test_host_sharded_array_holds_only_its_rows(ranks):
    _, results = ranks(4)
    for rank, r in enumerate(results):
        offset, shape, local = r['host_sharded']
        assert offset == 2 * rank and shape == (8, 3)
        np.testing.assert_array_equal(local, np.full((2, 3), rank))


# -- The sharded eps ---------------------------------------------------------------

def jax_eps(J, name, case, world, sharded):
    order, _, with_c, chunk, remat = EPS_CASES[name]
    k, kc = jax_kernels(J)
    fn = kc if with_c else k
    if sharded:
        score = J.JShardedMCScoreNet(fn, order=order, mesh=J.jmake_mesh({'sp': world}), chunk=chunk, remat=remat)
    else:
        score = J.JMCScoreNet(fn, order=order)
    c = J.jnp.asarray(case['c']) if with_c else None
    return J.jax.jit(lambda x: score(x, J.jnp.asarray(0.4), c))


@pytest.mark.parametrize('name', sorted(EPS_CASES))
@pytest.mark.parametrize('world', [2, 4])
def test_sharded_score_matches_jax(ranks, J, world, name):
    r"""The sharded eps at sp = 2 and 4 against the JAX package's sharded and
    unsharded eps (atol 1e-6), equal on every rank."""

    data, results = ranks(world)
    case = data['eps'][name]
    x = J.jnp.asarray(case['x'])
    for sharded in (True, False):
        want = np.asarray(jax_eps(J, name, case, world, sharded)(x))
        for r in results:
            np.testing.assert_allclose(r[f'eps/{name}'], want, atol=1e-6)
    assert all(r[f'eps_equal/{name}'] for r in results)


@pytest.mark.parametrize('name', sorted(EPS_CASES))
@pytest.mark.parametrize('world', [2, 4])
def test_sharded_score_vjp_matches_jax(ranks, J, world, name):
    r"""The gradient of ``sum(eps * v)`` through the sharded eps against the
    JAX ``MCScoreNet``'s (atol 1e-6): an all-gather whose backward
    reduce-scatters would come out ``world`` times too large."""

    data, results = ranks(world)
    case = data['eps'][name]
    eps = jax_eps(J, name, case, world, sharded=False)
    v = J.jnp.asarray(case['v'])
    want = np.asarray(J.jax.grad(lambda x: J.jnp.sum(eps(x) * v))(J.jnp.asarray(case['x'])))
    for r in results:
        np.testing.assert_allclose(r[f'vjp/{name}'], want, atol=1e-6)


# -- Guided sampling ---------------------------------------------------------------

@pytest.mark.parametrize('world', [2, 4])
def test_guided_sampling_matches_jax_sp(ranks, J, world):
    r"""A guided sampler over a tiny LocalScoreUNet with its windows split
    over sp = 2 (plain) and 4 (chunks of 2, per-chunk remat), against the
    JAX package's sp sampler on its own mesh with the same noise (atol
    1e-4); every rank's sample bitwise equal. Both stop at ``t = 1/4`` (24
    of 32 steps): nearer 0, jitted JAX's ``sigma(t)``, a cancellation that
    XLA reorders (``ROADMAP.md``, faults, item 1), departs from the eager
    value, and the last step of the unsharded samplers differs by 3.2e-4
    between the packages. At ``t = 1/4`` they differ by 1.4e-5."""

    jax, jnp = J.jax, J.jnp
    data, results = ranks(world)
    s = data['sampling']
    module, prior = jax_unet(J), J.JVPSDE(shape=())
    net = J.jbind_eps(module, flax_params(J, s['params']))

    def eps_fn(xw, t, c=None):
        mu, sigma = prior.mu(t), prior.sigma(t)
        return sigma * xw / (mu**2 + sigma**2) + 0.01 * net(xw, t, c)

    chunk, remat = SAMPLING[world]
    score = J.JShardedMCScoreNet(eps_fn, order=1, mesh=J.jmake_mesh({'sp': world}), chunk=chunk, remat=remat)
    sde = J.JVPSDE(
        eps=J.JGaussianScore(y=jnp.asarray(s['y']), A=observe, std=0.1, gamma=1e-2, remat=remat,
                             sde=J.JVPSDE(eps=score, shape=())),
        shape=s['init'].shape[1:],
    )
    want = np.asarray(jax.jit(lambda key: sde.sample(key, (2,), steps=SAMPLING_STEPS, corrections=1, tau=0.5,
                                                     segment=(0, SAMPLING_STOP)))(jax.random.key(3)))

    assert np.isfinite(want).all() and np.abs(want).max() < 10
    for r in results:
        np.testing.assert_allclose(r['sample'], want, atol=1e-4)
        assert r['sample_equal']


# -- Remat, and the command lines' factories -----------------------------------------

def test_remat_guard_rebuilds_a_chunked_sharded_score(monkeypatch):
    r"""``GaussianScore(remat=True)`` over a chunked ShardedMCScoreNet without
    per-chunk remat rebuilds it with ``remat=True`` (the same guard as for
    ``MCScoreNet``) and skips its own outer checkpoint; over an unchunked
    one it checkpoints the whole call."""

    from sda_tpu_torch.diffusion import guidance

    checkpointed = []
    monkeypatch.setattr(guidance, 'checkpoint', lambda fn, *args, **kw: checkpointed.append(fn) or fn(*args))
    monkeypatch.setattr(ShardedMCScoreNet, '__call__', lambda self, x, t, c=None: x * t)

    def guided(score):
        return GaussianScore(y=torch.zeros(2, 2), A=lambda x: x[..., ::4, :][:, :2], std=0.1,
                             sde=VPSDE(eps=score, shape=()), remat=True)

    score = ShardedMCScoreNet(kernel, order=1, mesh=None, axis='sp', chunk=4, remat=False)
    g = guided(score)
    rebuilt = g.sde.eps
    assert isinstance(rebuilt, ShardedMCScoreNet) and rebuilt is not score and not score.remat
    assert rebuilt.remat and rebuilt.chunk == 4 and rebuilt.order == 1 and rebuilt.axis == 'sp'
    g._eps(torch.ones(1, 4, 2), torch.tensor(0.5), None)
    assert checkpointed == []

    unchunked = ShardedMCScoreNet(kernel, order=1, mesh=None)
    g = guided(unchunked)
    assert g.sde.eps is unchunked
    g._eps(torch.ones(1, 4, 2), torch.tensor(0.5), None)
    assert checkpointed == [unchunked]


@pytest.mark.parametrize('world', [2, 4])
def test_remat_on_an_unchunked_sharded_score(ranks, world):
    r"""``GaussianScore(remat=True)`` checkpoints the whole sharded call, whose
    recomputation runs the all-gather again inside the backward pass: the
    guided eps equals the one without remat."""

    _, results = ranks(world)
    for r in results:
        np.testing.assert_allclose(r['remat_unchunked'][True], r['remat_unchunked'][False], atol=1e-6)


@pytest.mark.parametrize('world', [2, 4])
def test_make_trajectory_eps_composes_levers(ranks, world):
    r"""Both packs give a ShardedMCScoreNet only when the mesh's ``'sp'`` has
    more than one rank; the Kolmogorov pack forwards ``chunk``/``remat`` into
    it, and the QG pack drops ``chunk`` under a mesh, as the JAX packs do."""

    _, results = ranks(world)
    for r in results:
        assert r['levers/kolmogorov/sp'] == ('ShardedMCScoreNet', 8, True)
        assert r['levers/kolmogorov/dp'] == ('MCScoreNet', 8, True)
        assert r['levers/qg/sp'] == ('ShardedMCScoreNet', None, False)
        assert r['levers/qg/dp'] == ('MCScoreNet', 8, False)


# -- Data parallelism -----------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_dp(J, ranks):
    r"""``jax_dp(world)``: the JAX trainer's per-epoch stats and final
    parameters over a ``{'dp': world}`` mesh."""

    cache = {}

    def get(world):
        if world not in cache:
            jax, jnp = J.jax, J.jnp
            d = ranks(world)[0]['dp']
            module = J.JScoreNet(features=6, embedding=8, hidden_features=(16,), activation=jax.nn.silu)
            trainer = J.JTrainer(
                J.JVPSDE(shape=(6,)), module, flax_params(J, d['params']),
                J.JTrajectoryDataset(d['train'], window=3, flatten=True),
                J.JTrajectoryDataset(d['valid'], window=3, flatten=True),
                epochs=4, batch_size=DP_BATCH, learning_rate=DP_LR, weight_decay=1e-3, scheduler='linear',
                key=jax.random.key(7), mesh=J.jmake_mesh({'dp': world}),
            )
            stats = [trainer.step_epoch() for _ in range(DP_EPOCHS)]
            cache[world] = stats, params_from_flax(jax.tree_util.tree_map(np.asarray, trainer.params))
        return cache[world]

    return get


@pytest.mark.parametrize('layout', ['replicated', 'host_sharded'])
@pytest.mark.parametrize('world', [2, 4])
def test_dp_trainer_matches_jax(ranks, jax_dp, world, layout):
    r"""Three epochs of the port's ``Trainer`` over a ``{'dp': world}`` mesh
    against ``sda_tpu``'s ``Trainer(mesh=...)`` fed the same weights and
    draws: losses within 1e-4 relative and parameters within 1e-2 lr, as
    ``tests/test_torch_train.py`` holds one process in float32, with the
    data on every rank or each rank holding only its rows; the replicas'
    parameters bitwise equal."""

    _, results = ranks(world)
    want_stats, want_params = jax_dp(world)
    for r in results:
        got = r[f'dp/{layout}']
        assert got['replicas_equal']
        for g, w in zip(got['stats'], want_stats):
            assert g['lr'] == pytest.approx(w['lr'], rel=1e-6)
            for loss in ('loss_train', 'loss_valid'):
                np.testing.assert_allclose(g[loss], w[loss], rtol=1e-4)
        assert got['params'].keys() == want_params.keys()
        for k, w in want_params.items():
            np.testing.assert_allclose(got['params'][k], w.numpy(), atol=1e-2 * DP_LR, err_msg=k)

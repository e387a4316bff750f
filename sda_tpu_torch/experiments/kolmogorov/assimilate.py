#!/usr/bin/env python
r"""Kolmogorov zero-shot assimilation, the scenario catalog.

Counterpart of ``experiments/kolmogorov/assimilate.py``: each scenario
defines an observation operator ``A`` and its observation ``y``; the guided
sampler (SDA's :class:`GaussianScore` or the DPS baseline) draws posterior
trajectories, and the residual ``std(A(x) - y)`` should come out near the
observation noise. Scenarios (geometry relative to the grid, the notebook
values at 64^2):

- ``coarse``: 8x-coarsened observations of every 4th frame;
- ``subsample``: every ``stride``-th pixel from ``offset`` of 8 frames;
- ``extrapolate``: coarsen 4x, then the central half patch of every 3rd frame;
- ``patch``: a central full-resolution quarter patch of every 3rd frame;
- ``saturation``: coarsen 4x every 3rd frame, vorticity, ``w / (1 + |w|)``,
  the central 3/4 patch;
- ``circle``: the last frame's vorticity on a synthetic ring, checked by
  re-simulating the sampled first frame at 256^2 (:func:`resimulate`);
- ``loop``: loop closure ``x[0] - x[-1] = 0`` over 127 frames;
- ``vorticity``: the vorticity of every frame.

    python -m sda_tpu_torch.experiments.kolmogorov.assimilate --scenario subsample --method dps [--device cpu]
    torchrun --nproc_per_node 4 -m sda_tpu_torch.experiments.kolmogorov.assimilate --scenario loop --mesh sp=4

``--mesh sp=N`` (or ``dp=M,sp=N``) splits the trajectory's windows over the
``sp`` ranks of a ``torchrun`` launch; every rank draws the same samples,
which equal the run without a mesh, and ``dp`` only shapes the mesh. The
command line reads ``storage/{data}/test.h5`` (``h5py``) and the run's
weights, and renders the posterior's vorticity to
``results/{label}_{run}.png`` unless ``--no-render``; :func:`assimilate`
takes a score and a reference trajectory.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ...diffusion import VPSDE, DPSGaussianScore, GaussianScore
from ...dynamics import coarsen, upsample, vorticity
from ...parallel import make_mesh
from ...utils import resolve_device, set_float32_precision
from .utils import PATH, draw, load_score, make_chain, make_trajectory_eps

Tensor = torch.Tensor
Scenario = Tuple[Callable[[Tensor], Tensor], Tensor, float, int, float]

SCENARIOS = ('coarse', 'subsample', 'extrapolate', 'patch', 'saturation', 'loop', 'vorticity', 'circle')


def coarse_observation(x: Tensor) -> Tensor:
    r"""``A(x)``: every 4th frame of ``(..., L, 2, H, W)``, coarsened 8x."""

    return coarsen(x[..., ::4, :, :, :], 8)


def _noisy(obs: Tensor, std: float, rng: np.random.RandomState) -> Tensor:
    noise = rng.standard_normal(tuple(obs.shape)).astype(np.float32)
    return obs + std * torch.from_numpy(noise).to(obs.device)


def coarse_scenario(x_star: Tensor, rng: np.random.RandomState) -> Scenario:
    r"""``(A, y, std, length, gamma)`` of the ``coarse`` scenario for a
    reference trajectory ``x_star (L, 2, size, size)``; the observation
    noise comes from ``rng`` as in the JAX experiment."""

    length = min(32, x_star.shape[0])
    std = 0.1
    y = _noisy(coarse_observation(x_star[:length]), std, rng)

    return coarse_observation, y, std, length, 1e-2


def get_scenario(
    name: str,
    x_star: Tensor,
    rng: np.random.RandomState,
    stride: int = 8,
    offset: int = 0,
    length_override: Optional[int] = None,
) -> Scenario:
    r"""``(A, y, std, length, gamma)`` of a named scenario for a reference
    trajectory ``x_star (L, 2, size, size)`` in model space, with the
    observation noise drawn from ``rng`` (one draw of ``y``'s shape)."""

    size = x_star.shape[-1]

    if name == 'coarse':
        return coarse_scenario(x_star, rng)

    if name == 'subsample':
        length, std = 8, 0.1

        def A(x):
            return x[..., offset::stride, offset::stride]

        return A, _noisy(A(x_star[:length]), std, rng), std, length, 1e-2

    if name == 'extrapolate':
        length, std = 8, 0.01
        g = size // 4  # the coarse grid; its central half patch (4:12 at 64^2)

        def A(x):
            return coarsen(x, 4)[..., ::3, :, g // 4: 3 * g // 4, g // 4: 3 * g // 4]

        return A, _noisy(A(x_star[:length]), std, rng), std, length, 1e-2

    if name == 'patch':
        length, std = 16, 0.05
        lo, hi = 3 * size // 8, 5 * size // 8  # the central quarter (24:40 at 64^2)

        def A(x):
            return x[..., ::3, :, lo:hi, lo:hi]

        return A, _noisy(A(x_star[:length]), std, rng), std, length, 1e-2

    if name == 'saturation':
        length, std = 8, 0.05
        g = size // 4  # the coarse grid; its central 3/4 patch (2:14 at 64^2)

        def A(x):
            w = vorticity(coarsen(x[..., ::3, :, :, :], 4))
            w = w / (1 + torch.abs(w))
            return w[..., g // 8: g - g // 8, g // 8: g - g // 8]

        return A, _noisy(A(x_star[:length]), std, rng), std, length, 1e-2

    if name == 'circle':
        # A synthetic ring for the last frame's vorticity; y is not data.
        length, std = 8, 0.2
        grid = np.linspace(-1, 1, size, dtype=np.float32)
        dist = grid[:, None] ** 2 + grid[None, :] ** 2
        mask = torch.from_numpy(((0.4 < dist) & (dist < 0.6)).astype(np.float32)).to(x_star.device)

        def A(x):
            return vorticity(x[..., -1, :, :, :]) * mask

        return A, 0.6 * mask, std, length, 1e-2

    if name == 'loop':
        # A closed loop of 127 frames, beyond the 64-frame training data.
        length, std = length_override or 127, 1e-2

        def A(x):
            return x[..., 0, :, :, :] - x[..., -1, :, :, :]

        return A, torch.zeros((2, size, size), device=x_star.device), std, length, 1e-1

    if name == 'vorticity':
        length, std = 8, 0.1
        return vorticity, _noisy(vorticity(x_star[:length]), std, rng), std, length, 1e-2

    raise ValueError(f'unknown scenario {name}')


def scenario_label(scenario: str, stride: int = 8, offset: int = 0) -> str:
    r"""The scenario's name in the result tables (``subsample_s8``,
    ``subsample_7s16``, ...)."""

    if scenario == 'subsample':
        return f'subsample_{offset}s{stride}' if offset else f'subsample_s{stride}'
    return scenario


def assimilate(
    score: Callable[..., Tensor],
    x_star: Tensor,
    samples: int = 4,
    steps: int = 256,
    corrections: int = 1,
    tau: float = 0.5,
    seed: int = 0,
    init: Optional[Tensor] = None,
    noise: Optional[Callable[[int, int], Tensor]] = None,
    scenario: str = 'coarse',
    method: str = 'sda',
    solver: str = 'ddim',
    segments: int = 1,
    remat: bool = False,
    gamma: Optional[float] = None,
    stride: int = 8,
    offset: int = 0,
    length: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, float]:
    r"""Samples ``samples`` trajectories from the posterior of ``scenario``
    given observations of ``x_star`` and returns them with the residual
    ``std(A(x) - y)``.

    ``score`` is a trajectory eps function (see ``make_trajectory_eps``).
    The observation noise comes from ``numpy.random.RandomState(seed)``, the
    sampler's from ``generator`` (default: seeded with ``seed`` on
    ``x_star``'s device), unless ``init``/``noise`` are given (see
    :meth:`VPSDE.sample`). ``method`` is ``'sda'`` (:class:`GaussianScore`,
    with ``remat`` and the scenario's ``gamma`` unless given) or ``'dps'``
    (:class:`DPSGaussianScore`, zeta 1). ``segments > 1`` runs the time grid
    as that many consecutive slices, which gives the same result as one, and
    prints each slice's seconds as the JAX experiment does.
    """

    A, y, std, length, scenario_gamma = get_scenario(
        scenario, x_star, np.random.RandomState(seed), stride, offset, length_override=length,
    )
    gamma = scenario_gamma if gamma is None else gamma
    size = x_star.shape[-1]

    if method == 'sda':
        guided = GaussianScore(y=y, A=A, std=std, sde=VPSDE(eps=score, shape=()), gamma=gamma, remat=remat)
    elif method == 'dps':
        guided = DPSGaussianScore(y=y, A=A, sde=VPSDE(eps=score, shape=()), zeta=1.0)
    else:
        raise ValueError(f'unknown guidance method {method}')
    sde = VPSDE(eps=guided, shape=(length, 2, size, size))

    if generator is None:
        generator = torch.Generator(device=x_star.device).manual_seed(seed)
    xs = None if init is None else init.to(x_star.device)
    bounds = np.linspace(0, steps, segments + 1).astype(int)
    for i0, i1 in zip(bounds[:-1], bounds[1:]):
        t0 = time.perf_counter()
        xs = sde.sample(
            (samples,), steps=steps, corrections=corrections, tau=tau, generator=generator,
            init=xs, noise=noise, solver=solver, segment=(int(i0), int(i1)),
        )
        if segments > 1:
            if xs.is_cuda:
                torch.cuda.synchronize(xs.device)
            print(f'segment {i0}:{i1} done in {time.perf_counter() - t0:.2f}s', flush=True)

    residual = float(torch.std(A(xs) - y, correction=0))

    return xs, residual


def resimulate(xs: Tensor, size: int = 256) -> Tuple[Tensor, float]:
    r"""The ``circle`` scenario's physical-plausibility check: the first
    sampled trajectory's first frame, upsampled to ``size``, re-simulated by
    the spectral solver for the trajectory's length and coarsened back.
    Returns the simulated frames and their correlation with the sampled
    ones."""

    sample = xs[0]
    factor = size // sample.shape[-1]
    chain = make_chain(size, device=xs.device)

    y0 = upsample(sample[0], factor)
    sim = chain.trajectory(y0, length=sample.shape[0] - 1)
    sim = coarsen(torch.cat([y0[None], sim]), factor)

    corr = float(torch.sum(sim * sample) / (torch.linalg.norm(sim) * torch.linalg.norm(sample)))

    return sim, corr


def parse_mesh(mesh: str) -> Dict[str, int]:
    r"""``'dp=2,sp=4'`` -> ``{'dp': 2, 'sp': 4}``."""

    return {k: int(v) for k, v in (kv.split('=') for kv in mesh.split(','))}


def main(
    run: str = 'unet_0',
    scenario: str = 'coarse',
    samples: int = 4,
    steps: int = 256,
    corrections: int = 1,
    tau: float = 0.5,
    seed: int = 0,
    render: bool = True,
    chunk: Optional[int] = None,
    remat: bool = False,
    method: str = 'sda',
    stride: int = 8,
    offset: int = 0,
    mesh: Optional[str] = None,
    length: Optional[int] = None,
    save: bool = False,
    solver: str = 'ddim',
    bf16: Optional[bool] = None,
    gamma: Optional[float] = None,
    data: str = 'data',
    segments: int = 1,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    x_test=None,
    init: Optional[Tensor] = None,
    noise: Optional[Callable[[int, int], Tensor]] = None,
) -> Optional[Tuple[float, float, Tensor]]:
    r"""Assimilates test trajectory ``seed`` with the run ``{path}/runs/{run}``
    as the JAX experiment's ``assimilate`` does; returns ``(residual, std,
    samples)``, or ``None`` on a rank outside the ``mesh``. ``bf16=None``
    follows the run's config. ``x_test`` holds the test trajectories
    ``(N, L, 2, H, W)`` (default: ``{path}/{data}/test.h5``); ``init`` and
    ``noise`` replace the sampler's draws (see :meth:`VPSDE.sample`). Results
    go under ``{path}/results``."""

    if mesh is not None:
        mesh = make_mesh(parse_mesh(mesh), device)
        if mesh.get_coordinate() is None:
            return None
    lead = not dist.is_initialized() or dist.get_rank() == 0

    device = resolve_device(device)
    path = Path(path)
    if x_test is None:
        from ...train import load_h5

        x_test = load_h5(path / f'{data}/test.h5')
    x_star = torch.as_tensor(x_test[seed % len(x_test)], dtype=torch.float32, device=device)

    override = {} if bf16 is None else {'bf16': bf16}
    module, config = load_score(path / f'runs/{run}', device=device, **override)
    score = make_trajectory_eps(module, config.get('window', 5), chunk=chunk, remat=remat, mesh=mesh)

    t0 = time.perf_counter()
    xs, residual = assimilate(
        score, x_star, samples=samples, steps=steps, corrections=corrections, tau=tau, seed=seed,
        scenario=scenario, method=method, solver=solver, segments=segments, remat=remat, gamma=gamma,
        stride=stride, offset=offset, length=length, init=init, noise=noise,
    )
    std = get_scenario(scenario, x_star, np.random.RandomState(seed), stride, offset, length)[2]
    label = scenario_label(scenario, stride, offset)
    if lead:
        print(f'{label}[{method}]: residual std = {residual:.4f} (obs std = {std}) '
              f'in {time.perf_counter() - t0:.1f}s')

    suffix = '' if method == 'sda' else f'_{method}'
    if save and lead:
        out = path / f'results/samples_{label}_{run}{suffix}.npz'
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, xs=xs.float().cpu().numpy(), x_star=x_star[:xs.shape[1]].cpu().numpy())
        print(f'saved {out}')

    if render and lead:
        w = vorticity(xs[:, ::max(xs.shape[1] // 8, 1)]).cpu().numpy()
        out = path / f'results/{label}_{run}{suffix}.png'
        out.parent.mkdir(parents=True, exist_ok=True)
        draw(w).save(out)
        print(f'rendered {out}')

    if scenario == 'circle' and lead:
        sim, corr = resimulate(xs)
        print(f'circle: sim-vs-sample correlation = {corr:.4f}')

        if render:
            out = path / f'results/circle_sim_{run}.png'
            draw(vorticity(torch.stack([xs[0], sim])).cpu().numpy()).save(out)
            print(f'rendered {out} (row 0: sampled, row 1: re-simulated)')

    return residual, std, xs


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='unet_0')
    parser.add_argument('--scenario', default='coarse', choices=SCENARIOS)
    parser.add_argument('--samples', type=int, default=4)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--corrections', type=int, default=1)
    parser.add_argument('--tau', type=float, default=0.5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--chunk', type=int, default=None, help='evaluate score windows in sequential chunks')
    parser.add_argument('--remat', action='store_true', help='recompute the score net in the guidance gradient')
    parser.add_argument('--method', choices=['sda', 'dps'], default='sda')
    parser.add_argument('--stride', type=int, default=8, help='subsample scenario: pixel stride')
    parser.add_argument('--offset', type=int, default=0, help='subsample scenario: grid offset')
    parser.add_argument('--mesh', type=str, default=None,
                        help="sequence-parallel mesh, e.g. 'sp=4' (trajectory length must divide by sp, "
                             'each shard must hold a window)')
    parser.add_argument('--length', type=int, default=None, help='loop scenario: trajectory length')
    parser.add_argument('--no-render', dest='render', action='store_false', default=True)
    parser.add_argument('--save', action='store_true', help='save posterior samples + truth to results/*.npz')
    parser.add_argument('--solver', default='ddim', choices=['ddim', 'dpm2m'])
    parser.add_argument('--bf16', dest='bf16', action='store_true', default=None)
    parser.add_argument('--f32', dest='bf16', action='store_false')
    parser.add_argument('--gamma', type=float, default=None, help="variance inflation (default: the scenario's)")
    parser.add_argument('--data', type=str, default='data')
    parser.add_argument('--segments', type=int, default=1, help='run the time grid as N consecutive slices')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(
        args.run, args.scenario, args.samples, args.steps, args.corrections, args.tau, args.seed,
        render=args.render, chunk=args.chunk, remat=args.remat, method=args.method, stride=args.stride,
        offset=args.offset, mesh=args.mesh, length=args.length, save=args.save, solver=args.solver,
        bf16=args.bf16, gamma=args.gamma, data=args.data, segments=args.segments, device=args.device,
    )
    if dist.is_initialized():
        dist.destroy_process_group()

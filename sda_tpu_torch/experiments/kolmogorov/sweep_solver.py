#!/usr/bin/env python
r"""Posterior quality against sampling steps: ddim against dpm2m.

Counterpart of ``experiments/kolmogorov/sweep_solver.py``: for the
``coarse`` scenario, the residual ratio and the posterior's spectrum
distance to the test frames at each step count for both predictors, with
no Langevin corrections (with corrections dpm2m falls back to first order
by design, so 0 is where the choice of solver matters).

Appends to ``{path}/results/solver_sweep.csv``:
``scenario,solver,steps,run,residual,obs_std,residual_ratio,post_spec_dist,wall_s``,
where ``wall_s`` is the wall time of the assimilation, on the card when the
device is the card (it includes loading the run). Rows already present are
skipped, so a run at the defaults against the committed storage skips every
row: point ``SCRATCH`` (or ``path``) elsewhere.

    SCRATCH=/tmp/sweeps python -m sda_tpu_torch.experiments.kolmogorov.sweep_solver [--steps 32,64] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Sequence, Union

import torch

from ...eval import spectrum_distance
from ...train import append_csv, existing_csv_keys
from ...utils import set_float32_precision
from .assimilate import main as assimilate
from .utils import PATH, reference_frames


def main(
    run: str = 'unet_0',
    scenario: str = 'coarse',
    samples: int = 4,
    seed: int = 0,
    steps_grid: Sequence[int] = (32, 64, 128, 256),
    path: Path = PATH,
    device: Union[str, torch.device] = 'cuda',
    x_test=None,
) -> None:
    r"""Runs both solvers at each step count of ``steps_grid`` with
    ``{path}/runs/{run}`` on ``{path}/data/test.h5`` (or the trajectories
    ``x_test``)."""

    path = Path(path)
    csv = path / 'results/solver_sweep.csv'
    done = existing_csv_keys(csv, 4)

    if x_test is None:
        from ...train import load_h5

        x_test = load_h5(path / 'data/test.h5')
    reference = None

    for steps in steps_grid:
        for solver in ('ddim', 'dpm2m'):
            if (scenario, solver, str(steps), run) in done:
                print(f'skip {solver} steps={steps} (done)')
                continue

            t0 = time.perf_counter()
            residual, std, xs = assimilate(
                run, scenario, samples=samples, steps=steps, corrections=0, seed=seed, render=False,
                solver=solver, path=path, device=device, x_test=x_test,
            )
            wall = time.perf_counter() - t0  # the residual is a host float: the device has finished

            if reference is None:
                reference = reference_frames(x_test, xs.device)
            spec = spectrum_distance(xs.reshape((-1,) + tuple(xs.shape[-3:])), reference)

            append_csv(
                csv,
                f'{scenario},{solver},{steps},{run},{residual:.5f},{std},{residual / std:.3f},{spec:.4f},{wall:.1f}',
            )
            print(f'{solver} steps={steps}: residual/std {residual / std:.3f}, spectrum distance {spec:.4f}, '
                  f'wall {wall:.1f}s', flush=True)

    print(f'-> {csv}')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='unet_0')
    parser.add_argument('--scenario', type=str, default='coarse')
    parser.add_argument('--samples', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--steps', type=str, default='32,64,128,256', help='comma-separated step counts')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.scenario, args.samples, args.seed, [int(s) for s in args.steps.split(',')],
         device=args.device)

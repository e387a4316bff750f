#!/usr/bin/env python
r"""The guidance knobs against the residual ratio.

Counterpart of ``experiments/kolmogorov/sweep_guidance.py``: the ``coarse``
posterior's residual ratio sits at ~1.11 at the default guidance. This
sweeps the Langevin correction count, the corrector step ``tau`` and the
variance inflation ``gamma`` (defaults 1, 0.5 and 1e-2) and records, per
configuration, the residual ratio and the posterior's spectrum distance to
the test frames (through ``RealDFT2``, so on the card the DFT kernels).

Appends to ``{path}/results/guidance_sweep.csv``:
``scenario,run,corrections,tau,gamma,steps,residual,obs_std,residual_ratio,post_spec_dist``.
Rows already present are skipped, so a run at the defaults against the
committed storage skips every row: point ``SCRATCH`` (or ``path``) elsewhere.

    SCRATCH=/tmp/sweeps python -m sda_tpu_torch.experiments.kolmogorov.sweep_guidance [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Sequence, Tuple, Union

import torch

from ...eval import spectrum_distance
from ...train import append_csv, existing_csv_keys
from ...utils import set_float32_precision
from .assimilate import main as assimilate
from .utils import PATH, reference_frames

# (corrections, tau, gamma): the default, more corrections at two step
# sizes, and a gamma axis around the default.
GRID = (
    (1, 0.5, 1e-2),
    (2, 0.25, 1e-2),
    (2, 0.5, 1e-2),
    (4, 0.25, 1e-2),
    (4, 0.5, 1e-2),
    (1, 0.5, 3e-3),
    (1, 0.5, 3e-2),
    (1, 0.5, 1e-1),
    (4, 0.5, 3e-3),
)


def main(
    run: str = 'unet_0',
    scenario: str = 'coarse',
    samples: int = 4,
    steps: int = 256,
    seed: int = 0,
    path: Path = PATH,
    device: Union[str, torch.device] = 'cuda',
    x_test=None,
    grid: Sequence[Tuple[int, float, float]] = GRID,
) -> None:
    r"""Runs each ``(corrections, tau, gamma)`` of ``grid`` with
    ``{path}/runs/{run}`` on ``{path}/data/test.h5`` (or the trajectories
    ``x_test``)."""

    path = Path(path)
    csv = path / 'results/guidance_sweep.csv'
    done = existing_csv_keys(csv, 6)

    if x_test is None:
        from ...train import load_h5

        x_test = load_h5(path / 'data/test.h5')
    reference = None

    for corrections, tau, gamma in grid:
        key = (scenario, run, str(corrections), str(tau), str(gamma), str(steps))
        if key in done:
            print(f'skip C={corrections} tau={tau} gamma={gamma} (done)')
            continue

        residual, std, xs = assimilate(
            run, scenario, samples=samples, steps=steps, corrections=corrections, tau=tau, gamma=gamma, seed=seed,
            render=False, path=path, device=device, x_test=x_test,
        )

        if reference is None:
            reference = reference_frames(x_test, xs.device)
        spec = spectrum_distance(xs.reshape((-1,) + tuple(xs.shape[-3:])), reference)

        append_csv(
            csv,
            f'{scenario},{run},{corrections},{tau},{gamma},{steps},{residual:.5f},{std},{residual / std:.3f},{spec:.4f}',
        )
        print(f'C={corrections} tau={tau} gamma={gamma}: residual/std {residual / std:.3f}, spectrum {spec:.4f}',
              flush=True)

    print(f'-> {csv}')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='unet_0')
    parser.add_argument('--scenario', type=str, default='coarse')
    parser.add_argument('--samples', type=int, default=4)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.scenario, args.samples, args.steps, args.seed, device=args.device)

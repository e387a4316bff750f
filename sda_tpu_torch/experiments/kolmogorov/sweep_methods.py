#!/usr/bin/env python
r"""SDA against DPS over the assimilation scenario catalog.

Counterpart of ``experiments/kolmogorov/sweep_methods.py``: per (scenario,
method) the observation-residual ratio (residual std over the observation
noise; ~1 when the posterior explains the observations at the noise level)
and the posterior ensemble's energy-spectrum distance to the test frames
(DPS posteriors can fit the observations and leave the unobserved scales
unphysical). The spectra go through ``RealDFT2``, so on the card through
the DFT kernels.

Appends to ``{path}/results/method_sweep.csv``:
``scenario,method,run,residual,obs_std,residual_ratio,post_spec_dist``.
Rows already present are skipped, so a run at the defaults against the
committed storage skips every row: point ``SCRATCH`` (or ``path``) elsewhere.

    SCRATCH=/tmp/sweeps python -m sda_tpu_torch.experiments.kolmogorov.sweep_methods [--only subsample_s8] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Union

import torch

from ...eval import spectrum_distance
from ...train import append_csv, existing_csv_keys
from ...utils import set_float32_precision
from .assimilate import main as assimilate
from .assimilate import scenario_label
from .utils import PATH, reference_frames

SCENARIOS = (
    ('coarse', {}),
    ('subsample', {'stride': 8}),
    ('subsample', {'stride': 16, 'offset': 7}),
    ('patch', {}),
    ('saturation', {}),
    ('vorticity', {}),
    ('extrapolate', {}),
)


def main(
    run: str = 'unet_0',
    samples: int = 4,
    steps: int = 256,
    corrections: int = 1,
    seed: int = 0,
    only: Optional[str] = None,
    path: Path = PATH,
    device: Union[str, torch.device] = 'cuda',
    x_test=None,
) -> None:
    r"""Runs SDA and DPS on every scenario (or those named in ``only``,
    comma-separated labels) with ``{path}/runs/{run}`` on
    ``{path}/data/test.h5`` (or the trajectories ``x_test``)."""

    path = Path(path)
    csv = path / 'results/method_sweep.csv'
    done = existing_csv_keys(csv, 3)

    if x_test is None:
        from ...train import load_h5

        x_test = load_h5(path / 'data/test.h5')
    reference = None

    for scenario, kwargs in SCENARIOS:
        label = scenario_label(scenario, **kwargs)
        if only is not None and label not in only.split(','):
            continue
        for method in ('sda', 'dps'):
            if (label, method, run) in done:
                print(f'skip {label} {method} (done)')
                continue

            residual, std, xs = assimilate(
                run, scenario, samples=samples, steps=steps, corrections=corrections, seed=seed, render=False,
                method=method, path=path, device=device, x_test=x_test, **kwargs,
            )

            if reference is None:
                reference = reference_frames(x_test, xs.device)
            spec = spectrum_distance(xs.reshape((-1,) + tuple(xs.shape[-3:])), reference)

            append_csv(csv, f'{label},{method},{run},{residual:.5f},{std},{residual / std:.3f},{spec:.4f}')
            print(f'{label} {method}: residual/std {residual / std:.3f}, spectrum distance {spec:.4f}', flush=True)

    print(f'-> {csv}')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='unet_0')
    parser.add_argument('--samples', type=int, default=4)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--corrections', type=int, default=1)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--only', type=str, default=None, help='comma-separated scenario labels to run')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.samples, args.steps, args.corrections, args.seed, only=args.only, device=args.device)

#!/usr/bin/env python
r"""QG quantitative evaluation: the generative and posterior fidelity gates.

Counterpart of ``experiments/qg/eval.py``:

1. generative: unconditional windows from the trained kernel against
   held-out frames: the isotropic energy-spectrum distance (both layers)
   and the PV standard-deviation ratio;
2. posterior, per held-out trajectory (default: test trajectories 0-7 in
   the ``upper`` scenario): the observation residual over the noise, the
   posterior-mean RMSE per layer against the simulated truth, the
   spread-skill ratio (ensemble spread x sqrt((S+1)/S) over the RMSE, ~1
   for a calibrated ensemble) and the ensemble's spectrum distance to the
   test frames.

Appends to ``storage/results/eval.csv``, in the JAX pack's columns:
``kind,run,scenario,index,residual_ratio,rmse_top,rmse_bottom,spread_skill,spec_dist``
(generative rows carry the PV std ratio in the residual_ratio column and
leave the rmse and spread columns empty). Rows already present are skipped.

    python -m sda_tpu_torch.experiments.qg.eval --run qg_0 --indices 0-7 [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...diffusion import VPSDE
from ...eval import spectrum_distance
from ...train import append_csv, existing_csv_keys
from ...utils import resolve_device
from .assimilate import OBS_STD, assimilate
from .utils import PATH, load_score, make_trajectory_eps

Tensor = torch.Tensor


def parse_indices(spec: str) -> List[int]:
    r"""``'0-7'`` or ``'0,3'`` (or a mix) -> the list of indices."""

    out = []
    for part in spec.split(','):
        if '-' in part:
            a, b = part.split('-')
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def posterior_metrics(xs: Tensor, truth: Tensor, residual: float, std: float, test_frames: Tensor) -> List[float]:
    r"""The posterior row of an ensemble ``xs (S, L, 2, H, W)`` against its
    truth ``(L, 2, H, W)``: residual ratio, RMSE of the mean per layer,
    spread-skill and spectrum distance to ``test_frames``."""

    samples = xs.shape[0]
    mean = xs.mean(dim=0)
    rmse = (mean - truth).square().mean(dim=(0, 2, 3)).sqrt()
    spread = xs.var(dim=0, correction=1).mean().sqrt()
    skill = float((mean - truth).square().mean().sqrt())
    spread_skill = float(spread * np.sqrt((samples + 1) / samples) / skill)
    spec = spectrum_distance(xs.reshape((-1,) + tuple(truth.shape[-3:])), test_frames)

    return [residual / std, float(rmse[0]), float(rmse[1]), spread_skill, spec]


def main(
    run: str = 'qg_0',
    scenario: str = 'upper',
    indices: Sequence[int] = range(8),
    samples: int = 8,
    steps: int = 256,
    corrections: int = 1,
    tau: float = 0.5,
    seed: int = 0,
    gen_batch: int = 64,
    gen_steps: int = 128,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    runs: Optional[Path] = None,
    x_test: Optional[Tensor] = None,
    draws: Optional[dict] = None,
) -> Dict[Tuple[str, ...], List[float]]:
    r"""Evaluates ``run`` (weights under ``runs``, default ``path/runs``)
    against the test set ``x_test (N, L, 2, H, W)`` (default:
    ``path/data/test.h5``), appends the rows missing from
    ``path/results/eval.csv`` and returns them by key ``(kind, run,
    scenario, index)``. ``draws`` may give the samplers' draws:
    ``{'generative': init, 'posterior': {i: (init, noise)}}`` (see
    :meth:`VPSDE.sample`); otherwise they come from generators seeded with
    ``seed`` and ``seed + 100 + i``, as the JAX pack's keys."""

    device = resolve_device(device)
    path = Path(path)
    runs = path / 'runs' if runs is None else Path(runs)
    draws = draws or {}
    csv = path / 'results/eval.csv'
    done = existing_csv_keys(csv, 4)

    if x_test is None:
        from ...train import load_h5

        x_test = load_h5(path / 'data/test.h5')
    if not torch.is_tensor(x_test):
        x_test = torch.from_numpy(np.asarray(x_test, np.float32))
    x_test = x_test.to(device)
    size = tuple(x_test.shape[-2:])
    test_frames = x_test[:, ::max(x_test.shape[1] // 8, 1)].reshape((-1, 2) + size)

    module, config = load_score(runs / run, device=device)
    window = config.get('window', 5)
    rows = {}

    # 1. Generative gate: unconditional windows against held-out frames.
    key = ('generative', run, scenario, '')
    if key not in done:
        sde = VPSDE(eps=module, shape=(window * 2,) + size)
        xs = sde.sample((gen_batch,), steps=gen_steps, init=draws.get('generative'),
                        generator=torch.Generator(device=device).manual_seed(seed))
        frames = xs.reshape((gen_batch * window, 2) + size)

        spec = spectrum_distance(frames, test_frames)
        std_ratio = float(frames.std(correction=0) / test_frames.std(correction=0))

        append_csv(csv, f'generative,{run},{scenario},,{std_ratio:.4f},,,,{spec:.4f}')
        print(f'generative: spectrum distance {spec:.4f}, PV std ratio {std_ratio:.3f}', flush=True)
        rows[key] = [std_ratio, spec]

    # 2. Posterior gate across held-out trajectories.
    score = make_trajectory_eps(module, window)

    for i in indices:
        key = ('posterior', run, scenario, str(i))
        if key in done:
            continue

        x_star = x_test[i]
        init, noise = draws.get('posterior', {}).get(i, (None, None))
        xs, residual, _ = assimilate(
            score, x_star, scenario, samples=samples, steps=steps, corrections=corrections, tau=tau,
            seed=seed + 100 + i, init=init, noise=noise,
        )
        length = xs.shape[1]
        row = posterior_metrics(xs, x_star[:length], residual, OBS_STD, test_frames)

        append_csv(csv, f'posterior,{run},{scenario},{i},' + ','.join(f'{v:.4f}' for v in row))
        print(f'posterior[{i}]: residual ratio {row[0]:.3f}, rmse top/bottom {row[1]:.3f}/{row[2]:.3f}, '
              f'spread-skill {row[3]:.3f}, spectrum {row[4]:.4f}', flush=True)
        rows[key] = row

    print(f'-> {csv}')
    return rows


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='qg_0')
    parser.add_argument('--scenario', default='upper', choices=['upper', 'coarse', 'subsample'])
    parser.add_argument('--indices', type=str, default='0-7', help="e.g. '0-7' or '0,3'")
    parser.add_argument('--samples', type=int, default=8)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--corrections', type=int, default=1)
    parser.add_argument('--tau', type=float, default=0.5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--gen-batch', type=int, default=64, help='unconditional windows for the generative gate')
    parser.add_argument('--gen-steps', type=int, default=128)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.scenario, parse_indices(args.indices), args.samples, args.steps, args.corrections,
         args.tau, args.seed, gen_batch=args.gen_batch, gen_steps=args.gen_steps, device=args.device)

#!/usr/bin/env python
r"""Lorenz posterior W1 against sampling steps: ddim against dpm2m.

Counterpart of ``experiments/lorenz/sweep_solver.py``: for one evaluation
cell (``lo`` observations of one test trajectory), the guided posterior is
sampled at each step count with both predictors, with no Langevin
corrections (with corrections dpm2m falls back to first order by design),
and scored against the cached particle-filter ground truth as the main grid
scores it: mean log-prior, mean log-likelihood and W1.

Appends to ``{path}/results/solver_sweep.csv``:
``index,run,solver,steps,log_prior,log_lik,w1``. Rows already present are
skipped. At step count ``S`` the sampler draws from a generator seeded with
``(2000 + index) * 1000 + S``.

    SCRATCH=/tmp/sweeps python -m sda_tpu_torch.experiments.lorenz.sweep_solver [--steps 16,32] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ...diffusion import VPSDE, GaussianScore
from ...eval import emd
from ...train import append_csv, existing_csv_keys
from ...utils import resolve_device, set_float32_precision
from .eval import ensure_bpf, freq_params, load_observations, observe_raw
from .utils import PATH, load_score, log_likelihood, log_prior, make_chain, make_trajectory_eps


def main(
    run: str = 'local_k2_0',
    local: bool = True,
    index: int = 0,
    samples: int = 1024,
    steps_grid: Sequence[int] = (16, 32, 64, 128, 256),
    path: Path = PATH,
    runs: Optional[Path] = None,
    obs=None,
    device: Union[str, torch.device] = 'cuda',
) -> None:
    r"""Runs both solvers at each step count of ``steps_grid`` on index
    ``index``. ``obs`` holds the ``lo`` observations by index (default:
    ``{path}/results/obs.h5``), ``runs`` the run directories (default:
    ``{path}/runs``); the ground truth is cached under
    ``{path}/results/bpf_lo``."""

    device = resolve_device(device)
    path = Path(path)
    runs = path / 'runs' if runs is None else Path(runs)
    csv = path / 'results/solver_sweep.csv'
    done = existing_csv_keys(csv, 4)

    chain = make_chain(device=device)
    sigma, step = freq_params('lo')

    if obs is None:
        obs = load_observations('lo', path)
    y = torch.as_tensor(np.asarray(obs[index]), dtype=torch.float32, device=device)

    _, x_bpf = ensure_bpf('lo', obs, [index], samples, cache=path / 'results/bpf_lo', device=device)[index]

    module, config = load_score(runs / run, local=local, device=device)
    score = make_trajectory_eps(module, local, config.get('window', 5))

    for steps in steps_grid:
        for solver in ('ddim', 'dpm2m'):
            if (str(index), run, solver, str(steps)) in done:
                print(f'skip {solver} steps={steps} (done)')
                continue

            sde = VPSDE(
                eps=GaussianScore(
                    y=y, A=lambda x: x[..., ::step, :1], std=sigma, sde=VPSDE(eps=score, shape=()), gamma=3e-2,
                ),
                shape=(65, 3),
            )
            generator = torch.Generator(device=device).manual_seed((2000 + index) * 1000 + steps)
            xs = sde.sample((samples,), steps=steps, corrections=0, tau=0.25, solver=solver, generator=generator)
            xs = chain.postprocess(xs)

            log_px = float(log_prior(xs).mean())
            log_py = float(log_likelihood(y, xs, A=observe_raw, sigma=sigma, step=step).mean())
            w1 = emd(xs, x_bpf)

            append_csv(csv, f'{index},{run},{solver},{steps},{log_px},{log_py},{w1}')
            print(f'{solver} steps={steps}: log_prior {log_px:.2f}, log_lik {log_py:.2f}, W1 {w1:.3f}', flush=True)

    print(f'-> {csv}')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='local_k2_0')
    parser.add_argument('--local', action='store_true', default=True)
    parser.add_argument('--global', dest='local', action='store_false')
    parser.add_argument('--index', type=int, default=0)
    parser.add_argument('--samples', type=int, default=1024)
    parser.add_argument('--steps', type=str, default='16,32,64,128,256')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.local, args.index, args.samples, [int(s) for s in args.steps.split(',')],
         device=args.device)

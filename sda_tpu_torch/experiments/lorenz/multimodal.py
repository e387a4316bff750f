#!/usr/bin/env python
r"""Lorenz multimodal posterior: guided sampling against weak 4D-Var modes.

Counterpart of ``experiments/lorenz/multimodal.py``: observe only the third
coordinate (every 4th frame, noise 0.1) of a 49-frame test trajectory, so
that the posterior has several modes. Guided sampling covers them in one
batch; weak 4D-Var (L-BFGS) converges to one mode per start and is run from
``var_starts`` sampled trajectories, whose results are counted as distinct
modes when their squared distance is at least 10. Prints the
posterior-consistency residual and the mode count, and draws the samples and
modes to ``results/multimodal_<run>.png`` where matplotlib is installed.

    python -m sda_tpu_torch.experiments.lorenz.multimodal [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ...diffusion import VPSDE, GaussianScore
from ...eval import weak_4d_var_objective
from ...utils import resolve_device, set_float32_precision
from .utils import PATH, load_score, log_likelihood, log_prior, make_chain, make_trajectory_eps, weak_4d_var

Tensor = torch.Tensor


def main(
    run: str = 'global_0',
    local: bool = False,
    samples: int = 256,
    steps: int = 256,
    corrections: int = 2,
    tau: float = 0.5,
    var_starts: int = 32,
    seed: int = 0,
    device: Union[str, torch.device] = 'cuda',
    x_star: Optional[np.ndarray] = None,
    draws: Optional[Tuple[Tensor, Callable[[int, int], Tensor]]] = None,
    path: Path = PATH,
) -> dict:
    r"""Runs the demo on ``{path}/runs/{run}``; returns the samples ``xa``,
    the 4D-Var results ``xb``, the objective at each start and at its
    result, the kept modes, the residual and the seconds the 4D-Var runs
    took. ``x_star`` defaults to test trajectory 0 (first 49 frames);
    ``draws`` may give the sampler's ``(init, noise)``, otherwise they come
    from a generator seeded with ``seed``."""

    device = resolve_device(device)
    chain = make_chain(device=device)
    rng = np.random.RandomState(seed)

    if x_star is None:
        from ...train import load_h5

        x_star = load_h5(Path(path) / 'data/test.h5')[0, :49]
    y_star = torch.as_tensor(rng.normal(x_star[::4, 2:], 0.1), dtype=torch.float32, device=device)

    sigma, step = 0.1, 4

    def A_raw(x):
        return chain.preprocess(x)[..., 2:]

    module, config = load_score(Path(path) / f'runs/{run}', local=local, device=device)
    score = make_trajectory_eps(module, local, config.get('window', 5))

    sde = VPSDE(
        eps=GaussianScore(y=y_star, A=lambda x: x[..., ::step, 2:], std=sigma, sde=VPSDE(eps=score, shape=())),
        shape=(49, 3),
    )
    init, noise = (None, None) if draws is None else draws
    generator = torch.Generator(device=device).manual_seed(seed)
    xa = sde.sample((samples,), steps=steps, corrections=corrections, tau=tau, generator=generator,
                    init=init, noise=noise)
    xa = chain.postprocess(xa)

    residual = float(torch.std(chain.preprocess(xa)[:, ::step, 2:] - y_star, correction=0))
    print(f'obs residual std = {residual:.4f} (obs std = {sigma})')

    def objective(start):
        return weak_4d_var_objective(
            start[0], y_star, log_prior, lambda y, x: log_likelihood(y, x, A_raw, sigma, step),
        )

    xb, j_start, j_end = [], [], []
    t0 = time.perf_counter()
    for i in range(var_starts):
        xb.append(weak_4d_var(xa[i], y_star, A=A_raw, sigma=sigma, step=step))
        with torch.no_grad():
            j_start.append(float(objective(xa[i])(xa[i])))
            j_end.append(float(objective(xa[i])(xb[-1])))
    var_seconds = time.perf_counter() - t0  # the objectives read back each result
    xb = torch.stack(xb)

    d2 = torch.sum((xb[:, None] - xb[None]) ** 2, dim=(-1, -2))
    keep = []
    for i in range(xb.shape[0]):
        if all(float(d2[i, j]) >= 10.0 for j in keep):
            keep.append(i)
    print(f'weak 4D-Var found {len(keep)} distinct modes from {var_starts} starts')
    modes = xb[keep]
    xa_np, modes_np = xa.cpu().numpy(), modes.cpu().numpy()

    try:
        import matplotlib

        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(1, 3, sharey=True, figsize=(7, 3))
        t_axis = np.arange(1, 50)
        for i, ax in enumerate(axs):
            ax.plot(xa_np[:, :, i].T, t_axis, color='C0', lw=0.5, alpha=0.08)
            for j in range(min(len(modes_np), 6)):
                ax.plot(modes_np[j, :, i], t_axis, lw=0.9, ls='--', color=plt.cm.viridis(0.5 + 0.08 * j))
            ax.set_xlabel('abc'[i])
            ax.grid(alpha=0.3)
        axs[0].set_ylabel('frame')
        fig.tight_layout()
        out = Path(path) / f'results/multimodal_{run}.png'
        out.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out, dpi=130)
        print(f'figure -> {out}')
    except Exception as err:
        print(f'figure skipped: {err}')

    return {'xa': xa, 'xb': xb, 'objective_start': j_start, 'objective_end': j_end,
            'modes': modes, 'residual': residual, 'var_seconds': var_seconds}


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='global_0')
    parser.add_argument('--local', action='store_true', default=False)
    parser.add_argument('--samples', type=int, default=256)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--corrections', type=int, default=2)
    parser.add_argument('--var-starts', type=int, default=32)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.local, args.samples, args.steps, args.corrections, var_starts=args.var_starts,
         seed=args.seed, device=args.device)

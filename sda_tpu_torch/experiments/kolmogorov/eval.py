#!/usr/bin/env python
r"""Kolmogorov quantitative evaluation: generative and posterior fidelity.

Counterpart of ``experiments/kolmogorov/eval.py``:

1. generative: unconditional windows sampled from the trained kernel against
   test frames: the energy-spectrum distance, the ratio of vorticity
   standard deviations, and the Wasserstein gate (the Sinkhorn W1 of
   generated against test frames over the test-vs-test split distance);
2. posterior: the ``coarse`` assimilation's residual over the observation
   noise and its ensemble's spectrum distance to the test frames.

One row per run is appended to ``storage/results/eval.csv``:
``run,unconditional_spec_dist,vorticity_std_ratio,posterior_spec_dist,residual_ratio,w1_gen,w1_floor,w1_ratio``;
a run already in the file is skipped unless ``--force``.

    python -m sda_tpu_torch.experiments.kolmogorov.eval --run unet_0 [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ...diffusion import VPSDE
from ...dynamics import vorticity
from ...eval import pairwise_distances, sinkhorn, spectrum_distance
from ...train import append_csv, existing_csv_keys
from ...utils import resolve_device, set_float32_precision
from .assimilate import assimilate, get_scenario
from .utils import PATH, load_score, make_trajectory_eps

Tensor = torch.Tensor


def wasserstein_gate(frames: Tensor, test_frames: Tensor) -> Tuple[float, float, float]:
    r"""Sinkhorn W1 of generated against test frames, the test-vs-test split
    distance as its floor, and their ratio (~1 when the model matches the
    data up to finite-sample effects). Both use the same regularisation, 2%
    of the mean distance between the two halves of the test frames."""

    half = test_frames.shape[0] // 2
    a, b = test_frames[:half], test_frames[half:]

    reg = 0.02 * float(pairwise_distances(a, b).mean())

    w1_floor = float(sinkhorn(a, b, reg=reg))
    w1_gen = float(sinkhorn(frames, test_frames, reg=reg))

    return w1_gen, w1_floor, w1_gen / w1_floor


def unconditional(
    module, window: int, test_frames: Tensor, samples: int = 64, steps: int = 128,
    generator: Optional[torch.Generator] = None, init: Optional[Tensor] = None,
) -> Tuple[Dict[str, float], Tensor]:
    r"""Samples ``samples`` windows from the kernel ``module`` (no guidance,
    no corrections) and scores their frames against ``test_frames``;
    returns the metrics and the frames."""

    size = test_frames.shape[-1]
    sde = VPSDE(eps=module, shape=(window * 2, size, size))
    xs = sde.sample((samples,), steps=steps, generator=generator, init=init)
    frames = xs.reshape(samples * window, 2, size, size)

    w_gen, w_ref = vorticity(frames), vorticity(test_frames)
    w1_gen, w1_floor, w1_ratio = wasserstein_gate(frames, test_frames)
    metrics = {
        'spec_dist': spectrum_distance(frames, test_frames),
        'vort_ratio': float(w_gen.std(correction=0) / w_ref.std(correction=0)),
        'w1_gen': w1_gen, 'w1_floor': w1_floor, 'w1_ratio': w1_ratio,
    }

    return metrics, frames


def posterior_fidelity(xs: Tensor, residual: float, std: float, test_frames: Tensor) -> Dict[str, float]:
    r"""The posterior ensemble ``xs (B, L, 2, H, W)`` of the ``coarse``
    scenario: its residual over the observation noise and its spectrum
    distance to ``test_frames``."""

    frames = xs.reshape((-1,) + tuple(xs.shape[-3:]))

    return {'residual_ratio': residual / std, 'post_spec': spectrum_distance(frames, test_frames)}


def main(
    run: str = 'unet_0',
    samples: int = 64,
    steps: int = 128,
    seed: int = 0,
    data: str = 'data',
    force: bool = False,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    draws: Optional[dict] = None,
) -> Optional[Dict[str, float]]:
    r"""Evaluates ``run`` against ``{path}/{data}/test.h5`` and appends its
    row to ``{path}/results/eval.csv``; returns the metrics, or ``None`` if
    the run already has a row. ``draws`` may give the samplers' draws:
    ``{'unconditional': init, 'posterior': (init, noise)}`` (see
    :meth:`VPSDE.sample`); otherwise they come from generators seeded with
    ``seed`` and ``seed + 1``."""

    from ...train import load_h5

    path = Path(path)
    csv = path / 'results/eval.csv'
    if not force and (run,) in existing_csv_keys(csv, 1):
        print(f'{run}: row already in results/eval.csv, skipping (--force to re-evaluate)')
        return None

    device = resolve_device(device)
    draws = draws or {}
    x_test = torch.from_numpy(np.asarray(load_h5(path / f'{data}/test.h5'), np.float32)).to(device)
    size = x_test.shape[-1]
    test_frames = x_test[:, ::8].reshape(-1, 2, size, size)

    module, config = load_score(path / f'runs/{run}', device=device)
    window = config.get('window', 5)

    metrics, _ = unconditional(
        module, window, test_frames, samples, steps,
        generator=torch.Generator(device=device).manual_seed(seed), init=draws.get('unconditional'),
    )
    print(f'unconditional: spectrum distance {metrics["spec_dist"]:.4f}, '
          f'vorticity std ratio {metrics["vort_ratio"]:.3f}, W1 {metrics["w1_gen"]:.3f} '
          f'vs floor {metrics["w1_floor"]:.3f} (ratio {metrics["w1_ratio"]:.3f})')

    x_star = x_test[seed % len(x_test)]
    std = get_scenario('coarse', x_star, np.random.RandomState(seed))[2]
    init, noise = draws.get('posterior', (None, None))
    xs, residual = assimilate(
        make_trajectory_eps(module, window), x_star, samples=4, steps=256, corrections=1, tau=0.5,
        seed=seed, init=init, noise=noise, generator=torch.Generator(device=device).manual_seed(seed + 1),
    )
    metrics.update(posterior_fidelity(xs, residual, std, test_frames))
    print(f'posterior (coarse): spectrum distance {metrics["post_spec"]:.4f}, '
          f'residual/obs-noise ratio {metrics["residual_ratio"]:.3f}')

    append_csv(
        csv,
        f'{run},{metrics["spec_dist"]},{metrics["vort_ratio"]},{metrics["post_spec"]},'
        f'{metrics["residual_ratio"]},{metrics["w1_gen"]},{metrics["w1_floor"]},{metrics["w1_ratio"]}',
    )

    return metrics


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--run', type=str, default='unet_0')
    parser.add_argument('--samples', type=int, default=64)
    parser.add_argument('--steps', type=int, default=128)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--data', type=str, default='data')
    parser.add_argument('--force', action='store_true', help='re-evaluate even if the run already has a row')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.run, args.samples, args.steps, args.seed, args.data, args.force, device=args.device)

#!/usr/bin/env python
r"""Kolmogorov figures: sandwich plots, assimilation montages, GIFs.

Counterpart of ``experiments/kolmogorov/figures.py``, with the same file
names:

- ``results/data_montage.png``, ``sandwich.png`` and ``sandwich_noisy.png``:
  consecutive frames of test trajectory 16 as a square montage, the mirrored
  diagonal stack and a noisy stack;
- for each ``results/samples_<name>.npz`` that ``assimilate --save`` wrote:
  ``truth_<name>.png`` and ``posterior_<name>.png`` montages (at most 8
  frames) and ``assim_<name>.gif``, the first posterior sample animated.

Rendering is host work (numpy and :mod:`sda_tpu_torch.viz`): the script
runs on the CPU and only reads stored files.

    python -m sda_tpu_torch.experiments.kolmogorov.figures [--skip-sandwich] [--skip-assim]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ...dynamics import vorticity
from ...utils import set_float32_precision
from .utils import PATH, draw, sandwich, save_gif


def _vorticity(x) -> np.ndarray:
    return vorticity(torch.as_tensor(np.asarray(x))).numpy()


def sandwich_figures(frames: int = 9, path: Path = PATH) -> None:
    r"""Test trajectory 16 of ``{path}/data/test.h5``: its first ``frames``
    frames as a square montage, a mirrored sandwich stack and a noisy one."""

    from ...train import load_h5

    path = Path(path)
    w = _vorticity(load_h5(path / 'data/test.h5')[16, :frames])

    side = int(np.sqrt(frames))
    out = path / 'results'
    out.mkdir(parents=True, exist_ok=True)

    draw(w[: side * side].reshape(side, side, *w.shape[-2:]), zoom=4).save(out / 'data_montage.png')
    sandwich(w, mirror=True, zoom=3).save(out / 'sandwich.png')

    rng = np.random.RandomState(0)
    sandwich(0.7 * w + 0.4 * rng.standard_normal(w.shape), zoom=3).save(out / 'sandwich_noisy.png')
    print(f'sandwich figures -> {out}/[data_montage|sandwich|sandwich_noisy].png')


def assimilation_figures(gif_dt: float = 0.2, path: Path = PATH) -> None:
    r"""For each ``{path}/results/samples_*.npz``: truth and posterior
    montages and an animated GIF of the first posterior sample."""

    out = Path(path) / 'results'

    stored = sorted(out.glob('samples_*.npz'))
    if not stored:
        print('no stored samples (run assimilate.py --save first)')
        return

    for file in stored:
        name = file.stem[len('samples_'):]
        with np.load(file) as z:
            xs, x_star = z['xs'], z['x_star']

        # At most 8 frames per montage row.
        stride = max(1, x_star.shape[0] // 8)

        draw(_vorticity(x_star[::stride][:8]), zoom=4).save(out / f'truth_{name}.png')
        draw(_vorticity(xs[0, ::stride][:8]), zoom=4).save(out / f'posterior_{name}.png')
        save_gif(_vorticity(xs[0]), out / f'assim_{name}.gif', dt=gif_dt, zoom=2)

        print(f'{name}: truth/posterior montages + GIF ({xs.shape[0]} samples, {xs.shape[1]} frames)')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--skip-sandwich', action='store_true')
    parser.add_argument('--skip-assim', action='store_true')
    args = parser.parse_args()

    if not args.skip_sandwich:
        sandwich_figures()
    if not args.skip_assim:
        assimilation_figures()

#!/usr/bin/env python
r"""Kolmogorov data generation: batched ensemble simulation on the device.

Counterpart of ``experiments/kolmogorov/generate.py``: 1024 trajectories of
128 transitions at 256^2 (keeping the last 64), coarsened 4x to 64^2 and
split 80/10/10. Chunks of ``chunk`` trajectories run as one batch; each
chunk draws its white noise from a generator of its own, seeded from
``(seed, chunk index)``, as the JAX pack splits one key per chunk, so
``--only`` can simulate just the chunks that overlap the splits it asks for
and still write what a full run writes.

    python -m sda_tpu_torch.experiments.kolmogorov.generate [--trajectories 1024] [--only test] [--device cpu]

The command line writes ``storage/<data>/{train,valid,test}.h5``
(``h5py``); :func:`simulate` returns trajectories as a tensor.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ...dynamics import KolmogorovFlow, coarsen
from ...utils import chunk_generator, resolve_device, set_float32_precision
from .utils import PATH, make_chain


def simulate(
    chain: KolmogorovFlow,
    batch: int = 1,
    length: int = 128,
    keep: int = 64,
    coarse: int = 4,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    r"""Samples ``batch`` initial states from the prior (or from the white
    ``noise`` given), rolls out ``length`` transitions, keeps the last
    ``keep`` and coarsens them ``coarse`` times:
    ``(batch, keep, 2, size / coarse, size / coarse)``."""

    x = chain.prior((batch,), generator=generator, noise=noise)
    xs = chain.trajectory(x, length=length)  # (length, batch, 2, size, size)
    xs = coarsen(xs[length - keep:], coarse)

    return xs.transpose(0, 1)


def split_bounds(trajectories: int) -> Dict[str, Tuple[int, int]]:
    r"""The trajectories ``[a, b)`` of each split: the first 80% train, the
    next 10% valid, the rest test."""

    i = int(0.8 * trajectories)
    j = int(0.9 * trajectories)
    return {'train': (0, i), 'valid': (i, j), 'test': (j, trajectories)}


def main(
    trajectories: int = 1024,
    size: int = 256,
    length: int = 128,
    keep: int = 64,
    coarse: int = 4,
    chunk: int = 16,
    seed: int = 0,
    data: str = 'data',
    only: Optional[str] = None,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> None:
    r"""Simulates the splits ``only`` asks for (comma-separated; default:
    all) and writes them under ``path/<data>``. Only the chunks that overlap
    ``[first wanted trajectory, trajectories)`` are simulated. ``noise(i)``,
    when given, is the prior's white noise of chunk ``i``."""

    from ...train import save_h5

    device = resolve_device(device)
    chain = make_chain(size=size, device=device)

    bounds = split_bounds(trajectories)
    wanted = list(bounds) if only is None else only.split(',')
    first = min(bounds[name][0] for name in wanted) // chunk * chunk

    out = np.empty((trajectories - first, keep, 2, size // coarse, size // coarse), dtype=np.float32)

    for index, start in enumerate(range(0, trajectories, chunk)):
        if start < first:
            continue
        batch = min(chunk, trajectories - start)
        white = None if noise is None else noise(index)
        xs = simulate(chain, batch, length, keep, coarse, generator=chunk_generator(seed, index, device), noise=white)
        out[start - first:start - first + batch] = xs.cpu().numpy()
        print(f'{start + batch}/{trajectories}', flush=True)

    for name in wanted:
        a, b = bounds[name]
        split = out[a - first:b - first]
        save_h5(Path(path) / f'{data}/{name}.h5', split)
        print(f'{name}: {split.shape}')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--trajectories', type=int, default=1024)
    parser.add_argument('--size', type=int, default=256)
    parser.add_argument('--length', type=int, default=128)
    parser.add_argument('--keep', type=int, default=64)
    parser.add_argument('--coarse', type=int, default=4)
    parser.add_argument('--chunk', type=int, default=16)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--data', type=str, default='data',
                        help="output subdir under storage/ (e.g. 'data128' for --coarse 2)")
    parser.add_argument('--only', type=str, default=None,
                        help="comma-separated splits to produce (e.g. 'test'); the split matches a full run's")
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.trajectories, args.size, args.length, args.keep, args.coarse, args.chunk, args.seed, args.data,
         only=args.only, device=args.device)

#!/usr/bin/env python
r"""Lorenz data generation.

Counterpart of ``experiments/lorenz/generate.py``: 1024 chains, a 1024-step
burn-in (last state only), 1024 recorded steps, standardization and an
80/10/10 train/valid/test split. :func:`simulate` returns the splits as
tensors on the device; the command line writes them to HDF5, which needs
``h5py``.

    python -m sda_tpu_torch.experiments.lorenz.generate [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from ...train import save_h5
from ...utils import resolve_device, set_float32_precision
from .utils import PATH, make_chain


def simulate(
    chains: int = 1024,
    length: int = 1024,
    burnin: int = 1024,
    seed: int = 0,
    device: Union[str, torch.device] = 'cuda',
) -> Dict[str, torch.Tensor]:
    r"""``{'train', 'valid', 'test'}`` splits of ``(chains, length, 3)``
    standardized trajectories, all drawn from one generator seeded with
    ``seed``."""

    device = resolve_device(device)
    chain = make_chain(device=device)
    generator = torch.Generator(device=device).manual_seed(seed)

    x = chain.prior((chains,), generator=generator)
    x = chain.trajectory(x, length=burnin, last=True, generator=generator)
    x = chain.trajectory(x, length=length, generator=generator)  # (length, chains, 3)
    x = chain.preprocess(x).transpose(0, 1).contiguous()

    i, j = int(0.8 * chains), int(0.9 * chains)

    return {'train': x[:i], 'valid': x[i:j], 'test': x[j:]}


def main(chains: int = 1024, length: int = 1024, burnin: int = 1024, seed: int = 0, device: str = 'cuda'):
    for name, data in simulate(chains, length, burnin, seed, device).items():
        save_h5(PATH / f'data/{name}.h5', data.cpu().numpy())
        print(f'{name}: {tuple(data.shape)}')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--chains', type=int, default=1024)
    parser.add_argument('--length', type=int, default=1024)
    parser.add_argument('--burnin', type=int, default=1024)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.chains, args.length, args.burnin, args.seed, args.device)

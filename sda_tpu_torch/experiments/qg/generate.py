#!/usr/bin/env python
r"""QG data generation: batched ensemble simulation on the device.

Counterpart of ``experiments/qg/generate.py``: two-layer QG at 128^2 (dt
0.1), spun up through the baroclinic-instability equilibration (``burnin``
transitions), ``keep`` frames recorded, coarsened 2x to 64^2, standardised
per layer to unit scale and split 80/10/10. Chunks of ``chunk`` trajectories
run as one batch; each chunk draws its white noise from a generator of its
own, seeded from ``(seed, chunk index)``, as the JAX pack splits one key per
chunk.

    python -m sda_tpu_torch.experiments.qg.generate [--trajectories 1024] [--chunk 64] [--device cpu]

The command line writes ``storage/data/{train,valid,test}.h5`` (``h5py``)
and the per-layer scale to ``storage/data/scale.json``; :func:`generate`
returns the splits and the scale as tensors.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ...dynamics import QuasiGeostrophic, coarsen
from ...utils import chunk_generator, resolve_device
from .utils import PATH, make_chain

Tensor = torch.Tensor


def simulate(
    chain: QuasiGeostrophic,
    batch: int,
    burnin: int = 128,
    keep: int = 64,
    coarse: int = 2,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    r"""``batch`` trajectories: prior states (from ``generator``, or from the
    white ``noise`` given), ``burnin`` transitions, then ``keep`` recorded
    frames, coarsened ``coarse`` times: ``(batch, keep, 2, size / coarse,
    size / coarse)``."""

    x = chain.prior((batch,), generator=generator, noise=noise)
    x = chain.trajectory(x, length=burnin, last=True)
    xs = chain.trajectory(x, length=keep)  # (keep, batch, 2, size, size)

    return coarsen(xs, coarse).transpose(0, 1)


def generate(
    trajectories: int = 1024,
    size: int = 128,
    burnin: int = 128,
    keep: int = 64,
    coarse: int = 2,
    chunk: int = 64,
    seed: int = 0,
    device: Union[str, torch.device] = 'cuda',
    noise: Optional[Callable[[int], Tensor]] = None,
) -> Tuple[Dict[str, Tensor], Tensor]:
    r"""Simulates ``trajectories`` trajectories in chunks of ``chunk`` and
    returns the standardised splits ``{'train', 'valid', 'test'}`` and the
    per-layer ``scale`` (2,) they were divided by (the standard deviation
    over trajectories, frames and pixels). ``noise(i)``, when given, is the
    prior's white noise of chunk ``i``, ``(chunk, 2, size, size)``."""

    device = resolve_device(device)
    chain = make_chain(size=size, device=device)

    out = torch.empty((trajectories, keep, 2, size // coarse, size // coarse), device=device)

    for index, start in enumerate(range(0, trajectories, chunk)):
        batch = min(chunk, trajectories - start)
        white = None if noise is None else noise(index)
        out[start:start + batch] = simulate(
            chain, batch, burnin, keep, coarse, generator=chunk_generator(seed, index, device), noise=white,
        )
        print(f'{start + batch}/{trajectories}', flush=True)

    if not bool(torch.isfinite(out).all()):
        raise RuntimeError('QG simulation produced non-finite states')

    # Standardise to unit scale (per-layer std over the whole set).
    scale = out.double().std(dim=(0, 1, 3, 4), correction=0, keepdim=True).float()
    out /= scale

    i = int(0.8 * trajectories)
    j = int(0.9 * trajectories)
    splits = {'train': out[:i], 'valid': out[i:j], 'test': out[j:]}

    return splits, scale.reshape(2)


def main(
    trajectories: int = 1024,
    size: int = 128,
    burnin: int = 128,
    keep: int = 64,
    coarse: int = 2,
    chunk: int = 64,
    seed: int = 0,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    noise: Optional[Callable[[int], Tensor]] = None,
) -> Tensor:
    r"""Writes the splits under ``path/data`` and the scale to
    ``path/data/scale.json``; returns the scale."""

    from ...train import save_h5

    splits, scale = generate(trajectories, size, burnin, keep, coarse, chunk, seed, device, noise)

    data = Path(path) / 'data'
    data.mkdir(parents=True, exist_ok=True)
    (data / 'scale.json').write_text(json.dumps({'scale': scale.cpu().tolist()}))

    for name, split in splits.items():
        save_h5(data / f'{name}.h5', split.cpu().numpy())
        print(f'{name}: {tuple(split.shape)}')

    return scale


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--trajectories', type=int, default=1024)
    parser.add_argument('--size', type=int, default=128)
    parser.add_argument('--burnin', type=int, default=128)
    parser.add_argument('--keep', type=int, default=64)
    parser.add_argument('--coarse', type=int, default=2)
    parser.add_argument('--chunk', type=int, default=64)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.trajectories, args.size, args.burnin, args.keep, args.coarse, args.chunk, args.seed, args.device)

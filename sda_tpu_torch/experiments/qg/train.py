#!/usr/bin/env python
r"""QG score training: the windowed U-Net kernel over two-layer PV fields.

Counterpart of ``experiments/qg/train.py``: the Kolmogorov recipe (window 5,
U-Net (96, 192, 384) x (3, 3, 3), batch 32, AdamW 2e-4, linear decay) on
flattened 5-frame windows of the standardised 64^2 dataset, with a plain
circular ScoreUNet (no forcing channel), a resumable checkpoint and a
weights snapshot every 64 epochs, and a final 2-sample sanity draw whose
last frame is rendered, both layers, to ``runs/qg_<seed>/samples.png``.

    python -m sda_tpu_torch.experiments.qg.train --seed 0 [--epochs N] [--resume] [--device cpu]
    torchrun --nproc_per_node 8 -m sda_tpu_torch.experiments.qg.train --seed 0 --mesh

``--mesh`` splits each batch over every rank of a ``torchrun`` launch (data
parallelism; NCCL on the card, gloo with ``--device cpu``); rank 0 alone
writes the run directory.

The command line reads ``storage/data/{train,valid}.h5`` (``h5py``);
:func:`train` also takes the splits as tensors, as from
:func:`~sda_tpu_torch.experiments.qg.generate.generate`.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ...diffusion import VPSDE
from ...parallel import make_mesh
from ...train import RunLogger, TrajectoryDataset, Trainer, restore_checkpoint, save_checkpoint, save_params
from ...utils import resolve_device, save_config, set_float32_precision
from .utils import PATH, draw, init_score, make_score

CONFIG = {
    'window': 5,
    'embedding': 64,
    'hidden_channels': (96, 192, 384),
    'hidden_blocks': (3, 3, 3),
    'kernel_size': 3,
    'activation': 'SiLU',
    'size': 64,
    # Training
    'epochs': 4096,
    'batch_size': 32,
    'optimizer': 'AdamW',
    'learning_rate': 2e-4,
    'weight_decay': 1e-3,
    'scheduler': 'linear',
}


def train(
    seed: int,
    epochs: Optional[int] = None,
    resume: bool = False,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    trainset=None,
    validset=None,
    use_mesh: bool = False,
) -> Optional[torch.Tensor]:
    r"""Trains ``qg_<seed>`` under ``path/runs``; returns the final 2
    sampled windows ``(2, window, 2, size, size)`` (``None`` on ranks other
    than 0).

    ``trainset``/``validset`` are ``(N, L, 2, size, size)`` trajectories
    (default: the HDF5 splits under ``path/data``). ``use_mesh`` splits each
    batch over every rank of the process group (brought up from
    ``torchrun``'s environment if none is).
    """

    mesh = make_mesh(device=device) if use_mesh else None
    lead = mesh is None or dist.get_rank() == 0
    device = resolve_device(device)
    config = dict(CONFIG)
    if epochs is not None:
        config['epochs'] = epochs

    runpath = Path(path) / f'runs/qg_{seed}'
    if lead:
        runpath.mkdir(parents=True, exist_ok=True)
        if not (runpath / 'config.json').exists():
            save_config(config, runpath)
        logger = RunLogger(runpath)
    generator = torch.Generator(device=device).manual_seed(seed)

    window, size = config['window'], config['size']
    module = init_score(make_score(**config), torch.Generator().manual_seed(seed)).to(device)
    sde = VPSDE(shape=(window * 2, size, size))

    if trainset is None:
        trainset, validset = Path(path) / 'data/train.h5', Path(path) / 'data/valid.h5'
    trainset = TrajectoryDataset(trainset, window=window, flatten=True, device=device)
    validset = TrajectoryDataset(validset, window=window, flatten=True, device=device)

    trainer = Trainer(sde, module, trainset, validset, generator=generator, mesh=mesh, **config)

    ckpt = runpath / 'checkpoint.msgpack'
    if resume and ckpt.exists():
        restore_checkpoint(trainer, ckpt)
        print(f'resumed at epoch {trainer.epoch}')

    for stats in trainer:
        if not lead:
            continue
        logger.log(stats, step=trainer.epoch)

        if trainer.epoch % 64 == 0:
            save_checkpoint(trainer, ckpt)
            # A loadable weights snapshot: a run cut short stays usable.
            save_params(module, runpath / 'state.msgpack')

    if not lead:
        return None
    save_params(module, runpath / 'state.msgpack')

    # Final sanity sample: unconditional windows, both layers.
    with torch.no_grad():
        x = VPSDE(eps=module, shape=(window * 2, size, size)).sample((2,), steps=64, generator=generator)
    x = x.reshape(2, window, 2, size, size)
    top, bottom = x[:, -1, 0], x[:, -1, 1]
    print(f'sample, last frame: PV std {float(top.std()):.3f} (top), {float(bottom.std()):.3f} (bottom), '
          f'|PV| max {float(x[:, -1].abs().max()):.3f}')
    w = x[:, -1].cpu().numpy()
    scale = float(np.abs(w).max())
    draw(w, vmin=-scale, vmax=scale).save(runpath / 'samples.png')

    logger.finish()
    print(f'qg_{seed}: done')

    return x


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--mesh', action='store_true', help='split batches over every rank of the launch')
    parser.add_argument('--resume', action='store_true', help='continue from the latest checkpoint')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    train(args.seed, args.epochs, args.resume, device=args.device, use_mesh=args.mesh)
    if dist.is_initialized():
        dist.destroy_process_group()

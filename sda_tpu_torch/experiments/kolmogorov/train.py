#!/usr/bin/env python
r"""Kolmogorov score training: the windowed U-Net kernel.

Counterpart of ``experiments/kolmogorov/train.py``: the same config (window
5, U-Net (96, 192, 384) x (3, 3, 3), 4096 epochs, batch 32, AdamW 2e-4,
linear decay), trained on flattened 5-frame windows of the 64^2 dataset, a
resumable checkpoint every 64 epochs and a final 2-sample sanity draw.

    python -m sda_tpu_torch.experiments.kolmogorov.train --seed 0 [--bf16] [--resume] [--device cpu]
    torchrun --nproc_per_node 8 -m sda_tpu_torch.experiments.kolmogorov.train --seed 0 --mesh

``--mesh`` splits each batch over every rank of a ``torchrun`` launch (data
parallelism; NCCL on the card, gloo with ``--device cpu``); rank 0 alone
writes the run directory.

The command line reads ``storage/<data>/{train,valid}.h5`` (``h5py``);
:func:`train` also takes the splits as tensors, as from
:func:`~sda_tpu_torch.experiments.kolmogorov.generate.simulate`.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist

from ...diffusion import VPSDE
from ...dynamics import vorticity
from ...nn import reset_parameters
from ...parallel import make_mesh
from ...train import RunLogger, TrajectoryDataset, Trainer, restore_checkpoint, save_checkpoint, save_params
from ...utils import resolve_device, save_config
from .utils import PATH, make_score

CONFIG = {
    # Architecture
    'window': 5,
    'embedding': 64,
    'hidden_channels': (96, 192, 384),
    'hidden_blocks': (3, 3, 3),
    'kernel_size': 3,
    'activation': 'SiLU',
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
    bf16: bool = False,
    resume: bool = False,
    size: int = 64,
    data: str = 'data',
    batch_size: Optional[int] = None,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    trainset=None,
    validset=None,
    use_mesh: bool = False,
) -> Optional[torch.Tensor]:
    r"""Trains ``unet_<seed>`` (``unet<size>_<seed>`` beyond 64^2) under
    ``path/runs``; returns the vorticity of the final 2 samples (``None`` on
    ranks other than 0).

    ``trainset``/``validset`` are ``(N, L, 2, size, size)`` trajectories
    (default: the HDF5 splits under ``path/<data>``). ``use_mesh`` splits
    each batch over every rank of the process group (brought up from
    ``torchrun``'s environment if none is).
    """

    mesh = make_mesh(device=device) if use_mesh else None
    lead = mesh is None or dist.get_rank() == 0
    device = resolve_device(device)
    config = dict(CONFIG)
    if epochs is not None:
        config['epochs'] = epochs
    if bf16:
        config['bf16'] = True
    if batch_size is not None:
        config['batch_size'] = batch_size
    config['size'] = size

    name = f'unet_{seed}' if size == 64 else f'unet{size}_{seed}'
    runpath = Path(path) / f'runs/{name}'
    if lead:
        runpath.mkdir(parents=True, exist_ok=True)
        if not (runpath / 'config.json').exists():
            save_config(config, runpath)
        logger = RunLogger(runpath)
    generator = torch.Generator(device=device).manual_seed(seed)

    window = config['window']
    module = reset_parameters(make_score(**config), torch.Generator().manual_seed(seed)).to(device)
    sde = VPSDE(shape=(window * 2, size, size))

    if trainset is None:
        trainset, validset = Path(path) / f'{data}/train.h5', Path(path) / f'{data}/valid.h5'
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
            save_params(module, runpath / 'state.msgpack')

    if not lead:
        return None
    save_params(module, runpath / 'state.msgpack')

    # Final sanity sample.
    with torch.no_grad():
        x = VPSDE(eps=module, shape=(window * 2, size, size)).sample((2,), steps=64, generator=generator)
    w = vorticity(x.reshape(2, -1, 2, size, size))

    logger.finish()
    print(f'{name}: done, sample vorticity std {float(w.std()):.3f}')

    return w


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--bf16', action='store_true', help='bf16 network compute (params stay f32)')
    parser.add_argument('--resume', action='store_true', help='continue from the latest checkpoint')
    parser.add_argument('--size', type=int, default=64, help='field resolution')
    parser.add_argument('--data', type=str, default=None,
                        help="dataset subdir (default: 'data' at 64, 'data<size>' otherwise)")
    parser.add_argument('--batch', type=int, default=None, help='batch size override (default: config 32)')
    parser.add_argument('--mesh', action='store_true', help='split batches over every rank of the launch')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    data = args.data or ('data' if args.size == 64 else f'data{args.size}')
    train(args.seed, args.epochs, args.bf16, args.resume, size=args.size, data=data,
          batch_size=args.batch, device=args.device, use_mesh=args.mesh)
    if dist.is_initialized():
        dist.destroy_process_group()

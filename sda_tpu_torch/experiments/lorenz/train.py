#!/usr/bin/env python
r"""Lorenz score training: the global model (a 1-D U-Net with time as space)
and the local one (an MLP window kernel).

Counterpart of ``experiments/lorenz/train.py``: the same configs (4096
epochs, batch 64, AdamW 1e-3, linear decay), a resumable checkpoint every
256 epochs and a final physics-consistency ``log_p`` over 4096 sampled local
windows or 1024 global trajectories at 64 steps.

    python -m sda_tpu_torch.experiments.lorenz.train --model local [--window 3] [--device cpu]
    torchrun --nproc_per_node 2 -m sda_tpu_torch.experiments.lorenz.train --model local --mesh

``--mesh`` splits each batch over every rank of a ``torchrun`` launch (data
parallelism; NCCL on the card, gloo with ``--device cpu``); rank 0 alone
writes the run directory and samples the final ``log_p``.

The command line reads ``storage/data/{train,valid}.h5`` (``h5py``);
:func:`train` also takes the splits as tensors.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Union

import torch
import torch.distributed as dist

from ...diffusion import VPSDE, MCScoreWrapper
from ...nn import reset_parameters
from ...parallel import make_mesh
from ...train import RunLogger, TrajectoryDataset, Trainer, restore_checkpoint, save_checkpoint, save_params
from ...utils import resolve_device, save_config, set_float32_precision
from .utils import PATH, make_chain, make_global_score, make_local_score

GLOBAL_CONFIG = {
    # Architecture
    'embedding': 32,
    'hidden_channels': (64,),
    'hidden_blocks': (3,),
    'activation': 'SiLU',
    # Training
    'epochs': 4096,
    'batch_size': 64,
    'optimizer': 'AdamW',
    'learning_rate': 1e-3,
    'weight_decay': 1e-3,
    'scheduler': 'linear',
}

LOCAL_CONFIG = {
    # Architecture
    'window': 5,
    'embedding': 32,
    'width': 256,
    'depth': 5,
    'activation': 'SiLU',
    # Training
    'epochs': 4096,
    'batch_size': 64,
    'optimizer': 'AdamW',
    'learning_rate': 1e-3,
    'weight_decay': 1e-3,
    'scheduler': 'linear',
}


def train(
    model: str,
    seed: int,
    epochs: Optional[int] = None,
    resume: bool = False,
    window: Optional[int] = None,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    trainset=None,
    validset=None,
    use_mesh: bool = False,
) -> Optional[float]:
    r"""Trains one run under ``path/runs`` and returns its final ``log_p``
    (``None`` on ranks other than 0).

    ``trainset``/``validset`` are ``(N, L, 3)`` standardized trajectories
    (default: the HDF5 splits under ``path/data``). ``use_mesh`` splits each
    batch over every rank of the process group (brought up from
    ``torchrun``'s environment if none is).
    """

    mesh = make_mesh(device=device) if use_mesh else None
    lead = mesh is None or dist.get_rank() == 0
    device = resolve_device(device)
    config = dict(GLOBAL_CONFIG if model == 'global' else LOCAL_CONFIG)
    if epochs is not None:
        config['epochs'] = epochs
    if window is not None and model == 'local':
        config['window'] = window

    if model == 'local' and window is not None:
        runpath = Path(path) / f'runs/local_k{config["window"] // 2}_{seed}'
    else:
        runpath = Path(path) / f'runs/{model}_{seed}'
    if lead:
        runpath.mkdir(parents=True, exist_ok=True)
        if not (runpath / 'config.json').exists():
            save_config(config, runpath)
        logger = RunLogger(runpath)
    generator = torch.Generator(device=device).manual_seed(seed)
    init = torch.Generator().manual_seed(seed)

    if model == 'global':
        module = make_global_score(**config)
        sde = VPSDE(shape=(32, 3))
        eps_wrapper = MCScoreWrapper
        window, flatten = 32, False
    else:
        window = config['window']
        module = make_local_score(**config)
        sde = VPSDE(shape=(window * 3,))
        eps_wrapper = None
        flatten = True
    module = reset_parameters(module, init).to(device)

    if trainset is None:
        trainset, validset = Path(path) / 'data/train.h5', Path(path) / 'data/valid.h5'
    trainset = TrajectoryDataset(trainset, window=window, flatten=flatten, device=device)
    validset = TrajectoryDataset(validset, window=window, flatten=flatten, device=device)

    trainer = Trainer(
        sde, module, trainset, validset, generator=generator, eps_wrapper=eps_wrapper, mesh=mesh, **config,
    )

    ckpt = runpath / 'checkpoint.msgpack'
    if resume and ckpt.exists():
        restore_checkpoint(trainer, ckpt)
        print(f'resumed at epoch {trainer.epoch}')

    for stats in trainer:
        if not lead:
            continue
        logger.log(stats, step=trainer.epoch)

        if trainer.epoch % 256 == 0:
            save_checkpoint(trainer, ckpt)
            save_params(module, runpath / 'state.msgpack')

    if not lead:
        return None
    save_params(module, runpath / 'state.msgpack')

    log_p = float(sample_log_p(module, model == 'local', window, generator).mean())

    logger.log({'log_p': log_p})
    logger.finish()
    print(f'{runpath.name}: final log_p = {log_p:.3f}')

    return log_p


@torch.no_grad()
def sample_log_p(
    module: torch.nn.Module, local: bool, window: int, generator: torch.Generator, steps: int = 64,
) -> torch.Tensor:
    r"""The mean transition log-density of each of 4096 sampled local
    windows (or 1024 global trajectories of 32 states) at ``steps`` sampler
    steps; a run's final ``log_p`` is their mean."""

    if local:
        x = VPSDE(eps=module, shape=(window * 3,)).sample((4096,), steps=steps, generator=generator)
        x = x.reshape(x.shape[0], -1, 3)
    else:
        x = VPSDE(eps=MCScoreWrapper(module), shape=(32, 3)).sample((1024,), steps=steps, generator=generator)

    chain = make_chain(device=x.device)
    x = chain.postprocess(x)

    return chain.log_prob(x[:, :-1], x[:, 1:]).mean(dim=-1)


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--model', choices=['global', 'local'], default='local')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--resume', action='store_true', help='continue from the latest checkpoint')
    parser.add_argument('--window', type=int, default=None, help='local window size 2k+1 (k-sweep)')
    parser.add_argument('--mesh', action='store_true', help='split batches over every rank of the launch')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    train(args.model, args.seed, args.epochs, args.resume, args.window, args.device, use_mesh=args.mesh)
    if dist.is_initialized():
        dist.destroy_process_group()

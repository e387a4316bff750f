#!/usr/bin/env python
r"""Memory probe of the guided loop-closure program with chunk and remat.

Counterpart of ``experiments/kolmogorov/hbm_probe.py``: what the chunked
window evaluation with per-chunk recomputation (``MCScoreNet(chunk,
remat=True)``) buys on the guided ``loop`` program, ``(samples, 127, 2, 64,
64)``, the largest shape of the scenario catalog. It runs the sampler for a
few ``--steps`` (memory does not depend on the step count: the state is one
trajectory batch) and prints one JSON line: the configuration, ``status``,
``wall_s``, ``finite`` and ``peak_memory_gb``, the card's peak allocated
memory in units of 2^30 bytes (``torch.cuda.max_memory_allocated``; ``null``
on the CPU, where it is not measured). Running out of device memory gives
``"status": "exec_failed"`` and exit code 1: that is the probe's finding.

Eager PyTorch has no compile step, so the JAX script's ``--compile-only``
is refused.

    python -m sda_tpu_torch.experiments.kolmogorov.hbm_probe --samples 16 --chunk 8 --remat [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ...diffusion import VPSDE, GaussianScore
from ...utils import resolve_device, set_float32_precision
from .assimilate import get_scenario
from .utils import PATH, load_score, make_trajectory_eps


def build(
    run: str, samples: int, length: int, chunk: Optional[int], remat: bool, steps: int, corrections: int,
    scenario: str = 'loop', data: str = 'data', path: Path = PATH, device: Union[str, torch.device] = 'cuda',
):
    r"""The guided sampler of ``scenario`` with ``{path}/runs/{run}``, its
    windows evaluated in chunks of ``chunk`` (each recomputed in the
    backward pass if ``remat``), as a function of a seed."""

    device = resolve_device(device)
    path = Path(path)
    module, config = load_score(path / f'runs/{run}', device=device)
    size = config.get('size', 64)

    if scenario == 'loop':
        x_star = torch.zeros((1, 2, size, size), device=device)  # loop closure reads no trajectory
    else:
        from ...train import load_h5

        x_star = torch.as_tensor(load_h5(path / f'{data}/test.h5')[0], dtype=torch.float32, device=device)
    A, y, std, length, gamma = get_scenario(scenario, x_star, np.random.RandomState(0), length_override=length)

    score = make_trajectory_eps(module, config.get('window', 5), chunk=chunk, remat=remat)
    sde = VPSDE(
        eps=GaussianScore(y=y, A=A, std=std, sde=VPSDE(eps=score, shape=()), gamma=gamma),
        shape=(length, 2, size, size),
    )

    def program(seed: int) -> torch.Tensor:
        generator = torch.Generator(device=device).manual_seed(seed)
        return sde.sample((samples,), steps=steps, corrections=corrections, tau=0.5, generator=generator)

    return program


def probe(
    run: str = 'unet_0', samples: int = 16, length: int = 127, chunk: Optional[int] = None, remat: bool = False,
    steps: int = 8, corrections: int = 1, scenario: str = 'loop', data: str = 'data', path: Path = PATH,
    device: Union[str, torch.device] = 'cuda',
) -> dict:
    r"""Runs one configuration; returns the JSON line's fields."""

    device = resolve_device(device)
    out = {
        'run': run, 'scenario': scenario, 'samples': samples, 'length': length,
        'chunk': chunk, 'remat': remat, 'steps': steps,
    }
    program = build(run, samples, length, chunk, remat, steps, corrections, scenario, data, path, device)
    cuda = device.type == 'cuda'

    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    try:
        x = program(0)
        finite = bool(torch.isfinite(x).all())  # waits for the device
    except torch.cuda.OutOfMemoryError as err:
        out['status'] = 'exec_failed'
        out['error'] = str(err)[:400]
    else:
        out['wall_s'] = round(time.time() - t0, 1)
        out['finite'] = finite
        out['status'] = 'executed'
    out['peak_memory_gb'] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3) if cuda else None

    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--run', type=str, default='unet_0')
    parser.add_argument('--samples', type=int, default=16)
    parser.add_argument('--length', type=int, default=127)
    parser.add_argument('--chunk', type=int, default=None)
    parser.add_argument('--remat', action='store_true')
    parser.add_argument('--steps', type=int, default=8)
    parser.add_argument('--corrections', type=int, default=1)
    parser.add_argument('--compile-only', action='store_true',
                        help='refused: eager PyTorch has no compile step to measure')
    parser.add_argument('--scenario', type=str, default='loop', help="scenario whose guided program to probe")
    parser.add_argument('--data', type=str, default='data', help="dataset subdir ('data256' for 256^2)")
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)
    if args.compile_only:
        parser.error('--compile-only is refused: eager PyTorch has no compile step; the probe executes the program')

    out = probe(args.run, args.samples, args.length, args.chunk, args.remat, args.steps, args.corrections,
                args.scenario, args.data, PATH, args.device)
    print(json.dumps(out), flush=True)
    sys.exit(0 if out['status'] == 'executed' else 1)


if __name__ == '__main__':
    set_float32_precision()
    main()

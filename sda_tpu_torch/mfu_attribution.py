#!/usr/bin/env python
r"""Splits the main path's guided-sampler time into four nested legs.

Counterpart of ``tools/mfu_attribution.py``: on the main path's workload
(``unet_0`` in its committed dtype, 32 frames, batch 4, window 5, so 28 x 4
= 112 windows; ``y`` coarsened from a simulated truth as the ``coarse``
scenario does) it times nested pieces and reports each one's analytic
TFLOP/s (:mod:`sda_tpu_torch.nn.flops`) and its share of the card's peak:

1. ``kernel_forward``: the raw window kernel on the 112 windows, the
   convolutions' ceiling;
2. ``score_forward``: ``MCScoreNet`` over the trajectory (unfold, kernel,
   fold); the gap to (1) is the windowing's;
3. ``guided_eval``: one ``GaussianScore`` evaluation, forward plus the
   input VJP at 2.0x the forward FLOPs; the gap to (2) is the VJP's and
   the guidance's;
4. ``sampler_per_eval``: ``VPSDE.sample`` at 16 steps x 1 correction, per
   evaluation; the gap to (3) is the predictor's, the corrector's and the
   loop's.

Each leg is timed over 8 calls after a warm-up call (the sampler over 2),
with ``torch.cuda.synchronize()`` on both sides. With ``--trace
DIR`` one more call of each leg runs inside
:class:`~sda_tpu_torch.utils.profile_trace`, which writes its trace under
``DIR/<leg>``, and the leg gets ``busy_pct``: the device's kernel time over
that call's wall. The sampler's traced call runs ``TRACE_STEPS`` steps, the
same loop body as the timed ones, so that its trace stays small. The peak is the H100 SXM's published dense rate for the
legs' dtype (bf16 989, TF32 495, float32 67 TFLOP/s; a float32 network
runs its convolutions in TF32 when ``torch.backends.cudnn.allow_tf32`` is
set, see :func:`~sda_tpu_torch.utils.set_float32_precision`); a card the
table does not know raises. On the CPU (``--device cpu``) ``mfu_pct``,
``busy_pct`` and ``peak_tflops`` are ``null``: a CPU time is no device
metric.

    python -m sda_tpu_torch.mfu_attribution [--trace DIR] [--out FILE] [--device cpu]

Prints one JSON line, also written to ``--out``: ``legs`` (each with
``wall_ms``, ``flops``, ``tflops``, ``mfu_pct``, ``busy_pct``),
``peak_tflops``, ``conv_ceiling_mfu_pct``, ``windowing_efficiency``,
``vjp_efficiency``, ``sampler_body_efficiency``, ``dtype``, ``device`` and
``card`` (``nvidia-smi``'s name and power limit).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from .diffusion import VPSDE, GaussianScore
from .experiments.kolmogorov.assimilate import coarse_scenario
from .experiments.kolmogorov.generate import simulate
from .experiments.kolmogorov.utils import load_score, make_chain, make_trajectory_eps
from .nn import guided_sampler_flops, score_unet_flops
from .utils import profile_trace, resolve_device, set_float32_precision

UNET_0 = Path(__file__).resolve().parents[1] / 'experiments/kolmogorov/storage/runs/unet_0'

#: Published dense peaks in TFLOP/s (NVIDIA's data sheet, SXM part, at the
#: full 700 W), by ``torch.cuda.get_device_name``.
PEAK_TFLOPS = {
    'NVIDIA H100 80GB HBM3': {'bf16': 989.0, 'tf32': 495.0, 'f32': 67.0},
}

CORRECTIONS = 1
REPS, SAMPLER_REPS = 8, 2
TRACE_STEPS = 2


def compute_dtype(config: dict, device: torch.device) -> str:
    r"""The dtype the window kernel's convolutions run in."""

    if config.get('bf16', False):
        return 'bf16'
    return 'tf32' if device.type == 'cuda' and torch.backends.cudnn.allow_tf32 else 'f32'


def peak_tflops(device: torch.device, dtype: str) -> Optional[float]:
    r"""The card's published peak for ``dtype``; ``None`` on the CPU."""

    if device.type != 'cuda':
        return None
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_TFLOPS:
        raise ValueError(f'no published peak for {name!r}; known: {sorted(PEAK_TFLOPS)}')
    return PEAK_TFLOPS[name][dtype]


def nvidia_smi() -> str:
    r"""``nvidia-smi``'s name and power limit of the cards."""

    done = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, timeout=60, check=True)
    return done.stdout.strip()


def synchronize(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def wall_per_call(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    r"""Seconds per call of ``fn`` over ``reps`` calls after one warm-up."""

    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / reps


def device_kernels(profiler) -> list:
    r"""The profiler's averages of the kernels that ran on the device. User
    annotations on the device timeline (such as the optimizer's step range)
    span kernels and are left out."""

    return [e for e in profiler.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, 'is_user_annotation', False)]


def busy_share(profiler, wall_s: float) -> Optional[float]:
    r"""The device's kernel time in a profiled window over its wall;
    ``None`` when the profiler saw no device time."""

    busy_us = sum(e.self_device_time_total for e in device_kernels(profiler))
    return busy_us / (wall_s * 1e6) if busy_us > 0 else None


def attribute(
    module: Callable,
    config: dict,
    x_star: torch.Tensor,
    batch: int = 4,
    steps: int = 16,
    trace: Optional[Union[str, Path]] = None,
) -> dict:
    r"""The four legs of the window kernel ``module`` (its run's ``config``)
    on the ``coarse`` scenario of the truth ``x_star (L, 2, H, W)``, on
    ``x_star``'s device, the sampler leg at ``steps`` x 1 correction;
    returns the JSON line's fields."""

    device = x_star.device
    window = config.get('window', 5)
    size = x_star.shape[-1]
    A, y, std, length, gamma = coarse_scenario(x_star, np.random.RandomState(0))
    n_windows = length - 2 * (window // 2)

    arch = {k: config[k] for k in ('embedding', 'hidden_channels', 'hidden_blocks', 'kernel_size') if k in config}
    per_window = score_unet_flops(channels=window * 2, context_channels=1, size=size, **arch)  # the forcing
    dtype = compute_dtype(config, device)
    peak = peak_tflops(device, dtype)

    gen = torch.Generator(device=device).manual_seed(2)
    xw = torch.randn((n_windows * batch, window * 2, size, size), generator=gen, device=device)
    tw = torch.full((n_windows * batch,), 0.5, device=device)
    xt = torch.randn((batch, length, 2, size, size), generator=gen, device=device)
    t = torch.tensor(0.5, device=device)

    score = make_trajectory_eps(module, window)
    guided = GaussianScore(y=y, A=A, std=std, sde=VPSDE(eps=score, shape=()), gamma=gamma)
    sde = VPSDE(eps=guided, shape=(length, 2, size, size))
    evals = steps * (1 + CORRECTIONS)

    def kernel_forward():
        with torch.no_grad():
            return module(xw, tw)

    def score_forward():
        with torch.no_grad():
            return score(xt, t)

    def guided_eval():
        return guided(xt, t)

    def sampler(steps=steps):
        return sde.sample((batch,), steps=steps, corrections=CORRECTIONS, tau=0.5,
                          generator=torch.Generator(device=device).manual_seed(4))

    forward = per_window * n_windows * batch
    legs = {}
    for name, fn, flops, reps_, per in (
        ('kernel_forward', kernel_forward, forward, REPS, 1),
        ('score_forward', score_forward, forward, REPS, 1),
        ('guided_eval', guided_eval, 2.0 * forward, REPS, 1),
        ('sampler_per_eval', sampler, guided_sampler_flops(per_window, n_windows, batch, steps, CORRECTIONS) / evals,
         SAMPLER_REPS, evals),
    ):
        wall = wall_per_call(fn, reps_, device) / per
        tflops = flops / wall / 1e12
        leg = {'wall_ms': 1e3 * wall, 'flops': flops, 'tflops': tflops,
               'mfu_pct': None if peak is None else 100 * tflops / peak, 'busy_pct': None}
        if trace is not None:
            with profile_trace(Path(trace) / name) as traced:
                t0 = time.perf_counter()
                sampler(TRACE_STEPS) if name == 'sampler_per_eval' else fn()
                synchronize(device)
                traced_s = time.perf_counter() - t0
            share = busy_share(traced.profiler, traced_s)
            leg['busy_pct'] = None if share is None else 100 * share
        if name == 'sampler_per_eval':
            leg['probe_steps'] = steps
            if trace is not None:
                leg['trace_steps'] = TRACE_STEPS
        legs[name] = leg
        print(f'{name}: {json.dumps(leg)}', file=sys.stderr, flush=True)

    k, s, g, f = (legs[n]['tflops'] for n in ('kernel_forward', 'score_forward', 'guided_eval', 'sampler_per_eval'))
    return {
        'legs': legs,
        'peak_tflops': peak,
        'conv_ceiling_mfu_pct': legs['kernel_forward']['mfu_pct'],
        'windowing_efficiency': s / k,
        'vjp_efficiency': g / s,
        'sampler_body_efficiency': f / g,
        'dtype': dtype,
        'device': torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu',
        'card': nvidia_smi() if device.type == 'cuda' else None,
        'workload': {'windows': n_windows * batch, 'length': length, 'batch': batch, 'window': window, 'size': size},
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--run', type=Path, default=UNET_0, help='run directory (config.json, state.msgpack)')
    parser.add_argument('--length', type=int, default=32, help='trajectory frames')
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--steps', type=int, default=16, help="the sampler leg's steps")
    parser.add_argument('--trace', type=Path, default=None, help='profile one call of each leg under DIR/<leg>')
    parser.add_argument('--out', type=Path, default=None, help='also write the JSON here')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    module, config = load_score(args.run, device=device)
    size = config.get('size', 64)
    # The truth as the main path simulates it: 4x the model's grid, twice
    # the frames kept, coarsened 4x.
    truth = simulate(make_chain(4 * size, device=device), batch=1, length=2 * args.length, keep=args.length,
                     coarse=4, generator=torch.Generator(device=device).manual_seed(0))[0]

    out = attribute(module, config, truth, args.batch, args.steps, args.trace)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + '\n')
    return out


if __name__ == '__main__':
    set_float32_precision()
    main()

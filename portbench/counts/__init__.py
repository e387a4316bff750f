r"""Frozen arithmetic of the benchmark: FLOPs, bytes and the card's peaks.

Copied from the port (``sda_tpu_torch/nn/flops.py``, ``chip_smoke.py``'s
``dft_bound_ms``) so that a later change to the program cannot move the
yardstick; each score network's own count is in its arch module
(``portbench/archs``). ``portbench/tests/test_portbench_counts.py`` pins
that the copies still equal the port's functions.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from portbench import archs

#: Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
#: full 700 W), in FLOP/s by compute dtype, and its HBM rate in bytes/s.
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12


def conv_flops(elems: int, c_in: int, c_out: int, kernel_elems: int) -> int:
    r"""One multiply-accumulate counted as 2 FLOPs."""

    return 2 * elems * c_in * c_out * kernel_elems


def dense_flops(features_in: int, features_out: int) -> int:
    return 2 * features_in * features_out


def window_flops(config: dict) -> int:
    r"""Forward FLOPs of one window of ``config``'s score network: its arch's
    ``window_flops`` (``portbench/archs/<arch>.py``)."""

    return archs.of(config).window_flops(config)


def guided_step_flops(config: dict, length: int, samples: int, corrections: int) -> float:
    r"""FLOPs of one sampler step: ``1 + corrections`` guided evaluations,
    each a forward and an input VJP (2.0x the forward) over every window of
    every sample. Remat's second forward is not counted."""

    windows = length - config['window'] + 1
    return 2.0 * window_flops(config) * windows * samples * (1 + corrections)


def train_step_flops(config: dict, batch: int) -> float:
    r"""FLOPs of one training step: forward, input and weight gradients (3.0x
    the forward) over the batch."""

    return 3.0 * window_flops(config) * batch


# -- The spectral solver -----------------------------------------------------


def dft_bound_ms(n: int, h: int, w: int, kh: int, fw: int) -> Tuple[float, str]:
    r"""Least time one real 2-D transform of ``n`` fields needs, either
    direction, whatever the algorithm: the larger of its operations,
    2.5 H W log2(H W) per field, over the float32 peak, and its bytes, each
    field and its truncated spectrum moved once, over the memory rate."""

    flops = n * 2.5 * h * w * math.log2(h * w)
    nbytes = 4 * n * (h * w + 2 * kh * fw)
    t_ops, t_bytes = flops / PEAK_FLOPS['float32'], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def kolmogorov_substeps(size: int, dt: float, reynolds: float = 1e3,
                        max_velocity: float = 5.0, courant: float = 0.5) -> int:
    r"""CFL substeps per transition of the Kolmogorov solver."""

    dx = 2 * math.pi / size
    dt_min = min(courant * dx / max_velocity, dx**2 / (2 * 2 / reynolds))
    return 1 if dt_min > dt else math.ceil(dt / dt_min)


def solver_transforms(config: dict, batch: int, transitions: int) -> Dict[str, Dict[int, int]]:
    r"""The transforms that a rollout of ``transitions`` transitions of
    ``batch`` velocity fields needs, from a velocity state to velocity frames:
    per kernel, the number of transforms of each size (fields per call).
    One forward of the 2 velocity components, then per CFL substep three RK
    stages of 4 inverse fields (u, v and two vorticity derivatives) and 1
    forward field, and per transition 2 inverse fields (the velocity frame)."""

    s = kolmogorov_substeps(config['size'], config['dt'])
    stages = 3 * s * transitions
    return {
        'rfft2': {2 * batch: 1, batch: stages},
        'irfft2': {4 * batch: stages, 2 * batch: transitions},
    }


def spectral_shape(config: dict) -> Tuple[int, int]:
    r"""``(Kh, Fw)`` of the 2/3-rule truncated spectra."""

    modes = int(config['size'] / 3.0) + 1
    return 2 * modes - 1, modes


def solver_bound_ms(config: dict, batch: int, transitions: int, kernel: str) -> float:
    r"""The least device time of ``kernel``'s transforms in such a rollout."""

    size = config['size']
    kh, fw = spectral_shape(config)
    return sum(count * dft_bound_ms(n, size, size, kh, fw)[0]
               for n, count in solver_transforms(config, batch, transitions)[kernel].items())


def solver_flops(config: dict, batch: int, transitions: int) -> float:
    r"""Analytic FLOPs of such a rollout: every transform at 2.5 H W log2(H W)
    per field, plus the pointwise arithmetic counted from the shapes, per RK
    stage: the stream function and the 4 spectra (10 ops per mode), the
    product ``u wa + v wb`` (3 per pixel), the forcing (2 per mode) and the
    stage's combination (6 per mode on average over the 3 stages, with the
    integrating factors)."""

    size = config['size']
    kh, fw = spectral_shape(config)
    fft = 2.5 * size * size * math.log2(size * size)
    fields = sum(n * count for kernel in ('rfft2', 'irfft2')
                 for n, count in solver_transforms(config, batch, transitions)[kernel].items())
    stages = 3 * kolmogorov_substeps(size, config['dt']) * transitions
    pointwise = stages * batch * ((10 + 2 + 6) * kh * fw + 3 * size * size)
    return fields * fft + pointwise

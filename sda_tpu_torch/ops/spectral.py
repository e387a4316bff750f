r"""Real-valued 2-D DFT with mode truncation, on ``(re, im)`` pairs.

Counterpart of :class:`sda_tpu.ops.spectral.RealDFT2`. Three methods:

- ``'matmul'``: basis contractions in plain torch (the plain version). The
  JAX package runs them at ``Precision.HIGHEST``; on a card that is true
  float32, so callers keep ``torch.backends.cuda.matmul.allow_tf32`` False
  (PyTorch's default, which ``utils.set_float32_precision`` keeps).
- ``'kernel'``: the CUDA kernel pair of :mod:`.dft_kernels` (its plain
  version on a CPU tensor).
- ``'fft'``: ``torch.fft.rfft2``/``irfft2``, the counterpart of the JAX
  package's XLA FFT method. Like it, it takes only the untruncated layout: a
  truncated ``'fft'`` falls back to ``'matmul'``.

``'auto'`` resolves through :func:`default_dft_method`: ``'kernel'`` on a CUDA
device and ``'matmul'`` elsewhere, so the solvers' transforms go through the
kernels on the card.
Basis convention: ``numpy.fft.rfft2`` (forward :math:`e^{-2\pi i k n / N}`
unnormalised, inverse scaled by :math:`1/N` per axis).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..utils import resolve_device
from . import dft_kernels

Tensor = torch.Tensor


def default_dft_method(device: Union[str, torch.device]) -> str:
    r"""The DFT method ``'auto'`` picks for ``device``: the CUDA kernels on a
    CUDA device, the basis contractions elsewhere. Counterpart of
    :func:`sda_tpu.ops.spectral.default_dft_method`, which picks by the JAX
    platform (``'matmul'`` on a TPU)."""

    return 'kernel' if torch.device(device).type == 'cuda' else 'matmul'


class RealDFT2:
    r"""Forward/inverse real 2-D DFT over the last two axes.

    Arguments:
        height, width: The grid size.
        method: ``'matmul'``, ``'kernel'``, ``'fft'`` or ``'auto'``.
        h_modes: Retained non-negative frequencies along axis -2 (``None`` =
            all): rows ``0..h_modes-1`` then ``-(h_modes-1)..-1``.
        w_modes: Retained frequencies along the last axis (``None`` = the
            half spectrum ``W//2 + 1``).
        device: Where the bases live (``'cuda'`` by default).
    """

    def __init__(
        self,
        height: int,
        width: int,
        method: str = 'auto',
        h_modes: int = None,
        w_modes: int = None,
        device: Union[str, torch.device] = 'cuda',
    ):
        device = resolve_device(device)
        if method == 'auto':
            method = default_dft_method(device)
        if method not in ('matmul', 'kernel', 'fft'):
            raise ValueError(f"unknown DFT method '{method}'")
        if method == 'fft' and not (h_modes is None and w_modes is None):
            method = 'matmul'  # torch.fft keeps every mode

        self.height = height
        self.width = width
        self.method = method
        self.device = device

        full_w = w_modes is None

        if h_modes is None:
            freqs_h = np.fft.fftfreq(height, d=1.0 / height)
        else:
            freqs_h = np.concatenate([np.arange(0, h_modes), np.arange(-(h_modes - 1), 0)])

        if w_modes is None:
            w_modes = width // 2 + 1
        freqs_w = np.arange(w_modes)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.freqs_h = f32(freqs_h)
        self.freqs_w = f32(freqs_w)
        self.spectral_shape = (len(freqs_h), w_modes)

        fw = freqs_w[:, None] * np.arange(width)[None, :]
        self.cos_w = f32(np.cos(2 * np.pi * fw / width))
        self.sin_w = f32(np.sin(2 * np.pi * fw / width))

        ah = freqs_h[:, None] * np.arange(height)[None, :]
        self.cos_h = f32(np.cos(2 * np.pi * ah / height))
        self.sin_h = f32(np.sin(2 * np.pi * ah / height))

        # Hermitian weights along the half axis: interior columns count twice.
        dw = np.full(w_modes, 2.0)
        dw[0] = 1.0
        if full_w and width % 2 == 0:
            dw[-1] = 1.0
        self.weight_w = f32(dw)

        self.plan = dft_kernels.Plan(height, width, freqs_h, w_modes, device) if method == 'kernel' else None

    def _bases(self):
        return self.cos_w, self.sin_w, self.cos_h, self.sin_h

    def rfft2(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        r"""Real ``(..., H, W)`` -> ``(re, im)`` of shape ``(..., *spectral_shape)``."""

        if self.method == 'matmul':
            return dft_kernels.rfft2_plain(x, *self._bases())
        if self.method == 'fft':
            out = torch.fft.rfft2(x)
            return out.real, out.imag

        batch = x.shape[:-2]
        x = x.reshape((-1,) + x.shape[-2:]).float().contiguous()
        re, im = dft_kernels.rfft2(x, *self._bases(), self.plan)

        return re.reshape(batch + re.shape[1:]), im.reshape(batch + im.shape[1:])

    def irfft2(self, re: Tensor, im: Tensor) -> Tensor:
        r"""``(re, im)`` of shape ``(..., *spectral_shape)`` -> real ``(..., H, W)``;
        dropped modes count as zero."""

        if self.method == 'matmul':
            return dft_kernels.irfft2_plain(re, im, *self._bases(), self.weight_w)
        if self.method == 'fft':
            return torch.fft.irfft2(torch.complex(re, im), s=(self.height, self.width))

        batch = re.shape[:-2]
        re = re.reshape((-1,) + re.shape[-2:]).float().contiguous()
        im = im.reshape((-1,) + im.shape[-2:]).float().contiguous()
        x = dft_kernels.irfft2(re, im, *self._bases(), self.weight_w, self.plan)

        return x.reshape(batch + x.shape[1:])

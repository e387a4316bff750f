r"""Spectral fidelity metrics for 2-D flow fields.

Counterpart of :mod:`sda_tpu.eval.spectra`: the isotropic energy spectrum of
velocity fields and the log-spectral distance between two ensembles. The
transforms go through :class:`~sda_tpu_torch.ops.RealDFT2`, untruncated, so
on the card through the CUDA DFT kernels; the shell binning runs on the host
in numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.spectral import RealDFT2

Tensor = torch.Tensor


def energy_spectrum(x: Tensor, dft: Optional[RealDFT2] = None) -> Tuple[np.ndarray, np.ndarray]:
    r"""Isotropic kinetic-energy spectrum of velocity fields
    ``(..., 2, H, W)`` on the :math:`[0, 2\pi]^2` torus: ``(k_centers, E)``
    with ``E[k]`` the shell-integrated energy density, averaged over all
    leading axes. ``dft`` defaults to an untruncated ``RealDFT2`` on ``x``'s
    device."""

    size = x.shape[-1]

    if dft is None:
        dft = RealDFT2(size, size, device=x.device)

    ur, ui = dft.rfft2(x[..., 0, :, :])
    vr, vi = dft.rfft2(x[..., 1, :, :])

    ka = dft.freqs_h.cpu().numpy()[:, None]
    kb = dft.freqs_w.cpu().numpy()[None, :]
    k = np.sqrt(ka**2 + kb**2)

    # Half-spectrum Hermitian weighting.
    weight = np.where((kb == 0) | (kb == size // 2), 1.0, 2.0)

    density = 0.5 * (ur**2 + ui**2 + vr**2 + vi**2)
    density = density.cpu().numpy() * weight / float(size) ** 4
    density = density.reshape(-1, *density.shape[-2:]).mean(axis=0)

    k_max = int(k.max())
    bins = np.arange(0.5, k_max + 0.5)
    centers = 0.5 * (bins[:-1] + bins[1:])

    flat_k = k.ravel()
    flat_d = density.ravel()

    spectrum = np.zeros(len(centers))
    for i in range(len(centers)):
        mask = (flat_k >= bins[i]) & (flat_k < bins[i + 1])
        spectrum[i] = flat_d[mask].sum()

    return centers, spectrum


def spectrum_distance(x: Tensor, y: Tensor, k_max: Optional[int] = None) -> float:
    r"""Log-spectral distance between two velocity ensembles: the RMS of
    ``log10 E_x(k) / E_y(k)`` over shells up to ``k_max`` (default: a third
    of the smaller grid)."""

    size = min(x.shape[-1], y.shape[-1])
    if k_max is None:
        k_max = int(size / 3.0)

    dft = RealDFT2(x.shape[-1], x.shape[-1], device=x.device)
    kx, ex = energy_spectrum(x, dft)

    dft_y = dft if y.shape[-1] == x.shape[-1] else RealDFT2(y.shape[-1], y.shape[-1], device=y.device)
    ky, ey = energy_spectrum(y, dft_y)

    n = min(len(ex), len(ey), k_max)
    ratio = np.log10(np.maximum(ex[:n], 1e-30) / np.maximum(ey[:n], 1e-30))

    return float(np.sqrt(np.mean(ratio**2)))

r"""Plain PyTorch reference of the Kolmogorov flow solver.

Incompressible 2-D Navier-Stokes in vorticity form on the periodic square
``[0, 2 pi)^2``, pseudo-spectral with ``torch.fft``: spectra keep the modes
of the 2/3 rule (``|k_a|, k_b < size / 3 + 1``), the viscosity ``1 /
reynolds`` and the linear drag are integrated exactly by integrating
factors, advection and the forcing ``-4 cos(4 b)`` (the curl of ``sin(4 b)``
along the first velocity component) by Kutta's RK3 over CFL substeps; the
velocity's mean decays by the drag alone. The prior is white noise
band-passed around wavenumber 4, made divergence-free and scaled to a top
speed of 3.

``precision='bfloat16'`` is the control: every transform's input and output
and every stage's state are rounded to bf16. Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor


class KolmogorovReference:
    def __init__(self, size: int, dt: float, device, reynolds: float = 1e3, drag: float = 0.1,
                 max_velocity: float = 5.0, courant: float = 0.5, precision: str = 'float32'):
        self.size = size
        self.round = (lambda a: a) if precision == 'float32' else (lambda a: a.to(torch.bfloat16).float())
        m = int(size / 3.0) + 1
        self.rows = torch.cat((torch.arange(m), torch.arange(size - m + 1, size))).to(device)
        self.cols = m
        ka = torch.cat((torch.arange(m), torch.arange(-(m - 1), 0))).float().to(device)[:, None]
        kb = torch.arange(m).float().to(device)[None, :]
        self.ka, self.kb = ka, kb
        k2 = ka**2 + kb**2
        self.k2 = k2
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)

        b = 2 * math.pi / size * (torch.arange(size, dtype=torch.float32, device=device) + 0.5)
        self.forcing = self.rfft2((-4 * torch.cos(4 * b)).expand(size, size))

        dx = 2 * math.pi / size
        dt_min = min(courant * dx / max_velocity, dx**2 / (4 / reynolds))
        self.substeps = 1 if dt_min > dt else math.ceil(dt / dt_min)
        h = dt / self.substeps
        self.h = h
        lin = -k2 / reynolds - drag
        self.e_full, self.e_half = torch.exp(lin * h), torch.exp(lin * h / 2)
        self.mean_decay = math.exp(-drag * h)

    def rfft2(self, x: Tensor) -> Tensor:
        return torch.fft.rfft2(self.round(x))[..., self.rows, :self.cols]

    def irfft2(self, spec: Tensor) -> Tensor:
        full = torch.zeros(spec.shape[:-2] + (self.size, self.size // 2 + 1), dtype=torch.complex64,
                           device=spec.device)
        full[..., self.rows, :self.cols] = spec
        return self.round(torch.fft.irfft2(full, s=(self.size, self.size)))

    def to_spectral(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        u, v = self.rfft2(x[..., 0, :, :]), self.rfft2(x[..., 1, :, :])
        return 1j * (self.ka * v - self.kb * u), x.mean(dim=(-2, -1))

    def velocity(self, w: Tensor) -> Tuple[Tensor, Tensor]:
        psi = w * self.inv_k2
        return 1j * self.kb * psi, -1j * self.ka * psi

    def to_velocity(self, w: Tensor, mean: Tensor) -> Tensor:
        u, v = self.velocity(w)
        return torch.stack((self.irfft2(u), self.irfft2(v)), dim=-3) + mean[..., None, None]

    def nonlinear(self, w: Tensor) -> Tensor:
        u, v = self.velocity(w)
        u, v = self.irfft2(u), self.irfft2(v)
        wa, wb = self.irfft2(1j * self.ka * w), self.irfft2(1j * self.kb * w)
        return self.forcing - self.rfft2(u * wa + v * wb)

    def substep(self, w: Tensor) -> Tensor:
        h, e1, e2 = self.h, self.e_half, self.e_full
        k1 = self.nonlinear(w)
        w2 = self.round_c(e1 * (w + h / 2 * k1))
        k2 = self.nonlinear(w2)
        w3 = self.round_c(e2 * w - h * e2 * k1 + 2 * h * e1 * k2)
        k3 = self.nonlinear(w3)
        return self.round_c(e2 * w + h / 6 * (e2 * k1 + 4 * e1 * k2 + k3))

    def round_c(self, w: Tensor) -> Tensor:
        return torch.complex(self.round(w.real), self.round(w.imag))

    def trajectory(self, x: Tensor, length: int) -> Tensor:
        r"""``length`` transitions of velocity fields ``(B, 2, H, W)``:
        ``(length, B, 2, H, W)``."""

        w, mean = self.to_spectral(x)
        frames = []
        for _ in range(length):
            for _ in range(self.substeps):
                w = self.substep(w)
            mean = mean * self.mean_decay**self.substeps
            frames.append(self.to_velocity(w, mean))
        return torch.stack(frames)

    def prior(self, noise: Tensor, peak: float = 4.0, top_speed: float = 3.0) -> Tensor:
        r"""The filtered divergence-free field of white ``noise (B, 2, H, W)``."""

        u, v = self.rfft2(noise[..., 0, :, :]), self.rfft2(noise[..., 1, :, :])
        k = torch.sqrt(self.k2)
        g = (k / peak) ** 2 * torch.exp(-((k / peak) ** 2))
        u, v = u * g, v * g
        d = (self.ka * u + self.kb * v) * self.inv_k2
        u, v = u - self.ka * d, v - self.kb * d
        uv = torch.stack((self.irfft2(u), self.irfft2(v)), dim=-3)
        speed = torch.sqrt(torch.sum(uv**2, dim=-3, keepdim=True))
        return uv * (top_speed / torch.amax(speed, dim=(-2, -1), keepdim=True))

r"""2-D Kolmogorov flow: a pseudo-spectral Navier-Stokes solver.

Counterpart of :class:`sda_tpu.dynamics.kolmogorov.KolmogorovFlow`, with the
same physics and numerics: vorticity form on the periodic square, spectra as
``(re, im)`` pairs truncated by the 2/3 rule, viscosity and drag integrated
exactly by an integrating factor, advection and forcing by classical RK3 over
CFL substeps. Every transform goes through :class:`~sda_tpu_torch.ops.RealDFT2`,
so on the card (``dft_method='auto'``) through the CUDA DFT kernels: 15 per
substep. Python loops take the place of ``fori_loop``/``scan``. States are
channel-first velocity fields ``(..., 2, H, W)``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..ops.spectral import RealDFT2
from . import ops
from .markov import MarkovChain

Tensor = torch.Tensor
Spectral = Tuple[Tensor, Tensor]  # (re, im)


class KolmogorovFlow(MarkovChain):
    r"""Incompressible 2-D Navier-Stokes with Kolmogorov forcing.

    Arguments:
        size: The grid size per axis.
        dt: The transition time step.
        reynolds: The Reynolds number (viscosity is ``1/reynolds``).
        forcing_wavenumber: The forcing wavenumber (``sin(k b)`` on u).
        forcing_magnitude: The forcing amplitude.
        drag: The linear drag coefficient.
        max_velocity: The velocity bound of the CFL substep estimate.
        courant: The Courant number of the CFL substep estimate.
        dft_method: ``'auto'``, ``'matmul'`` or ``'kernel'`` (see RealDFT2).
        device: Where the solver runs (``'cuda'`` by default).
    """

    def __init__(
        self,
        size: int = 256,
        dt: float = 0.01,
        reynolds: float = 1e3,
        forcing_wavenumber: int = 4,
        forcing_magnitude: float = 1.0,
        drag: float = 0.1,
        max_velocity: float = 5.0,
        courant: float = 0.5,
        dft_method: str = 'auto',
        device: Union[str, torch.device] = 'cuda',
    ):
        super().__init__()

        self.size = size
        self.dt = dt
        self.nu = 1.0 / reynolds
        self.drag = drag

        # Only the modes the 2/3 rule keeps: dealiasing is exact by
        # construction.
        modes = int(size / 3.0) + 1
        self.dft = RealDFT2(size, size, method=dft_method, h_modes=modes, w_modes=modes, device=device)
        self.device = self.dft.device

        self.ka = self.dft.freqs_h[:, None]
        self.kb = self.dft.freqs_w[None, :]
        self.k2 = self.ka**2 + self.kb**2
        self.inv_k2 = torch.where(self.k2 > 0, 1.0 / torch.where(self.k2 > 0, self.k2, 1.0), 0.0)

        # Curl of the forcing sin(k b) x_a-hat: -k cos(k b).
        b = 2 * math.pi / size * (torch.arange(size, dtype=torch.float32, device=self.device) + 0.5)
        curl_f = -forcing_magnitude * forcing_wavenumber * torch.cos(forcing_wavenumber * b)
        curl_f = curl_f.expand(size, size).contiguous()
        self.forcing_re, self.forcing_im = self.dft.rfft2(curl_f)

        # CFL substepping (the diffusion bound is kept for parity).
        dx = 2 * math.pi / size
        dt_advect = courant * dx / max_velocity
        dt_diffuse = dx**2 / (2 * 2 * self.nu)
        dt_min = min(dt_advect, dt_diffuse)

        self.steps = 1 if dt_min > dt else math.ceil(dt / dt_min)
        h = dt / self.steps

        # Exact integrating factors for the linear term -nu k^2 - drag.
        lin = -self.nu * self.k2 - drag
        self.h = h
        self.exp_full = torch.exp(lin * h)
        self.exp_half = torch.exp(lin * h / 2)
        self.mean_decay = math.exp(-drag * h)

    # -- Spectral <-> physical conversions ---------------------------------

    def to_spectral(self, x: Tensor) -> Tuple[Spectral, Tensor]:
        r"""Velocity ``(..., 2, H, W)`` -> (vorticity spectrum pair, mean)."""

        u = x[..., 0, :, :]
        v = x[..., 1, :, :]

        ur, ui = self.dft.rfft2(u)
        vr, vi = self.dft.rfft2(v)

        wr = -self.ka * vi + self.kb * ui
        wi = self.ka * vr - self.kb * ur

        mean = torch.stack((u.mean(dim=(-2, -1)), v.mean(dim=(-2, -1))), dim=-1)

        return (wr, wi), mean

    def _velocity_spectra(self, w: Spectral) -> Tuple[Spectral, Spectral]:
        r"""Stream-function inversion: u_hat = i kb psi, v_hat = -i ka psi."""

        wr, wi = w
        pr = wr * self.inv_k2
        pi = wi * self.inv_k2

        u_hat = (-self.kb * pi, self.kb * pr)
        v_hat = (self.ka * pi, -self.ka * pr)

        return u_hat, v_hat

    def to_velocity(self, w: Spectral, mean: Tensor) -> Tensor:
        r"""(vorticity spectrum pair, mean flow) -> velocity ``(..., 2, H, W)``."""

        u_hat, v_hat = self._velocity_spectra(w)

        u = self.dft.irfft2(*u_hat)
        v = self.dft.irfft2(*v_hat)

        return torch.stack((u, v), dim=-3) + mean[..., None, None]

    # -- Dynamics ----------------------------------------------------------

    def _nonlinear(self, w: Spectral) -> Spectral:
        r"""Dealiased advection + forcing: 4 inverse and 1 forward transforms."""

        wr, wi = w
        u_hat, v_hat = self._velocity_spectra(w)

        u = self.dft.irfft2(*u_hat)
        v = self.dft.irfft2(*v_hat)

        wa = self.dft.irfft2(-self.ka * wi, self.ka * wr)
        wb = self.dft.irfft2(-self.kb * wi, self.kb * wr)

        # The truncated forward transform is the 2/3-rule dealiasing.
        ar, ai = self.dft.rfft2(u * wa + v * wb)

        return (-ar + self.forcing_re, -ai + self.forcing_im)

    def substep(self, w: Spectral) -> Spectral:
        r"""One CFL substep: integrating-factor classical RK3 (Kutta)."""

        h = self.h
        e1 = self.exp_half
        e2 = self.exp_full
        wr, wi = w

        k1r, k1i = self._nonlinear(w)

        w2 = (e1 * (wr + h / 2 * k1r), e1 * (wi + h / 2 * k1i))
        k2r, k2i = self._nonlinear(w2)

        w3 = (
            e2 * wr - h * e2 * k1r + 2 * h * e1 * k2r,
            e2 * wi - h * e2 * k1i + 2 * h * e1 * k2i,
        )
        k3r, k3i = self._nonlinear(w3)

        return (
            e2 * wr + h / 6 * (e2 * k1r + 4 * e1 * k2r + k3r),
            e2 * wi + h / 6 * (e2 * k1i + 4 * e1 * k2i + k3i),
        )

    def _advance(self, w: Spectral, mean: Tensor) -> Tuple[Spectral, Tensor]:
        r"""Advances one transition (``self.steps`` substeps)."""

        for _ in range(self.steps):
            w = self.substep(w)

        return w, mean * self.mean_decay**self.steps

    def transition(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        r"""Deterministic transition on velocity fields (``generator`` unused)."""

        w, mean = self.to_spectral(x)
        w, mean = self._advance(w, mean)

        return self.to_velocity(w, mean)

    def trajectory(
        self,
        x: Tensor,
        length: int,
        last: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        r"""Rollout that stays in spectral space between transitions."""

        w, mean = self.to_spectral(x)

        xs = []
        for _ in range(length):
            w, mean = self._advance(w, mean)
            if not last:
                xs.append(self.to_velocity(w, mean))

        return self.to_velocity(w, mean) if last else torch.stack(xs)

    # -- Initial conditions ------------------------------------------------

    def prior(
        self,
        shape: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        max_velocity: float = 3.0,
        peak_wavenumber: float = 4.0,
    ) -> Tensor:
        r"""Filtered random divergence-free velocity field of batch ``shape``:
        white noise (from ``generator``, or ``noise`` of shape
        ``shape + (2, size, size)`` when given) band-passed near
        ``peak_wavenumber``, Leray-projected and scaled to a maximum speed of
        ``max_velocity``."""

        shape = tuple(shape)
        if noise is None:
            noise = torch.randn(
                shape + (2, self.size, self.size), generator=generator, device=self.device
            )
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)

        ur, ui = self.dft.rfft2(noise[..., 0, :, :])
        vr, vi = self.dft.rfft2(noise[..., 1, :, :])

        k = torch.sqrt(self.k2)
        g = (k / peak_wavenumber) ** 2 * torch.exp(-((k / peak_wavenumber) ** 2))

        ur, ui = ur * g, ui * g
        vr, vi = vr * g, vi * g

        dr = (self.ka * ur + self.kb * vr) * self.inv_k2
        di = (self.ka * ui + self.kb * vi) * self.inv_k2
        ur, ui = ur - self.ka * dr, ui - self.ka * di
        vr, vi = vr - self.kb * dr, vi - self.kb * di

        u = self.dft.irfft2(ur, ui)
        v = self.dft.irfft2(vr, vi)
        uv = torch.stack((u, v), dim=-3)

        speed = torch.sqrt(torch.sum(uv**2, dim=-3, keepdim=True))
        peak = torch.amax(speed, dim=(-2, -1), keepdim=True)

        return uv * (max_velocity / peak)

    coarsen = staticmethod(ops.coarsen)
    vorticity = staticmethod(ops.vorticity)

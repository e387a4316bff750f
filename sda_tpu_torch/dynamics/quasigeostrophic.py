r"""Two-layer quasi-geostrophic (QG) flow, a multi-field assimilation system.

Counterpart of :class:`sda_tpu.dynamics.quasigeostrophic.QuasiGeostrophic`,
with the same physics and numerics: rigid-lid two-layer QG on the periodic
square with equal layer depths, imposed baroclinic shear ``U_1 = -U_2 = U/2``,
background PV gradients ``beta +- kd^2 U / 2``, bottom drag on the lower
layer, spectral hyperviscosity integrated exactly by an integrating factor,
and the Kolmogorov solver's IF-RK3 stages over CFL substeps. Spectra are
``(re, im)`` pairs truncated by the 2/3 rule, so the quadratic terms are
dealiased by construction.

Every transform goes through :class:`~sda_tpu_torch.ops.RealDFT2`, so on the
card (``dft_method='auto'``) through the CUDA DFT kernels, one launch per
direction per call site: a tendency stacks the spectra of ``u``, ``v`` and
the PV's two derivatives into one pair for one inverse launch, then makes
one forward launch, so a substep makes 3 of each. Python loops take the
place of ``fori_loop``/``scan``. States are channel-first potential-vorticity
fields ``(..., 2, H, W)`` (layer 1, layer 2).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..ops.spectral import RealDFT2
from . import ops
from .markov import MarkovChain

Tensor = torch.Tensor
Spectral = Tuple[Tensor, Tensor]  # (re, im), layers stacked on axis -3


class QuasiGeostrophic(MarkovChain):
    r"""Two-layer quasi-geostrophic dynamics.

    Arguments:
        size: The grid size per axis.
        dt: The transition time step.
        beta: The planetary vorticity gradient.
        shear: The imposed baroclinic shear ``U`` (``U_1 = -U_2 = U/2``).
        deformation_wavenumber: The baroclinic deformation wavenumber
            ``k_d`` (coupling strength between the layers).
        drag: The bottom-drag coefficient on layer 2.
        hyperviscosity: The :math:`\nu_4` coefficient of :math:`\nabla^4`
            dissipation (``None``: scaled so that the cutoff mode damps
            strongly per substep).
        max_velocity / courant: The CFL substep estimate.
        dft_method: ``'auto'``, ``'matmul'``, ``'kernel'`` or ``'fft'`` (see
            RealDFT2).
        device: Where the solver runs (``'cuda'`` by default).
    """

    def __init__(
        self,
        size: int = 128,
        dt: float = 0.1,
        beta: float = 10.0,
        shear: float = 1.0,
        deformation_wavenumber: float = 8.0,
        drag: float = 0.2,
        hyperviscosity: Optional[float] = None,
        max_velocity: float = 5.0,
        courant: float = 0.5,
        dft_method: str = 'auto',
        device: Union[str, torch.device] = 'cuda',
    ):
        super().__init__()

        self.size = size
        self.dt = dt
        self.beta = beta
        self.u1 = shear / 2
        self.u2 = -shear / 2
        self.kd2 = deformation_wavenumber**2
        self.drag = drag

        modes = int(size / 3.0) + 1
        self.dft = RealDFT2(size, size, method=dft_method, h_modes=modes, w_modes=modes, device=device)
        self.device = self.dft.device

        # Axis -2 = y, axis -1 = x (zonal).
        self.ky = self.dft.freqs_h[:, None]
        self.kx = self.dft.freqs_w[None, :]
        self.neg_ky, self.neg_kx = -self.ky, -self.kx
        self.k2 = self.kx**2 + self.ky**2

        # Background PV gradients.
        self.q1y = beta + self.kd2 / 2 * shear
        self.q2y = beta - self.kd2 / 2 * shear

        # Per-mode inverse of q = A psi, A = [[-k2 - F, F], [F, -k2 - F]],
        # F = kd^2 / 2: det = k2 (k2 + 2F), zero (and its inverse 0) at k = 0.
        f_half = self.kd2 / 2
        det = self.k2 * (self.k2 + 2 * f_half)
        inv_det = torch.where(det > 0, 1.0 / torch.where(det > 0, det, 1.0), 0.0)
        self.inv_aa = (-self.k2 - f_half) * inv_det  # diagonal
        self.inv_ab = -f_half * inv_det  # off-diagonal

        # Mean-flow advection U_i and background gradients Q_iy, per layer.
        self.u_mean = torch.tensor([self.u1, self.u2], device=self.device).reshape(2, 1, 1)
        self.qgrad = torch.tensor([self.q1y, self.q2y], device=self.device).reshape(2, 1, 1)

        # CFL substepping (advecting speed ~ max_velocity + |U| / 2).
        dx = 2 * math.pi / size
        dt_min = courant * dx / (max_velocity + abs(shear) / 2)
        self.steps = 1 if dt_min > dt else math.ceil(dt / dt_min)
        h = dt / self.steps
        self.h = h

        if hyperviscosity is None:
            k_cut = float(modes - 1)
            hyperviscosity = 5.0 / (h * k_cut**4)
        self.nu4 = hyperviscosity

        lin = -self.nu4 * self.k2**2
        self.exp_full = torch.exp(lin * h)
        self.exp_half = torch.exp(lin * h / 2)

    # -- Inversion and conversions -------------------------------------------

    def _invert(self, q: Spectral) -> Spectral:
        r"""Potential vorticity -> streamfunction, per mode (2x2 solve), on a
        pair of ``(..., 2, K, F)`` spectra."""

        qr, qi = q
        q1r, q2r = qr[..., 0, :, :], qr[..., 1, :, :]
        q1i, q2i = qi[..., 0, :, :], qi[..., 1, :, :]

        p1r = self.inv_aa * q1r + self.inv_ab * q2r
        p2r = self.inv_ab * q1r + self.inv_aa * q2r
        p1i = self.inv_aa * q1i + self.inv_ab * q2i
        p2i = self.inv_ab * q1i + self.inv_aa * q2i

        return torch.stack((p1r, p2r), dim=-3), torch.stack((p1i, p2i), dim=-3)

    def to_spectral(self, x: Tensor) -> Spectral:
        r"""Physical PV ``(..., 2, H, W)`` -> spectral pair (one launch)."""

        return self.dft.rfft2(x)

    def to_physical(self, q: Spectral) -> Tensor:
        return self.dft.irfft2(*q)

    def streamfunction(self, x: Tensor) -> Tensor:
        r"""Physical PV -> physical streamfunction (both layers)."""

        return self.to_physical(self._invert(self.to_spectral(x)))

    # -- Dynamics ------------------------------------------------------------

    def _tendency(self, q: Spectral) -> Spectral:
        r"""Explicit tendency: advection, background terms and bottom drag.
        The spectra of ``u = -d psi/dy``, ``v = d psi/dx`` and the PV's two
        derivatives are written into one pair ``(..., 4, 2, K, F)`` for one
        inverse call; the product goes back in one forward call."""

        qr, qi = q
        pr, pi = self._invert(q)

        shape = qr.shape[:-3] + (4,) + qr.shape[-3:]
        re = torch.empty(shape, device=qr.device)
        im = torch.empty(shape, device=qr.device)

        # d/dx = i kx, d/dy = i ky in pair form; u's spectrum is -(d psi/dy).
        torch.mul(self.ky, pi, out=re[..., 0, :, :, :])
        torch.mul(self.neg_ky, pr, out=im[..., 0, :, :, :])
        torch.mul(self.neg_kx, pi, out=re[..., 1, :, :, :])
        torch.mul(self.kx, pr, out=im[..., 1, :, :, :])
        torch.mul(self.neg_kx, qi, out=re[..., 2, :, :, :])
        torch.mul(self.kx, qr, out=im[..., 2, :, :, :])
        torch.mul(self.neg_ky, qi, out=re[..., 3, :, :, :])
        torch.mul(self.ky, qr, out=im[..., 3, :, :, :])

        # Physical-space products (dealiased by the truncated transform).
        u, v, qx, qy = self.dft.irfft2(re, im).unbind(-4)
        adv_r, adv_i = self.dft.rfft2(u * qx + v * qy)

        # Mean-flow advection U_i dq_i/dx and background gradients Q_iy v_i.
        mean_r = -self.u_mean * re[..., 2, :, :, :] - self.qgrad * re[..., 1, :, :, :]
        mean_i = -self.u_mean * im[..., 2, :, :, :] - self.qgrad * im[..., 1, :, :, :]

        # Bottom drag -r nabla^2 psi_2 (layer 2 only).
        lap2_r = -self.k2 * pr[..., 1, :, :]
        lap2_i = -self.k2 * pi[..., 1, :, :]
        zeros = torch.zeros_like(lap2_r)
        drag_r = torch.stack((zeros, -self.drag * lap2_r), dim=-3)
        drag_i = torch.stack((zeros, -self.drag * lap2_i), dim=-3)

        return -adv_r + mean_r + drag_r, -adv_i + mean_i + drag_i

    def substep(self, q: Spectral) -> Spectral:
        r"""Integrating-factor classical RK3 (as in the Kolmogorov solver)."""

        h = self.h
        e1 = self.exp_half
        e2 = self.exp_full
        qr, qi = q

        k1r, k1i = self._tendency(q)

        q2 = (e1 * (qr + h / 2 * k1r), e1 * (qi + h / 2 * k1i))
        k2r, k2i = self._tendency(q2)

        q3 = (
            e2 * qr - h * e2 * k1r + 2 * h * e1 * k2r,
            e2 * qi - h * e2 * k1i + 2 * h * e1 * k2i,
        )
        k3r, k3i = self._tendency(q3)

        return (
            e2 * qr + h / 6 * (e2 * k1r + 4 * e1 * k2r + k3r),
            e2 * qi + h / 6 * (e2 * k1i + 4 * e1 * k2i + k3i),
        )

    def _advance(self, q: Spectral) -> Spectral:
        r"""Advances one transition (``self.steps`` substeps)."""

        for _ in range(self.steps):
            q = self.substep(q)

        return q

    def transition(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        r"""Deterministic transition on PV fields (``generator`` unused)."""

        return self.to_physical(self._advance(self.to_spectral(x)))

    def trajectory(
        self,
        x: Tensor,
        length: int,
        last: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        r"""Rollout that stays in spectral space between transitions: the
        time-major stack ``(length, *x.shape)``, or the final state if
        ``last``."""

        q = self.to_spectral(x)

        xs = []
        for _ in range(length):
            q = self._advance(q)
            if not last:
                xs.append(self.to_physical(q))

        return self.to_physical(q) if last else torch.stack(xs)

    # -- Initial conditions --------------------------------------------------

    def prior(
        self,
        shape: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None,
        amplitude: float = 5.0,
        peak_wavenumber: float = 6.0,
    ) -> Tensor:
        r"""Band-limited random PV in both layers of batch ``shape``, each
        layer scaled to an rms of ``amplitude``: white noise (from
        ``generator``, or ``noise`` of shape ``shape + (2, size, size)`` when
        given) band-passed near ``peak_wavenumber``."""

        shape = tuple(shape)
        if noise is None:
            noise = torch.randn(shape + (2, self.size, self.size), generator=generator, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)

        nr, ni = self.dft.rfft2(noise)

        k = torch.sqrt(self.k2)
        g = (k / peak_wavenumber) ** 2 * torch.exp(-((k / peak_wavenumber) ** 2))

        q = self.dft.irfft2(nr * g, ni * g)
        rms = torch.sqrt(torch.mean(q**2, dim=(-2, -1), keepdim=True))

        return q * (amplitude / rms)

    # -- Observation operators -----------------------------------------------

    coarsen = staticmethod(ops.coarsen)
    upsample = staticmethod(ops.upsample)
    vorticity = staticmethod(ops.vorticity)

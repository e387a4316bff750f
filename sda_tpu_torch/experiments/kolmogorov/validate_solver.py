#!/usr/bin/env python
r"""Physics gate of the pseudo-spectral Kolmogorov solver, run through the port.

Counterpart of ``experiments/kolmogorov/validate_solver.py``, with the same
criteria and thresholds, each asserted; the script exits non-zero on any
violation:

1. stationarity: after the spin-up the two halves of the window agree
   within 10% in mean energy, and the coefficient of variation of the
   ensemble-mean energy over time stays below 0.15;
2. spectrum shape: the energy spectrum E(k) peaks at k <= 2 (the inverse
   cascade), the enstrophy spectrum k^2 E(k) peaks within [2, 8] (forcing
   wavenumber 4 within a factor 2), and E(k) falls from its low-k maximum
   to the 2/3-rule cutoff by at least the k^-3 slope's 3 log10(k_cut / 4)
   orders of magnitude;
3. CFL honesty: every speed below 2 x max_velocity = 10;
4. sanity: every field finite.

The transforms go through the solver's ``RealDFT2``, so on the card through
the CUDA DFT kernels. The JSON report goes to
``storage/results/solver_validation.json``, the last field's vorticity to
``results/vorticity_sample.png``, and, where matplotlib is installed, the
spectrum and the energy history to ``results/solver_validation.png``; the
spectrum is printed too.

    python -m sda_tpu_torch.experiments.kolmogorov.validate_solver [--size 256] [--spinup 64] [--window 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ...dynamics import KolmogorovFlow, vorticity
from ...utils import resolve_device, set_float32_precision
from ...viz import RGBImage
from .utils import PATH, make_chain, vorticity2rgb

Tensor = torch.Tensor


def energy_spectrum(chain: KolmogorovFlow, x: Tensor) -> Tuple[np.ndarray, np.ndarray]:
    r"""Isotropic energy spectrum E(k) of velocity fields ``(..., 2, H, W)``
    through the solver's truncated transform: ``(k_centers, E)`` over unit
    shells from 0.5 to ``size / 2``, averaged over the leading axes."""

    r, i = chain.dft.rfft2(x[..., :2, :, :])  # u and v in one call
    (ur, vr), (ui, vi) = r.unbind(-3), i.unbind(-3)

    # Half spectrum: the interior columns count twice.
    kb = chain.kb[0]
    weight = torch.where((kb == 0) | (kb == chain.size // 2), 1.0, 2.0)
    density = 0.5 * (ur**2 + ui**2 + vr**2 + vi**2)
    density = density * weight / float(chain.size) ** 4

    k = np.sqrt(chain.k2.cpu().numpy())
    bins = np.arange(0.5, chain.size // 2)
    spectrum = np.zeros(len(bins) - 1)

    flat_k = k.ravel()
    flat_d = density.cpu().numpy().reshape(-1, flat_k.size).mean(axis=0)

    for n in range(len(bins) - 1):
        m = (flat_k >= bins[n]) & (flat_k < bins[n + 1])
        spectrum[n] = flat_d[m].sum()

    return 0.5 * (bins[:-1] + bins[1:]), spectrum


def main(
    size: int = 256,
    spinup: int = 64,
    window: int = 64,
    ensemble: int = 4,
    device: Union[str, torch.device] = 'cuda',
    path: Path = PATH,
    noise: Optional[Tensor] = None,
) -> dict:
    r"""Spins up ``ensemble`` prior states (from a generator seeded 0, or
    from the white ``noise`` given) for ``spinup`` transitions, records
    ``window`` more, and asserts the gate; returns the report, or raises
    ``SystemExit`` naming the failed checks."""

    device = resolve_device(device)
    chain = make_chain(size=size, device=device)

    x = chain.prior((ensemble,), generator=torch.Generator(device=device).manual_seed(0), noise=noise)
    x = chain.trajectory(x, length=spinup, last=True)
    xs = chain.trajectory(x, length=window)  # (window, ensemble, 2, H, W)

    energy = (0.5 * xs.square().mean(dim=(-3, -2, -1))).cpu().numpy()  # (window, ensemble)
    speed = xs.square().sum(dim=-3).sqrt()

    centers, spectrum = energy_spectrum(chain, xs[-1])
    enstrophy_spectrum = centers**2 * spectrum
    k_cut = (2.0 / 3.0) * (size // 2)  # the 2/3-rule dealiasing cutoff

    half = window // 2
    report = {
        'size': size,
        'substeps_per_dt': chain.steps,
        'mean_energy_first_half': float(energy[:half].mean()),
        'mean_energy_second_half': float(energy[half:].mean()),
        'energy_cv_over_time': float(energy.mean(axis=1).std() / energy.mean()),
        'max_speed': float(speed.max()),
        'spectrum_peak_k': float(centers[np.argmax(spectrum)]),
        'enstrophy_peak_k': float(centers[np.argmax(enstrophy_spectrum)]),
        # Measured at the cutoff, the last physically resolved wavenumber:
        # the bins beyond hold only what the truncation leaves.
        'spectrum_decay_orders': float(np.log10(
            spectrum[centers < 8].max()
            / max(spectrum[(centers >= 0.85 * k_cut) & (centers < k_cut)].mean(), 1e-30)
        )),
        # The k^-3 enstrophy-cascade slope from the forcing scale to the cutoff.
        'spectrum_decay_required': float(3.0 * np.log10(k_cut / 4.0)),
        'finite': bool(torch.isfinite(xs).all()),
    }

    checks = {
        'stationary_halves_within_10pct': abs(
            report['mean_energy_second_half'] - report['mean_energy_first_half']
        ) < 0.10 * report['mean_energy_first_half'],
        'energy_cv_below_0.15': report['energy_cv_over_time'] < 0.15,
        'energy_peak_at_large_scales': report['spectrum_peak_k'] <= 2.0,
        'enstrophy_peak_near_forcing': 2.0 <= report['enstrophy_peak_k'] <= 8.0,
        'spectrum_decay_sufficient': report['spectrum_decay_orders'] >= report['spectrum_decay_required'],
        'max_speed_below_2x_cfl_assumption': report['max_speed'] < 10.0,
        'all_finite': report['finite'],
    }
    report['checks'] = checks
    report['passed'] = all(checks.values())

    out = Path(path) / 'results/solver_validation.json'
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    print('energy spectrum E(k), k = 1..16: ' + ' '.join(f'{e:.3e}' for e in spectrum[:16]))

    try:
        import matplotlib

        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].loglog(centers, spectrum)
        axes[0].axvline(4, ls='--', c='grey')
        axes[0].set(xlabel='k', ylabel='E(k)', title='energy spectrum')
        axes[1].plot(energy.mean(axis=1))
        axes[1].set(xlabel='step', ylabel='energy', title='energy history')
        fig.tight_layout()
        fig.savefig(out.parent / 'solver_validation.png', dpi=120)
    except Exception as err:
        print(f'figures skipped: {err}')

    w = vorticity(xs[-1, 0]).cpu().numpy()
    scale = float(np.abs(w).max())
    RGBImage(vorticity2rgb(w, vmin=-scale, vmax=scale)).save(out.parent / 'vorticity_sample.png')

    if not report['passed']:
        failed = [name for name, ok in checks.items() if not ok]
        raise SystemExit(f'solver validation FAILED: {failed}')

    print('solver validation PASSED')
    return report


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--size', type=int, default=256)
    parser.add_argument('--spinup', type=int, default=64)
    parser.add_argument('--window', type=int, default=64)
    parser.add_argument('--ensemble', type=int, default=4)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    main(args.size, args.spinup, args.window, args.ensemble, device=args.device)

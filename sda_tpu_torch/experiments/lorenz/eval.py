#!/usr/bin/env python
r"""Lorenz evaluation: particle-filter ground truth against guided sampling.

Counterpart of ``experiments/lorenz/eval.py``: frozen observations of the
test trajectories (``lo``: every 8th frame of the first coordinate with
noise 0.05; ``hi``: every frame with noise 0.25), two independent particle
filter posteriors per index as ground truth (cached), then guided sampling
for each correction count, with the mean log-prior, the mean
log-likelihood and the W1 distance to the ground truth appended to
``results/stats_{freq}.csv``. Rows already in the file are skipped.

The JAX package samples every index at once under ``vmap``; here the
indices run one after another, each with its own observation.

    python -m sda_tpu_torch.experiments.lorenz.eval observations
    python -m sda_tpu_torch.experiments.lorenz.eval evaluate --run local_k2_0 --freq lo --indices 0 [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...diffusion import VPSDE, GaussianScore
from ...eval import emd
from ...train import append_csv, existing_csv_keys
from ...utils import resolve_device
from .utils import PATH, load_score, log_likelihood, log_prior, make_chain, make_trajectory_eps, posterior

Tensor = torch.Tensor


def make_observations(seed: int = 0, path: Path = PATH) -> None:
    r"""Writes the frozen observations ``{path}/results/obs.h5`` of the first
    65 frames of ``{path}/data/test.h5``, drawn with
    ``numpy.random.RandomState(seed)`` as the JAX experiment draws them."""

    import h5py

    from ...train import load_h5

    path = Path(path)
    x = load_h5(path / 'data/test.h5')[:, :65]
    rng = np.random.RandomState(seed)

    y_lo = rng.normal(x[:, ::8, :1], 0.05)
    y_hi = rng.normal(x[:, :, :1], 0.25)

    (path / 'results').mkdir(parents=True, exist_ok=True)
    with h5py.File(path / 'results/obs.h5', mode='w') as f:
        f.create_dataset('lo', data=y_lo)
        f.create_dataset('hi', data=y_hi)

    print(f'obs: lo {y_lo.shape}, hi {y_hi.shape}')


def load_observations(freq: str, path: Path = PATH) -> np.ndarray:
    import h5py

    with h5py.File(Path(path) / 'results/obs.h5', mode='r') as f:
        return f[freq][:]


def freq_params(freq: str) -> Tuple[float, int]:
    r"""``(sigma, step)``: ``lo`` is low frequency and low noise, ``hi``
    high frequency and high noise."""

    if freq == 'lo':
        return 0.05, 8
    else:
        return 0.25, 1


def observe_raw(x: Tensor) -> Tensor:
    r"""The observed first coordinate of raw (un-standardized) states."""

    return make_chain(device=x.device).preprocess(x)[..., :1]


def ensure_bpf(
    freq: str,
    y_all,
    indices: Sequence[int],
    samples: int = 1024,
    cache: Optional[Path] = None,
    device: Union[str, torch.device] = 'cuda',
) -> Dict[int, Tuple[Tensor, Tensor]]:
    r"""Two independent particle-filter posteriors per index, ``samples`` of
    each: ``{index: (x, x_)}`` on ``device``. Index ``i`` draws from a
    generator seeded with ``i``. With ``cache``, pairs are read from and
    written to ``{cache}/idx{i}.npz`` (the JAX experiment's layout)."""

    device = resolve_device(device)
    sigma, step = freq_params(freq)

    out = {}
    for i in indices:
        file = None if cache is None else Path(cache) / f'idx{i}.npz'
        if file is not None and file.exists():
            with np.load(file) as z:
                pair = z['x'][:samples], z['x_'][:samples]
            out[i] = tuple(torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in pair)
            continue

        generator = torch.Generator(device=device).manual_seed(i)
        y = torch.as_tensor(np.asarray(y_all[i]), dtype=torch.float32, device=device)
        out[i] = tuple(
            posterior(y, A=observe_raw, sigma=sigma, step=step, generator=generator, device=device)[:samples]
            for _ in range(2)
        )
        if file is not None:
            file.parent.mkdir(parents=True, exist_ok=True)
            np.savez(file, x=out[i][0].cpu().numpy(), x_=out[i][1].cpu().numpy())
        print(f'bpf[{freq}]: index {i}', flush=True)

    return out


def existing_rows(csv: Path) -> set:
    r"""The ``(index, run, corrections)`` keys already in a stats CSV."""

    return existing_csv_keys(csv, 3)


def evaluate(
    run: str,
    local: bool,
    freq: str,
    indices: Sequence[int],
    samples: int = 1024,
    steps: int = 256,
    corrections: Sequence[int] = (0, 1, 2, 4, 8, 16),
    obs=None,
    path: Path = PATH,
    runs: Optional[Path] = None,
    device: Union[str, torch.device] = 'cuda',
    draws: Optional[Callable[[int, int], Tuple[Tensor, Callable]]] = None,
) -> Dict[Tuple[str, str, str], Tuple[float, float, float]]:
    r"""Appends the ground-truth row and one row per correction count of each
    index to ``{path}/results/stats_{freq}.csv`` (``index,run,C,log_px,
    log_py,w1``), skipping rows already there; returns the rows written.

    ``obs`` holds the observations by index (default: ``results/obs.h5``),
    ``runs`` the run directories (default: ``{path}/runs``). The ground
    truth is cached under ``{path}/results/bpf_{freq}``. Index ``i`` at
    ``C`` corrections samples from a generator seeded with
    ``(1000 + i) * 1000 + C``, unless ``draws(i, C)`` gives ``(init,
    noise)`` (see :meth:`VPSDE.sample`).
    """

    device = resolve_device(device)
    path = Path(path)
    runs = path / 'runs' if runs is None else Path(runs)
    sigma, step = freq_params(freq)
    chain = make_chain(device=device)

    csv = path / f'results/stats_{freq}.csv'
    done = existing_rows(csv)
    if obs is None:
        obs = load_observations(freq, path)

    def y_of(i):
        return torch.as_tensor(np.asarray(obs[i]), dtype=torch.float32, device=device)

    bpf_pairs = ensure_bpf(freq, obs, indices, samples, cache=path / f'results/bpf_{freq}', device=device)

    written = {}

    def write(i, label, C, x, x_):
        log_px = float(log_prior(x).mean())
        log_py = float(log_likelihood(y_of(i), x, A=observe_raw, sigma=sigma, step=step).mean())
        w1 = emd(x, x_)
        append_csv(csv, f'{i},{label},{C},{log_px},{log_py},{w1}')
        done.add((str(i), label, str(C)))
        written[(str(i), label, str(C))] = (log_px, log_py, w1)
        print(f'{label}[{i}] C={C}:', log_px, log_py, w1, flush=True)

    for i in indices:
        if (str(i), 'ground-truth', '') not in done:
            write(i, 'ground-truth', '', *bpf_pairs[i])

    todo = [(C, i) for C in corrections for i in indices if (str(i), run, str(C)) not in done]
    if not todo:
        return written

    module, config = load_score(runs / run, local=local, device=device)
    score = make_trajectory_eps(module, local, config.get('window', 5))

    for C, i in todo:
        sde = VPSDE(
            eps=GaussianScore(
                y=y_of(i), A=lambda x: x[..., ::step, :1], std=sigma,
                sde=VPSDE(eps=score, shape=()), gamma=3e-2,
            ),
            shape=(65, 3),
        )
        init, noise = (None, None) if draws is None else draws(i, C)
        generator = torch.Generator(device=device).manual_seed((1000 + i) * 1000 + C)
        xs = sde.sample((samples,), steps=steps, corrections=C, tau=0.25, generator=generator,
                        init=init, noise=noise)
        write(i, run, C, chain.postprocess(xs), bpf_pairs[i][1])

    return written


def parse_indices(spec: str) -> list:
    r"""``'0-15'`` or ``'0,3,7'`` -> the list of indices."""

    out = []
    for part in spec.split(','):
        if '-' in part:
            a, b = part.split('-')
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('command', choices=['observations', 'evaluate'])
    parser.add_argument('--run', type=str, default='local_0')
    parser.add_argument('--local', action='store_true', default=True)
    parser.add_argument('--global', dest='local', action='store_false')
    parser.add_argument('--freq', choices=['lo', 'hi'], default='lo')
    parser.add_argument('--indices', type=str, default='0', help="e.g. '0-15' or '0,3,7'")
    parser.add_argument('--samples', type=int, default=1024)
    parser.add_argument('--steps', type=int, default=256)
    parser.add_argument('--corrections', type=str, default='0,1,2,4,8,16',
                        help='comma-separated Langevin correction counts')
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    if args.command == 'observations':
        make_observations()
    else:
        evaluate(
            args.run, args.local, args.freq, parse_indices(args.indices), args.samples, args.steps,
            corrections=tuple(int(c) for c in args.corrections.split(',')), device=args.device,
        )

#!/usr/bin/env python
r"""The JAX package's Lorenz ground-truth row for index 0 of ``lo`` and
``hi``, over three particle-filter seeds: the reference that
``chip_smoke.py`` gates the port's ground truth against.

As ``experiments/lorenz/eval.py`` computes the ``ground-truth`` row of
``stats_{freq}.csv``: two independent posteriors (16,384 particles, 64
transitions of burn-in, the bootstrap filter, 1,024 samples kept) from the
halves of ``jax.random.split(key(seed))``, then the mean log-prior of the
first, its mean log-likelihood of the observations, and the exact W1
between the two. Seed 0 is the key the experiment gives index 0.

Eight seeds, not three: at ``hi`` (65 observations, each followed by a
resampling) the filter keeps ~40 distinct ancestors of the first frame, so
``log_px`` varies by ~1 from seed to seed; three seeds gave a spread of 0.16,
from which the committed row itself lies 6 spreads away. Runs on the CPU
(~40 min: JAX's resampling draws M^2 Gumbel variables per observation):

    python tests/lorenz_bpf_reference.py
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / 'experiments/lorenz'))
sys.path.insert(0, str(REPO))

from utils import log_likelihood, log_prior, make_chain, posterior  # noqa: E402

from sda_tpu.eval import emd  # noqa: E402

SEEDS = tuple(range(8))
FREQS = {'lo': (0.05, 8), 'hi': (0.25, 1)}


def ground_truth(freq: str, samples: int = 1024):
    r"""The row's statistics for each seed."""

    sigma, step = FREQS[freq]
    chain = make_chain()

    def A(x):
        return chain.preprocess(x)[..., :1]

    y = jnp.asarray(np.load(REPO / 'tests/golden/lorenz_eval_inputs.npz')[f'obs_{freq}'], jnp.float32)
    draw = jax.jit(lambda key: posterior(key, y, A=A, sigma=sigma, step=step)[:samples])

    rows = []
    for seed in SEEDS:
        k1, k2 = jax.random.split(jax.random.key(seed))
        x, x_ = np.asarray(draw(k1)), np.asarray(draw(k2))
        rows.append({
            'log_px': float(jnp.mean(log_prior(jnp.asarray(x)))),
            'log_py': float(jnp.mean(log_likelihood(y, jnp.asarray(x), A=A, sigma=sigma, step=step))),
            'w1': emd(x, x_),
        })
        print(freq, seed, rows[-1], file=sys.stderr, flush=True)
    return rows


def main():
    out = {}
    for freq in FREQS:
        rows = ground_truth(freq)
        out[freq] = {'seeds': list(SEEDS)}
        for stat in ('log_px', 'log_py', 'w1'):
            values = [row[stat] for row in rows]
            out[freq][stat] = {'values': values, 'mean': float(np.mean(values)),
                               'spread': float(np.max(values) - np.min(values))}
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()

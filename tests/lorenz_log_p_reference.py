#!/usr/bin/env python
r"""The JAX package's final Lorenz ``log_p`` for two committed runs, over
three sampler seeds: the reference that ``chip_smoke.py`` gates the port's
``log_p`` against.

As ``experiments/lorenz/train.py`` ends a run: ``VPSDE.sample`` at 64 steps
(ddim, no corrections) of 4096 local windows (``local_k2_0``) or 1024 global
trajectories of 32 states (``global_0``), un-standardized, then the mean
transition log-density under ``NoisyLorenz63``, with the median over
windows beside it: a single sample off the attractor moves the mean by
orders of magnitude (``local_k2_0`` at seed 2), never the median. Runs on
the CPU:

    python tests/lorenz_log_p_reference.py
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

from utils import load_score, make_chain  # noqa: E402

from sda_tpu.diffusion import VPSDE, MCScoreWrapper, bind_eps  # noqa: E402

SEEDS = (0, 1, 2)


def log_p(run: str, seed: int) -> np.ndarray:
    local = run.startswith('local')
    module, params, config = load_score(REPO / 'experiments/lorenz/storage/runs' / run, local=local)
    eps = bind_eps(module, params)
    key = jax.random.key(seed)

    if local:
        window = config['window']
        x = VPSDE(eps=eps, shape=(window * 3,)).sample(key, (4096,), steps=64)
        x = x.reshape(x.shape[0], -1, 3)
    else:
        x = VPSDE(eps=MCScoreWrapper(eps), shape=(32, 3)).sample(key, (1024,), steps=64)

    chain = make_chain()
    x = chain.postprocess(x)

    return np.asarray(jnp.mean(chain.log_prob(x[:, :-1], x[:, 1:]), axis=-1))


def main():
    out = {}
    for run in ('local_k2_0', 'global_0'):
        per_window = [log_p(run, seed) for seed in SEEDS]
        out[run] = {'seeds': list(SEEDS)}
        for stat in ('mean', 'median'):
            values = [float(getattr(np, stat)(v)) for v in per_window]
            out[run][stat] = {'values': values, 'mean': float(np.mean(values)),
                              'spread': float(np.max(values) - np.min(values))}
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()

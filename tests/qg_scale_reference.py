#!/usr/bin/env python
r"""The JAX package's per-layer QG data scale: the reference that
``chip_smoke.py`` gates the port's ``scale`` against.

Runs ``experiments/qg/generate.py``'s ``main`` at its published settings
(128^2, dt 0.1, 128 burn-in transitions, 64 kept frames, coarsened 2x) for
``SEEDS``, 8 trajectories each, and prints the mean over the seeds of each
layer's standard deviation (the ``scale`` that ``generate.py`` divides by)
and its spread (max - min over the seeds). The data go to a temporary
``SCRATCH`` directory. Runs on the CPU, in about 3.5 minutes on 8 cores:

    python tests/qg_scale_reference.py

Its output, which ``chip_smoke.py`` keeps as ``QG_SCALE_REFERENCE``:
``{"mean": [20.951797485351562, 12.084048509597778], "spread":
[1.794342041015625, 1.1476202011108398]}``.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

SEEDS = (0, 1, 2, 3)
TRAJECTORIES = 8

REPO = Path(__file__).resolve().parents[1]


def main():
    with tempfile.TemporaryDirectory() as tmp:
        os.environ['SCRATCH'] = tmp

        import jax

        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_default_matmul_precision', 'highest')

        sys.path.insert(0, str(REPO / 'experiments/qg'))
        sys.path.insert(0, str(REPO))
        import generate  # noqa: E402

        scales = []
        for seed in SEEDS:
            generate.main(trajectories=TRAJECTORIES, chunk=TRAJECTORIES, seed=seed)
            scale = json.loads((generate.PATH / 'data/scale.json').read_text())['scale']
            print(f'seed {seed}: scale {scale}', flush=True)
            scales.append(scale)

    scales = np.asarray(scales)
    mean, spread = scales.mean(axis=0), scales.max(axis=0) - scales.min(axis=0)
    print(json.dumps({'seeds': list(SEEDS), 'trajectories': TRAJECTORIES,
                      'mean': mean.tolist(), 'spread': spread.tolist()}))


if __name__ == '__main__':
    main()

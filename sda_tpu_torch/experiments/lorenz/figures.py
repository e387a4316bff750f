#!/usr/bin/env python
r"""Lorenz statistics figure and summary tables from the evaluation CSVs.

Counterpart of ``experiments/lorenz/figures.py``: per (model, corrections)
the medians of log-prior, log-likelihood and W1 against the particle-filter
ground truth, for the ``lo`` and ``hi`` observation settings, printed as
markdown tables with the seed spread, and drawn as corrections-vs-metric
panels to ``results/statistics.png`` where matplotlib is installed. The
standard output is the JAX script's, byte for byte.

    python -m sda_tpu_torch.experiments.lorenz.figures [--runs local_k1_0,...] [--spread-c 8] [--spread-freq lo]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...utils import set_float32_precision
from .utils import PATH

COLUMNS = ['index', 'run', 'corrections', 'log_px', 'log_py', 'w1']


def load_stats(freq: str):
    rows = []
    seen = set()
    csv = PATH / f'results/stats_{freq}.csv'
    if not csv.exists():
        return rows
    for line in csv.read_text().splitlines():
        parts = line.split(',')
        if len(parts) != 6:
            continue
        # Re-runs of a grid cell append a second row with the same
        # (index, run, corrections) key; the last supersedes the stale one.
        key = (parts[0], parts[1], parts[2])
        if key in seen:
            rows = [r for r in rows if (str(r['index']), r['run'], '' if r['corrections'] is None else str(r['corrections'])) != key]
        seen.add(key)
        rows.append({
            'index': int(parts[0]),
            'run': parts[1],
            'corrections': None if parts[2] == '' else int(parts[2]),
            'log_px': float(parts[3]),
            'log_py': float(parts[4]),
            'w1': float(parts[5]),
        })
    return rows


def medians(rows, run, C=None):
    sel = [r for r in rows if r['run'] == run and r['corrections'] == C]
    if not sel:
        return None
    return {
        k: float(np.median([r[k] for r in sel]))
        for k in ('log_px', 'log_py', 'w1')
    } | {'n': len(sel)}


def main(runs, out: Path = None, show_table: bool = True):
    corrections = (0, 1, 2, 4, 8, 16)

    table = {}
    for freq in ('lo', 'hi'):
        rows = load_stats(freq)
        table[freq] = {'ground-truth': medians(rows, 'ground-truth')}
        for run in runs:
            table[freq][run] = {
                C: medians(rows, run, C) for C in corrections
            }

    if show_table:
        for freq in ('lo', 'hi'):
            gt = table[freq]['ground-truth']
            if gt is None:
                continue
            print(f"\n### {freq} — medians over indices "
                  f"(BPF floor: log-prior {gt['log_px']:.1f}, "
                  f"log-lik {gt['log_py']:.2f}, W1 {gt['w1']:.2f}; "
                  f"n={gt['n']})\n")
            print('| model | ' + ' | '.join(f'W1@C={c}' for c in corrections)
                  + ' | log-prior@C=16 |')
            print('|---|' + '---|' * (len(corrections) + 1))
            for run in runs:
                cells = []
                for C in corrections:
                    m = table[freq][run][C]
                    cells.append(f"{m['w1']:.1f}" if m else '—')
                m16 = table[freq][run][16]
                tail = f"{m16['log_px']:.1f}" if m16 else '—'
                print(f'| {run} | ' + ' | '.join(cells) + f' | {tail} |')

    # Figure: each metric against the corrections, the ground truth dashed.
    try:
        import matplotlib

        matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 3, figsize=(12, 6), sharey='row')
        metrics = ('log_px', 'log_py', 'w1')
        labels = (r'log p(x_2:L | x_1)', r'log p(y | x)', 'W1')

        for i, freq in enumerate(('lo', 'hi')):
            gt = table[freq]['ground-truth']
            for j, (m, lab) in enumerate(zip(metrics, labels)):
                ax = axes[i, j]
                if gt:
                    ax.axvline(gt[m], ls='--', c='r', label='BPF')
                for run in runs:
                    pts = [
                        (table[freq][run][C][m], C)
                        for C in corrections
                        if table[freq][run][C]
                    ]
                    if pts:
                        ax.plot(*zip(*pts), '-o', ms=3, label=run)
                ax.set_yscale('symlog', base=2, linthresh=1)
                ax.set_yticks(corrections)
                ax.set_yticklabels(corrections)
                if m == 'log_px':
                    ax.set_xlim(-300, 150)
                ax.set_xlabel(f'{lab} ({freq})')
                ax.grid(alpha=0.3)
        axes[0, 0].set_ylabel('corrections')
        axes[1, 0].set_ylabel('corrections')
        axes[0, 2].legend(fontsize=7)

        fig.tight_layout()
        out = out or (PATH / 'results/statistics.png')
        fig.savefig(out, dpi=130)
        print(f'\nfigure -> {out}')
    except Exception as err:
        print(f'figure skipped: {err}')


def seed_spread(families=('local_k1', 'local_k2', 'local_k3', 'local_k4', 'global'),
                seeds=(0, 1, 2), C=8, freq='lo'):
    r"""Mean +/- spread of per-seed median W1 at one grid cell.

    Every model is trained from 3 seeds; this summarizes the seed
    variability at the (freq, C) cell where all seeds were evaluated.
    Per-seed medians are taken over the common index set so seeds with
    different evaluated index ranges stay comparable.
    """

    rows = load_stats(freq)

    # Common index set = intersection over every (family, seed) pair that
    # has any rows at this cell; families with no seed evaluated here are
    # dropped (reported), never silently compared over unequal index sets.
    index_sets = {}
    for fam in families:
        for s in seeds:
            idx = {
                r['index'] for r in rows
                if r['run'] == f'{fam}_{s}' and r['corrections'] == C
            }
            if idx:
                index_sets[(fam, s)] = idx

    evaluated_families = [
        fam for fam in families if any(f == fam for f, _ in index_sets)
    ]
    if not index_sets:
        print(f'\nseed spread — {freq}, C={C}: no evaluated (family, seed) '
              'pairs in the CSVs; skipping.')
        return

    indices = set.intersection(*index_sets.values())
    if not indices:
        print(f'\nseed spread — {freq}, C={C}: evaluated index sets are '
              'disjoint across seeds; skipping (refusing to compare seeds '
              'over different indices).')
        return

    print(f'\n### seed spread — {freq}, C={C}, median W1 over the '
          f'{len(indices)} indices common to all evaluated (family, seed) '
          f'pairs (3 training seeds)\n')
    print('| model | W1 per seed | mean ± spread |')
    print('|---|---|---|')
    printed = False
    for fam in evaluated_families:
        per_seed = []
        for s in seeds:
            sel = [
                r['w1'] for r in rows
                if r['run'] == f'{fam}_{s}' and r['corrections'] == C
                and r['index'] in indices
            ]
            if sel:
                per_seed.append(float(np.median(sel)))
        if not per_seed:
            continue
        mean = float(np.mean(per_seed))
        spread = (max(per_seed) - min(per_seed)) / 2
        cells = ', '.join(f'{v:.2f}' for v in per_seed)
        print(f'| {fam} | {cells} | {mean:.2f} ± {spread:.2f} |')
        printed = True
    if not printed:
        print('| (no rows) | — | — |')


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        '--runs', type=str,
        default='local_k1_0,local_k2_0,local_k3_0,local_k4_0,global_0',
    )
    parser.add_argument('--spread-c', type=int, default=8,
                        help='corrections cell for the seed-spread table')
    parser.add_argument('--spread-freq', type=str, default='lo')
    args = parser.parse_args()

    runs = args.runs.split(',')
    main(runs)

    # Seed spread over the families named in --runs (strip the seed suffix)
    # instead of a hard-coded list, so absent runs are never tabulated.
    families = []
    for r in runs:
        fam = r.rsplit('_', 1)[0]
        if fam not in families:
            families.append(fam)
    seed_spread(tuple(families), C=args.spread_c, freq=args.spread_freq)

r"""The port's benchmark: one cell of ``BENCHMARK.json`` per process.

    python3 -m portbench.run --workload assim64 --seed 12345 --seconds 30 --trace 0

In order: the port's command-line float32 precision; a check that the card
is there (no fallback to the CPU); set-up, which reads the run's parameters
(or draws them from the seed), builds the program and warms up the cell's own
shapes (``setup_s``); a window of ``--seconds`` of closed-loop work, each
unit issued when the last one was, with the peak memory reset at its start;
with ``--trace 1`` a short profiled window after it; then, with the
program's state freed, the comparison of what the window produced with the
plain reference. The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.

Everything that belongs to a configuration, a cell or a metric is a file found
by its name: ``configs/<config>.json``, ``archs/<arch>.py`` (the score
network a configuration names), ``workloads/<cell>.json`` (its driver kind,
traffic and limits), ``drivers/<kind>.py`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Compile caches of Triton and ``torch.compile``, at fixed paths inside the
#: checkout (the DFT kernels build under ``sda_tpu_torch/csrc/build``).
CACHES = {'TRITON_CACHE_DIR': BENCH / '.cache' / 'triton', 'TORCHINDUCTOR_CACHE_DIR': BENCH / '.cache' / 'inductor'}
#: Top-level modules that may not be loaded once the window has closed.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'sda_tpu')


def load(kind: str, name: str):
    r"""The module ``portbench/<kind>/<name>.py``."""

    path = BENCH / kind / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'portbench_{kind}_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def parameters(config: dict, seed: int, device) -> dict:
    r"""The run's parameters as a flat tree: read from ``config['weights']``
    where the configuration names a file, else drawn from ``seed`` on
    ``device`` by its arch's ``init_tree``."""

    from . import archs, weights
    from .seeds import generator

    if 'weights' in config:
        return weights.flat(weights.read_tree(ROOT / config['weights']))
    return archs.of(config).init_tree(config, generator(seed, 'params', device=device))


def forbidden_modules() -> List[str]:
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN))


def card() -> str:
    r"""``nvidia-smi``'s name and power limit of the card."""

    try:
        done = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f'nvidia-smi failed: {err}'
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else done.stderr.strip()


def selected(entries: List[dict], cell: str, reported: set) -> List[dict]:
    r"""The metrics of ``entries`` that ``cell`` reports: those that list it,
    and those without a list whose ``moves`` the cell reports."""

    out = []
    for m in entries:
        if 'workloads' in m:
            if cell in m['workloads']:
                out.append(m)
        elif 'moves' not in m or m['moves'] in reported:
            out.append(m)
    return out


def run_cell(
    cell: str,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    manifest: Optional[dict] = None,
    work: Optional[dict] = None,
    config: Optional[dict] = None,
    tree: Optional[dict] = None,
    inspect: Optional[Callable] = None,
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
) -> dict:
    r"""Runs one cell and returns its result line as a dict (the JSON object
    the command prints). ``manifest``, ``work``, ``config`` and ``tree``
    replace ``BENCHMARK.json``, the cell's file, its configuration's file and
    the run's parameters (:func:`parameters`; the tests run tiny cells on
    the CPU this way). ``inspect(driver)``, after the comparison, adds
    its return value under ``'readings'`` (the calibration reads the
    control there)."""

    import torch

    cuda = device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    manifest = manifest or read_json(ROOT / 'BENCHMARK.json')
    entry = next(w for w in manifest['workloads'] if w['name'] == cell)
    work = work or read_json(BENCH / 'workloads' / f'{cell}.json')
    config = config or read_json(BENCH / 'configs' / f"{entry['config']}.json")

    t0 = time.perf_counter()
    torch.zeros((), device=device)
    sync()
    t1 = time.perf_counter()
    if tree is None:
        tree = parameters(config, seed, device)
        sync()
    t2 = time.perf_counter()
    driver = load('drivers', work['driver']).Driver(config, work, seed, device, tree)
    sync()
    setup_s = time.perf_counter() - t0
    log(f'{cell}: set-up {setup_s:.3f} s (device context {t1 - t0:.3f} s, parameters {t2 - t1:.3f} s, '
        f'program built and warmed up {t0 + setup_s - t2:.3f} s)')

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    counts = 0
    t0 = time.perf_counter()
    while True:
        counts += driver.unit()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f'{cell}: {counts} {driver.count_name}s in {window_s:.3f} s')

    traced, breakdown = None, None
    if trace:
        from . import trace as tracing

        done = [0]

        def traced_units():
            done[0] = 0
            for _ in range(work['trace_units']):
                done[0] += driver.unit()

        t1 = time.perf_counter()
        dev, _, trace_s = tracing.profile(traced_units, device, host=False)
        traced = {'dev': dev, 'window_s': trace_s, 'counts': done[0], 'units': work['trace_units'],
                  'busy_s': tracing.busy_seconds(dev)}
        gap_dev, gap_host, _ = tracing.profile(traced_units, device, host=True)
        breakdown = tracing.breakdown(dev, gap_dev, gap_host)
        log(f'{cell}: traced {traced["counts"]} {driver.count_name}s, {len(dev)} device operations, '
            f'{trace_s:.3f} s window; traced again with the host\'s operators; read in '
            f'{time.perf_counter() - t1:.1f} s')
    peak = max(setup_peak, window_peak, torch.cuda.max_memory_allocated(device) if cuda else 0)

    driver.release()
    t1 = time.perf_counter()
    checks = driver.check()
    log(f'{cell}: comparison with the reference in {time.perf_counter() - t1:.1f} s')

    run = {'cell': cell, 'cuda': cuda, 'config': config, 'work': work, 'setup_s': setup_s, 'window_s': window_s,
           'counts': counts, 'window_peak_bytes': window_peak, 'flops_per_count': driver.flops_per_count,
           'peak_flops': driver.peak_flops, 'trace': traced}
    e2e = selected(manifest['end_to_end'], cell, set())
    reported = {m['name'] for m in e2e}
    metrics = {}
    for m in (selected(manifest['per_layer'], cell, reported) if trace else e2e):
        value = load('metrics', m['name']).read(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    failed = [name for name, value, limit in checks
              if limit is None or not math.isfinite(value) or value > limit]
    result = {
        'correct': not failed,
        'attempted': counts,
        'failed': len(failed),
        'metrics': metrics,
        'device': {
            'platform': 'gpu' if cuda else 'cpu',
            'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
            'count': entry['chips'],
            'memory_peak_bytes': peak,
            'card': card() if cuda else 'cpu',
        },
    }
    if trace:
        result['device'].update(busy_s=traced['busy_s'], window_s=traced['window_s'])
        if breakdown is not None:
            result['breakdown'] = breakdown
    if inspect is not None:
        result['readings'] = inspect(driver)
    result['checks'] = {name: {'value': value, 'limit': limit} for name, value, limit in checks}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, path in CACHES.items():
        os.environ[var] = str(path)

    import torch

    from sda_tpu_torch.utils import set_float32_precision

    set_float32_precision()
    chips = next(w['chips'] for w in read_json(ROOT / 'BENCHMARK.json')['workloads'] if w['name'] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device('cuda'))

    found = forbidden_modules()
    if found:
        print(f'loaded in this process: {found}', file=sys.stderr)
        return 3
    print(result['device']['card'], file=sys.stderr)
    for name, c in result['checks'].items():
        ok = c['limit'] is not None and c['value'] <= c['limit']
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

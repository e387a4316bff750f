r"""Readings that the cells' limits are set from, on the card, at each cell's
own size: the comparison's numbers of sound runs of the program over many
seeds (the lower readings) and of the control, the plain reference in the
next precision below the configuration's, in the program's place (the upper
readings); for a training cell also of its planted faults. Not part of a
benchmark run.

    python3 -m portbench.control --workload assim64 --seeds 1,2,3 --seconds 30 --control-seeds 3 [--faults half_batch,leaf_doubled]

One JSON line per seed on standard output, and the same lines appended to
``chiprun_out/readings_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

from portbench import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True, help='comma-separated')
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--control-seeds', type=int, default=3, help='how many of the seeds also read the control')
    parser.add_argument('--faults', default='', help="comma-separated planted faults of a training cell")
    args = parser.parse_args(argv)

    for var, path in run.CACHES.items():
        os.environ[var] = str(path)

    import torch

    from sda_tpu_torch.utils import set_float32_precision

    set_float32_precision()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2

    manifest = run.read_json(run.ROOT / 'BENCHMARK.json')
    entry = next(w for w in manifest['workloads'] if w['name'] == args.workload)
    config = run.read_json(run.BENCH / 'configs' / f"{entry['config']}.json")
    faults = [f for f in args.faults.split(',') if f]
    work = run.read_json(run.BENCH / 'workloads' / f'{args.workload}.json')
    out = run.ROOT / 'chiprun_out' / f'readings_{args.workload}.jsonl'
    out.parent.mkdir(parents=True, exist_ok=True)

    for k, seed in enumerate(int(s) for s in args.seeds.split(',')):
        def inspect(driver, k=k):
            readings = {}
            if k < args.control_seeds:
                readings['control'] = driver.control()
                for fault in faults:
                    readings[fault] = driver.control(fault)
            return readings

        result = run.run_cell(args.workload, seed, args.seconds, False, torch.device('cuda'), manifest=manifest,
                              work=work, config=config, inspect=inspect)
        line = json.dumps({'seed': seed, 'metrics': result['metrics'], 'attempted': result['attempted'],
                           'program': result['checks'], 'readings': result['readings']})
        print(line, flush=True)
        with open(out, 'a') as f:
            f.write(line + '\n')
        del result
        gc.collect()
        torch.cuda.empty_cache()
    print(run.card(), file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())

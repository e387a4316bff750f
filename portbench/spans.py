r"""The program's own spans and counters (``sda_tpu_torch.tracing``) on the
profiler's clock, for the per-layer metrics that read them.

A window is profiled with the host's operators and the device, as
``trace.profile(host=True)`` does, with the program's spans on, and keeps
three things besides: each span (name, start, end), each device operation's
launch (the host's CUDA API call of the same correlation), and the change of
every counter. A device operation belongs to every span whose interval holds
the start of its launch, by time over all threads: the calling thread waits
inside ``autograd.grad`` and ``backward`` while autograd's worker launches
the backward's kernels. Times are in microseconds.

``run.py`` reads nothing of this: its windows run with the program's spans
off, as before. So :func:`reading` builds the cell's driver once more, after
the comparison, and profiles ``trace_units`` units of it, once per traced
run, kept in the run for every metric that reads it. It builds that driver
from the command line's ``--seed`` and the run's parameters
(``run.parameters``), so ``run_cell`` called in-process (no ``--seed``, and
perhaps a ``tree`` of its own) gives no reading. A program without
``sda_tpu_torch.tracing`` gives no reading either, and those metrics none.
"""

from __future__ import annotations

import argparse
import bisect
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch

from portbench import trace

#: The least share of the window's device operations whose launch was found
#: for a reading by span to be trusted.
MATCHED = 0.99

Span = Tuple[float, float]


def overlap(xs: List[Span], ys: List[Span]) -> float:
    r"""The length of the intersection of two unions of sorted disjoint
    intervals."""

    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read_events(events) -> dict:
    r"""A reading from the profiler's raw events (``kineto_results.events()``):
    ``dev``, the device operations as ``(name, start, end, launch start or
    None)``; ``spans``, each span name's intervals; ``matched``, the share of
    device operations whose launch was found.

    A device operation's launch is the host event of the same correlation id
    and the same linked (enclosing operator's) id; where two host events
    share both, none is taken."""

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, spans = [], {}, {}
    for e in events:
        start = e.start_ns() * 1e-3
        end = start + e.duration_ns() * 1e-3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((e.name(), start, end, (e.correlation_id(), e.linked_correlation_id())))
        elif e.is_user_annotation():
            spans.setdefault(e.name(), []).append((start, end))
        else:
            key = (e.correlation_id(), e.linked_correlation_id())
            host[key] = None if key in host else start
    dev = [(name, a, b, host.get(key)) for name, a, b, key in dev]
    matched = sum(launch is not None for *_, launch in dev) / len(dev) if dev else 0.0
    return {'dev': dev, 'spans': spans, 'matched': matched}


def measure(driver, units: int, device: torch.device) -> dict:
    r"""Runs ``units`` units of ``driver`` under the profiler with the
    program's spans on; the reading of :func:`read_events`, with
    ``window_s``, ``counts`` (what the units counted) and ``counters`` (each
    counter's change)."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from sda_tpu_torch import tracing

    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    before = dict(tracing.counters)
    with torch_profile(activities=activities) as prof:
        with tracing.enable():
            t0 = time.perf_counter()
            counts = sum(driver.unit() for _ in range(units))
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    out = read_events(prof.profiler.kineto_results.events())
    out.update(window_s=window_s, counts=counts,
               counters={k: v - before.get(k, 0) for k, v in tracing.counters.items()})
    return out


def intervals(reading: dict, name: str) -> List[Span]:
    r"""The union of ``name``'s spans, as sorted disjoint intervals."""

    return trace.union((name, a, b) for a, b in reading['spans'].get(name, []))


def device_seconds(reading: dict, name: str) -> float:
    r"""Summed device time of the operations launched inside ``name``'s
    spans."""

    spans = intervals(reading, name)
    starts = [a for a, _ in spans]
    total = 0.0
    for _, a, b, launch in reading['dev']:
        if launch is not None:
            k = bisect.bisect_right(starts, launch) - 1
            if k >= 0 and launch <= spans[k][1]:
                total += b - a
    return total * 1e-6


def gaps(reading: dict) -> List[Span]:
    r"""The device's idle gaps: those between the merged intervals of its
    operations."""

    busy = trace.union(op[:3] for op in reading['dev'])
    return [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]


def idle_seconds(reading: dict, name: str) -> float:
    r"""The device's idle time that falls inside ``name``'s spans."""

    return overlap(gaps(reading), intervals(reading, name)) * 1e-6


def trusted(reading: Optional[dict]) -> Optional[dict]:
    r"""``reading`` where it saw the device and found the launch of at least
    ``MATCHED`` of its operations, else ``None``."""

    return reading if reading is not None and reading['dev'] and reading['matched'] >= MATCHED else None


def command_seed(argv: Optional[List[str]] = None) -> Optional[int]:
    r"""The ``--seed`` of the command line (``portbench.run``'s), else
    ``None``: ``run_cell`` called in-process gives no seed to read."""

    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument('--seed', type=int, default=None)
    return parser.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def reading(run: dict, log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)):
    r"""The cell's reading with spans on, measured at the first call for a
    traced run on the card and kept in ``run['spans']`` for the others;
    ``None`` on the CPU, where the program has no spans, or where the
    command line has no ``--seed``."""

    if 'spans' not in run:
        run['spans'] = None
        if run['cuda'] and run['trace']:
            seed = command_seed()
            try:
                import sda_tpu_torch.tracing  # noqa: F401
            except ImportError:
                log(f"{run['cell']}: the program has no spans; no reading")
            else:
                if seed is None:
                    log(f"{run['cell']}: no --seed on the command line; no reading")
                else:
                    run['spans'] = _measure(run, seed, log)
    return run['spans']


def _measure(run: dict, seed: int, log: Callable[[str], None]) -> dict:
    from portbench import run as bench

    t0 = time.perf_counter()
    config, work = run['config'], run['work']
    device = torch.device('cuda')
    tree = bench.parameters(config, seed, device)
    driver = bench.load('drivers', work['driver']).Driver(config, work, seed, device, tree)
    t1 = time.perf_counter()
    try:
        out = measure(driver, work['trace_units'], device)
    finally:
        driver.release()
    idle_ms = sum(b - a for a, b in gaps(out)) * 1e-3 / max(out['counts'], 1)
    log(f"{run['cell']}: spans on: {out['counts']} {driver.count_name}s, {len(out['dev'])} device operations, "
        f"{100 * out['matched']:.3f}% matched to their launch, {out['window_s']:.3f} s window, device idle "
        f"{idle_ms:.3f} ms per {driver.count_name}; counters {out['counters']}; driver built in {t1 - t0:.1f} s, "
        f"read in {time.perf_counter() - t1:.1f} s")
    return out

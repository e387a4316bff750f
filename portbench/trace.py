r"""Reading a ``torch.profiler`` window: device intervals, their union, the
device operations with most time and the longest idle gaps.

The busy time is the union of every device operation's interval (kernels,
copies, fills), so operations that overlap count once; the window is the
host's clock around the profiled work, from one synchronisation to the next.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

Interval = Tuple[str, float, float]  # name, start, end (microseconds)


def profile(fn: Callable[[], None], device: torch.device, host: bool = True):
    r"""Runs ``fn`` under the profiler (CUDA activity, and the host's
    operators if ``host``); returns ``(device intervals, host intervals,
    window seconds)``. The events are read as the profiler recorded them,
    without building its tree of averages."""

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU] if host or device.type != 'cuda' else []
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0

    dev: List[Interval] = []
    cpu: List[Interval] = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        span = (e.name(), e.start_ns() * 1e-3, (e.start_ns() + e.duration_ns()) * 1e-3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append(span)
    return dev, cpu, window_s


def union(spans: List[Interval]) -> List[Tuple[float, float]]:
    r"""The merged intervals covered by ``spans``, in order."""

    merged: List[List[float]] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(dev: List[Interval]) -> float:
    return sum(b - a for a, b in union(dev)) * 1e-6


def is_kernel(name: str) -> bool:
    return not re.match(r'(?i)mem(cpy|set)', name)


def kernel_seconds(dev: List[Interval], pattern: str) -> Tuple[float, int]:
    r"""Summed device time and count of the kernels whose name matches."""

    hits = [b - a for name, a, b in dev if re.search(pattern, name)]
    return sum(hits) * 1e-6, len(hits)


def breakdown(dev: List[Interval], gap_dev: List[Interval], gap_host: List[Interval],
              top: int = 10) -> Optional[Dict[str, list]]:
    r"""The ``top`` device operations of ``dev`` by summed time, and the
    ``top`` longest gaps between the device operations of ``gap_dev``, each
    named after the innermost host operation of ``gap_host`` that ran at its
    middle (a second window traced with the host's operators, which slow the
    host: its gaps are longer than the first window's). ``None`` without
    device activity."""

    if not dev:
        return None
    totals: Dict[str, float] = {}
    for name, a, b in dev:
        totals[name[:120]] = totals.get(name[:120], 0.0) + (b - a) * 1e-6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]

    merged = union(gap_dev)
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])), key=lambda g: g[0] - g[1])[:top]
    idle = []
    for a, b in gaps:
        mid = (a + b) / 2
        around = [(e - s, name) for name, s, e in gap_host if s <= mid <= e]
        idle.append([min(around)[1][:120] if around else 'no host operation', (b - a) * 1e-6])
    return {'device_ops': [[n, s] for n, s in ops], 'idle_gaps': idle}


def idle_pct(run: dict) -> Optional[float]:
    r"""100 minus the busy share of a run's traced window; ``None`` without
    device activity."""

    trace = run['trace']
    if not trace or not trace['dev']:
        return None
    return 100 * (1 - trace['busy_s'] / trace['window_s'])

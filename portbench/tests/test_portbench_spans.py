r"""``portbench.spans`` and the metrics that read the program's spans: the
readers on synthetic events (launch attribution across threads, the idle
gaps inside spans, no reading below 99% matched), the readings of tiny cells
on the CPU, and a traced tiny run that leaves the program's spans off in its
own windows and reports every metric it reported before."""

import pytest
import torch

from sda_tpu_torch import tracing

from portbench import run, spans
from portbench.tests.conftest import tiny_cell

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    r"""One raw profiler event, in microseconds."""

    def __init__(self, name, start, end, device=CPU, corr=0, linked=0, annotation=False, thread=1):
        self._name, self.start, self.end, self.device = name, start, end, device
        self.corr, self.linked, self.annotation, self.thread = corr, linked, annotation, thread

    def name(self):
        return self._name

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return int(self.start * 1e3)

    def duration_ns(self):
        return int((self.end - self.start) * 1e3)

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread


def launched(name, op, launch, start, end, corr, thread=1):
    r"""A host operator (correlation ``op``), its CUDA API call and the device
    operation it enqueued, as the profiler records them."""

    return [Event(f'aten::{name}', launch - 1, launch + 2, corr=op, thread=thread),
            Event('cudaLaunchKernel', launch, launch + 1, corr=corr, linked=op, thread=thread),
            Event(f'{name}_kernel', start, end, CUDA, corr=corr, linked=op)]


def test_launch_attribution_across_threads():
    r"""The calling thread waits inside ``guidance.vjp`` while autograd's
    worker (thread 2) launches the backward's kernels: they belong to the
    span by their launch's time, wherever they run. Host operators' and CUDA
    calls' correlation ids overlap: the pair (id, linked id) tells them apart."""

    events = [Event('guidance.forward', 0, 50, annotation=True), Event('guidance.vjp', 60, 200, annotation=True),
              Event('guidance.vjp', 0, 300, CUDA, annotation=True)]
    events += launched('mm', 7, 10, 12, 40, 30)
    events += launched('mm_backward', 30, 120, 150, 250, 7, thread=2)  # runs after the span closed
    events += launched('add', 40, 210, 260, 270, 50)  # after the span
    reading = spans.read_events(events)
    assert reading['matched'] == 1.0 and len(reading['dev']) == 3
    assert reading['spans']['guidance.vjp'] == [(60.0, 200.0)]
    assert spans.device_seconds(reading, 'guidance.forward') == pytest.approx(28e-6)
    assert spans.device_seconds(reading, 'guidance.vjp') == pytest.approx(100e-6)
    assert spans.device_seconds(reading, 'windowed.kernel') == 0.0


def test_idle_gaps_inside_spans():
    r"""Device busy over [0, 10], [5, 20], [30, 40], [60, 70]: gaps (20, 30)
    and (40, 60); spans over [15, 35] and [45, 80] hold 10 + 15 us of them."""

    events = [Event('train.backward', 15, 35, annotation=True), Event('train.backward', 45, 80, annotation=True)]
    for k, (a, b) in enumerate([(0, 10), (5, 20), (30, 40), (60, 70)]):
        events += launched('k', 100 + k, a, a, b, 200 + k)
    reading = spans.read_events(events)
    assert spans.idle_seconds(reading, 'train.backward') == pytest.approx(25e-6)
    assert spans.idle_seconds(reading, 'train.forward') == 0.0
    assert spans.overlap([(0, 1), (2, 3)], [(0.5, 2.5)]) == pytest.approx(1.0)


def test_no_reading_below_99_percent_matched():
    events = [Event('guidance.forward', 0, 1000, annotation=True), Event('guidance.vjp', 1000, 2000, annotation=True)]
    for k in range(100):
        events += launched('k', 1000 + k, 10 * k + 1, 10 * k + 2, 10 * k + 3, 5000 + k)
    events += launched('k', 2000, 1500, 1502, 1503, 6000)
    full = spans.read_events(events)
    cut = spans.read_events([e for e in events if e.device == CUDA or e.corr not in (5000, 5001)])  # 2 lost
    assert full['matched'] == 1.0 and cut['matched'] == pytest.approx(99 / 101)
    assert spans.trusted(full) is full and spans.trusted(cut) is None
    assert spans.trusted(spans.read_events(events[:2])) is None  # no device operation

    work, config, _ = tiny_cell('assim64')
    metric = run.load('metrics', 'vjp_over_fwd.assim')
    for reading, want in ((full, 1 / 100), (cut, None)):
        cell = {'cuda': True, 'trace': {'dev': []}, 'work': work, 'config': config, 'spans': reading}
        assert metric.read(cell) == (None if want is None else pytest.approx(want))


def test_no_reading_from_a_program_without_spans(monkeypatch):
    monkeypatch.setitem(__import__('sys').modules, 'sda_tpu_torch.tracing', None)
    built = []
    monkeypatch.setattr(spans, '_measure', lambda *a: built.append(a))
    logged = []
    cell = {'cell': 'assim64', 'cuda': True, 'trace': {'dev': []}}
    assert spans.reading(cell, log=logged.append) is None and spans.reading(cell, log=logged.append) is None
    assert not built and len(logged) == 1 and 'no spans' in logged[0] and cell['spans'] is None


def test_command_seed():
    assert spans.command_seed(['--workload', 'assim64', '--seed', str(2**33 + 7), '--trace', '1']) == 2**33 + 7
    assert spans.command_seed([]) is None
    assert spans.command_seed(['--se', '3']) is None


def tiny_driver(cell, device='cpu'):
    work, config, tree = tiny_cell(cell)
    return run.load('drivers', work['driver']).Driver(config, work, 2**33 + 5, torch.device(device), tree), work


@pytest.mark.parametrize('cell, names', [
    ('assim64', {'guidance.forward', 'guidance.vjp', 'windowed.kernel'}),
    ('assim256', {'guidance.forward', 'guidance.vjp', 'windowed.kernel'}),
    ('train64', {'train.forward', 'train.backward', 'train.optimizer'}),
    ('datagen256', {'kolmogorov.substep'}),
])
def test_tiny_readings_on_the_cpu(cell, names):
    r"""The spans of each cell's traffic, and ``useful_windows_pct.assim``
    from the counter: every window used without chunks, and with the tiny
    ``assim256``'s chunks of 4 over 4 windows and remat, half."""

    driver, work = tiny_driver(cell)
    reading = spans.measure(driver, work['trace_units'], torch.device('cpu'))
    assert names <= set(reading['spans']) and not tracing.enabled()
    assert reading['dev'] == [] and spans.trusted(reading) is None
    if work['driver'] == 'assim':
        cell_run = {'cuda': True, 'trace': {'dev': []}, 'work': work, 'config': driver.config, 'spans': reading}
        useful = run.load('metrics', 'useful_windows_pct.assim').read(cell_run)
        assert useful == pytest.approx(100.0 if work['traffic']['chunk'] is None else 50.0)
    else:
        assert reading['counters']['unet.windows'] == 0


def test_traced_tiny_run_keeps_the_spans_off_and_its_metrics(monkeypatch):
    r"""A traced tiny cell on the CPU: no span of the program opens in any
    window of ``run.py``; it reports the metrics it reported before (the new
    readers find no device, so they add none) and the same breakdown."""

    def refuse(name):
        raise AssertionError(f'span {name!r} opened')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    work, config, tree = tiny_cell('assim64')
    manifest = run.read_json(run.ROOT / 'BENCHMARK.json')
    before = dict(manifest, per_layer=[m for m in manifest['per_layer']
                                       if m['source'] not in ('program_span', 'program_counter')])
    results = [run.run_cell('assim64', 2**33 + 5, 0.3, True, torch.device('cpu'), manifest=m, work=work,
                            config=config, tree=tree, log=lambda s: None) for m in (before, manifest)]
    assert results[0]['metrics'].keys() == results[1]['metrics'].keys()
    assert results[0].get('breakdown') == results[1].get('breakdown')
    assert all(c['value'] <= c['limit'] for r in results for c in r['checks'].values())
    assert not tracing.enabled()


@pytest.mark.gpu
def test_tiny_reading_on_the_card(cuda):
    r"""On the card every device operation of a tiny guided segment finds its
    launch, and each span holds device time."""

    driver, work = tiny_driver('assim256', cuda)
    reading = spans.trusted(spans.measure(driver, 1, cuda))
    assert reading is not None
    for name in ('guidance.forward', 'guidance.vjp', 'windowed.kernel'):
        assert spans.device_seconds(reading, name) > 0

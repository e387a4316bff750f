r"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names."""

import json
import re

import pytest

from portbench import archs, run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\n\t]{1,200}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
MANIFEST = run.read_json(run.ROOT / 'BENCHMARK.json')
#: What an arch module (``portbench/archs/<arch>.py``) gives.
ARCH = ('program', 'reference', 'init_tree', 'window_flops', 'names')


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
    assert len((run.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST['command']) <= 32
    for word in MANIFEST['command']:
        assert LINE.match(word) and not word.startswith('/') and '..' not in word
    assert 1 <= len(MANIFEST['paths']) <= 16
    for path in MANIFEST['paths']:
        assert PATH.match(path) and (run.ROOT / path).is_dir() and not path.endswith('_torch')
    assert isinstance(MANIFEST['run_seconds'], int) and 1 <= MANIFEST['run_seconds'] <= 51


def test_run_seconds_fit_the_full_check():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('entry', MANIFEST['configs'], ids=lambda e: e['name'])
def test_configs(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(entry['name']) and LINE.match(entry['source']) and LINE.match(entry['why'])
    assert entry['file'].startswith(tuple(p + '/' for p in MANIFEST['paths']))
    config = json.loads((run.ROOT / entry['file']).read_text())
    assert config['source'] == entry['source'] and config['reduced'] == entry['reduced']
    assert len(entry['reduced']) <= 16 and all(NAME.match(k) for k in entry['reduced'])
    assert any(w['config'] == entry['name'] for w in MANIFEST['workloads'])
    assert 'weights' not in config or (run.ROOT / config['weights']).is_file()
    arch = archs.of(config)
    assert all(callable(getattr(arch, f, None)) for f in ARCH), config['arch']
    assert all(getattr(arch, f).__module__.startswith('portbench.reference.') for f in ('reference', 'init_tree'))


@pytest.mark.parametrize('entry', MANIFEST['workloads'], ids=lambda e: e['name'])
def test_workloads(entry):
    assert set(entry) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(entry['name']) and NAME.match(entry['traffic']) and LINE.match(entry['why'])
    assert entry['chips'] in (1, 4)
    assert entry['config'] in {c['name'] for c in MANIFEST['configs']}
    work = run.read_json(run.BENCH / 'workloads' / f"{entry['name']}.json")
    assert work['config'] == entry['config'] and work['why'] == entry['why']
    assert (run.BENCH / 'drivers' / f"{work['driver']}.py").is_file()
    assert work['limits'] and all(v is not None for v in work['limits'].values())
    reported = {m['name'] for m in run.selected(MANIFEST['end_to_end'], entry['name'], set())}
    assert 'setup_s' in reported and len(reported) >= 2
    assert run.selected(MANIFEST['per_layer'], entry['name'], reported)


def test_names_are_unique():
    for key in ('configs', 'workloads'):
        names = [e['name'] for e in MANIFEST[key]]
        assert len(names) == len(set(names))
    metrics = [m['name'] for m in MANIFEST['end_to_end'] + MANIFEST['per_layer']]
    assert len(metrics) == len(set(metrics))
    pairs = [(w['config'], w['traffic']) for w in MANIFEST['workloads']]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize('metric', MANIFEST['end_to_end'], ids=lambda m: m['name'])
def test_end_to_end(metric):
    assert set(metric) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
    assert NAME.match(metric['name']) and UNIT.match(metric['unit']) and metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= metric['bound'] <= 0.25
    assert (run.BENCH / 'metrics' / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize('metric', MANIFEST['per_layer'], ids=lambda m: m['name'])
def test_per_layer(metric):
    assert set(metric) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
    assert NAME.match(metric['name']) and UNIT.match(metric['unit']) and metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
    assert LINE.match(metric['layer'])
    moves = next(m for m in MANIFEST['end_to_end'] if m['name'] == metric['moves'])
    for cell in metric['workloads']:
        assert cell in moves.get('workloads', [cell])
    assert (run.BENCH / 'metrics' / f"{metric['name']}.py").is_file()


def test_metrics_of_one_layer_share_its_name():
    layers = {}
    for m in MANIFEST['per_layer']:
        layers.setdefault(m['layer'].split(' (')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())

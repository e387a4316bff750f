r"""The command refuses to measure without a card, and without the program;
no module of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the program."""

import ast
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'sda_tpu'}
SOURCES = sorted(run.BENCH.rglob('*.py'))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.ImportFrom):
            names.add('portbench.' + (node.module or ''))
    return names


def program_imports(path):
    r"""What the reference module ``path`` imports beyond plain Python, numpy,
    torch and the other reference modules (``portbench.reference.<name>``)."""

    tops = {name.split('.')[0] for name in imported(path)
            if name != 'portbench.reference' and not name.startswith('portbench.reference.')}
    return tops - {'__future__', 'contextlib', 'math', 'typing', 'numpy', 'torch'}


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(run.ROOT)))
def test_no_jax(path):
    assert not {name.split('.')[0] for name in imported(path)} & FORBIDDEN


@pytest.mark.parametrize('path', sorted((run.BENCH / 'reference').glob('*.py')), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    extra = program_imports(path)
    assert not extra, extra


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'sda_tpu_torch_probe.x', sys)
    assert 'sda_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'sda_tpu.probe', sys)
    assert 'sda_tpu' in run.forbidden_modules()


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert run.main(['--workload', 'assim64', '--seed', str(2**33), '--seconds', '1']) != 0
    assert capsys.readouterr().out == ''


def test_refuses_without_the_program(tmp_path):
    shutil.copy(run.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(run.BENCH, tmp_path / 'portbench', ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    done = subprocess.run([sys.executable, '-m', 'portbench.run', '--workload', 'assim64', '--seed', '1',
                           '--seconds', '1'], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ''

r"""Multi-process runs of the port on the CPU, as ``tests/test_multihost.py``
runs the JAX demo: the two-rank demo (data-parallel epochs with each rank
holding only its rows, and sequence-parallel guided sampling, each against
one process), and a command line's ``--mesh`` under a two-rank ``torchrun``
launch against the same command in one process.

Every launch runs in a session of its own and is killed whole at its
deadline, so that no rank outlives a failed test.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

from sda_tpu_torch.train import save_h5

REPO = Path(__file__).resolve().parents[1]


def run(args, timeout, env=None):
    r"""Runs ``args`` from the repository's root; on its deadline kills its
    whole process group. Returns ``(returncode, output)``."""

    proc = subprocess.Popen(
        args, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return 'timeout', out
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return proc.returncode, out


def test_two_rank_demo_parity():
    code, out = run([sys.executable, '-m', 'sda_tpu_torch.parallel.demo', '--launch', '2', '--device', 'cpu'], 120)
    assert code == 0, out[-4000:]
    assert 'MULTIHOST DEMO OK (2 ranks, cpu)' in out
    for rank in range(2):
        assert out.count(f'[{rank}] PARITY OK') == 1, out
        assert out.count(f'[{rank}] SP PARITY OK') == 1, out


def test_lorenz_train_mesh_under_torchrun(tmp_path, monkeypatch):
    r"""``lorenz.train --mesh`` for 1 epoch on two gloo ranks under
    ``torchrun``: rank 0 alone writes the run directory (one ``config.json``,
    one record for the epoch and one for the final ``log_p``), and its
    losses equal those of ``train`` in one process (rtol 1e-5: the two
    ranks' halves of each batch are summed in another order). The
    one-process run skips the final ``log_p``, which the losses do not
    depend on."""

    import torch

    from sda_tpu_torch.experiments.lorenz import train as lorenz_train

    rng = np.random.RandomState(0)
    train, valid = rng.randn(128, 16, 3).astype(np.float32), rng.randn(64, 16, 3).astype(np.float32)
    save_h5(tmp_path / 'sda_tpu/lorenz/data/train.h5', train)
    save_h5(tmp_path / 'sda_tpu/lorenz/data/valid.h5', valid)

    args = [sys.executable, '-m', 'torch.distributed.run', '--standalone', '--nproc_per_node', '2',
            '-m', 'sda_tpu_torch.experiments.lorenz.train', '--model', 'local', '--epochs', '1', '--mesh',
            '--device', 'cpu']
    code, out = run(args, 120, dict(os.environ, SCRATCH=str(tmp_path), OMP_NUM_THREADS='2'))
    assert code == 0, out[-4000:]
    assert out.count('local_0: final log_p') == 1, out[-4000:]
    run_dir = tmp_path / 'sda_tpu/lorenz/runs/local_0'
    assert sorted(p.name for p in run_dir.iterdir()) == ['config.json', 'metrics.jsonl', 'state.msgpack']
    records = [json.loads(line) for line in (run_dir / 'metrics.jsonl').read_text().splitlines()]
    assert [sorted(r) for r in records] == [['loss_train', 'loss_valid', 'lr', 'step', 'time'], ['log_p', 'time']]

    monkeypatch.setattr(lorenz_train, 'sample_log_p', lambda *args, **kwargs: torch.zeros(1))
    lorenz_train.train('local', 0, epochs=1, device='cpu', path=tmp_path / 'one', trainset=train, validset=valid)
    one = json.loads((tmp_path / 'one/runs/local_0/metrics.jsonl').read_text().splitlines()[0])
    for key in ('loss_train', 'loss_valid'):
        np.testing.assert_allclose(records[0][key], one[key], rtol=1e-5)

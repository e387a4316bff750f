r"""Tiny cells of the benchmark on the CPU: the tests' own configuration, at
widths a test run holds, with seeded parameters."""

import copy

import pytest
import torch

from portbench import run
from portbench.reference.unet import init_tree

TINY = dict(arch='unet', window=5, embedding=8, hidden_channels=[4, 8], hidden_blocks=[1, 1], kernel_size=3,
            activation='SiLU', epochs=16, batch_size=4, optimizer='AdamW', learning_rate=2e-4,
            weight_decay=1e-3, scheduler='linear', bf16=False, size=16, dt=0.2)


def tiny_cell(cell: str, bf16: bool = False):
    r"""``(work, config, tree)`` of a cell cut to a test's size: the cell's
    own driver, traffic kind and limits, a tiny network in float32 (or bf16)
    and seeded parameters."""

    work = copy.deepcopy(run.read_json(run.BENCH / 'workloads' / f'{cell}.json'))
    config = dict(TINY, bf16=bf16)
    tr = work['traffic']
    if work['driver'] == 'assim':
        tr.update(samples=2, steps=4, segment=2, chunk=4 if tr['chunk'] else None)
        work['reference_chunk'] = 4
    elif work['driver'] == 'train':
        tr.update(trajectories=12, frames=8)
        work['trace_units'] = 2
    else:
        tr.update(batch=2, segment=2)
        config['size'] = 32
    return work, config, init_tree(config, torch.Generator().manual_seed(0))


def run_tiny(cell: str, seconds: float = 0.3, bf16: bool = False, seed: int = 2**33 + 5, device='cpu',
             steps=None, **kwargs):
    r"""A tiny cell's run; ``steps`` replaces an assim cell's grid."""

    work, config, tree = tiny_cell(cell, bf16)
    if steps is not None:
        work['traffic']['steps'] = steps
    return run.run_cell(cell, seed, seconds, False, torch.device(device), work=work, config=config, tree=tree,
                        log=lambda s: None, **kwargs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')

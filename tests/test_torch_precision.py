r"""The port's float32 precision: ``set_float32_precision`` sets torch's two
TF32 flags, every command line calls it first, and library calls leave the
flags as they found them.

A command line is run as ``__main__`` with ``--help``: argparse exits after
the precision is set and before any work.
"""

import contextlib
import importlib.util
import io
import pkgutil
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sda_tpu_torch
from sda_tpu_torch.experiments.kolmogorov.assimilate import assimilate
from sda_tpu_torch.experiments.kolmogorov.utils import make_score, make_trajectory_eps
from sda_tpu_torch.utils import CONV_TF32, set_float32_precision

COMMAND_LINES = sorted(
    m.name for m in pkgutil.walk_packages(sda_tpu_torch.__path__, 'sda_tpu_torch.')
    if "if __name__ == '__main__':" in Path(importlib.util.find_spec(m.name).origin).read_text()
)


def flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture()
def odd_flags():
    r"""Both flags set to what no command line chooses, restored after."""

    saved = flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = not CONV_TF32, True
    yield flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize('start', [(True, True), (False, False)])
def test_set_float32_precision(start, odd_flags):
    r"""From either state of both flags: convolutions as ``CONV_TF32``,
    matmuls in true float32."""

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = start
    set_float32_precision()
    assert flags() == (CONV_TF32, False)


def test_every_command_line_is_listed():
    assert len(COMMAND_LINES) == 23 and 'sda_tpu_torch.mfu_attribution' in COMMAND_LINES


@pytest.mark.parametrize('module', COMMAND_LINES)
def test_command_line_sets_the_precision(module, odd_flags, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [module, '--help'])
    with contextlib.redirect_stdout(io.StringIO()) as out, pytest.raises(SystemExit) as exit_:
        with pytest.warns(RuntimeWarning, match='found in sys.modules') if module in sys.modules \
                else contextlib.nullcontext():
            runpy.run_module(module, run_name='__main__')
    assert exit_.value.code == 0 and 'usage' in out.getvalue()
    assert flags() == (CONV_TF32, False)


def test_library_call_leaves_the_flags(odd_flags):
    r"""``assimilate`` at a tiny size on the CPU."""

    module = make_score(window=5, embedding=8, hidden_channels=(8,), hidden_blocks=(1,), size=16)
    x_star = torch.from_numpy(np.random.RandomState(0).standard_normal((8, 2, 16, 16)).astype(np.float32))
    xs, residual = assimilate(make_trajectory_eps(module, 5), x_star, samples=1, steps=2, corrections=1)
    assert xs.shape == (1, 8, 2, 16, 16) and np.isfinite(residual)
    assert flags() == odd_flags

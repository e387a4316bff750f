r"""``sda_tpu_torch.utils.profile_trace`` and
``sda_tpu_torch.ops.default_dft_method`` against their JAX counterparts'
contracts (``sda_tpu/utils.py``, ``sda_tpu/ops/spectral.py``).

The JAX ``profile_trace`` swallows a failure to start or stop; the port's
raises by design, so these tests hold what both do when the profiler works:
a trace under ``path`` and ``active`` set.
"""

import json

import pytest
import torch

from sda_tpu.utils import profile_trace as jprofile_trace
from sda_tpu_torch.ops import RealDFT2, default_dft_method
from sda_tpu_torch.utils import profile_trace


def test_profile_trace_writes_a_trace(tmp_path):
    trace = profile_trace(tmp_path / 'trace')
    assert trace.path == str(tmp_path / 'trace') and trace.active is False
    with trace as entered:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert entered is trace and trace.active is True
    (path,) = (tmp_path / 'trace').glob('*.pt.trace.json')
    events = json.loads(path.read_text())['traceEvents']
    assert any('mm' in e.get('name', '') for e in events)
    assert 'mm' in trace.profiler.key_averages().table()


def test_profile_trace_has_the_jax_interface(tmp_path):
    r"""The same name, signature (``path``) and ``active`` attribute."""

    for cls in (jprofile_trace, profile_trace):
        trace = cls(str(tmp_path / cls.__module__))
        assert trace.path == str(tmp_path / cls.__module__) and trace.active is False


def test_profile_trace_lets_errors_through(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profile_trace(tmp_path / 'trace'):
            1 / 0
    assert list((tmp_path / 'trace').glob('*.pt.trace.json'))


@pytest.mark.parametrize('device, want', [
    ('cpu', 'matmul'),
    (torch.device('cpu'), 'matmul'),
    ('cuda', 'kernel'),
    (torch.device('cuda', 1), 'kernel'),
])
def test_default_dft_method(device, want):
    r"""A device object is enough: nothing is launched."""

    assert default_dft_method(device) == want


def test_real_dft2_auto_resolves_as_before():
    assert RealDFT2(16, 16, method='auto', device='cpu').method == 'matmul'
    assert RealDFT2(16, 16, device='cpu', h_modes=5, w_modes=5).method == 'matmul'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            RealDFT2(16, 16, method='auto', device='cuda')

r"""The port's analytic FLOP counters (``sda_tpu_torch.nn.flops``) against the
JAX package's (``sda_tpu.nn.flops``) and against PyTorch's own count.

``FlopCounterMode`` counts every convolution and matmul of a call as 2 FLOPs
per multiply-accumulate, the analytic counters' convention, so over a
``ScoreUNet`` forward the two agree exactly. The modules are built on the
meta device: the counter needs shapes only, so ``unet_0``'s widths cost
nothing here.
"""

import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils.flop_counter import FlopCounterMode

from sda_tpu.nn import flops as jflops
from sda_tpu_torch.diffusion import LocalScoreUNet, ScoreUNet
from sda_tpu_torch.nn import flops

UNET_0 = dict(embedding=64, hidden_channels=(96, 192, 384), hidden_blocks=(3, 3, 3))


@settings(max_examples=60, deadline=None)
@given(
    depth=st.integers(1, 3),
    widths=st.lists(st.integers(1, 64), min_size=3, max_size=3),
    blocks=st.lists(st.integers(0, 4), min_size=3, max_size=3),
    kernel=st.sampled_from([1, 3, 5, (3, 5)]),
    size=st.sampled_from([8, 16, 64, (32, 16)]),
    channels=st.integers(1, 12),
    context=st.integers(0, 3),
    embedding=st.integers(1, 64),
    stride=st.sampled_from([2, (2, 1)]),
)
def test_counters_match_jax(depth, widths, blocks, kernel, size, channels, context, embedding, stride):
    r"""Each counter equals the JAX package's over a grid of widths, blocks,
    kernel sizes, sizes, strides and context channels."""

    hidden, blocks = tuple(widths[:depth]), tuple(blocks[:depth])
    kwargs = dict(hidden_channels=hidden, hidden_blocks=blocks, kernel_size=kernel, size=size, stride=stride,
                  embedding=embedding)

    assert flops.conv_flops(size if isinstance(size, int) else 7, channels, context + 1, 9) == \
        jflops.conv_flops(size if isinstance(size, int) else 7, channels, context + 1, 9)
    assert flops.dense_flops(channels, embedding) == jflops.dense_flops(channels, embedding)
    assert flops.unet_flops(channels + context, channels, **kwargs) == jflops.unet_flops(channels + context, channels,
                                                                                          **kwargs)
    window = flops.score_unet_flops(channels, context, **kwargs)
    assert window == jflops.score_unet_flops(channels, context, **kwargs)
    for corrections, multiplier in ((0, 2.0), (1, 2.0), (2, 3.0)):
        assert flops.guided_sampler_flops(window, 28, 4, 16, corrections, multiplier) == \
            jflops.guided_sampler_flops(window, 28, 4, 16, corrections, multiplier)


def counted(module, x, t, backward=False) -> int:
    with FlopCounterMode(display=False) as counter:
        y = module(x, t)
        if backward:
            y.sum().backward()
    return counter.get_total_flops()


@pytest.mark.parametrize('channels, context, kwargs, size, want', [
    (6, 0, dict(embedding=64, hidden_channels=(8, 16), hidden_blocks=(1, 1)), 16, 3_594_240),
    (6, 2, dict(embedding=16, hidden_channels=(12, 24, 48), hidden_blocks=(2, 1, 3), kernel_size=5), 32, None),
    (10, 0, UNET_0, 64, 28_000_690_176),
])
def test_score_unet_flops_equal_flop_counter(channels, context, kwargs, size, want):
    r"""``score_unet_flops`` equals ``FlopCounterMode``'s total over one
    ``ScoreUNet`` forward of one event, exactly; at ``unet_0``'s widths that
    is 28,000,690,176 FLOPs per window."""

    with torch.device('meta'):
        module = ScoreUNet(channels, context, activation=F.silu, circular=True, **kwargs)
        x = torch.zeros(1, channels, size, size)
        c = torch.zeros(1, context, size, size) if context else None
        with FlopCounterMode(display=False) as counter:
            module(x, torch.full((1,), 0.5), c)

    analytic = flops.score_unet_flops(channels, context, size=size, **kwargs)
    assert counter.get_total_flops() == analytic
    if want is not None:
        assert analytic == want


def test_unet_0_window_and_vjp_multiplier():
    r"""``unet_0`` is a ``LocalScoreUNet``: its forcing is one context
    channel, 28,007,768,064 FLOPs per window. With the parameters frozen, a
    forward and its input VJP (``backward()`` of the sum) count
    ``vjp_multiplier`` = 2 forwards, within [1.95, 2.05]."""

    with torch.device('meta'):
        module = LocalScoreUNet(10, size=64, activation=F.silu, **UNET_0).requires_grad_(False)
        x = torch.zeros(1, 10, 64, 64, requires_grad=True)
        t = torch.full((1,), 0.5)
        forward = counted(module, x, t)
        both = counted(module, x, t, backward=True)

    assert forward == flops.score_unet_flops(10, 1, size=64, **UNET_0) == 28_007_768_064
    assert 1.95 <= both / forward <= 2.05


def test_vjp_multiplier_at_small_widths():
    with torch.device('meta'):
        module = ScoreUNet(4, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1)).requires_grad_(False)
        x = torch.zeros(1, 4, 16, 16, requires_grad=True)
        t = torch.full((1,), 0.5)
        ratio = counted(module, x, t, backward=True) / counted(module, x, t)

    assert 1.95 <= ratio <= 2.05

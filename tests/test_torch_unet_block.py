r"""The U-Net block kernels' plain versions (:mod:`sda_tpu_torch.ops.unet_kernels`)
and :class:`~sda_tpu_torch.nn.UNet`'s channels-last path, on the CPU.

The plain versions, forward and hand-written backward, are held against
today's channel-first code with autograd: ``layer_norm``, ``Conv``'s circular
pad, ``ModResidualBlock`` and ``UNet.forward_plain``. In float32 both sides
compute the same sums, so they agree to float32 rounding. In bf16 each side
rounds at its own places (the hand-written backward sums the halo and the
residual in float32 and rounds once; on the CPU a bf16 convolution adds its
bias before rounding, where the channels-last path adds it after), so bf16 is
held to bf16's rounding: each side's distance to a float32 twin with the
same parameters, or a relative gap of a few bf16 units. The kernels
themselves run only on the card (``tests/test_torch_unet_block_gpu.py``).
"""

import types

import pytest
import torch
import torch.nn.functional as F

from sda_tpu_torch import tracing
from sda_tpu_torch.nn import UNet, layer_norm, layers
from sda_tpu_torch.nn.layers import Conv
from sda_tpu_torch.ops import dft_kernels
from sda_tpu_torch.ops import unet_kernels as uk

PADS = ((1, 1), (1, 1))


def randn(seed, *shape, dtype=torch.float32, grad=False):
    t = torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dtype)
    return t.requires_grad_(grad)


def channels_last(seed, n, c, h, w, dtype, grad=True):
    r"""An ``(N, C, H, W)`` leaf laid out channels-last, as a convolution gives it."""

    t = randn(seed, n, c, h, w, dtype=dtype).contiguous(memory_format=torch.channels_last)
    return t.requires_grad_(grad)


def circular(h, pads=PADS):
    r"""``Conv``'s own circular pad of a channel-first ``h``."""

    return F.pad(h, Conv(1, 1, (3, 3), padding='circular')._pads(h.shape[2:]), mode='circular')


def close(a, b, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5, atol=1e-5)
    else:
        gap = (a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12)
        assert gap < 2e-2, gap


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('up', [1, 2])
@pytest.mark.parametrize('channels', [96, 192, 384, 5])
@pytest.mark.parametrize('m_grad', [True, False])
def test_norm_pad_matches_layer_norm_and_conv_pad(dtype, up, channels, m_grad):
    n, h, w = 2, 6, 4
    x = channels_last(0, n, channels, h, w, dtype)
    r = channels_last(1, n, channels, h, w, dtype)
    b = randn(2, channels, grad=True)  # a float32 parameter, cast as Conv casts it
    m = randn(3, n, channels, dtype=dtype, grad=m_grad)

    s, p = uk.norm_pad(x, r, b, m, PADS, (up, up))

    s_ref = x + (r + b.to(dtype)[:, None, None])
    h_ref = layer_norm(s_ref + m[:, :, None, None], dim=1)
    if up > 1:
        h_ref = torch.repeat_interleave(torch.repeat_interleave(h_ref, up, dim=2), up, dim=3)
    p_ref = circular(h_ref)

    assert s.dtype == p.dtype == dtype
    assert p.shape == (n, channels, h * up + 2, w * up + 2)
    close(s, s_ref, dtype)
    close(p, p_ref, dtype)

    ds, dp = randn(4, *s.shape, dtype=dtype), randn(5, *p.shape, dtype=dtype)
    inputs = [x, r, b] + ([m] if m_grad else [])
    grads = torch.autograd.grad((s, p), inputs, (ds, dp))
    grads_ref = torch.autograd.grad((s_ref, p_ref), inputs, (ds, dp))
    for g, g_ref in zip(grads, grads_ref):
        assert g.dtype == g_ref.dtype and g.shape == g_ref.shape
        close(g, g_ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('channels', [96, 192, 384, 5])
@pytest.mark.parametrize('silu', [True, False])
def test_act_pad_matches_silu_and_conv_pad(dtype, channels, silu):
    n, h, w = 2, 5, 6
    a = channels_last(0, n, channels, h, w, dtype)
    b = randn(1, channels, grad=True)

    _, q = uk.act_pad(a, None, b, silu, PADS, dtype=dtype)
    v_ref = a + b.to(dtype)[:, None, None]
    q_ref = circular(F.silu(v_ref) if silu else v_ref)
    close(q, q_ref, dtype)

    dq = randn(2, *q.shape, dtype=dtype)
    grads = torch.autograd.grad(q, (a, b), dq)
    grads_ref = torch.autograd.grad(q_ref, (a, b), dq)
    for g, g_ref in zip(grads, grads_ref):
        assert g.dtype == g_ref.dtype
        close(g, g_ref, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_act_pad_casts_a_channel_first_input_and_keeps_the_skip(dtype):
    # The U-Net's entry: a float32 channel-first input, read in place; and a
    # descent's end: the stream x + (r + b) kept and padded.
    n, c, h, w = 2, 11, 6, 5
    x = randn(0, n, c, h, w, grad=True)
    v, q = uk.act_pad(x, pads=PADS, dtype=dtype)
    assert v is None and q.dtype == dtype
    assert q.is_contiguous(memory_format=torch.channels_last)
    close(q, circular(x.to(dtype)), dtype)
    (gx,) = torch.autograd.grad(q, x, randn(1, *q.shape, dtype=dtype))
    (gx_ref,) = torch.autograd.grad(circular(x.to(dtype)), x, randn(1, *q.shape, dtype=dtype))
    assert gx.dtype == torch.float32
    close(gx, gx_ref, dtype)

    s, r = channels_last(2, n, 96, h, w, dtype), channels_last(3, n, 96, h, w, dtype)
    b = randn(4, 96, grad=True)
    v, q = uk.act_pad(s, r, b, pads=PADS, keep=True, dtype=dtype)
    v_ref = s + (r + b.to(dtype)[:, None, None])
    close(v, v_ref, dtype)
    close(q, circular(v_ref), dtype)
    dv, dq = randn(5, *v.shape, dtype=dtype), randn(6, *q.shape, dtype=dtype)
    grads = torch.autograd.grad((v, q), (s, r, b), (dv, dq))
    grads_ref = torch.autograd.grad((v_ref, circular(v_ref)), (s, r, b), (dv, dq))
    for g, g_ref in zip(grads, grads_ref):
        close(g, g_ref, dtype)


@pytest.mark.parametrize('pads', [((1, 1), (1, 1)), ((0, 1), (2, 1)), ((3, 0), (1, 3))])
@pytest.mark.parametrize('up', [(1, 1), (2, 2), (1, 2)])
def test_fold_is_the_adjoint_of_pad(pads, up):
    h = randn(0, 2, 3, 4, 5).double()
    g = randn(1, *uk.pad_plain(h, pads, up).shape).double()
    lhs = (uk.pad_plain(h, pads, up) * g).sum()
    rhs = (h * uk.fold_plain(g, pads, up).double()).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-6, atol=1e-6)


def unets(dtype, widths, blocks, size):
    r"""A U-Net in ``dtype`` and its float32 twin with the same parameters."""

    def make(d):
        torch.manual_seed(0)
        net = UNet(11, 10, 16, hidden_channels=widths, hidden_blocks=blocks, activation=F.silu,
                   spatial=2, circular=True, dtype=d)
        with torch.no_grad():
            for i, p in enumerate(net.parameters()):
                p.copy_(randn(100 + i, *p.shape) * (0.1 if p.ndim == 1 else 1.0) / max(p[0].numel(), 1) ** 0.5)
        return net

    return make(dtype), make(None)


def run(net, fn, size, seed=0, y_grad=True):
    x = randn(seed, 2, 11, size, size, grad=True)
    y = randn(seed + 1, 2, 16, grad=y_grad)
    out = fn(x, y)
    cot = randn(seed + 2, *out.shape)
    leaves = [x] + ([y] if y_grad else []) + [p for p in net.parameters() if p.requires_grad]
    return [out] + list(torch.autograd.grad(out.float(), leaves, cot))


@pytest.mark.parametrize('widths, blocks, size', [
    ((96, 192, 384), (1, 1, 1), 8),   # unet_0's widths
    ((5, 7, 3), (2, 0, 1), 8),        # odd widths, a level without blocks
])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_channels_last_unet_matches_todays_path(widths, blocks, size, dtype):
    net, twin = unets(dtype, widths, blocks, size)
    fused = run(net, net.forward_fused, size)
    plain = run(net, net.forward_plain, size)
    assert fused[0].shape == plain[0].shape and fused[0].is_contiguous() and fused[0].dtype == plain[0].dtype
    if dtype == torch.float32:
        # The convolutions sum in another order channels-last.
        for a, b in zip(fused, plain):
            assert (a - b).norm() <= 1e-5 * b.norm(), ((a - b).norm(), b.norm())
        return
    # bf16: as far from the float32 twin as today's path, up to bf16 rounding:
    # typically (the median over output and gradients), and for each tensor
    # within a few times (a width of 3 channels makes each norm noisy).
    exact = run(twin, twin.forward_plain, size)
    ratios = []
    for a, b, e in zip(fused, plain, exact):
        assert a.dtype == b.dtype
        err_fused = (a.float() - e.float()).norm() / e.float().norm()
        err_plain = (b.float() - e.float()).norm() / e.float().norm()
        assert err_fused < 3 * err_plain + 5e-3, (err_fused, err_plain)
        ratios.append(err_fused / err_plain)
    assert torch.stack(ratios).median() < 1.25, ratios


def test_channels_last_unet_without_modulation_grad():
    # The guided sampler's case: frozen parameters, the input VJP alone.
    net, _ = unets(torch.bfloat16, (8, 16, 12), (1, 2, 1), 8)
    net.requires_grad_(False)
    fused = run(net, net.forward_fused, 8, y_grad=False)
    plain = run(net, net.forward_plain, 8, y_grad=False)
    assert len(fused) == len(plain) == 2
    for a, b in zip(fused, plain):
        close(a, b, torch.bfloat16)


UNET_0 = dict(hidden_channels=(96, 192, 384), hidden_blocks=(3, 3, 3), activation=F.silu, spatial=2,
              circular=True, dtype=torch.bfloat16)


@pytest.mark.parametrize('change, fused', [
    ({}, True),                                     # unet_0 on a card
    ({'spatial': 1}, False),                         # the Lorenz U-Nets
    ({'circular': False}, False),                    # 'same' padding
    ({'dtype': None}, False),                        # float32 (qg_0)
    ({'dtype': torch.float16}, False),
    ({'activation': F.relu}, False),
])
def test_dispatch_takes_todays_path_unless_fusable(change, fused, monkeypatch):
    net = UNet(11, 10, 64, **{**UNET_0, **change})
    card = types.SimpleNamespace(is_cuda=True)
    assert net.fused_for(card) is fused
    # A CPU tensor always takes today's path.
    assert not net.fused_for(torch.zeros(1))

    monkeypatch.setattr(UNet, 'forward_fused', lambda *a: pytest.fail('forward_fused on the CPU'))
    small = UNet(11, 10, 8, **{**UNET_0, **change, 'hidden_channels': (4, 4, 4), 'hidden_blocks': (1, 1, 1)})
    x = randn(0, 1, 11, *(8,) * small.spatial)
    assert small(x, randn(1, 1, 8)).shape == (1, 10) + x.shape[2:]


def test_block_counters(monkeypatch):
    net, _ = unets(torch.bfloat16, (8, 16, 12), (1, 2, 1), 8)
    x, y = randn(0, 2, 11, 8, 8), randn(1, 2, 16)
    per_forward = 2 * sum(net.hidden_blocks)
    before = dict(tracing.counters)

    net(x, y)  # the CPU takes today's path
    assert tracing.counters['unet.blocks'] - before['unet.blocks'] == per_forward
    assert tracing.counters['unet.blocks_fused'] == before['unet.blocks_fused']

    # The plain versions launch nothing, so no block counts as fused.
    net.forward_fused(x, y)
    assert tracing.counters['unet.blocks'] - before['unet.blocks'] == 2 * per_forward
    assert tracing.counters['unet.blocks_fused'] == before['unet.blocks_fused']
    for name in ('norm_pad', 'norm_pad_bwd', 'act_pad', 'act_pad_bwd'):
        assert tracing.counters[f'unet.{name}'] == before[f'unet.{name}']

    # A block counts as fused where its norm_pad launched: a stand-in for the
    # kernel that counts its launch as the launcher does.
    plain = uk.norm_pad_plain

    def launched(*args, **kwargs):
        tracing.counters['unet.norm_pad'] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(uk, 'norm_pad_plain', launched)
    net.forward_fused(x, y)
    assert tracing.counters['unet.blocks'] - before['unet.blocks'] == 3 * per_forward
    assert tracing.counters['unet.blocks_fused'] - before['unet.blocks_fused'] == per_forward

    # A checkpointed forward's recompute counts again, as unet.windows does.
    from torch.utils.checkpoint import checkpoint
    x.requires_grad_(True)
    checkpoint(net.forward_fused, x, y, use_reentrant=False).float().sum().backward()
    assert tracing.counters['unet.blocks_fused'] - before['unet.blocks_fused'] == 3 * per_forward


def test_kept_casts_follow_the_parameters():
    net, _ = unets(torch.bfloat16, (8, 16, 12), (1, 2, 1), 8)
    net.requires_grad_(False)
    conv = net.convs[1]
    w = layers.kept_cast(conv, 'weight', torch.bfloat16, torch.channels_last)
    assert w.dtype == torch.bfloat16 and w.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(w, conv.weight.to(torch.bfloat16))
    assert layers.kept_cast(conv, 'weight', torch.bfloat16, torch.channels_last) is w

    # An in-place update, a new tensor and another autograd mode cast again.
    with torch.no_grad():
        conv.weight.mul_(2)
    again = layers.kept_cast(conv, 'weight', torch.bfloat16, torch.channels_last)
    assert again is not w and torch.equal(again, conv.weight.to(torch.bfloat16))
    conv.weight = torch.nn.Parameter(conv.weight.detach() + 1)
    with torch.no_grad():
        fresh = layers.kept_cast(conv, 'weight', torch.bfloat16, torch.channels_last)
    assert torch.equal(fresh, conv.weight.to(torch.bfloat16)) and fresh.grad_fn is None
    tracked = layers.kept_cast(conv, 'weight', torch.bfloat16, torch.channels_last)
    assert tracked.grad_fn is not None and tracked is not fresh

    # The fused forward reads the parameters as they are now.
    x, y = randn(0, 2, 11, 8, 8), randn(1, 2, 16)
    for step in range(3):
        close(net.forward_fused(x, y), net.forward_plain(x, y), torch.bfloat16)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.05 * randn(step, *p.shape))


def test_training_through_kept_casts_matches_todays_path():
    # Each step's parameter gradients reach the parameters through the kept
    # casts, and each optimizer step's update is read by the next forward.
    nets = [unets(None, (8, 16, 12), (1, 2, 1), 8)[0] for _ in range(2)]
    optimizers = [torch.optim.SGD(net.parameters(), lr=1e-3) for net in nets]
    for step in range(3):
        x, y = randn(10 + step, 2, 11, 8, 8), randn(20 + step, 2, 16)
        cot = randn(30 + step, 2, 10, 8, 8)
        for net, opt, fn in zip(nets, optimizers, ('forward_fused', 'forward_plain')):
            opt.zero_grad()
            (getattr(net, fn)(x, y) * cot).sum().backward()
            opt.step()
        for a, b in zip(*(net.parameters() for net in nets)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_kernels_build_for_hopper_and_load_lazily(tmp_path):
    cmd = dft_kernels.nvcc_command(tmp_path / 'lib.so', uk.SOURCE)
    assert 'arch=compute_90a,code=sm_90a' in cmd and str(uk.SOURCE) in cmd
    assert uk.SOURCE.exists() and uk._library is None
    text = uk.SOURCE.read_text()
    for name in ('sda_norm_pad', 'sda_norm_pad_bwd', 'sda_act_pad', 'sda_act_pad_bwd'):
        assert f'int {name}(' in text
    assert 'atomic' not in text.replace('No atomics', '')

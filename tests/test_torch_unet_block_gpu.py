r"""The U-Net block kernels against their plain versions, and the channels-last
U-Net against today's channel-first path, on the card.

Marked ``gpu``: every test skips without a CUDA device. The card's machine
has no JAX, so run this file there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_unet_block_gpu.py

This file imports only the port and torch. Kernels are compared with their
plain versions in bf16 at ``unet_0``'s three levels and the ``assim64``
batch of 112 windows. The two compute the same float32 values but sum in
other orders (the layer norm's statistics, the halo), so an output may
differ in its last bf16 bit: tolerances are two bf16 units (``2 ** -7``
relative). The U-Net is held to a float32 twin (TF32 off), each path's
distance to it compared, as on the CPU (``tests/test_torch_unet_block.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from sda_tpu_torch import tracing
from sda_tpu_torch.nn import UNet
from sda_tpu_torch.ops import unet_kernels as uk

pytestmark = pytest.mark.gpu

PADS = ((1, 1), (1, 1))
BF16_UNIT = 2.0 ** -7
#: unet_0's levels at the assim64 batch, (N, H, W, C), and a width that 8
#: does not divide (the kernels' scalar path).
LEVELS = [(112, 64, 64, 96), (112, 32, 32, 192), (112, 16, 16, 384), (16, 8, 6, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def randn(seed, *shape, device, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device).to(dtype)


def close(a, b, rtol=BF16_UNIT, atol=BF16_UNIT):
    torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize('up', [1, 2])
@pytest.mark.parametrize('level', LEVELS)
def test_norm_pad_matches_its_plain_version(cuda, level, up):
    n, h, w, c = level
    x, r = randn(0, n, h, w, c, device=cuda), randn(1, n, h, w, c, device=cuda)
    b, m = randn(2, c, device=cuda, dtype=torch.float32), randn(3, n, c, device=cuda)
    pads, ups = PADS, (up, up)

    s, p, mean, rstd = uk.launch_norm_pad(x, r, b, m, pads, ups)
    s_ref, p_ref, mean_ref, rstd_ref = uk.norm_pad_plain(x, r, b, m, pads, ups)
    torch.cuda.synchronize()
    assert torch.equal(s, s_ref)
    close(mean, mean_ref, 1e-5, 1e-5)
    close(rstd, rstd_ref, 1e-5, 1e-5)
    close(p, p_ref)

    dp, ds = randn(4, *p.shape, device=cuda), randn(5, *s.shape, device=cuda)
    for need_dm in (False, True):
        dx, dm = uk.launch_norm_pad_bwd(dp, ds, s, m, mean, rstd, pads, ups, need_dm)
        dx_ref, dm_ref = uk.norm_pad_bwd_plain(dp, ds, s, m, mean, rstd, pads, ups, need_dm)
        close(dx, dx_ref)
        if need_dm:
            close(dm, dm_ref, 1e-4, 1e-4 * dm_ref.abs().max().item())
        else:
            assert dm is None

    # No residual, no modulation: s is x itself, and nothing reaches it.
    s, p, mean, rstd = uk.launch_norm_pad(x, None, None, None, pads, ups)
    assert s is x
    close(p, uk.norm_pad_plain(x, None, None, None, pads, ups)[1])
    dx, _ = uk.launch_norm_pad_bwd(dp, None, s, None, mean, rstd, pads, ups)
    close(dx, uk.norm_pad_bwd_plain(dp, None, s, None, mean, rstd, pads, ups)[0])


@pytest.mark.parametrize('level', LEVELS)
def test_act_pad_matches_its_plain_version(cuda, level):
    n, h, w, c = level
    a, r = randn(0, n, h, w, c, device=cuda), randn(1, n, h, w, c, device=cuda)
    b = randn(2, c, device=cuda, dtype=torch.float32)

    # SiLU on a convolution's output plus its bias (inside a block).
    _, q = uk.launch_act_pad(a, None, b, True, PADS)
    close(q, uk.act_pad_plain(a, None, b, True, PADS, torch.bfloat16)[1])
    dq = randn(3, *q.shape, device=cuda)
    close(uk.launch_act_pad_bwd(dq, None, a, b, True, PADS),
          uk.act_pad_bwd_plain(dq, None, a, b, True, PADS, torch.bfloat16))

    # The identity on the stream x + (r + b), kept (a descent's end).
    v, q = uk.launch_act_pad(a, r, b, False, PADS, keep=True)
    v_ref, q_ref = uk.act_pad_plain(a, r, b, False, PADS, torch.bfloat16)
    assert torch.equal(v, v_ref) and torch.equal(q, q_ref)
    ds = randn(4, *v.shape, device=cuda)
    close(uk.launch_act_pad_bwd(dq, ds, a, None, False, PADS),
          uk.act_pad_bwd_plain(dq, ds, a, None, False, PADS, torch.bfloat16))


def test_act_pad_reads_the_channel_first_entry(cuda):
    # The U-Net's input: float32 (N, C, H, W), cast, laid out channels-last
    # and padded in one pass; its gradient comes back float32 channel-first.
    x = randn(0, 112, 11, 64, 64, device=cuda, dtype=torch.float32)
    view = x.permute(0, 2, 3, 1)
    _, q = uk.launch_act_pad(view, None, None, False, PADS)
    assert torch.equal(q, uk.act_pad_plain(view, None, None, False, PADS, torch.bfloat16)[1])
    dq = randn(1, *q.shape, device=cuda)
    dx = uk.launch_act_pad_bwd(dq, None, view, None, False, PADS)
    assert dx.dtype == torch.float32 and dx.stride() == view.stride()
    close(dx, uk.act_pad_bwd_plain(dq, None, view, None, False, PADS, torch.bfloat16), 1e-6, 1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = randn(0, 4, 8, 8, 96, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        uk.launch_norm_pad(x.transpose(1, 2), None, None, None, PADS)
    with pytest.raises(ValueError, match='bfloat16'):
        uk.launch_norm_pad(x.float(), None, None, None, PADS)
    with pytest.raises(ValueError, match='bfloat16'):
        uk.launch_norm_pad(x, x.half(), None, None, PADS)
    with pytest.raises(ValueError, match='float32'):
        uk.launch_norm_pad(x, None, randn(1, 96, device=cuda), None, PADS)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        uk.launch_act_pad(x.half(), None, None, False, PADS)
    with pytest.raises(ValueError, match='contiguous'):
        uk.launch_act_pad(x[:, ::2], None, None, False, PADS)
    with pytest.raises(ValueError, match='contiguous'):
        uk.launch_act_pad_bwd(randn(1, 4, 10, 10, 96, device=cuda).transpose(1, 2), None, x, None, False, PADS)
    with pytest.raises(ValueError, match='at most 6144'):
        uk.launch_norm_pad(randn(0, 1, 2, 2, 8192, device=cuda), None, None, None, PADS)
    with pytest.raises(ValueError, match='computes in bfloat16'):
        uk.act_pad(x.float(), dtype=torch.float32)


def unet_0(device, dtype):
    r"""``unet_0``'s U-Net (window 5 of 2 channels and the forcing in, 96 /
    192 / 384, 3 / 3 / 3, SiLU, circular) with seeded parameters."""

    torch.manual_seed(0)
    net = UNet(11, 10, 64, hidden_channels=(96, 192, 384), hidden_blocks=(3, 3, 3), activation=F.silu,
               spatial=2, circular=True, dtype=dtype).to(device)
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            p.copy_(randn(100 + i, *p.shape, device=device, dtype=torch.float32)
                    * (0.1 if p.ndim == 1 else 1.0) / max(p[0].numel(), 1) ** 0.5)
    return net


def evaluate(net, fn, device, n=16, seed=0):
    r"""Output, input VJP, modulation and every parameter gradient."""

    x = randn(seed, n, 11, 64, 64, device=device, dtype=torch.float32).requires_grad_(True)
    y = randn(seed + 1, n, 64, device=device, dtype=torch.float32).requires_grad_(True)
    out = fn(x, y)
    cot = randn(seed + 2, *out.shape, device=device, dtype=torch.float32)
    return [out] + list(torch.autograd.grad(out.float(), [x, y] + list(net.parameters()), cot))


def test_fused_unet_matches_todays_path(cuda):
    net = unet_0(cuda, torch.bfloat16)
    twin = unet_0(cuda, None)
    assert net.fused_for(torch.empty(1, device=cuda))
    before = dict(tracing.counters)
    fused = evaluate(net, net.forward, cuda)
    blocks = sum(net.hidden_blocks) * 2
    assert tracing.counters['unet.blocks_fused'] - before['unet.blocks_fused'] == blocks
    assert tracing.counters['unet.blocks'] - before['unet.blocks'] == blocks
    # Per forward: a norm_pad per block and per ascent's layer norm; an act_pad
    # per block, at the entry, per descent and at the exit; each once backward.
    for name, count in (('norm_pad', blocks + 2), ('act_pad', blocks + 4)):
        assert tracing.counters[f'unet.{name}'] - before[f'unet.{name}'] == count
        assert tracing.counters[f'unet.{name}_bwd'] - before[f'unet.{name}_bwd'] == count

    plain = evaluate(net, net.forward_plain, cuda)
    exact = evaluate(twin, twin.forward_plain, cuda)
    ratios = []
    for a, b, e in zip(fused, plain, exact):
        assert a.shape == b.shape and a.dtype == b.dtype
        err_fused = (a.float() - e.float()).norm() / e.float().norm()
        err_plain = (b.float() - e.float()).norm() / e.float().norm()
        assert err_fused < 1.5 * err_plain + 1e-3, (err_fused, err_plain)
        ratios.append(err_fused / err_plain)
    assert torch.stack(ratios).median() < 1.1, ratios


def test_fused_unet_repeats_bit_for_bit(cuda):
    net = unet_0(cuda, torch.bfloat16)
    first = evaluate(net, net.forward, cuda, seed=7)
    second = evaluate(net, net.forward, cuda, seed=7)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_unet_runs_channels_last_throughout(cuda):
    from torch.profiler import ProfilerActivity, profile

    net = unet_0(cuda, torch.bfloat16).requires_grad_(False)
    x = randn(0, 4, 11, 64, 64, device=cuda, dtype=torch.float32).requires_grad_(True)
    y = randn(1, 4, 64, device=cuda, dtype=torch.float32)
    torch.autograd.grad(net(x, y).float().sum(), x)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(net(x, y).float().sum(), x)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    transposes = sorted(k for k in names if 'nchwToNhwc' in k or 'nhwcToNchw' in k)
    assert not transposes, transposes
    assert any('norm_pad_kernel' in k for k in names) and any('act_pad_bwd_kernel' in k for k in names)

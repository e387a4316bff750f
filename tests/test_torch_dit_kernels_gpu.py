r"""DiT's adaLN kernels against their plain versions, and the DiT's fused
glue against today's PyTorch chain, on the card.

Marked ``gpu``: every test skips without a CUDA device. The card's machine
has no JAX, so run this file there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_dit_kernels_gpu.py

This file imports only the port and torch. Kernels are compared with their
plain versions in bf16 at DiT-XL/2's shape in ``assim64_dit`` (28 windows of
1,024 tokens of 1,152) and at widths that leave lanes idle, the widest
included. The two compute the same float32 values but sum in other orders
(the statistics), so an output may differ in its last bf16 bit: the
tolerance is two bf16 units, ``2^-7 (1 + |plain|)``. The vectors' gradients
are float32 sums over the tokens, held to ``1e-4`` of their largest. The DiT
is held to a float32 twin (TF32 off), each path's distance to it compared,
as ``tests/test_torch_unet_block_gpu.py`` holds the U-Net.
"""

import pytest
import torch

from sda_tpu_torch import tracing
from sda_tpu_torch.nn.dit import DiT
from sda_tpu_torch.ops import dit_kernels as dk

pytestmark = pytest.mark.gpu

BF16_UNIT = 2.0 ** -7
#: (B, N, D): the cell's shape, then 4, 8 and 1 vectors a lane, some lanes idle.
SHAPES = [(28, 1024, 1152), (3, 37, 1000), (2, 5, 2048), (4, 9, 64)]


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


def operands(shape, device):
    r"""Rows ``x, a`` and ``shift, scale, gate``: views of one ``(B, 6 D)``
    modulation, as ``adaln`` gives them."""

    b, n, d = shape
    x, a = randn(0, b, n, d, device=device), randn(1, b, n, d, device=device)
    mod = randn(2, b, 6 * d, device=device, dtype=torch.float32).mul(0.5).to(torch.bfloat16)
    return x, a, mod.chunk(6, dim=1)[:3]


def close(a, b):
    a, b = a.float(), b.float()
    assert ((a - b).abs() <= BF16_UNIT * (1 + b.abs())).all(), (a - b).abs().max().item()


def sums_close(a, b):
    torch.testing.assert_close(a, b.float(), rtol=1e-4, atol=1e-4 * b.abs().max().item())


@pytest.mark.parametrize('shape', SHAPES)
def test_norm_modulate_matches_its_plain_version(cuda, shape):
    x, _, (shift, scale, _) = operands(shape, cuda)
    h, mean, rstd = dk.launch_norm_modulate(x, shift, scale)
    h_ref, mean_ref, rstd_ref = dk.norm_modulate_plain(x, shift, scale)
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=1e-5)
    close(h, h_ref)

    dh = randn(3, *x.shape, device=cuda)
    dx, dshift, dscale = dk.launch_norm_modulate_bwd(dh, x, mean, rstd, scale)
    assert dshift is None and dscale is None
    close(dx, dk.norm_modulate_bwd_plain(dh, None, x, mean, rstd, scale)[0])
    dx2, dshift, dscale = dk.launch_norm_modulate_bwd(dh, x, mean, rstd, scale, need_vectors=True)
    assert torch.equal(dx, dx2)
    want = dk.vector_grads_plain(dh, x, mean, rstd)
    sums_close(dshift, want[0])
    sums_close(dscale, want[1])
    again = dk.launch_norm_modulate_bwd(dh, x, mean, rstd, scale, need_vectors=True)
    assert torch.equal(dshift, again[1]) and torch.equal(dscale, again[2])  # no atomics


@pytest.mark.parametrize('shape', SHAPES)
def test_gated_norm_modulate_matches_its_plain_version(cuda, shape):
    x, a, (shift, scale, gate) = operands(shape, cuda)
    xp, h, mean, rstd = dk.launch_gated_norm_modulate(x, gate, a, shift, scale)
    xp_ref, h_ref, mean_ref, rstd_ref = dk.gated_norm_modulate_plain(x, gate, a, shift, scale)
    close(xp, xp_ref)
    # h from the plain version on the kernel's x', so a last-bit difference in
    # x' is not counted twice.
    close(h, dk.norm_modulate_plain(xp, shift, scale)[0])
    close(h, h_ref)

    dh, ds = randn(3, *x.shape, device=cuda), randn(4, *x.shape, device=cuda)
    dx, da, dshift, dscale, dgate = dk.launch_gated_norm_modulate_bwd(dh, ds, xp, mean, rstd, scale, gate)
    assert dshift is dscale is dgate is None
    dx_ref, da_ref = dk.norm_modulate_bwd_plain(dh, ds, xp, mean, rstd, scale, gate)
    close(dx, dx_ref)
    close(da, da_ref)
    dx2, da2, dshift, dscale, dgate = dk.launch_gated_norm_modulate_bwd(dh, ds, xp, mean, rstd, scale, gate, a)
    assert torch.equal(dx, dx2) and torch.equal(da, da2)
    for got, want in zip((dshift, dscale, dgate), dk.vector_grads_plain(dh, xp, mean, rstd, dx, a)):
        sums_close(got, want)


@pytest.mark.parametrize('shape', SHAPES)
def test_gated_add_matches_its_plain_version(cuda, shape):
    x, m, (_, _, gate) = operands(shape, cuda)
    close(dk.launch_gated_add(x, gate, m), dk.gated_add_plain(x, gate, m))
    dy = randn(3, *x.shape, device=cuda)
    dm, dgate = dk.launch_gated_add_bwd(dy, gate)
    assert dgate is None
    close(dm, dk.gated_add_bwd_plain(dy, gate))
    dm2, dgate = dk.launch_gated_add_bwd(dy, gate, m)
    assert torch.equal(dm, dm2)
    sums_close(dgate, dk.vector_grads_plain(None, None, None, None, dy, m)[2])


def test_autograd_functions_on_the_card(cuda):
    r"""Each function's gradients, the vectors' where they take gradients,
    against the same function on the CPU (the plain versions), both bf16."""

    x, a, vectors = operands((3, 64, 256), cuda)
    cases = {
        dk.norm_modulate: (x, vectors[0], vectors[1]),
        dk.gated_norm_modulate: (x, vectors[2], a, vectors[0], vectors[1]),
        dk.gated_add: (x, vectors[2], a),
    }
    for fn, args in cases.items():
        for vector_grads in (False, True):
            got = {}
            for device in (cuda, torch.device('cpu')):
                inputs = [t.to(device).detach().requires_grad_(t.ndim == 3 or vector_grads) for t in args]
                out = fn(*inputs)
                out = out if isinstance(out, tuple) else (out,)
                cots = [randn(7 + i, *o.shape, device=cuda).to(device) for i, o in enumerate(out)]
                leaves = [t for t in inputs if t.requires_grad]
                got[device.type] = list(out) + list(torch.autograd.grad(out, leaves, cots))
            assert len(got['cuda']) == len(got['cpu'])
            for g, w in zip(got['cuda'], got['cpu']):
                assert g.dtype == w.dtype == torch.bfloat16
                if g.ndim == 3:
                    close(g.cpu(), w)
                else:  # a vector's gradient: a sum over 64 tokens, rounded to bf16 on both sides
                    torch.testing.assert_close(g.cpu().float(), w.float(), rtol=2 * BF16_UNIT,
                                               atol=2 * BF16_UNIT * w.float().abs().max().item())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, a, (shift, scale, gate) = operands((2, 8, 64), cuda)
    with pytest.raises(ValueError, match='contiguous'):
        dk.launch_norm_modulate(x.transpose(0, 1), shift, scale)
    with pytest.raises(ValueError, match='bfloat16'):
        dk.launch_norm_modulate(x.float(), shift, scale)
    with pytest.raises(ValueError, match='bfloat16'):
        dk.launch_gated_add(x, gate.float(), a)
    with pytest.raises(ValueError, match='contiguous channels'):
        dk.launch_norm_modulate(x, shift, torch.stack((scale, scale), dim=2)[..., 0])
    with pytest.raises(ValueError, match='aligned'):
        dk.launch_norm_modulate(x, shift, randn(5, 2, 6 * 64 + 1, device=cuda)[:, 1:65])
    with pytest.raises(ValueError, match='8 divides'):
        dk.launch_norm_modulate(x[..., :60].contiguous(), shift[:, :60], scale[:, :60])
    wide = randn(6, 1, 2, 2056, device=cuda)
    with pytest.raises(ValueError, match='at most 2048'):
        dk.launch_norm_modulate(wide, wide[:, 0], wide[:, 1])
    assert not dk.fits(wide, wide[:, 0]) and not dk.fits(x.float(), shift.float()) and dk.fits(x, shift)


def dit(device, dtype, depth=2):
    r"""DiT-XL/2's width (1,152, 16 heads of 72) at ``depth`` blocks on a
    64^2 field of 11 channels, seeded parameters drawn at a scale that keeps
    every branch alive (adaLN-Zero's zeros would leave the blocks the
    identity)."""

    net = DiT(input_size=64, patch_size=2, in_channels=11, out_channels=10, hidden_size=1152, depth=depth,
              num_heads=16, dtype=dtype).to(device)
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            fan_in = max(p[0].numel(), 1) if p.ndim > 1 else 1
            p.copy_(randn(100 + i, *p.shape, device=device, dtype=torch.float32)
                    * (0.1 if p.ndim == 1 else 1.0) / fan_in ** 0.5)
    return net


def evaluate(net, device, params=True, seed=0, n=4):
    r"""Output, input VJP and, where ``params``, every parameter's gradient."""

    x = randn(seed, n, 11, 64, 64, device=device, dtype=torch.float32).requires_grad_(True)
    t = torch.rand(n, generator=torch.Generator(device=device).manual_seed(seed + 1), device=device)
    net.requires_grad_(params)
    out = net(x, t)
    cot = randn(seed + 2, *out.shape, device=device, dtype=torch.float32)
    leaves = [x] + (list(net.parameters()) if params else [])
    return [out] + list(torch.autograd.grad(out.float(), leaves, cot))


def test_fused_dit_matches_todays_chain(cuda, monkeypatch):
    net, twin = dit(cuda, torch.bfloat16), dit(cuda, None)
    depth, n = len(net.blocks), 4
    names = ('dit.norm_mod', 'dit.gated_norm_mod', 'dit.gated_add')
    before = dict(tracing.counters)
    fused = evaluate(net, cuda, params=False)
    per_forward = {'dit.norm_mod': depth + 1, 'dit.gated_norm_mod': depth, 'dit.gated_add': depth}
    for name in names:
        assert tracing.counters[name] - before[name] == per_forward[name]
        assert tracing.counters[f'{name}_bwd'] - before[f'{name}_bwd'] == per_forward[name]
    assert tracing.counters['dit.blocks_fused'] - before['dit.blocks_fused'] == depth * n
    assert tracing.counters['dit.blocks'] - before['dit.blocks'] == depth * n

    fused += evaluate(net, cuda)
    exact = evaluate(twin, cuda, params=False) + evaluate(twin, cuda)
    before = dict(tracing.counters)
    monkeypatch.setattr(dk, 'fits', lambda *args: False)
    plain = evaluate(net, cuda, params=False) + evaluate(net, cuda)
    assert all(tracing.counters[k] == before[k] for k in names + ('dit.blocks_fused',))
    ratios = []
    for a, b, e in zip(fused, plain, exact):
        assert a.shape == b.shape and a.dtype == b.dtype
        err_fused = (a.float() - e.float()).norm() / e.float().norm()
        err_plain = (b.float() - e.float()).norm() / e.float().norm()
        assert err_fused < 1.5 * err_plain + 1e-3, (err_fused, err_plain)
        ratios.append(err_fused / err_plain)
    assert torch.stack(ratios).median() < 1.1, ratios


def test_fused_dit_forward_repeats_bit_for_bit(cuda):
    r"""The kernels have no atomics, so the forward repeats bit for bit. The
    input VJP does not, on either path: cuDNN's attention backward
    accumulates atomically."""

    net = dit(cuda, torch.bfloat16)
    assert torch.equal(evaluate(net, cuda, seed=7)[0], evaluate(net, cuda, seed=7)[0])

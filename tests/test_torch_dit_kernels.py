r"""DiT's adaLN kernels' plain versions (:mod:`sda_tpu_torch.ops.dit_kernels`)
and :class:`~sda_tpu_torch.nn.dit.DiTBlock`'s fused path, on the CPU.

The plain versions, forward and hand-written backward, are held against
autograd through today's composition (``nn.dit.norm``, ``modulate`` and the
gated adds). In float64 both sides compute the same sums, so they agree to
float64 rounding; in bf16 the plain versions round once where the
composition rounds three times, so they are held to a few bf16 units. On a
CPU tensor the autograd functions run the plain versions, which is how
``DiTBlock.forward_fused`` is held here against ``forward_plain``. The
kernels themselves run only on the card (``tests/test_torch_dit_kernels_gpu.py``).
"""

import pytest
import torch

from portbench import run
from sda_tpu_torch import tracing
from sda_tpu_torch.nn.dit import DiT, DiTBlock, adaln, modulate, norm
from sda_tpu_torch.ops import dit_kernels as dk

#: A width the kernels' vectors take and one that 8 does not divide.
WIDTHS = [16, 12]
KERNEL_COUNTERS = ('dit.blocks_fused', 'dit.norm_mod', 'dit.norm_mod_bwd', 'dit.gated_norm_mod',
                   'dit.gated_norm_mod_bwd', 'dit.gated_add', 'dit.gated_add_bwd')


def randn(seed, *shape, dtype=torch.float64, grad=False):
    t = torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dtype)
    return t.requires_grad_(grad)


def operands(d, dtype=torch.float64, grad=True, b=3, n=5):
    r"""Token rows ``(b, n, d)`` twice and three vectors, views of one ``(b,
    6 d)`` tensor as ``adaln`` gives them."""

    x, a = randn(0, b, n, d, dtype=dtype, grad=grad), randn(1, b, n, d, dtype=dtype, grad=grad)
    mod = randn(2, b, 6 * d, dtype=dtype, grad=grad)
    return x, a, mod


def grads(outputs, inputs, seed=10):
    r"""The VJP of ``outputs`` with seeded cotangents, for each of ``inputs``."""

    cots = [randn(seed + i, *o.shape, dtype=o.dtype) for i, o in enumerate(outputs)]
    return torch.autograd.grad(outputs, inputs, cots, allow_unused=True)


def composition_norm_modulate(x, shift, scale):
    return modulate(norm(x), shift, scale)


def composition_gated_norm_modulate(x, gate, a, shift, scale):
    xp = x + gate.unsqueeze(1) * a
    return xp, modulate(norm(xp), shift, scale)


def composition_gated_add(x, gate, m):
    return x + gate.unsqueeze(1) * m


CASES = {
    'norm_modulate': (dk.norm_modulate, composition_norm_modulate, lambda x, a, v: (x, v[0], v[1])),
    'gated_norm_modulate': (dk.gated_norm_modulate, composition_gated_norm_modulate,
                            lambda x, a, v: (x, v[2], a, v[0], v[1])),
    'gated_add': (dk.gated_add, composition_gated_add, lambda x, a, v: (x, v[2], a)),
}


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize('vector_grads', [True, False])
@pytest.mark.parametrize('d', WIDTHS)
@pytest.mark.parametrize('case', list(CASES))
def test_plain_forward_and_backward_equal_the_composition(case, d, vector_grads):
    r"""Every output and every input's gradient, the vectors' sums over the
    tokens included where they take gradients, in float64."""

    fn, composition, args = CASES[case]
    x, a, mod = operands(d)
    mod.requires_grad_(vector_grads)
    inputs = args(x, a, mod.chunk(6, dim=1)[:3])
    got, want = outputs(fn(*inputs)), outputs(composition(*inputs))
    leaves = [t for t in (x, a, mod) if t.requires_grad]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    for g, w in zip(grads(got, leaves), grads(want, leaves)):
        assert (g is None) == (w is None)
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize('d', WIDTHS)
def test_plain_formulas_equal_the_composition(d):
    r"""The plain functions the kernels are held to on the card, called
    directly: the statistics, ``da = gate dx`` from the unrounded sum, and
    each vector's sum."""

    x, a, mod = operands(d)
    shift, scale, gate = mod.chunk(6, dim=1)[:3]
    xp, h, mean, rstd = dk.gated_norm_modulate_plain(x, gate, a, shift, scale)
    torch.testing.assert_close(mean, xp.mean(-1))
    torch.testing.assert_close(rstd, (xp.var(-1, correction=0) + dk.EPS).rsqrt())

    dh, ds = randn(3, *h.shape), randn(4, *h.shape)
    xp_want, h_want = composition_gated_norm_modulate(x, gate, a, shift, scale)
    want = torch.autograd.grad((xp_want, h_want), (x, a, shift, scale, gate), (ds, dh))
    dx, da = dk.norm_modulate_bwd_plain(dh, ds, xp, mean, rstd, scale, gate)
    dshift, dscale, dgate = dk.vector_grads_plain(dh, xp, mean, rstd, dx, a)
    for got, w in zip((dx, da, dshift, dscale, dgate), want):
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-10)

    dy = randn(5, *x.shape)
    dm_want, dgate_want = torch.autograd.grad(composition_gated_add(x, gate, a), (a, gate), dy)
    torch.testing.assert_close(dk.gated_add_bwd_plain(dy, gate), dm_want)
    torch.testing.assert_close(dk.vector_grads_plain(None, None, None, None, dy, a)[2], dgate_want)


@pytest.mark.parametrize('d', WIDTHS)
@pytest.mark.parametrize('case', list(CASES))
def test_bf16_rounds_once(case, d):
    r"""In bf16 the plain versions compute in float32 and round each output
    once: each lies within half a bf16 unit of the float64 composition of
    its bf16 inputs (``h`` of the gated site: of the rounded ``x'``)."""

    fn, composition, args = CASES[case]
    x, a, mod = operands(d, dtype=torch.bfloat16, grad=False, n=64)
    inputs = args(x, a, mod.chunk(6, dim=1)[:3])
    got = outputs(fn(*inputs))
    exact = outputs(composition(*(t.double() for t in inputs)))
    if case == 'gated_norm_modulate':
        exact = (exact[0], composition_norm_modulate(got[0].double(), *(t.double() for t in inputs[3:])))
    for g, e in zip(got, exact):
        assert g.dtype == torch.bfloat16
        err = ((g.double() - e).abs() / (2.0 ** -8 * e.abs().clamp_min(2.0 ** -6))).max()
        assert err <= 1.0 + 1e-3, err


def tiny_block(d=16, heads=2, dtype=None, seed=0):
    torch.manual_seed(seed)
    block = DiTBlock(d, heads, dtype=dtype)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.3 * torch.randn(p.shape))  # nonzero gates: adaLN-Zero's init would zero the branches
    return block


@pytest.mark.parametrize('d', WIDTHS)
def test_block_fused_path_equals_the_plain_path(d):
    r"""``forward_fused`` (the autograd functions, on the CPU their plain
    versions) against ``forward_plain``: the output, the input VJP and
    every parameter's gradient, in float32."""

    block = tiny_block(d, heads=2)
    x, c = randn(0, 3, 7, d, dtype=torch.float32, grad=True), randn(1, 3, d, dtype=torch.float32)
    got = {}
    for name in ('forward_fused', 'forward_plain'):
        vectors = [v for v in torch.chunk(block.adaLN_modulation(c), 6, dim=1)]
        out = getattr(block, name)(x, *vectors)
        got[name] = [out] + list(grads([out], [x] + list(block.parameters())))
    for g, w in zip(got['forward_fused'], got['forward_plain']):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cpu_inputs_take_the_plain_path(dtype):
    r"""On the CPU, float32 or bf16, a block runs today's code bit for bit
    and no kernel counter moves."""

    torch.manual_seed(0)
    dit = DiT(input_size=8, patch_size=2, in_channels=3, out_channels=2, hidden_size=16, depth=2, num_heads=2,
              dtype=None if dtype == torch.float32 else dtype)
    x, t = randn(0, 2, 3, 8, 8, dtype=torch.float32), torch.rand(2, generator=torch.Generator().manual_seed(1))
    before = dict(tracing.counters)
    dit(x, t)
    assert tracing.counters['dit.blocks'] - before['dit.blocks'] == 2 * 2
    assert all(tracing.counters[k] == before[k] for k in KERNEL_COUNTERS)

    h, c = dit.x_embedder(x) + dit.pos_embed.to(dtype), dit.t_embedder(t)
    vectors = adaln(dit.blocks[0].adaLN_modulation, c, 6)
    assert h.dtype == dtype and not dk.fits(h, vectors[0])
    assert torch.equal(dit.blocks[0](h, c), dit.blocks[0].forward_plain(h, *vectors))


def test_launchers_refuse_a_cpu_tensor():
    x, a, mod = operands(16, dtype=torch.bfloat16, grad=False)
    shift, scale, gate = mod.chunk(6, dim=1)[:3]
    with pytest.raises(ValueError, match='CUDA'):
        dk.launch_norm_modulate(x, shift, scale)
    with pytest.raises(ValueError, match='CUDA'):
        dk.launch_gated_add(x, gate, a)
    assert not dk.fits(x, shift)


def test_fused_blocks_reader():
    r"""``fused_dit_blocks_pct.assim`` reads the counters of the spans'
    window; a program without ``dit.blocks_fused`` (the parent's), a U-Net
    cell and the CPU give nothing."""

    read = run.load('metrics', 'fused_dit_blocks_pct.assim').read
    work = {'driver': 'assim'}

    def cell(counters, driver='assim'):
        reading = {'dev': [], 'matched': 1.0, 'spans': {}, 'counters': counters}
        return {'cuda': True, 'trace': {'dev': []}, 'work': dict(work, driver=driver), 'spans': reading}

    assert read(cell({'dit.blocks': 56, 'dit.blocks_fused': 56})) == 100
    assert read(cell({'dit.blocks': 56, 'dit.blocks_fused': 28})) == 50
    assert read(cell({'dit.blocks': 56})) is None
    assert read(cell({'dit.blocks': 0, 'dit.blocks_fused': 0, 'unet.blocks': 9})) is None
    assert read(cell({'dit.blocks': 56, 'dit.blocks_fused': 56}, driver='train')) is None
    assert read({'cuda': False, 'trace': 1, 'work': work}) is None

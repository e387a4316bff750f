r"""The diffusion transformer (``sda_tpu_torch.nn.dit``) as the Kolmogorov
window kernel, against the benchmark's plain reference
(``portbench/reference/dit.py``, which computes attention, LayerNorm, GELU and
the patches by hand) on seeded weights at a tiny size: depth 2, width 64, 4
heads of 16, patch 2, 16^2 fields, 11 channels in and 10 out. In float32 the
two differ by float32's rounding alone. Besides: the position table and the
unpatchify on hand-checked cases, every block's part in the output, the
``make_score`` dispatch, the FLOP count against PyTorch's, the spans and
counters, AdamW steps through ``Trainer`` and one guided sampler step."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import dit as ref
from portbench.reference import unet as unet_ref
from sda_tpu_torch import tracing
from sda_tpu_torch.diffusion import VPSDE, GaussianScore, LocalScoreDiT, LocalScoreUNet
from sda_tpu_torch.experiments.kolmogorov.assimilate import coarse_observation
from sda_tpu_torch.experiments.kolmogorov.utils import make_score, make_trajectory_eps
from sda_tpu_torch.nn.dit import DiT, sincos_2d
from sda_tpu_torch.nn.flops import dit_flops
from sda_tpu_torch.train import TrajectoryDataset, Trainer

TINY = dict(arch='dit', window=5, size=16, patch_size=2, hidden_size=64, depth=2, num_heads=4, mlp_ratio=4.0,
            bf16=False)
#: float32 against float32 through two blocks, where the two sides sum in
#: other orders (a convolution against a product of patches, SDPA against
#: the written-out softmax): outputs of order 1, a few float32 ulps.
ATOL = RTOL = 1e-5


def tiny(seed=0, **overrides):
    r"""The port's tiny window kernel and its reference on one seeded tree."""

    config = dict(TINY, **overrides)
    tree = ref.init_tree(config, torch.Generator().manual_seed(seed))
    module = make_score(**config)
    module.load_state_dict({'dit.' + k: v for k, v in tree.items()})
    return module, ref.DiT(unet_ref.to_device(tree, 'cpu'), config), tree


def inputs(n=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 10, 16, 16, generator=g), torch.rand(n, generator=g)


def test_forward_and_input_vjp_equal_the_reference():
    module, net, _ = tiny()
    x, t = inputs()
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    got = {}
    for name, fn in (('port', module), ('reference', net)):
        xr = x.clone().requires_grad_(True)
        out = fn(xr, t)
        (vjp,) = torch.autograd.grad((out * v).sum(), xr)
        got[name] = out.detach(), vjp
    assert got['port'][0].abs().max() > 0.1  # not the zero network of adaLN-Zero's initialisation
    # The forward: ATOL and RTOL as above. The VJP sums the same products
    # backwards over every output, some thousand terms of order 1 per
    # element, so its rounding is a few times the forward's.
    assert torch.allclose(got['port'][0], got['reference'][0], atol=ATOL, rtol=RTOL)
    assert torch.allclose(got['port'][1], got['reference'][1], atol=10 * ATOL, rtol=10 * RTOL)


@pytest.mark.parametrize('block', range(TINY['depth']))
def test_every_block_contributes(block):
    r"""A block whose two gates are zeroed is the identity: the output moves
    by far more than the rounding tolerance."""

    module, _, _ = tiny()
    x, t = inputs()
    full = module(x, t).detach()
    d = TINY['hidden_size']
    linear = module.dit.blocks[block].adaLN_modulation[1]
    with torch.no_grad():
        for k in (2, 5):  # gate_msa, gate_mlp
            linear.weight[k * d:(k + 1) * d] = 0
            linear.bias[k * d:(k + 1) * d] = 0
    cut = module(x, t).detach()
    assert float((cut - full).abs().max()) > 1e3 * ATOL * float(full.abs().max())


def test_sincos_table_by_hand():
    r"""Token ``(i, j)`` of a row-major grid reads ``[sin j, cos j, sin i,
    cos i]`` at width 4; at width 8 the frequencies are 1 and 1e-2."""

    table = sincos_2d(4, 2)
    for i in range(2):
        for j in range(2):
            want = torch.tensor([math.sin(j), math.cos(j), math.sin(i), math.cos(i)])
            assert torch.allclose(table[2 * i + j], want)
    table = sincos_2d(8, 3)
    i, j = 2, 1
    want = [math.sin(j), math.sin(j / 100), math.cos(j), math.cos(j / 100),
            math.sin(i), math.sin(i / 100), math.cos(i), math.cos(i / 100)]
    assert torch.allclose(table[3 * i + j], torch.tensor(want))
    assert torch.equal(sincos_2d(1152, 32), ref.sincos(1152, 32, 'cpu'))


def test_unpatchify_by_hand():
    r"""Token ``(i, j)``'s values ``v[(a p + b) C + c]`` land at pixel ``(i p
    + a, j p + b)`` of channel ``c``."""

    dit = DiT(input_size=4, patch_size=2, in_channels=1, out_channels=2, hidden_size=8, depth=0, num_heads=1)
    tokens = torch.arange(4 * 4 * 2, dtype=torch.float32).reshape(1, 4, 8)  # 4 tokens, p p C = 8
    field = dit.unpatchify(tokens)
    assert field.shape == (1, 2, 4, 4)
    for i in range(2):
        for j in range(2):
            for a in range(2):
                for b in range(2):
                    for c in range(2):
                        assert field[0, c, 2 * i + a, 2 * j + b] == 8 * (2 * i + j) + (2 * a + b) * 2 + c
    assert torch.equal(field[0, 0, 0], torch.tensor([0.0, 2.0, 8.0, 10.0]))


def test_make_score_builds_the_dit_and_still_the_unet():
    module = make_score(**TINY)
    assert isinstance(module, LocalScoreDiT) and len(module.dit.blocks) == 2
    assert module.dit.blocks[0].attn.qkv.weight.shape == (192, 64)
    assert module.dit.x_embedder.proj.weight.shape == (64, 11, 2, 2)

    unet = dict(window=5, embedding=8, hidden_channels=(4, 8), hidden_blocks=(1, 1), kernel_size=3, size=16)
    torch.manual_seed(3)
    plain = make_score(**unet)
    torch.manual_seed(3)
    named = make_score(**unet, arch='unet')
    torch.manual_seed(3)
    direct = LocalScoreUNet(channels=10, size=16, embedding=8, hidden_channels=(4, 8), hidden_blocks=(1, 1),
                            kernel_size=3, activation=torch.nn.functional.silu, circular=True)
    assert isinstance(plain, LocalScoreUNet)
    x, t = inputs()
    for other in (named, direct):
        assert plain.state_dict().keys() == other.state_dict().keys()
        assert all(torch.equal(v, other.state_dict()[k]) for k, v in plain.state_dict().items())
        assert torch.equal(plain(x, t), other(x, t))
    with pytest.raises(ValueError):
        make_score(**unet, arch='vit')


def test_flops_equal_pytorch_count():
    r"""``dit_flops`` equals ``FlopCounterMode`` over a forward; on the CPU the
    attention takes SDPA's math path, which the counter sees as two batched
    products."""

    from torch.nn.attention import SDPBackend, sdpa_kernel

    module = make_score(**TINY)
    x, t = inputs(n=2)
    with FlopCounterMode(display=False) as counter, sdpa_kernel(SDPBackend.MATH):
        module(x, t)
    assert counter.get_total_flops() == 2 * dit_flops(11, 10, 16, 2, 64, 2, 4.0)
    assert dit_flops(11, 10, 64) == 1_049_161_531_392  # DiT-XL/2 over a 64^2 window


def test_spans_and_counters():
    module, _, _ = tiny()
    x, t = inputs(n=3)
    before = dict(tracing.counters)
    with torch.no_grad():
        module(x.unsqueeze(0).expand(2, -1, -1, -1, -1), t[0])  # 2 x 3 windows
    assert tracing.counters['dit.blocks'] - before['dit.blocks'] == 2 * 6
    assert tracing.counters['dit.attention'] - before['dit.attention'] == 2 * 6

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.enable(), torch.no_grad():
            module(x, t)
    names = [e.name for e in prof.events()]
    assert names.count('dit.attention') == 2 and names.count('dit.adaln') == 2 * 3


def test_two_adamw_steps_equal_the_reference():
    module, _, tree = tiny(seed=4)
    data = torch.randn(6, 8, 2, 16, 16, generator=torch.Generator().manual_seed(5))
    dataset = TrajectoryDataset(data, window=5, flatten=True, device='cpu')
    trainer = Trainer(VPSDE(shape=(10, 16, 16)), module, dataset, dataset, epochs=4, batch_size=3,
                      learning_rate=1e-3, weight_decay=1e-3)
    g = torch.Generator().manual_seed(6)
    batches = [(dataset.crop(data[[k, k + 1, k + 2]], starts=torch.tensor([0, 1, 2])), torch.rand(3, generator=g),
                torch.randn(3, 10, 16, 16, generator=g)) for k in (0, 3)]
    losses = [float(trainer.train_step(*batch)) for batch in batches]

    p0 = unet_ref.to_device(tree, 'cpu')
    want = unet_ref.adamw_steps(p0, lambda p: ref.DiT(p, TINY), batches, [trainer.lr(0), trainer.lr(1)], 1e-3)
    assert losses == pytest.approx(want['losses'], rel=1e-5)
    params = {k: p.detach() for k, p in module.named_parameters()}
    d = TINY['hidden_size']
    for k, v in want['params'].items():
        got = params['dit.' + k]
        if k.endswith('attn.qkv.bias'):
            # The keys' bias shifts every score of a query alike, which the
            # softmax ignores: its gradient is rounding alone, and Adam's
            # step lr m / sqrt(v) moves it by up to lr a step either way.
            assert float((got[d:2 * d] - v[d:2 * d]).abs().max()) <= 2 * 2 * trainer.lr(0)
            got, v = torch.cat((got[:d], got[2 * d:])), torch.cat((v[:d], v[2 * d:]))
        # Elsewhere the steps agree to a small share of lr (1e-3).
        assert torch.allclose(got, v, atol=1e-5, rtol=1e-5), k


def test_guided_step_equals_the_reference():
    r"""``make_score(arch='dit')`` through ``make_trajectory_eps``,
    ``GaussianScore`` and ``VPSDE.sample``: one step (predictor and a
    correction) against the reference's guided step."""

    module, net, _ = tiny(seed=7)
    module.requires_grad_(False)
    shape = (2, 8, 2, 16, 16)
    g = torch.Generator().manual_seed(8)
    y = torch.randn(2, 2, 2, 2, generator=g)[0]
    x = torch.randn(shape, generator=g)
    noise = {(i, 0): torch.randn(shape, generator=g) for i in range(4)}
    guided = GaussianScore(y=y, A=coarse_observation, std=0.1, gamma=1e-2,
                           sde=VPSDE(eps=make_trajectory_eps(module, 5), shape=()))
    want = VPSDE(eps=guided, shape=shape[1:]).sample((2,), steps=4, corrections=1, tau=0.5, init=x,
                                                      noise=lambda i, j: noise[i, j], segment=(1, 2))
    got = unet_ref.GuidedStep(net, 5, y, 0.1, 1e-2, 4, 1, 0.5, chunk=3)(x, 1, lambda i, j: noise[i, j])
    assert float((got - want).abs().max()) < 1e-4 * max(1.0, float(want.abs().max()))

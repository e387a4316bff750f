r"""Each driver's unit of work against the plain reference at a tiny size on
the CPU: in float32 the two agree to rounding, and each reference piece
equals the port's counterpart."""

import pytest
import torch

from portbench.reference import unet as ref
from portbench.reference.kolmogorov import KolmogorovReference
from portbench.tests.conftest import TINY, run_tiny

@pytest.mark.parametrize('cell', ['assim64', 'assim256', 'train64', 'datagen256'])
def test_cell_agrees_with_the_reference_in_float32(cell):
    r"""In float32 the program differs from the reference by float32's
    rounding alone: every number far under its limit, which allows bf16's."""

    result = run_tiny(cell)
    checks = result['checks']
    assert checks and all(c['value'] < c['limit'] / 50 for c in checks.values()), checks
    assert result['attempted'] > 0 and result['metrics'] == {}  # no device metric from a CPU run


def program_and_control(cell, device):
    r"""The configuration's bf16 (the solver: its float32) passes the cell's
    limits; the control, the reference a precision lower in the program's
    place, fails one."""

    result = run_tiny(cell, bf16=True, device=device, inspect=lambda driver: driver.control())
    for name, c in result['checks'].items():
        assert c['value'] <= c['limit'], (name, c)
    assert any(value > limit for _, value, limit in result['readings']), result['readings']


@pytest.mark.parametrize('cell', ['assim64', 'assim256', 'train64', 'datagen256'])
def test_bf16_program_and_its_control(cell):
    program_and_control(cell, 'cpu')


@pytest.mark.gpu
@pytest.mark.parametrize('cell', ['assim64', 'assim256', 'train64', 'datagen256'])
def test_bf16_program_and_its_control_on_the_card(cell, cuda):
    r"""The same on the card, where the products run on its kernels (the
    solver's transforms on the CUDA DFT kernels)."""

    program_and_control(cell, cuda)


def test_score_unet_equals_the_port():
    from sda_tpu_torch.experiments.kolmogorov.utils import make_score
    from sda_tpu_torch.train import params_from_flax

    tree = ref.init_tree(TINY, torch.Generator().manual_seed(1))
    module = make_score(**TINY)
    module.load_state_dict(params_from_flax(ref.nest(tree)))
    x = torch.randn(3, 10, 16, 16)
    t = torch.rand(3)
    want = module(x, t)
    got = ref.ScoreUNet(ref.to_device(tree, 'cpu'), TINY)(x, t)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_kolmogorov_equals_the_port():
    from sda_tpu_torch.dynamics import KolmogorovFlow

    chain = KolmogorovFlow(size=32, dt=0.2, device='cpu')
    solver = KolmogorovReference(32, 0.2, 'cpu')
    noise = torch.randn(2, 2, 32, 32, generator=torch.Generator().manual_seed(3))
    x0 = chain.prior((2,), noise=noise)
    assert torch.allclose(solver.prior(noise), x0, atol=1e-5)
    want = chain.trajectory(x0, length=3)
    got = solver.trajectory(x0, 3)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) < 1e-5


def test_adamw_equals_torch():
    tree = ref.init_tree(TINY, torch.Generator().manual_seed(2))
    params = ref.to_device(tree, 'cpu')
    x, t, z = torch.randn(4, 10, 16, 16), torch.rand(4), torch.randn(4, 10, 16, 16)
    out = ref.adamw_steps(params, lambda p: ref.ScoreUNet(p, TINY), [(x, t, z)] * 2, [1e-3, 1e-3],
                          TINY['weight_decay'])
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.AdamW(list(p.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-3)
    for _ in range(2):
        opt.zero_grad()
        ref.denoising_loss(ref.ScoreUNet(p, TINY), x, t, z).backward()
        opt.step()
    for k in p:
        assert torch.allclose(out['params'][k], p[k].detach(), atol=1e-6)


def test_guided_step_equals_the_port():
    from sda_tpu_torch.diffusion import VPSDE, GaussianScore, MCScoreNet
    from sda_tpu_torch.experiments.kolmogorov.assimilate import coarse_observation
    from sda_tpu_torch.experiments.kolmogorov.utils import make_score
    from sda_tpu_torch.train import params_from_flax

    tree = ref.init_tree(TINY, torch.Generator().manual_seed(4))
    module = make_score(**TINY)
    module.load_state_dict(params_from_flax(ref.nest(tree)))
    module.requires_grad_(False)
    shape = (2, 8, 2, 16, 16)
    g = torch.Generator().manual_seed(5)
    y = torch.randn(2, 2, 2, 2, generator=g)[0]
    x = torch.randn(shape, generator=g)
    noise = {(i, j): torch.randn(shape, generator=g) for i in range(4) for j in range(1)}

    guided = GaussianScore(y=y, A=coarse_observation, std=0.1, sde=VPSDE(eps=MCScoreNet(module, 2), shape=()),
                           gamma=1e-2)
    sde = VPSDE(eps=guided, shape=shape[1:])
    want = sde.sample((2,), steps=4, corrections=1, tau=0.5, init=x, noise=lambda i, j: noise[i, j],
                      segment=(1, 2))
    step = ref.GuidedStep(ref.ScoreUNet(ref.to_device(tree, 'cpu'), TINY), 5, y, 0.1, 1e-2, 4, 1, 0.5, chunk=3)
    got = step(x, 1, lambda i, j: noise[i, j])
    assert float((got - want).abs().max()) < 1e-4 * max(1.0, float(want.abs().max()))

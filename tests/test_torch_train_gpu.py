r"""The port's training path on the card against the same on the CPU.

Marked ``gpu``: every test skips without a CUDA device. The card's machine
has no JAX, so run this file there without the repository's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_train_gpu.py

This file imports only the port and torch. Float32 runs with ``allow_tf32``
off on the card, so the two devices differ only by summation order.
"""

import pytest
import torch
import torch.nn.functional as F

from sda_tpu_torch.diffusion import VPSDE, LocalScoreUNet, ScoreNet
from sda_tpu_torch.nn import reset_parameters
from sda_tpu_torch.train import TrajectoryDataset, Trainer, restore_checkpoint, save_checkpoint

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def trainer(module, data, device, **kwargs):
    module = module.to(device)
    dataset = TrajectoryDataset(data, window=3, flatten=True, device=device)
    shape = dataset.crop(dataset.data[:1]).shape[1:]
    return Trainer(VPSDE(shape=tuple(shape)), module, dataset, dataset, epochs=8, batch_size=4,
                   generator=torch.Generator(device=device).manual_seed(0), **kwargs)


@pytest.mark.parametrize('model', ['score_net', 'local_score_unet'])
def test_train_steps_match_cpu(cuda, model):
    r"""Three AdamW steps with the same batches, ``t`` and noise on both
    devices: losses within 1e-5 relative, parameters within 1e-2 lr (Adam's
    first steps move every parameter by about lr whatever its gradient, so
    only a gradient at float32 noise level could differ more; none does at
    these sizes)."""

    g = torch.Generator().manual_seed(1)
    if model == 'score_net':
        make = lambda: ScoreNet(9, embedding=8, hidden_features=(32, 32), activation=F.silu)  # noqa: E731
        data = torch.randn(6, 10, 3, generator=g)
    else:
        make = lambda: LocalScoreUNet(6, size=16, embedding=8, hidden_channels=(8, 16),  # noqa: E731
                                      hidden_blocks=(1, 1), activation=F.silu)
        data = torch.randn(6, 10, 2, 16, 16, generator=g)
    lr = 1e-3

    sides = {}
    for name, device in (('cpu', torch.device('cpu')), ('card', cuda)):
        module = reset_parameters(make(), torch.Generator().manual_seed(0))
        sides[name] = trainer(module, data, device, learning_rate=lr)

    losses = {k: [] for k in sides}
    for step in range(3):
        x = data[[step, step + 1, step + 2, step + 3], :3].flatten(1, 2)
        t = torch.rand(4, generator=g)
        z = torch.randn(x.shape, generator=g)
        for name, side in sides.items():
            device = side.trainset.data.device
            losses[name].append(side.train_step(x.to(device), t.to(device), z.to(device)).item())

    assert losses['card'] == pytest.approx(losses['cpu'], rel=1e-5)
    for a, b in zip(sides['cpu'].module.parameters(), sides['card'].module.parameters()):
        assert (a - b.cpu()).abs().max().item() <= 1e-2 * lr


def test_resume_on_the_card_is_bitwise(cuda, tmp_path):
    r"""Two epochs, or one, a checkpoint, a restore and one more, with the
    card's own generator: the same parameters, bit for bit."""

    data = torch.randn(8, 10, 3, generator=torch.Generator().manual_seed(2))

    def make(seed):
        module = reset_parameters(ScoreNet(9, embedding=8, hidden_features=(32,)), torch.Generator().manual_seed(seed))
        return trainer(module, data, cuda)

    straight = make(0)
    stats = [straight.step_epoch() for _ in range(2)]

    first = make(0)
    first.step_epoch()
    save_checkpoint(first, tmp_path / 'checkpoint.msgpack')
    second = make(1)
    restore_checkpoint(second, tmp_path / 'checkpoint.msgpack')
    assert second.step_epoch() == stats[1]
    for a, b in zip(straight.module.parameters(), second.module.parameters()):
        assert torch.equal(a, b)

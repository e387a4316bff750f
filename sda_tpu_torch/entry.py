r"""One forward of the flagship window kernel.

Counterpart of ``entry()`` of the JAX package's ``__graft_entry__.py``: the
Kolmogorov ``LocalScoreUNet`` that ``experiments/kolmogorov/train.py``
trains (window 5, 64^2, embedding 64, widths (96, 192, 384), blocks (3, 3,
3), SiLU, circular), with weights drawn as a fresh network's from a
generator seeded 0. The multi-rank dry run of the same file is
``python -m sda_tpu_torch.parallel.demo``.

    python -m sda_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from .diffusion import LocalScoreUNet
from .nn import reset_parameters
from .utils import resolve_device, set_float32_precision

Tensor = torch.Tensor


def entry(device: Union[str, torch.device] = 'cuda') -> Tuple[LocalScoreUNet, Tuple[Tensor, Tensor]]:
    r"""Returns ``(fn, (x, t))``: the flagship kernel, frozen, whose call
    ``fn(x, t)`` is its forward, and an example input, ``x`` zeros ``(2, 10,
    64, 64)`` and ``t`` 0.5 per element, on ``device``."""

    device = resolve_device(device)
    window = 5
    module = LocalScoreUNet(
        channels=window * 2,
        size=64,
        embedding=64,
        hidden_channels=(96, 192, 384),
        hidden_blocks=(3, 3, 3),
        activation=F.silu,
        circular=True,
    )
    fn = reset_parameters(module, torch.Generator().manual_seed(0)).requires_grad_(False).eval().to(device)

    x = torch.zeros((2, window * 2, 64, 64), device=device)
    t = torch.full((2,), 0.5, device=device)

    return fn, (x, t)


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--device', type=str, default='cuda')
    args = parser.parse_args()

    fn, args_ = entry(args.device)
    out = fn(*args_)
    print('entry OK:', tuple(out.shape))

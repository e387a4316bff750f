r"""Shared helpers: broadcasting, configs, activation registry, devices.

Counterpart of :mod:`sda_tpu.utils` (``broadcast``, ``random_config``,
``save_config``, ``load_config``, ``ACTIVATIONS``), plus :func:`resolve_device`, which every entry point of the
port uses to refuse a silent fall back to the CPU.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Callable, Dict, Sequence, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: Name -> elementwise activation, the same registry as ``sda_tpu.utils``.
ACTIVATIONS: Dict[str, Callable[[Tensor], Tensor]] = {
    'ReLU': F.relu,
    'ELU': F.elu,
    # jax.nn.gelu defaults to the tanh approximation.
    'GELU': lambda x: F.gelu(x, approximate='tanh'),
    'SELU': F.selu,
    'SiLU': F.silu,
}


def resolve_device(device: Union[str, torch.device] = 'cuda') -> torch.device:
    r"""Returns ``torch.device(device)``, raising if it names CUDA and no card
    is present (entry points run on the card unless asked for the CPU)."""

    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def broadcast(*tensors: Tensor, ignore: int = 0) -> tuple:
    r"""Broadcasts tensors to a common shape, ignoring the last ``ignore`` axes
    (event axes), as ``sda_tpu.utils.broadcast``."""

    if ignore > 0:
        dims = [t.shape[:-ignore] for t in tensors]
        tails = [t.shape[-ignore:] for t in tensors]
    else:
        dims = [t.shape for t in tensors]
        tails = [() for _ in tensors]

    common = torch.broadcast_shapes(*dims)

    return tuple(
        t.expand(common + tuple(tail)) for t, tail in zip(tensors, tails)
    )


def random_config(configs: Dict[str, Sequence[Any]], seed: int = None) -> Dict[str, Any]:
    r"""Uniformly samples one value per key with ``random.Random(seed)``, as
    ``sda_tpu.utils.random_config``."""

    gen = random.Random(seed)

    return {key: gen.choice(list(values)) for key, values in configs.items()}


def save_config(config: Dict[str, Any], path: Path) -> None:
    r"""Writes ``config.json`` into the run directory ``path`` (mode ``'x'``:
    fails if it already exists)."""

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    with open(path / 'config.json', mode='x') as f:
        json.dump(config, f)


def load_config(path: Path) -> Dict[str, Any]:
    r"""Reads ``config.json`` from a run directory."""

    with open(Path(path) / 'config.json', mode='r') as f:
        return json.load(f)

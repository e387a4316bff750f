r"""Shared helpers: broadcasting, configs, activation registry, devices.

Counterpart of :mod:`sda_tpu.utils` (``broadcast``, ``random_config``,
``save_config``, ``load_config``, ``ACTIVATIONS``, :class:`profile_trace`), plus :func:`resolve_device`, which every
entry point of the port uses to refuse a silent fall back to the CPU, :func:`chunk_generator` and
:func:`set_float32_precision`, which every command line of the port calls first. The JAX package's
``enable_compilation_cache`` has no counterpart: eager PyTorch compiles nothing but the CUDA library, which
``ops.dft_kernels`` already caches by source hash.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Callable, Dict, Sequence, Union

import numpy as np
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


#: Whether float32 convolutions run in TF32 on the card (cuDNN), as torch's
#: default has them; float32 matmuls never do (``RealDFT2('matmul')`` is the
#: plain version of the DFT kernels and needs true float32).
CONV_TF32 = True


def set_float32_precision() -> None:
    r"""Sets the float32 precision of the card's convolutions (``CONV_TF32``)
    and matmuls (true float32) through torch's global flags
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``, the legacy API: the
    ``fp32_precision`` attributes must not be mixed with it in one process.
    Command lines call it before anything else; library functions leave the
    flags alone."""

    torch.backends.cudnn.allow_tf32 = CONV_TF32
    torch.backends.cuda.matmul.allow_tf32 = False


def chunk_generator(seed: int, index: int, device: Union[str, torch.device]) -> torch.Generator:
    r"""The generator of chunk ``index`` of a simulation seeded ``seed``: its
    stream depends on the two only, as the JAX packs split one key per
    chunk, so a chunk's trajectories do not depend on the chunks before."""

    state = np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) % 2**63)


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


class profile_trace:
    r"""Context manager around ``torch.profiler``: traces the host and, where
    a card is present, the device, and writes a Chrome/TensorBoard trace
    (``*.pt.trace.json``) under ``path``. The profiler object is
    ``self.profiler`` (``key_averages()`` for device time by kernel).

    Unlike :class:`sda_tpu.utils.profile_trace`, a failure to start or stop
    the profiler raises: a profile that is silently absent hides the device.

    >>> with profile_trace('/tmp/trace'):
    ...     step(...)
    """

    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        self.active = False
        self.profiler = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(self.path))
        self.profiler.__enter__()
        self.active = True
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        return False

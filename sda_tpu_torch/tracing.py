r"""Spans and counters inside the port.

A span marks a stretch of host code under ``torch.profiler``: a profiler's
trace then shows it beside the host's operators and, on the same clock, the
device operations it launched. Spans are off by default; :func:`span` then
returns one shared no-op context, so a span site costs a flag test and no
call into the profiler. :func:`enable` turns them on for a block, as
:class:`~sda_tpu_torch.utils.profile_trace` does for its trace.

The counters are plain integers in :data:`counters`, always on, each
incremented where its work is issued.

Spans:

- ``guidance.forward`` / ``guidance.vjp``: :class:`~sda_tpu_torch.diffusion.GaussianScore`'s
  prior eps (autograd on) and its input VJP (a checkpointed eps's recompute
  falls inside it);
- ``windowed.kernel``: each call of the window kernel in
  :mod:`~sda_tpu_torch.diffusion.windowed` (the whole unfolded batch, or one
  chunk; a checkpointed chunk's recompute is a second span);
- ``train.forward`` / ``train.backward`` / ``train.optimizer``: the phases of
  :class:`~sda_tpu_torch.train.Trainer`'s step;
- ``kolmogorov.substep``: :meth:`~sda_tpu_torch.dynamics.KolmogorovFlow.substep`;
- ``dit.attention``: each DiT block's attention kernel call
  (:func:`~sda_tpu_torch.nn.dit.attention`);
- ``dit.adaln``: each DiT block's two LayerNorm-and-modulate sites and its
  two gated residual adds (:class:`~sda_tpu_torch.nn.dit.DiTBlock`).

Counters:

- ``unet.windows``: windows handed to the window kernel (batch x windows of
  each call, pad windows and recomputes included);
- ``unet.blocks``: calls of a U-Net residual block, and ``unet.blocks_fused``
  those whose ``norm_pad`` kernel launched (:meth:`~sda_tpu_torch.nn.UNet.forward_fused`);
- ``unet.norm_pad`` / ``unet.norm_pad_bwd`` / ``unet.act_pad`` /
  ``unet.act_pad_bwd``: launches of those kernels
  (:mod:`~sda_tpu_torch.ops.unet_kernels`), forward and backward;
- ``dft.rfft2`` / ``dft.irfft2``: launches of the DFT kernels
  (:data:`~sda_tpu_torch.ops.dft_kernels.launches` reads them);
- ``dit.blocks`` / ``dit.attention``: the windows (batch) of each DiT block
  call and of each of its attention calls, summed; ``dit.blocks_fused`` the
  windows of the block calls whose three glue sites launched kernels
  (:meth:`~sda_tpu_torch.nn.dit.DiTBlock.forward_fused`);
- ``dit.norm_mod`` / ``dit.norm_mod_bwd`` / ``dit.gated_norm_mod`` /
  ``dit.gated_norm_mod_bwd`` / ``dit.gated_add`` / ``dit.gated_add_bwd``:
  launches of those kernels (:mod:`~sda_tpu_torch.ops.dit_kernels`), forward
  and backward.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

_NULL = contextlib.nullcontext()
_enabled = False

#: Every counter of the port, by name.
counters: Dict[str, int] = {
    'unet.windows': 0, 'unet.blocks': 0, 'unet.blocks_fused': 0,
    'unet.norm_pad': 0, 'unet.norm_pad_bwd': 0, 'unet.act_pad': 0, 'unet.act_pad_bwd': 0,
    'dft.rfft2': 0, 'dft.irfft2': 0,
    'dit.blocks': 0, 'dit.attention': 0, 'dit.blocks_fused': 0,
    'dit.norm_mod': 0, 'dit.norm_mod_bwd': 0, 'dit.gated_norm_mod': 0, 'dit.gated_norm_mod_bwd': 0,
    'dit.gated_add': 0, 'dit.gated_add_bwd': 0,
}


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enable() -> Iterator[None]:
    r"""Turns spans on for the block, then restores the previous state."""

    global _enabled
    previous, _enabled = _enabled, True
    try:
        yield
    finally:
        _enabled = previous


def span(name: str):
    r"""A context that marks its block as ``name`` in a profiler's trace
    while spans are on, and does nothing otherwise."""

    if not _enabled:
        return _NULL
    return torch.profiler.record_function(name)

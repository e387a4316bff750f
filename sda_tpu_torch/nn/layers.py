r"""Neural-network primitives: non-affine LayerNorm, time embedding, ResMLP.

Counterpart of :mod:`sda_tpu.nn.layers`. ``Dense`` and ``Conv`` mirror flax's
``dtype`` semantics: parameters stay float32, and with ``dtype`` set the
inputs and parameters are cast to it for the product (``bf16: true`` runs
compute in bfloat16); with ``dtype=None`` the product runs in the promoted
type of input and parameters.

A fresh ``Dense`` or ``Conv`` starts as flax's does: the kernel from
``lecun_normal`` (a normal truncated at two standard deviations, scaled to
variance ``1 / fan_in``) and a zero bias. :func:`reset_parameters` redraws
every such layer of a module from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def layer_norm(x: Tensor, dim: int = -1, eps: float = 1e-5) -> Tensor:
    r"""Standardizes ``x`` along ``dim`` with no affine terms. Statistics are
    float32 and use the population variance, as ``sda_tpu.nn.layers``."""

    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=dim, keepdim=True, correction=0)

    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


#: The standard deviation of a unit normal truncated to ``[-2, 2]``.
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> Tensor:
    r"""Fills ``weight`` as flax's ``lecun_normal``: a normal truncated at
    two standard deviations, with variance ``1 / fan_in`` after truncation."""

    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    r"""Redraws every :class:`Dense` and :class:`Conv` of ``module``, in
    module order, from ``generator``; returns ``module``."""

    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.reset_parameters(generator)
    return module


def _compute_dtype(x: Tensor, weight: Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return torch.promote_types(x.dtype, weight.dtype) if dtype is None else dtype


def kept_cast(
    module: nn.Module, name: str, dtype: torch.dtype, memory_format: torch.memory_format = torch.preserve_format,
) -> Tensor:
    r"""``module``'s parameter ``name`` cast to ``dtype`` and ``memory_format``,
    kept on the module and cast again only when the parameter changes: a new
    tensor or an in-place update (its version), or another autograd mode.
    Where the parameter takes a gradient, the kept cast carries it."""

    p = getattr(module, name)
    grad = torch.is_grad_enabled() and p.requires_grad
    key = (p.data_ptr(), p._version, p.device, dtype, memory_format, grad, torch.is_inference_mode_enabled())
    kept = module.__dict__.setdefault('_kept_casts', {})
    if name not in kept or kept[name][0] != key:
        kept[name] = (key, p.to(dtype=dtype, memory_format=memory_format))
    return kept[name][1]


class Dense(nn.Linear):
    r"""``nn.Linear`` with flax's compute-``dtype`` semantics."""

    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dtype = _compute_dtype(x, self.weight, self.compute_dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))

    def forward_kept(self, x: Tensor) -> Tensor:
        r""":meth:`forward` of an ``x`` already in the compute dtype, with the
        parameters' casts kept between calls (:func:`kept_cast`)."""

        dtype = _compute_dtype(x, self.weight, self.compute_dtype)
        return F.linear(x, kept_cast(self, 'weight', dtype), kept_cast(self, 'bias', dtype))


class Conv(nn.Module):
    r"""N-d convolution over channel-first inputs ``(N, C, *spatial)`` with
    flax's padding rules, padded explicitly:

    - ``'circular'``: wrap ``((k - 1) // 2, k // 2)`` per axis (flax
      ``'CIRCULAR'``), whatever the stride;
    - ``'same'``: zeros, ``total = max((ceil(n / s) - 1) s + k - n, 0)`` split
      ``(total // 2, total - total // 2)`` (flax/XLA ``'SAME'``). For a
      stride-2 conv that is ``(0, 1)``, where torch's ``padding=1`` would be
      ``(1, 1)``.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
        stride: Sequence[int] = None,
        padding: str = 'same',
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride) if stride is not None else (1,) * len(self.kernel_size)
        self.padding = padding
        self.compute_dtype = dtype

        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def _pads(self, spatial: Sequence[int]) -> Tuple[int, ...]:
        pads = []
        for n, k, s in zip(spatial, self.kernel_size, self.stride):
            if self.padding == 'circular':
                lo, hi = (k - 1) // 2, k // 2
            else:
                total = max((-(-n // s) - 1) * s + k - n, 0)
                lo, hi = total // 2, total - total // 2
            pads.append((lo, hi))
        # F.pad takes the last axis first.
        return tuple(p for lo_hi in reversed(pads) for p in lo_hi)

    def forward(self, x: Tensor) -> Tensor:
        dtype = _compute_dtype(x, self.weight, self.compute_dtype)
        x = x.to(dtype)

        pads = self._pads(x.shape[2:])
        if self.padding == 'circular':
            x = F.pad(x, pads, mode='circular')
        else:
            x = F.pad(x, pads)

        conv = (F.conv1d, F.conv2d, F.conv3d)[len(self.kernel_size) - 1]
        return conv(x, self.weight.to(dtype), self.bias.to(dtype), stride=self.stride)

    def wrap(self) -> Tuple[Tuple[int, int], ...]:
        r"""The circular pad ``(lo, hi)`` of each axis, first axis first."""

        return tuple(((k - 1) // 2, k // 2) for k in self.kernel_size)

    def forward_padded(self, p: Tensor, bias: bool = False) -> Tensor:
        r"""The 2-D convolution of an input ``p`` already padded (by
        :meth:`wrap`) and in the compute dtype, channels-last, without the
        bias unless ``bias``; the parameters' casts are kept between calls
        (:func:`kept_cast`)."""

        dtype = _compute_dtype(p, self.weight, self.compute_dtype)
        weight = kept_cast(self, 'weight', dtype, torch.channels_last)
        return F.conv2d(p, weight, kept_cast(self, 'bias', dtype) if bias else None, stride=self.stride)


class TimeEmbedding(nn.Module):
    r"""``t -> [cos(pi k t), sin(pi k t)]_{k=1..16} -> Dense(256) -> SiLU ->
    Dense(features)``, frequencies and phases in float32."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()

        self.register_buffer(
            'freqs', math.pi * torch.arange(1, 17, dtype=torch.float32), persistent=False
        )
        self.denses = nn.ModuleList([Dense(32, 256, dtype), Dense(256, features, dtype)])

    def forward(self, t: Tensor) -> Tensor:
        t = self.freqs * t[..., None].float()
        t = torch.cat((torch.cos(t), torch.sin(t)), dim=-1)

        t = self.denses[0](t)
        t = F.silu(t)
        return self.denses[1](t)


class ResMLP(nn.Module):
    r"""Residual MLP: per transition an optional width-changing Dense, then
    ``x + Dense(act(Dense(layer_norm(x))))`` (``sda_tpu.nn.layers.ResMLP``).
    Denses are listed in flax creation order."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        hidden_features: Sequence[int] = (64, 64),
        activation: Callable[[Tensor], Tensor] = F.relu,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.activation = activation
        self.plan = []  # per transition: whether it starts with a width change
        denses = []
        before = in_features
        for after in (*hidden_features, out_features):
            self.plan.append(after != before)
            if after != before:
                denses.append(Dense(before, after, dtype))
            denses.append(Dense(after, after, dtype))
            denses.append(Dense(after, after, dtype))
            before = after
        self.denses = nn.ModuleList(denses)

    def forward(self, x: Tensor) -> Tensor:
        layers = iter(self.denses)
        for widen in self.plan:
            if widen:
                x = next(layers)(x)
            h = layer_norm(x)
            h = next(layers)(h)
            h = self.activation(h)
            h = next(layers)(h)
            x = x + h
        return x

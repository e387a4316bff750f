r"""The diffusion transformer with adaLN-Zero blocks (DiT; Peebles & Xie,
*Scalable Diffusion Models with Transformers*, arXiv:2212.09748), as
``facebookresearch/DiT``'s ``models.py`` writes it and under its names.

Fields ``(N, C, H, W)`` are cut into ``p x p`` patches (a convolution of
kernel and stride ``p``) and become ``(H / p) (W / p)`` tokens, row-major,
with a fixed 2-D sin-cos position table added. The time ``t`` becomes ``c``
through 256 frequencies (cos first) and Linear -> SiLU -> Linear. Every block
reads six vectors from ``Linear(SiLU(c))``::

    x = x + gate_msa Attn(LN(x) (1 + scale_msa) + shift_msa)
    x = x + gate_mlp MLP(LN(x) (1 + scale_mlp) + shift_mlp)

with a LayerNorm without affine terms (eps 1e-6), attention with a qkv bias
through ``scaled_dot_product_attention`` and a tanh-GELU MLP. The final layer
is a shift-and-scale adaLN and a Linear to ``p p C_out`` per token, folded
back into a field. There is no class embedder: ``c`` is the time embedding
alone.

Linears and the patch convolution are :class:`~sda_tpu_torch.nn.layers.Dense`
and :class:`~sda_tpu_torch.nn.layers.Conv`: float32 parameters, products in
``dtype`` (the residual stream then holds ``dtype`` too); the LayerNorm's
statistics and the GELU run in float32 inside their kernels. On a CUDA input
the attention may use only a fused kernel (cuDNN, flash or memory-efficient),
never the math path that holds every head's ``N x N`` scores.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..tracing import counters, span
from .layers import Conv, Dense

Tensor = torch.Tensor

#: The attention kernels a CUDA input may use.
FUSED = ('CUDNN_ATTENTION', 'FLASH_ATTENTION', 'EFFICIENT_ATTENTION')


def norm(x: Tensor) -> Tensor:
    r"""LayerNorm over the last axis without affine terms, eps 1e-6."""

    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    r"""``x (1 + scale) + shift`` with per-sample ``shift`` and ``scale``
    broadcast over the tokens."""

    return x * (1 + scale.unsqueeze(1)) + shift.unsqueeze(1)


def sincos_1d(dim: int, pos: Tensor) -> Tensor:
    r"""``[sin(pos w), cos(pos w)]`` with ``w_k = 10000^(-2k / dim)``,
    ``k < dim / 2``; ``(M,) -> (M, dim)``, in float64."""

    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2))
    out = pos.double().reshape(-1, 1) * omega
    return torch.cat((torch.sin(out), torch.cos(out)), dim=1)


def sincos_2d(dim: int, grid: int) -> Tensor:
    r"""The fixed position table ``(grid^2, dim)`` of row-major tokens: the
    first half encodes the column, the second the row (``models.py``'s
    ``get_2d_sincos_pos_embed``, whose meshgrid puts the width first)."""

    rows, cols = torch.meshgrid(torch.arange(grid), torch.arange(grid), indexing='ij')
    return torch.cat((sincos_1d(dim // 2, cols), sincos_1d(dim // 2, rows)), dim=1).float()


def adaln(modulation: nn.Sequential, c: Tensor, n: int) -> tuple:
    r"""The ``n`` modulation vectors ``Linear(SiLU(c))`` of a block, ``c`` in
    the compute dtype; the Linear's parameter casts are kept between calls."""

    return modulation[1].forward_kept(modulation[0](c)).chunk(n, dim=1)


class PatchEmbed(nn.Module):
    r"""``(N, C, H, W) -> (N, (H / p)(W / p), hidden)``: a convolution of
    kernel and stride ``p``, tokens row-major."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()

        self.proj = Conv(in_channels, hidden_size, (patch_size,) * 2, stride=(patch_size,) * 2, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class TimestepEmbedder(nn.Module):
    r"""``t -> [cos(t f), sin(t f)] -> Linear -> SiLU -> Linear``, with
    ``f_k = 10000^(-k / 128)``, ``k < 128``, in float32."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()

        half = 128
        self.register_buffer('freqs', torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32) / half),
                             persistent=False)
        self.mlp = nn.Sequential(Dense(2 * half, hidden_size, dtype), nn.SiLU(), Dense(hidden_size, hidden_size, dtype))

    def forward(self, t: Tensor) -> Tensor:
        args = t.float()[:, None] * self.freqs
        return self.mlp(torch.cat((torch.cos(args), torch.sin(args)), dim=-1))


class Attention(nn.Module):
    r"""Multi-head self-attention with a qkv bias, ``scaled_dot_product_attention``
    at head dimension ``hidden / heads``."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()

        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, n, d = x.shape
        counters['dit.attention'] += b
        q, k, v = self.qkv.forward_kept(x).reshape(b, n, 3, self.num_heads, d // self.num_heads).permute(2, 0, 3, 1, 4)
        with span('dit.attention'):
            o = attention(q, k, v)
        return self.proj.forward_kept(o.transpose(1, 2).reshape(b, n, d))


def attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    r"""``softmax(q k^T / sqrt(d)) v`` over ``(N, heads, tokens, d)``; on a
    CUDA input through a fused kernel only."""

    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([getattr(SDPBackend, name) for name in FUSED]):
        return F.scaled_dot_product_attention(q, k, v)


class Mlp(nn.Module):
    r"""``fc2(gelu_tanh(fc1(x)))``."""

    def __init__(self, dim: int, hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()

        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2.forward_kept(F.gelu(self.fc1.forward_kept(x), approximate='tanh'))


class DiTBlock(nn.Module):
    r"""A transformer block with adaLN-Zero conditioning."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0, dtype: Optional[torch.dtype] = None):
        super().__init__()

        self.attn = Attention(hidden_size, num_heads, dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(hidden_size, 6 * hidden_size, dtype))

    def forward(self, x: Tensor, c: Tensor) -> Tensor:
        counters['dit.blocks'] += x.shape[0]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = adaln(self.adaLN_modulation, c, 6)
        with span('dit.adaln'):
            h = modulate(norm(x), shift_msa, scale_msa)
        h = self.attn(h)
        with span('dit.adaln'):
            x = x + gate_msa.unsqueeze(1) * h
            h = modulate(norm(x), shift_mlp, scale_mlp)
        h = self.mlp(h)
        with span('dit.adaln'):
            return x + gate_mlp.unsqueeze(1) * h


class FinalLayer(nn.Module):
    r"""A shift-and-scale adaLN, then a Linear to ``p p C_out`` per token."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()

        self.linear = Dense(hidden_size, patch_size * patch_size * out_channels, dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Dense(hidden_size, 2 * hidden_size, dtype))

    def forward(self, x: Tensor, c: Tensor) -> Tensor:
        shift, scale = adaln(self.adaLN_modulation, c, 2)
        x = modulate(norm(x), shift, scale)
        return self.linear.forward_kept(x)


class DiT(nn.Module):
    r"""The diffusion transformer ``(x (N, C_in, H, W), t (N,)) -> (N, C_out,
    H, W)``, ``H = W = input_size``.

    Arguments:
        input_size: The side of the square field.
        patch_size: The side of a patch.
        in_channels / out_channels: The channels in and out.
        hidden_size: The token width.
        depth: The number of blocks.
        num_heads: The attention heads (head dimension ``hidden / heads``).
        mlp_ratio: The MLP's expansion.
        dtype: The compute dtype (``None`` = float32).
    """

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        out_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()

        self.out_channels = out_channels
        self.patch_size = patch_size
        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype)
        self.register_buffer('pos_embed', sincos_2d(hidden_size, input_size // patch_size), persistent=False)
        self.blocks = nn.ModuleList([DiTBlock(hidden_size, num_heads, mlp_ratio, dtype) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, out_channels, dtype)

    def unpatchify(self, x: Tensor) -> Tensor:
        r"""``(N, h w, p p C) -> (N, C, h p, w p)`` for a square grid."""

        p, c = self.patch_size, self.out_channels
        h = w = math.isqrt(x.shape[1])
        x = x.reshape(x.shape[0], h, w, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(x.shape[0], c, h * p, w * p)

    def forward(self, x: Tensor, t: Tensor) -> Tensor:
        x = self.x_embedder(x)
        x = x + self.pos_embed.to(x.dtype)
        c = self.t_embedder(t)
        for block in self.blocks:
            x = block(x, c)
        return self.unpatchify(self.final_layer(x, c))

r"""Plain PyTorch reference of the diffusion transformer as the Kolmogorov
window kernel (``"arch": "dit"``), and its parameters drawn from a seed.

Written from the published model (Peebles & Xie, arXiv:2212.09748;
``facebookresearch/DiT``'s ``models.py``), under its parameter names
(``blocks.3.attn.qkv.weight``, Linears ``(out, in)``): the window's ``2
window`` state channels and the forcing ``sin(4 b)`` are cut into ``p x p``
patches by reshape and embedded by one product, a fixed 2-D sin-cos table is
added, and ``t`` is embedded through 256 frequencies (cos first) and Linear ->
SiLU -> Linear into ``c``. Each block takes six vectors ``Linear(SiLU(c))``
and computes

    x += gate_msa * attn(ln(x) * (1 + scale_msa) + shift_msa)
    x += gate_mlp * mlp(ln(x) * (1 + scale_mlp) + shift_mlp)

with ``ln`` a LayerNorm without affine terms (eps 1e-6, written out), the
attention written out as ``softmax(q k^T / sqrt(d)) v`` per head and the MLP's
GELU by its tanh formula. The final layer is ``Linear(ln(x) * (1 + scale) +
shift)`` and the tokens are folded back into a field by reshape.

Departures from ``models.py``, each an assumption of the configuration: the
channels are ``2 window + 1`` in and ``2 window`` out (SDA predicts eps only,
so ``learn_sigma`` does not apply); there is no class embedder, so ``c`` is
the time embedding alone; ``t`` in ``[0, 1]`` is scaled by 1000; the
parameters are drawn by :func:`init_tree` from a seed, not adaLN-Zero's zeros
(which would make the output identically zero).

Precisions as ``reference.unet``'s: ``'float32'`` (under
``unet.true_float32``), ``'bfloat16'`` (every product's inputs and output in
bf16, the residual stream in bf16; the attention's scores and softmax in
float32 from bf16 inputs, its probabilities rounded to bf16 for the product
with ``v``, as a fused attention kernel rounds them) and ``'fp8'`` (the
control: every product's inputs in e4m3 and its output gradient in e5m2).
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import unet as ref

Tensor = torch.Tensor

#: The factor on ``t`` into the timestep embedder.
T_SCALE = 1000.0


def tokens(config: dict) -> int:
    return (config['size'] // config['patch_size']) ** 2


def sincos(dim: int, grid: int, device) -> Tensor:
    r"""``models.py``'s ``get_2d_sincos_pos_embed(dim, grid)``: per token (row
    ``i``, column ``j``, row-major) ``[sin(j w), cos(j w), sin(i w), cos(i
    w)]`` with ``w_k = 10000^(-k / (dim / 4))``, ``k < dim / 4``; computed in
    float64, returned in float32."""

    w = 1.0 / 10000 ** (torch.arange(dim // 4, dtype=torch.float64) / (dim // 4))
    pos = torch.arange(grid, dtype=torch.float64)[:, None] * w
    one = torch.cat((torch.sin(pos), torch.cos(pos)), dim=1)  # (grid, dim / 2)
    j = one[None, :, :].expand(grid, grid, -1)
    i = one[:, None, :].expand(grid, grid, -1)
    return torch.cat((j, i), dim=-1).reshape(grid * grid, dim).float().to(device)


def layer_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


def gelu_tanh(x: Tensor) -> Tensor:
    x32 = x.float()
    return (0.5 * x32 * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x32 + 0.044715 * x32**3)))).to(x.dtype)


def modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


class DiT:
    r"""The window kernel ``eps(x, t)``: ``x (N, 2 window, size, size)``,
    ``t (N,)`` in ``[0, 1]``; float32 output."""

    def __init__(self, params: Dict[str, Tensor], config: dict, precision: str = 'float32'):
        self.p, self.config = params, config
        self.cast = ref.caster(precision)
        self.out = ref._GradFP8.apply if precision == 'fp8' else (lambda a: a)
        self.dtype = torch.float32 if precision == 'float32' else torch.bfloat16
        size, device = config['size'], next(iter(params.values())).device
        b = 2 * math.pi / size * (torch.arange(size, dtype=torch.float32) + 0.5)
        self.forcing = torch.sin(4 * b).expand(1, size, size).to(device)
        self.pos = sincos(config['hidden_size'], size // config['patch_size'], device)

    def linear(self, name: str, x: Tensor) -> Tensor:
        return self.out(F.linear(self.cast(x), self.cast(self.p[name + '.weight']), self.cast(self.p[name + '.bias'])))

    def attention(self, name: str, x: Tensor) -> Tensor:
        n, t, d = x.shape
        heads = self.config['num_heads']
        qkv = self.linear(name + '.qkv', x).reshape(n, t, 3, heads, d // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (n, heads, t, d / heads)
        scores = (self.cast(q).float() @ self.cast(k).float().transpose(-1, -2)) * (d // heads) ** -0.5
        p = torch.softmax(self.out(scores), dim=-1)
        o = self.out((self.cast(p) @ self.cast(v)).to(self.dtype))
        return self.linear(name + '.proj', o.transpose(1, 2).reshape(n, t, d))

    def block(self, name: str, x: Tensor, c: Tensor) -> Tensor:
        mods = self.linear(name + '.adaLN_modulation.1', F.silu(c)).chunk(6, dim=1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
        x = x + gate_msa[:, None] * self.attention(name + '.attn', modulate(layer_norm(x), shift_msa, scale_msa))
        h = modulate(layer_norm(x), shift_mlp, scale_mlp)
        h = self.linear(name + '.mlp.fc2', gelu_tanh(self.linear(name + '.mlp.fc1', h)))
        return x + gate_mlp[:, None] * h

    def __call__(self, x: Tensor, t: Tensor) -> Tensor:
        config = self.config
        p, size = config['patch_size'], config['size']
        g = size // p
        n = x.shape[0]
        h = torch.cat((x, self.forcing.expand(n, -1, -1, -1)), dim=1)
        c_in = h.shape[1]
        patches = h.reshape(n, c_in, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(n, g * g, c_in * p * p)
        w = self.p['x_embedder.proj.weight']
        h = self.out(F.linear(self.cast(patches), self.cast(w.reshape(w.shape[0], -1)),
                              self.cast(self.p['x_embedder.proj.bias'])))
        h = h + self.pos.to(h.dtype)

        half = 128
        freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32) / half).to(x.device)
        args = (T_SCALE * t.float())[:, None] * freqs
        c = torch.cat((torch.cos(args), torch.sin(args)), dim=-1)
        c = self.linear('t_embedder.mlp.2', F.silu(self.linear('t_embedder.mlp.0', c)))

        for i in range(config['depth']):
            h = self.block(f'blocks.{i}', h, c)

        shift, scale = self.linear('final_layer.adaLN_modulation.1', F.silu(c)).chunk(2, dim=1)
        h = self.linear('final_layer.linear', modulate(layer_norm(h), shift, scale))
        out = config['window'] * 2
        h = h.reshape(n, g, g, p, p, out).permute(0, 5, 1, 3, 2, 4).reshape(n, out, size, size)
        return h.float()


# -- Parameters drawn from a seed --------------------------------------------


def shapes(config: dict) -> Dict[str, tuple]:
    r"""Every parameter's name and shape, in ``models.py``'s order."""

    d, p, depth = config['hidden_size'], config['patch_size'], config['depth']
    m = int(d * config['mlp_ratio'])
    c = 2 * config['window']
    out = {'x_embedder.proj.weight': (d, c + 1, p, p), 'x_embedder.proj.bias': (d,),
           't_embedder.mlp.0.weight': (d, 256), 't_embedder.mlp.0.bias': (d,),
           't_embedder.mlp.2.weight': (d, d), 't_embedder.mlp.2.bias': (d,)}
    for i in range(depth):
        for name, (fan_out, fan_in) in (('attn.qkv', (3 * d, d)), ('attn.proj', (d, d)), ('mlp.fc1', (m, d)),
                                        ('mlp.fc2', (d, m)), ('adaLN_modulation.1', (6 * d, d))):
            out[f'blocks.{i}.{name}.weight'] = (fan_out, fan_in)
            out[f'blocks.{i}.{name}.bias'] = (fan_out,)
    out.update({'final_layer.linear.weight': (p * p * c, d), 'final_layer.linear.bias': (p * p * c,),
                'final_layer.adaLN_modulation.1.weight': (2 * d, d), 'final_layer.adaLN_modulation.1.bias': (2 * d,)})
    return out


def init_tree(config: dict, generator: torch.Generator) -> Dict[str, Tensor]:
    r"""Seeded parameters as a flat tree of float32 tensors on the
    generator's device, drawn in one call and cut into views: weights normal
    with variance ``1 / fan_in``, biases normal with standard deviation 0.1.
    The adaLN and final Linears are drawn like the others, not zeroed: a
    block's shifts, scales and gates come out of order 0.3, so that every
    leaf has a gradient and every block moves the output."""

    named = shapes(config)
    sizes = [math.prod(s) for s in named.values()]
    flat = torch.randn(sum(sizes), generator=generator, device=generator.device)
    tree, offset = {}, 0
    for (name, shape), size in zip(named.items(), sizes):
        leaf = flat[offset:offset + size].view(shape)
        offset += size
        leaf.mul_(1 / math.sqrt(math.prod(shape[1:])) if name.endswith('.weight') else 0.1)
        tree[name] = leaf
    return tree

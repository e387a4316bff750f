r"""Plain PyTorch reference of the Kolmogorov score model, its guided sampler
step and its AdamW training step. The step, the loss and AdamW take any window
network ``net(x, t)``: an arch's ``reference`` (``portbench/archs``).

Written from the model's description, not from the program: the window
kernel is a modulated U-Net over ``window`` frames of 2 velocity channels
plus the forcing ``sin(4 b)`` as a context channel, with a sinusoidal time
embedding (16 frequencies ``pi k``, Dense 32 -> 256, SiLU, Dense 256 ->
embedding); every residual block is ``x + conv(silu(conv(ln(x + dense(emb)))))``
with circular 'same' padding and a parameter-free layer norm over channels;
stride-2 convolutions go down, nearest upsampling by 2, a layer norm and a
convolution go up, with skip additions. Parameters are read from the flax
tree by name (``Conv_i`` kernels HWIO, ``Dense_i`` kernels ``(in, out)``).

Precisions: ``'float32'`` (true float32: the caller runs it under
:func:`true_float32`), ``'bfloat16'`` (every product in bf16, as the
configuration states) and ``'fp8'`` (the control, the usual float8 recipe:
every product's inputs rounded to e4m3 and, in a backward pass, its output
gradient to e5m2, each with a per-tensor scale, the products then computed
in bf16).
Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
ETA = 1e-3
FP8_MAX = 448.0


@contextlib.contextmanager
def true_float32():
    r"""float32 products without TF32, restored on exit."""

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _fp8(x: Tensor, dtype: torch.dtype) -> Tensor:
    r"""``x`` rounded to the float8 ``dtype`` with a per-tensor scale, in bf16."""

    scale = x.detach().abs().amax().float().clamp_min(1e-30) / torch.finfo(dtype).max
    return ((x.float() / scale).to(dtype).float() * scale).to(torch.bfloat16)


class _RoundFP8(torch.autograd.Function):
    r"""A product's input rounded to float8 e4m3 (per-tensor scale); its
    gradient passes through (the backward products see the rounded values)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GradFP8(torch.autograd.Function):
    r"""The identity on a product's output; its gradient, the input of the
    backward products, rounded to float8 e5m2 (per-tensor scale)."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


def caster(precision: str) -> Callable[[Tensor], Tensor]:
    if precision == 'float32':
        return lambda a: a.float()
    if precision == 'bfloat16':
        return lambda a: a.to(torch.bfloat16)
    if precision == 'fp8':
        return _RoundFP8.apply
    raise ValueError(f'unknown precision {precision!r}')


def to_device(tree: dict, device) -> Dict[str, Tensor]:
    r"""A flat ``{path: array or tensor}`` tree as float32 tensors on
    ``device``."""

    def leaf(v):
        if torch.is_tensor(v):
            return v.to(device, torch.float32)
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return {k: leaf(v) for k, v in tree.items()}


def layer_norm(x: Tensor, dim: int, eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    mean = x32.mean(dim=dim, keepdim=True)
    var = (x32 - mean).square().mean(dim=dim, keepdim=True)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


class ScoreUNet:
    r"""The window kernel ``eps(x, t)`` of a Kolmogorov run: ``x (N, 2
    window, size, size)``, ``t (N,)``; float32 output."""

    def __init__(self, params: Dict[str, Tensor], config: dict, precision: str = 'float32'):
        self.p = params
        self.config = config
        self.cast = caster(precision)
        self.out = _GradFP8.apply if precision == 'fp8' else (lambda a: a)
        size = config['size']
        b = 2 * math.pi / size * (torch.arange(size, dtype=torch.float32) + 0.5)
        device = next(iter(params.values())).device
        self.forcing = torch.sin(4 * b).expand(1, size, size).to(device)

    def dense(self, name: str, x: Tensor) -> Tensor:
        w, b = self.p[name + '/kernel'], self.p[name + '/bias']
        return self.out(self.cast(x) @ self.cast(w) + self.cast(b))

    def conv(self, name: str, x: Tensor, stride: int = 1) -> Tensor:
        w = self.p[name + '/kernel'].permute(3, 2, 0, 1)
        k = w.shape[-1]
        x = F.pad(self.cast(x), ((k - 1) // 2, k // 2, (k - 1) // 2, k // 2), mode='circular')
        return self.out(F.conv2d(x, self.cast(w), self.cast(self.p[name + '/bias']), stride=stride))

    def block(self, name: str, x: Tensor, emb: Tensor) -> Tensor:
        h = x + self.dense(name + '/Dense_0', emb)[:, :, None, None]
        h = layer_norm(h, dim=1)
        h = F.silu(self.conv(name + '/Conv_0', h))
        return x + self.conv(name + '/Conv_1', h)

    def __call__(self, x: Tensor, t: Tensor) -> Tensor:
        freqs = math.pi * torch.arange(1, 17, dtype=torch.float32, device=x.device)
        phase = freqs * t.float()[:, None]
        emb = torch.cat((torch.cos(phase), torch.sin(phase)), dim=-1)
        emb = self.dense('ScoreUNet_0/TimeEmbedding_0/Dense_1',
                         F.silu(self.dense('ScoreUNet_0/TimeEmbedding_0/Dense_0', emb)))

        h = torch.cat((x, self.forcing.expand(x.shape[0], -1, -1, -1)), dim=1)
        unet = 'ScoreUNet_0/UNet_0'
        blocks = self.config['hidden_blocks']
        depths = len(blocks)
        conv, block, skips = 0, 0, []
        for i, n in enumerate(blocks):
            h = self.conv(f'{unet}/Conv_{conv}', h, stride=1 if i == 0 else 2)
            conv += 1
            for _ in range(n):
                h = self.block(f'{unet}/ModResidualBlock_{block}', h, emb)
                block += 1
            skips.append(h)
        skips.pop()
        for i in reversed(range(depths)):
            for _ in range(blocks[i]):
                h = self.block(f'{unet}/ModResidualBlock_{block}', h, emb)
                block += 1
            if i > 0:
                h = layer_norm(h, dim=1)
                h = h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
                h = self.conv(f'{unet}/Conv_{conv}', h) + skips.pop()
            else:
                h = self.conv(f'{unet}/Conv_{conv}', h)
            conv += 1
        return h.float()


# -- Windows -------------------------------------------------------------------


def unfold(x: Tensor, window: int) -> Tensor:
    r"""``(B, L, 2, H, W) -> (B, L - window + 1, 2 window, H, W)``."""

    n = x.shape[1] - window + 1
    w = torch.stack([x[:, i:i + n] for i in range(window)], dim=2)
    return w.flatten(2, 3)


def fold(s: Tensor, window: int) -> Tensor:
    r"""The adjoint-free inverse of :func:`unfold` used by the score: the
    first window's leading frames, every window's centre, the last window's
    trailing frames."""

    k = window // 2
    s = s.unflatten(2, (window, -1))
    return torch.cat((s[:, 0, :k], s[:, :, k], s[:, -1, k + 1:]), dim=1)


def mu(t: Tensor) -> Tensor:
    return torch.cos(math.acos(math.sqrt(ETA)) * t) ** 2


def sigma(t: Tensor) -> Tensor:
    return torch.sqrt(1 - mu(t) ** 2 + ETA**2)


def coarse(x: Tensor) -> Tensor:
    r"""The ``coarse`` observation: every 4th frame, mean-pooled 8x8."""

    x = x[:, ::4]
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 8, 8, w // 8, 8).mean(dim=(-3, -1))


class GuidedStep:
    r"""One step of the guided sampler on a trajectory batch ``(B, L, 2, H,
    W)``: the ddim predictor at ``t`` then ``corrections`` Langevin
    corrections at ``t - dt``, each with the SDA posterior eps

        eps - sigma grad_x log N(y | A((x - sigma eps) / mu), std^2 + gamma (sigma / mu)^2).

    The gradient is ``(g - sigma J^T g) / mu`` with ``g`` the likelihood's
    gradient in ``x_hat`` and ``J`` the score's Jacobian, computed window
    chunk by window chunk so that the activations of ``chunk`` windows per
    sample are held at a time."""

    def __init__(self, net: ScoreUNet, window: int, y: Tensor, std: float, gamma: float,
                 steps: int, corrections: int, tau: float, chunk: int):
        self.net, self.window = net, window
        self.y, self.std, self.gamma = y, std, gamma
        self.steps, self.corrections, self.tau = steps, corrections, tau
        self.chunk = chunk
        self.time = torch.linspace(1.0, 0.0, steps + 1, device=y.device)[:-1]

    def _kernel(self, xw: Tensor, t: Tensor) -> Tensor:
        b, n = xw.shape[:2]
        out = self.net(xw.flatten(0, 1), t.expand(b * n))
        return out.unflatten(0, (b, n))

    def eps(self, x: Tensor, t: Tensor) -> Tensor:
        xw = unfold(x, self.window)
        with torch.no_grad():
            s = torch.cat([self._kernel(xw[:, i:i + self.chunk], t)
                           for i in range(0, xw.shape[1], self.chunk)], dim=1)
        return fold(s, self.window)

    def guided(self, x: Tensor, t: Tensor) -> Tensor:
        m, s = mu(t), sigma(t)
        var = self.std**2 + self.gamma * (s / m) ** 2
        e = self.eps(x, t)

        with torch.enable_grad():
            x_hat = ((x - s * e) / m).requires_grad_(True)
            log_p = -0.5 * torch.sum((self.y - coarse(x_hat)) ** 2 / var)
            (g,) = torch.autograd.grad(log_p, x_hat)

            n = x.shape[1] - self.window + 1
            probe = torch.zeros(x.shape[:1] + (n, 2 * self.window) + x.shape[3:], device=x.device,
                                requires_grad=True)
            (v,) = torch.autograd.grad((fold(probe, self.window) * g).sum(), probe)

            jtg = torch.zeros_like(x)
            for i in range(0, n, self.chunk):
                xr = x.detach().requires_grad_(True)
                out = self._kernel(unfold(xr, self.window)[:, i:i + self.chunk], t)
                (part,) = torch.autograd.grad((out * v[:, i:i + self.chunk]).sum(), xr)
                jtg += part

        return e - s * (g - s * jtg) / m

    @torch.no_grad()
    def __call__(self, x: Tensor, i: int, noise: Callable[[int, int], Tensor]) -> Tensor:
        dt = 1.0 / self.steps
        t = self.time[i]
        e = self.guided(x, t)
        r = mu(t - dt) / mu(t)
        x = r * x + (sigma(t - dt) - r * sigma(t)) * e
        for j in range(self.corrections):
            z = noise(i, j).reshape(x.shape)
            e = self.guided(x, t - dt)
            delta = self.tau / e.square().mean(dim=(1, 2, 3, 4), keepdim=True)
            x = x - (delta * e + torch.sqrt(2 * delta) * z) * sigma(t - dt)
        return x


# -- Training ----------------------------------------------------------------


def denoising_loss(net: Callable[[Tensor, Tensor], Tensor], x: Tensor, t: Tensor, z: Tensor) -> Tensor:
    r"""``mean((eps(mu x + sigma z, t) - z)^2)`` over a batch of windows."""

    tt = t.reshape(-1, 1, 1, 1)
    return (net(mu(tt) * x + sigma(tt) * z, t) - z).square().mean()


def adamw_steps(params: Dict[str, Tensor], network: Callable[[Dict[str, Tensor]], Callable], batches: List[tuple],
                lrs: List[float], weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8,
                hook: Optional[Callable[[Dict[str, Tensor]], Dict[str, Tensor]]] = None) -> dict:
    r"""AdamW (decoupled ``weight_decay``) of the network ``network(params)``
    over ``batches`` of ``(x, t, z)``, learning rate ``lrs[k]`` at step ``k``.
    Returns each step's loss, the first step's gradients and the parameters
    after the last step. ``hook`` may alter each step's gradients (a planted
    fault)."""

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, ((x, t, z), lr) in enumerate(zip(batches, lrs), start=1):
        loss = denoising_loss(network(p), x, t, z)
        grads = torch.autograd.grad(loss, list(p.values()))
        if hook is not None:
            grads = list(hook(dict(zip(p, grads))).values())
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {k: g.clone() for k, g in zip(p, grads)}
            for (k, w), g in zip(p.items(), grads):
                w.mul_(1 - lr * weight_decay)
                m[k] = betas[0] * m[k] + (1 - betas[0]) * g
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * g * g
                m_hat = m[k] / (1 - betas[0] ** step)
                v_hat = v2[k] / (1 - betas[1] ** step)
                w.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    return {'losses': losses, 'grads': first, 'params': {k: w.detach() for k, w in p.items()}}


# -- Parameters drawn from a seed --------------------------------------------


def init_tree(config: dict, generator: torch.Generator) -> Dict[str, Tensor]:
    r"""Seeded parameters of a configuration, as a flat flax tree of float32
    tensors on the generator's device: kernels normal with variance ``1 /
    fan_in``, biases small normals, so that every leaf has a gradient."""

    c = 2 * config['window']
    k = config['kernel_size']
    e = config['embedding']
    hidden, blocks = config['hidden_channels'], config['hidden_blocks']
    shapes = {'ScoreUNet_0/TimeEmbedding_0/Dense_0': (32, 256),
              'ScoreUNet_0/TimeEmbedding_0/Dense_1': (256, e)}
    unet = 'ScoreUNet_0/UNet_0'
    convs, mods = [], []
    for i, n in enumerate(blocks):
        convs.append((c + 1 if i == 0 else hidden[i - 1], hidden[i]))
        mods += [hidden[i]] * n
    for i in reversed(range(len(blocks))):
        mods += [hidden[i]] * blocks[i]
        convs.append((hidden[i], hidden[i - 1] if i > 0 else c))
    for j, (cin, cout) in enumerate(convs):
        shapes[f'{unet}/Conv_{j}'] = (k, k, cin, cout)
    for j, ch in enumerate(mods):
        shapes[f'{unet}/ModResidualBlock_{j}/Dense_0'] = (e, ch)
        for q in (0, 1):
            shapes[f'{unet}/ModResidualBlock_{j}/Conv_{q}'] = (k, k, ch, ch)

    tree = {}
    for name, shape in shapes.items():
        fan_in = math.prod(shape[:-1])
        tree[name + '/kernel'] = torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(fan_in)
        tree[name + '/bias'] = 0.1 * torch.randn(shape[-1:], generator=generator, device=generator.device)
    return tree


def nest(flat_tree: Dict[str, np.ndarray]) -> dict:
    r"""``{'a/b/c': v}`` -> ``{'a': {'b': {'c': v}}}``."""

    out: dict = {}
    for key, value in flat_tree.items():
        *path, leaf = key.split('/')
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def leaf_norms(tree: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def finite(x: Optional[Tensor]) -> bool:
    return x is not None and bool(torch.isfinite(x).all())

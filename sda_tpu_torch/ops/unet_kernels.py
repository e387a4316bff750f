r"""The U-Net residual blocks' glue as two hand-written CUDA kernels, channels-last.

``csrc/unet_block.cu`` holds them; at first use on a CUDA tensor this module
compiles it with ``nvcc`` for ``sm_90a`` into a plain-C shared library under
``csrc/build/<source hash>/`` (as :mod:`~sda_tpu_torch.ops.dft_kernels` does
for ``dft.cu``) and loads it with ``ctypes``. Nothing is compiled or loaded at
import. The kernels replace no TPU kernel: the JAX package leaves this glue
to XLA.

Tensors are channels-last, ``(N, H, W, C)``. The residual stream arrives as
three parts, ``x + (r + b)``: ``x`` the stream so far, ``r`` a convolution's
output without its bias, ``b`` that bias (``(C,)``); ``r`` or ``b`` may be
absent (``bf16(x) + b``, or ``x`` alone). Each sum is rounded to the compute
type where PyTorch's adds round it.

- :func:`norm_pad`: ``s = x + (r + b)`` and ``P = pad(up(layer_norm_C(s + m)))``
  with the modulation ``m (N, C)``: statistics in float32, population
  variance, ``eps`` 1e-5 (:func:`~sda_tpu_torch.nn.layers.layer_norm`).
- :func:`act_pad`: ``v = x + (r + b)`` (``x`` cast to the compute type first,
  of any dtype and dense strides) and ``Q = pad(act(v))``, ``act`` SiLU or the
  identity.

``pad`` wraps circularly, ``(lo, hi)`` per axis (flax ``'CIRCULAR'``:
``((k - 1) // 2, k // 2)`` for a kernel of ``k``), and ``up`` repeats each
pixel along an axis (nearest-neighbour upsampling). Each function is an
autograd function whose backward folds the padded gradient's halo onto the
pixels it was copied from, then applies the layer norm's or the activation's
backward and adds the gradient that reached ``s`` itself; it saves only
``s, m, mean, rstd`` (:func:`norm_pad`) or ``x, b`` (:func:`act_pad`, where
``x`` is a convolution's output, the stream or the U-Net's input).

Each kernel has its plain version beside it (``*_plain``: forward and the
backward formulas). The public functions take the plain version for a CPU
tensor; on a CUDA tensor they launch the kernel or raise. The launch counts
are the counters ``unet.norm_pad``, ``unet.norm_pad_bwd``, ``unet.act_pad``
and ``unet.act_pad_bwd`` of :mod:`sda_tpu_torch.tracing`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..tracing import counters
from .dft_kernels import build as build_source

Tensor = torch.Tensor
Pads = Tuple[Tuple[int, int], Tuple[int, int]]

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'unet_block.cu'

#: Eps of the layer norm (:func:`~sda_tpu_torch.nn.layers.layer_norm`).
EPS = 1e-5
#: Elements of the tile of pixels that a block of :func:`norm_pad`'s kernels
#: stages in shared memory (``kTile``), so also its widest channel axis.
MAX_CHANNELS = 6144
#: Most pixels in one such tile (``kMaxPixels``).
MAX_PIXELS = 256

_library: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build():
    r"""Compiles ``csrc/unet_block.cu`` unless a library built from the same
    source exists; returns its path and the compiler's output."""

    return build_source(SOURCE, 'sda_unet_block')


def library() -> ctypes.CDLL:
    r"""The kernels' shared library, built and loaded at first call."""

    global _library
    with _lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.sda_norm_pad.argtypes = [ptr] * 8 + [i32] * 12 + [ctypes.c_float, ptr]
            lib.sda_norm_pad_bwd.argtypes = [ptr] * 9 + [i32] * 12 + [ptr]
            lib.sda_act_pad.argtypes = [ptr, i32] + [i64] * 4 + [ptr] * 4 + [i32] * 10 + [ptr]
            lib.sda_act_pad_bwd.argtypes = (
                [ptr] * 3 + [i32] + [i64] * 4 + [ptr] * 2 + [i64] * 4 + [i32] * 10 + [ptr]
            )
            for fn in (lib.sda_norm_pad, lib.sda_norm_pad_bwd, lib.sda_act_pad, lib.sda_act_pad_bwd):
                fn.restype = i32
            _library = lib
    return _library


# -- Plain versions ------------------------------------------------------------


def residual_plain(x: Tensor, r: Optional[Tensor], b: Optional[Tensor]) -> Tensor:
    r"""``x + (r + b)``; ``x + b`` where ``r`` is absent; ``x`` where both are.
    ``b`` is cast to the others' dtype first."""

    c = x if r is None else r
    if b is not None:
        c = c + b.to(c.dtype)
    return c if r is None else x + c


def pad_plain(h: Tensor, pads: Pads, up: Sequence[int] = (1, 1)) -> Tensor:
    r"""``h (N, H, W, C)`` repeated ``up`` times along H and W, then wrapped
    circularly by ``pads``."""

    for dim, (lo, hi), r in zip((1, 2), pads, up):
        if r > 1:
            h = torch.repeat_interleave(h, r, dim=dim)
        n = h.shape[dim]
        h = torch.cat((h.narrow(dim, n - lo, lo), h, h.narrow(dim, 0, hi)), dim=dim)
    return h


def fold_plain(g: Tensor, pads: Pads, up: Sequence[int] = (1, 1)) -> Tensor:
    r"""The adjoint of :func:`pad_plain`: each pixel's sum, in float32, over
    the positions of ``g (N, Ho, Wo, C)`` that hold it."""

    g = g.float()
    for dim, (lo, hi), r in zip((1, 2), pads, up):
        n = g.shape[dim] - lo - hi
        core = g.narrow(dim, lo, n).clone()
        core.narrow(dim, n - lo, lo).add_(g.narrow(dim, 0, lo))
        core.narrow(dim, 0, hi).add_(g.narrow(dim, lo + n, hi))
        if r > 1:
            shape = core.shape[:dim] + (n // r, r) + core.shape[dim + 1:]
            core = core.reshape(shape).sum(dim + 1)
        g = core
    return g


def _modulated(s: Tensor, m: Optional[Tensor]) -> Tensor:
    return s if m is None else s + m[:, None, None, :]


def norm_pad_plain(
    x: Tensor, r: Optional[Tensor], b: Optional[Tensor], m: Optional[Tensor], pads: Pads,
    up: Sequence[int] = (1, 1),
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    r"""``s, P, mean, rstd``: the stream ``s = x + (r + b)``, ``P =
    pad(up(layer_norm(s + m)))`` in ``s``'s dtype, and the statistics
    ``(N, H, W)`` in float32."""

    s = residual_plain(x, r, b)
    u = _modulated(s, m).float()
    var, mean = torch.var_mean(u, dim=-1, correction=0)
    rstd = torch.rsqrt(var + EPS)
    h = ((u - mean[..., None]) * rstd[..., None]).to(s.dtype)
    return s, pad_plain(h, pads, up), mean, rstd


def norm_pad_bwd_plain(
    dp: Tensor, ds: Optional[Tensor], s: Tensor, m: Optional[Tensor], mean: Tensor, rstd: Tensor,
    pads: Pads, up: Sequence[int] = (1, 1), need_dm: bool = False,
) -> Tuple[Tensor, Optional[Tensor]]:
    r"""``dx, dm``: the gradient of the stream ``s`` (``ds`` plus the layer
    norm's backward of the folded ``dp``), in ``s``'s dtype, and where
    ``need_dm`` the modulation's ``(N, C)`` in float32."""

    g = fold_plain(dp, pads, up)
    y = (_modulated(s, m).float() - mean[..., None]) * rstd[..., None]
    d = rstd[..., None] * (g - g.mean(-1, keepdim=True) - y * (g * y).mean(-1, keepdim=True))
    dm = d.sum((1, 2)) if need_dm else None
    if ds is not None:
        d = d + ds.float()
    return d.to(s.dtype), dm


def act_pad_plain(
    x: Tensor, r: Optional[Tensor], b: Optional[Tensor], silu: bool, pads: Pads, dtype: torch.dtype,
) -> Tuple[Tensor, Tensor]:
    r"""``v, Q``: ``v = x + (r + b)`` with ``x`` cast to ``dtype``, and ``Q =
    pad(act(v))``."""

    v = residual_plain(x.to(dtype), r, b)
    return v, pad_plain(F.silu(v) if silu else v, pads)


def act_pad_bwd_plain(
    dq: Tensor, ds: Optional[Tensor], x: Optional[Tensor], b: Optional[Tensor], silu: bool, pads: Pads,
    dtype: torch.dtype,
) -> Tensor:
    r"""The gradient of ``v`` (:func:`act_pad_plain`) in float32: ``ds`` plus
    the folded ``dq`` times ``act'(v)``, with ``v`` recomputed from ``x`` and
    ``b`` for SiLU."""

    g = fold_plain(dq, pads)
    if silu:
        v = residual_plain(x.to(dtype), None, b).float()
        sig = torch.sigmoid(v)
        g = g * sig * (1 + v * (1 - sig))
    if ds is not None:
        g = g + ds.float()
    return g


# -- Kernel launches -------------------------------------------------------------
#
# The launchers take channels-last tensors as (N, H, W, C), contiguous (act_pad's
# x may also be the (N, H, W, C) view of a contiguous (N, C, H, W) tensor); the
# bias is float32, every other tensor bf16 but the statistics.


def _check(name: str, t: Tensor, device: torch.device, shape=None, dtype=torch.bfloat16) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f'{name}: {dtype} on {device} expected, got {t.dtype} on {t.device}')
    if shape is not None and t.shape != shape:
        raise ValueError(f'{name}: shape {tuple(shape)} expected, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: a contiguous tensor expected')


def _vector(c: int, *tensors: Optional[Tensor]) -> int:
    r"""The kernels' vector of channels: 8 bf16 (16 bytes) where 8 divides
    ``c`` and every pointer is aligned to 16 bytes, else 1."""

    bits = 0
    for t in tensors:
        if t is not None:
            bits |= t.data_ptr()
    return 8 if c % 8 == 0 and bits % 16 == 0 else 1


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _geometry(x: Tensor, pads: Pads, up: Sequence[int]) -> Tuple[int, ...]:
    r"""``(up, lo, out)`` of both axes of the padded output of ``x``."""

    out = []
    for n, (lo, hi), r in zip(x.shape[1:3], pads, up):
        if r < 1 or not 0 <= lo <= n * r or not 0 <= hi <= n * r:
            raise ValueError(f'pads {pads} and up {tuple(up)} do not fit an axis of {n}')
        out += [r, lo, n * r + lo + hi]
    return tuple(out)


def tile_pixels(c: int) -> int:
    r"""Pixels in one block's tile of :func:`norm_pad`'s kernels at ``c``
    channels: 64 at 96, 32 at 192, 16 at 384."""

    return min(MAX_PIXELS, MAX_CHANNELS // c)


def _launch(name: str, device: torch.device, *args) -> None:
    r"""Calls the library's ``sda_<name>`` with ``args`` and ``device``'s
    current stream, on ``device``; counts the launch or raises."""

    fn = getattr(_library or library(), f'sda_{name}')
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')
    counters[f'unet.{name}'] += 1


def _check_operands(x: Tensor, r, b, m, device) -> Tuple[int, int, int, int]:
    if x.ndim != 4:
        raise ValueError(f'x: (N, H, W, C) expected, got {tuple(x.shape)}')
    if device.type != 'cuda':
        raise ValueError(f'x: a CUDA tensor expected, got one on {device}')
    n, h, w, c = x.shape
    if r is not None:
        _check('r', r, device, x.shape)
    if b is not None:
        _check('b', b, device, (c,), torch.float32)
    if m is not None:
        _check('m', m, device, (n, c))
    if not 0 < n <= 65535:
        raise ValueError(f'x: batch {n} outside the kernel grid (1..65535)')
    return n, h, w, c


def launch_norm_pad(
    x: Tensor, r: Optional[Tensor], b: Optional[Tensor], m: Optional[Tensor], pads: Pads,
    up: Sequence[int] = (1, 1),
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    r"""Enqueues :func:`norm_pad_plain`'s function; ``s`` is ``x`` itself
    where nothing is added. No autograd."""

    _check('x', x, x.device)
    n, h, w, c = _check_operands(x, r, b, m, x.device)
    if c > MAX_CHANNELS:
        raise ValueError(f'x: {c} channels, the kernel takes at most {MAX_CHANNELS}')
    geometry = _geometry(x, pads, up)

    s = x if r is None and b is None else torch.empty_like(x)
    out = torch.empty((n, geometry[2], geometry[5], c), dtype=x.dtype, device=x.device)
    mean = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    vec = _vector(c, x, r, m, s, out)

    _launch(
        'norm_pad', x.device, x.data_ptr(), _ptr(r), _ptr(b), _ptr(m), None if s is x else s.data_ptr(),
        out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, h, w, c, *geometry, vec, tile_pixels(c),
        EPS,
    )
    return s, out, mean, rstd


def launch_norm_pad_bwd(
    dp: Tensor, ds: Optional[Tensor], s: Tensor, m: Optional[Tensor], mean: Tensor, rstd: Tensor,
    pads: Pads, up: Sequence[int] = (1, 1), need_dm: bool = False,
) -> Tuple[Tensor, Optional[Tensor]]:
    r"""Enqueues :func:`norm_pad_bwd_plain`'s function; no autograd."""

    _check('s', s, s.device)
    n, h, w, c = _check_operands(s, ds, None, m, s.device)
    geometry = _geometry(s, pads, up)
    _check('dp', dp, s.device, (n, geometry[2], geometry[5], c))
    _check('mean', mean, s.device, (n, h, w), torch.float32)
    _check('rstd', rstd, s.device, (n, h, w), torch.float32)
    if c > MAX_CHANNELS:
        raise ValueError(f's: {c} channels, the kernel takes at most {MAX_CHANNELS}')

    dx = torch.empty_like(s)
    tile = tile_pixels(c)
    part = torch.empty((n, -(-h * w // tile), c), dtype=torch.float32, device=s.device) if need_dm else None
    dm = torch.empty((n, c), dtype=torch.float32, device=s.device) if need_dm else None
    vec = _vector(c, dp, ds, s, m, dx)

    _launch(
        'norm_pad_bwd', s.device, dp.data_ptr(), _ptr(ds), s.data_ptr(), _ptr(m), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), _ptr(part), _ptr(dm), n, h, w, c, *geometry, vec, tile,
    )
    return dx, dm


def _dense_input(x: Tensor) -> None:
    r"""``x (N, H, W, C)`` may be float32 or bf16, contiguous or the view of a
    contiguous ``(N, C, H, W)``, and nothing else."""

    if x.ndim != 4:
        raise ValueError(f'x: (N, H, W, C) expected, got {tuple(x.shape)}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'x: float32 or bfloat16 expected, got {x.dtype}')
    if not (x.is_contiguous() or x.permute(0, 3, 1, 2).is_contiguous()):
        raise ValueError('x: a contiguous (N, H, W, C) tensor or view of a contiguous (N, C, H, W) expected')


def _act_geometry(x: Tensor, pads: Pads) -> Tuple[int, int, int, int]:
    _, lo_h, out_h, _, lo_w, out_w = _geometry(x, pads, (1, 1))
    return lo_h, out_h, lo_w, out_w


def launch_act_pad(
    x: Tensor, r: Optional[Tensor], b: Optional[Tensor], silu: bool, pads: Pads, keep: bool = False,
) -> Tuple[Optional[Tensor], Tensor]:
    r"""Enqueues :func:`act_pad_plain`'s function in bf16; ``v`` is written
    only where ``keep`` (else ``None``), and is ``x`` itself where nothing is
    added to a bf16 channels-last ``x``. No autograd."""

    _dense_input(x)
    n, h, w, c = _check_operands(x, r, b, None, x.device)
    geometry = _act_geometry(x, pads)

    s = None
    if keep:
        plain = r is None and b is None and x.dtype == torch.bfloat16 and x.is_contiguous()
        s = x if plain else torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    out = torch.empty((n, geometry[1], geometry[3], c), dtype=torch.bfloat16, device=x.device)
    vec = _vector(c, x, r, s, out) if x.is_contiguous() and x.dtype == torch.bfloat16 else 1

    _launch(
        'act_pad', x.device, x.data_ptr(), int(x.dtype == torch.float32), *x.stride(), _ptr(r), _ptr(b),
        None if s is None or s is x else s.data_ptr(), out.data_ptr(), n, h, w, c, *geometry, vec, int(silu),
    )
    return s, out


def launch_act_pad_bwd(
    dq: Tensor, ds: Optional[Tensor], x: Tensor, b: Optional[Tensor], silu: bool, pads: Pads,
) -> Tensor:
    r"""Enqueues :func:`act_pad_bwd_plain`'s function; the gradient has
    ``x``'s dtype and strides (``x`` itself is read only for SiLU). No
    autograd."""

    _dense_input(x)
    n, h, w, c = _check_operands(x, ds, b, None, x.device)
    geometry = _act_geometry(x, pads)
    _check('dq', dq, x.device, (n, geometry[1], geometry[3], c))

    dx = torch.empty_like(x)
    dense = x.is_contiguous()
    vec = _vector(c, dq, ds, dx, x if silu else None) if dense and x.dtype == torch.bfloat16 else 1

    _launch(
        'act_pad_bwd', x.device, dq.data_ptr(), _ptr(ds), x.data_ptr() if silu else None,
        int(x.dtype == torch.float32), *x.stride(), _ptr(b), dx.data_ptr(), *dx.stride(), n, h, w, c, *geometry,
        vec, int(silu),
    )
    return dx


# -- Autograd functions ----------------------------------------------------------
#
# They take and give (N, C, H, W) tensors, channels-last in memory: what cuDNN's
# convolutions take and give. Inside, a tensor is its (N, H, W, C) view.


def _nhwc(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t.permute(0, 2, 3, 1)


def _nchw(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t.permute(0, 3, 1, 2)


def _grad(g: Optional[Tensor]) -> Optional[Tensor]:
    r"""An incoming ``(N, C, H, W)`` gradient as a contiguous ``(N, H, W, C)``."""

    return None if g is None else g.permute(0, 2, 3, 1).contiguous()


class _NormPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, b, m, pads, up):
        fn = norm_pad_plain if x.device.type == 'cpu' else launch_norm_pad
        s, out, mean, rstd = fn(_nhwc(x), _nhwc(r), b, m, pads, up)
        ctx.save_for_backward(s, m, mean, rstd)
        ctx.pads, ctx.up = pads, up
        ctx.set_materialize_grads(False)
        return _nchw(s), _nchw(out)

    @staticmethod
    def backward(ctx, ds, dp):
        s, m, mean, rstd = ctx.saved_tensors
        need_x, need_r, need_b, need_m = ctx.needs_input_grad[:4]
        if dp is None:
            dx, dm = _grad(ds), None
        else:
            fn = norm_pad_bwd_plain if s.device.type == 'cpu' else launch_norm_pad_bwd
            dx, dm = fn(_grad(dp), _grad(ds), s, m, mean, rstd, ctx.pads, ctx.up, need_m)
        if dx is None:
            return (None,) * 6
        return (
            _nchw(dx) if need_x else None,
            _nchw(dx) if need_r else None,
            dx.sum((0, 1, 2), dtype=torch.float32) if need_b else None,
            dm.to(m.dtype) if need_m and dm is not None else None,
            None,
            None,
        )


class _ActPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, b, silu, pads, keep, dtype):
        x = _nhwc(x)
        if x.device.type == 'cpu':
            s, out = act_pad_plain(x, _nhwc(r), b, silu, pads, dtype)
            s = s if keep else None
        else:
            if dtype != torch.bfloat16:
                raise ValueError(f'act_pad: the kernel computes in bfloat16, not {dtype}')
            s, out = launch_act_pad(x, _nhwc(r), b, silu, pads, keep)
        ctx.save_for_backward(x, b)
        ctx.silu, ctx.pads, ctx.dtype = silu, pads, dtype
        ctx.set_materialize_grads(False)
        return _nchw(s), _nchw(out)

    @staticmethod
    def backward(ctx, ds, dq):
        x, b = ctx.saved_tensors
        need_x, need_r, need_b = ctx.needs_input_grad[:3]
        ds, dq = _grad(ds), _grad(dq)
        if dq is None:
            dv = ds
        elif dq.device.type == 'cpu':
            dv = act_pad_bwd_plain(dq, ds, x, b, ctx.silu, ctx.pads, ctx.dtype)
        else:
            dv = launch_act_pad_bwd(dq, ds, x, b, ctx.silu, ctx.pads)
        if dv is None:
            return (None,) * 7
        return (
            _nchw(dv.to(x.dtype)) if need_x else None,
            _nchw(dv.to(ctx.dtype)) if need_r else None,
            dv.sum((0, 1, 2), dtype=torch.float32) if need_b else None,
            None, None, None, None,
        )


# -- Public entry points -----------------------------------------------------------


def norm_pad(
    x: Tensor, r: Optional[Tensor] = None, b: Optional[Tensor] = None, m: Optional[Tensor] = None,
    pads: Pads = ((1, 1), (1, 1)), up: Sequence[int] = (1, 1),
) -> Tuple[Tensor, Tensor]:
    r"""``(s, P)``: the stream ``s = x + (r + b)`` and ``P =
    pad(up(layer_norm_C(s + m)))``, ``(N, C, H up + lo + hi, W up + lo +
    hi)``, from ``x, r (N, C, H, W)`` channels-last in memory, the bias ``b
    (C,)`` (float32 on a card) and the modulation ``m (N, C)``; the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""

    return _NormPad.apply(x, r, b, m, tuple(map(tuple, pads)), tuple(up))


def act_pad(
    x: Tensor, r: Optional[Tensor] = None, b: Optional[Tensor] = None, silu: bool = False,
    pads: Pads = ((1, 1), (1, 1)), keep: bool = False, dtype: torch.dtype = torch.bfloat16,
) -> Tuple[Optional[Tensor], Tensor]:
    r"""``(v, Q)``: ``v = x + (r + b)`` in ``dtype`` (``None`` unless
    ``keep``) and ``Q = pad(act(v))``, ``act`` SiLU or the identity, from
    ``x (N, C, H, W)`` of any dtype, channels-last or contiguous, ``r``
    channels-last and the bias ``b (C,)`` (float32 on a card); the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""

    return _ActPad.apply(x, r, b, silu, tuple(map(tuple, pads)), keep, dtype)

r"""DiT's adaLN glue as hand-written CUDA kernels, one pass per site.

``csrc/dit_block.cu`` holds them; at first use on a CUDA tensor this module
compiles it with ``nvcc`` for ``sm_90a`` into a plain-C shared library under
``csrc/build/<source hash>/`` (as :mod:`~sda_tpu_torch.ops.dft_kernels` does
for ``dft.cu``) and loads it with ``ctypes``. Nothing is compiled or loaded at
import. The kernels replace no TPU kernel: the JAX package has no DiT.

Token rows are ``(B, N, D)``, contiguous; the modulation vectors ``(B, D)``
may be views with a row stride (the chunks of ``adaLN_modulation``'s ``(B,
6D)`` output), their channels contiguous. ``LN`` is a layer norm over ``D``
without affine terms (population variance, ``eps`` 1e-6, statistics in
float32), ``y = (x - mean) rstd``; each output is rounded once, from float32.

- :func:`norm_modulate`: ``h = LN(x) (1 + scale) + shift``;
- :func:`gated_norm_modulate`: ``x' = x + gate a`` and ``h = LN(x') (1 +
  scale) + shift``;
- :func:`gated_add`: ``x + gate m``.

Each is an autograd function. The input VJP: ``dx = LN'(dh (1 + scale))``
(plus the gradient ``x'`` received itself, and ``da = gate dx``, where
gated), ``dm = gate dy`` and ``dx = dy`` itself for :func:`gated_add`. The
vectors' gradients, sums over each sample's tokens (``dshift = sum dh``,
``dscale = sum dh y``, ``dgate = sum dx a``), are computed only where
autograd asks for them (training): per tile of 32 tokens, then the tiles in
order, so they repeat bit for bit.

Each kernel has its plain version beside it (``*_plain``: forward and the
backward formulas, in float32, or float64 for a float64 input). The public
functions take the plain version for a CPU tensor; on a CUDA tensor they
launch the kernel or raise. The launch counts are the counters
``dit.norm_mod``, ``dit.norm_mod_bwd``, ``dit.gated_norm_mod``,
``dit.gated_norm_mod_bwd``, ``dit.gated_add`` and ``dit.gated_add_bwd`` of
:mod:`sda_tpu_torch.tracing`. :func:`fits` says which inputs the kernels
take: :class:`~sda_tpu_torch.nn.dit.DiTBlock` runs them on those alone.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..tracing import counters
from .dft_kernels import build as build_source

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'dit_block.cu'

#: Eps of the layer norm (``nn.dit.norm``).
EPS = 1e-6
#: The widest row a warp holds in registers: 32 lanes x 8 vectors of 8
#: channels (``kMaxK``).
MAX_WIDTH = 2048
#: Tokens per partial sum of the vectors' gradients (``kTileRows``).
TILE_ROWS = 32

_library: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build():
    r"""Compiles ``csrc/dit_block.cu`` unless a library built from the same
    source exists; returns its path and the compiler's output."""

    return build_source(SOURCE, 'sda_dit_block')


def library() -> ctypes.CDLL:
    r"""The kernels' shared library, built and loaded at first call."""

    global _library
    with _lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            vec = [ptr, i64]
            lib.sda_dit_norm_mod.argtypes = [ptr] + vec * 2 + [ptr] * 3 + [i32] * 3 + [f32, ptr]
            lib.sda_dit_gated_norm_mod.argtypes = [ptr] * 2 + vec * 3 + [ptr] * 4 + [i32] * 3 + [f32, ptr]
            lib.sda_dit_norm_mod_bwd.argtypes = [ptr] * 4 + vec + [ptr] * 3 + [i32] * 3 + [ptr]
            lib.sda_dit_gated_norm_mod_bwd.argtypes = [ptr] * 5 + vec * 2 + [ptr] * 5 + [i32] * 3 + [ptr]
            lib.sda_dit_gated_add.argtypes = [ptr] * 2 + vec + [ptr] + [i32] * 3 + [ptr]
            lib.sda_dit_gated_add_bwd.argtypes = [ptr] * 2 + vec + [ptr] * 3 + [i32] * 3 + [ptr]
            for name in ('norm_mod', 'gated_norm_mod', 'norm_mod_bwd', 'gated_norm_mod_bwd', 'gated_add',
                         'gated_add_bwd'):
                getattr(lib, f'sda_dit_{name}').restype = i32
            _library = lib
    return _library


def fits(x: Tensor, vectors: Tensor) -> bool:
    r"""Whether the kernels take token rows ``x (B, N, D)`` modulated by
    ``vectors`` (of the same dtype): CUDA bf16 with ``D`` a multiple of 8 up
    to :data:`MAX_WIDTH`."""

    d = x.shape[-1]
    return (x.is_cuda and x.ndim == 3 and x.dtype == vectors.dtype == torch.bfloat16 and d % 8 == 0
            and d <= MAX_WIDTH)


# -- Plain versions ------------------------------------------------------------


def _acc(t: Tensor) -> torch.dtype:
    r"""The type the arithmetic runs in: float32, or float64 for float64."""

    return torch.promote_types(t.dtype, torch.float32)


def _rows(v: Tensor, dtype: torch.dtype) -> Tensor:
    r"""A ``(B, D)`` vector broadcast over the tokens of ``(B, N, D)``."""

    return v.to(dtype)[:, None]


def norm_modulate_plain(x: Tensor, shift: Tensor, scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    r"""``h, mean, rstd``: ``h = LN(x) (1 + scale) + shift`` in ``x``'s dtype,
    the statistics ``(B, N)`` in float32 (float64 for float64)."""

    acc = _acc(x)
    u = x.to(acc)
    var, mean = torch.var_mean(u, dim=-1, correction=0)
    rstd = torch.rsqrt(var + EPS)
    h = (u - mean[..., None]) * rstd[..., None] * (1 + _rows(scale, acc)) + _rows(shift, acc)
    return h.to(x.dtype), mean, rstd


def gated_add_plain(x: Tensor, gate: Tensor, m: Tensor) -> Tensor:
    r"""``x + gate m`` in ``x``'s dtype, rounded once."""

    acc = _acc(x)
    return (x.to(acc) + _rows(gate, acc) * m.to(acc)).to(x.dtype)


def gated_norm_modulate_plain(
    x: Tensor, gate: Tensor, a: Tensor, shift: Tensor, scale: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    r"""``x', h, mean, rstd``: ``x' = x + gate a`` (rounded), then
    :func:`norm_modulate_plain` of ``x'``."""

    xp = gated_add_plain(x, gate, a)
    return (xp,) + norm_modulate_plain(xp, shift, scale)


def norm_modulate_bwd_plain(
    dh: Tensor, ds: Optional[Tensor], x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor,
    gate: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    r"""``dx, da``: ``dx = LN'(dh (1 + scale)) + ds`` at the normalised
    ``x`` (``x'`` where gated), and where ``gate`` is given ``da = gate dx``
    from the same unrounded sum; both in ``x``'s dtype."""

    acc = _acc(x)
    y = (x.to(acc) - mean[..., None]) * rstd[..., None]
    g = dh.to(acc) * (1 + _rows(scale, acc))
    d = rstd[..., None] * (g - g.mean(-1, keepdim=True) - y * (g * y).mean(-1, keepdim=True))
    if ds is not None:
        d = d + ds.to(acc)
    da = None if gate is None else (_rows(gate, acc) * d).to(x.dtype)
    return d.to(x.dtype), da


def gated_add_bwd_plain(dy: Tensor, gate: Tensor) -> Tensor:
    r"""``dm = gate dy`` in ``dy``'s dtype (``dx`` is ``dy`` itself)."""

    acc = _acc(dy)
    return (_rows(gate, acc) * dy.to(acc)).to(dy.dtype)


def vector_grads_plain(
    dh: Optional[Tensor], x: Optional[Tensor], mean: Optional[Tensor], rstd: Optional[Tensor],
    g: Optional[Tensor] = None, a: Optional[Tensor] = None,
) -> Tuple[Optional[Tensor], Optional[Tensor], Optional[Tensor]]:
    r"""``dshift, dscale, dgate`` ``(B, D)``, sums over the tokens in float32
    (float64 for float64): ``sum dh`` and ``sum dh y`` where ``dh`` is given
    (``y`` from ``x, mean, rstd``), ``sum g a`` where ``g`` is given."""

    dshift = dscale = dgate = None
    if dh is not None:
        acc = _acc(dh)
        y = (x.to(acc) - mean[..., None]) * rstd[..., None]
        dshift, dscale = dh.to(acc).sum(1), (dh.to(acc) * y).sum(1)
    if g is not None:
        acc = _acc(g)
        dgate = (g.to(acc) * a.to(acc)).sum(1)
    return dshift, dscale, dgate


# -- Kernel launches -------------------------------------------------------------
#
# The launchers take contiguous bf16 token rows (B, N, D) and bf16 vectors (B, D)
# with contiguous channels; no autograd.


def _check(name: str, t: Tensor, like: Tensor) -> None:
    if t.device != like.device or t.dtype != torch.bfloat16:
        raise ValueError(f'{name}: bfloat16 on {like.device} expected, got {t.dtype} on {t.device}')
    if t.shape != like.shape or not t.is_contiguous():
        raise ValueError(f'{name}: a contiguous tensor of shape {tuple(like.shape)} expected')
    if t.data_ptr() % 16:
        raise ValueError(f'{name}: 16-byte aligned data expected')


def _rows_of(x: Tensor) -> Tuple[int, int, int]:
    r"""``B, N, D`` of the token rows ``x``, which the kernels must take."""

    if x.device.type != 'cuda':
        raise ValueError(f'x: a CUDA tensor expected, got one on {x.device}')
    if x.ndim != 3 or x.numel() == 0:
        raise ValueError(f'x: non-empty (B, N, D) token rows expected, got {tuple(x.shape)}')
    _check('x', x, x)
    b, n, d = x.shape
    if d % 8 or d > MAX_WIDTH:
        raise ValueError(f'x: a width that 8 divides, at most {MAX_WIDTH}, expected, got {d}')
    return b, n, d


def _vector(name: str, v: Tensor, x: Tensor) -> Tuple[int, int]:
    r"""``(pointer, row stride)`` of a ``(B, D)`` vector of ``x``'s rows."""

    if v.device != x.device or v.dtype != torch.bfloat16:
        raise ValueError(f'{name}: bfloat16 on {x.device} expected, got {v.dtype} on {v.device}')
    if v.shape != (x.shape[0], x.shape[2]) or v.stride(1) != 1:
        raise ValueError(f'{name}: ({x.shape[0]}, {x.shape[2]}) with contiguous channels expected')
    if v.data_ptr() % 16 or v.stride(0) % 8:
        raise ValueError(f'{name}: 16-byte aligned rows expected')
    return v.data_ptr(), v.stride(0)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, device: torch.device, *args) -> None:
    r"""Calls the library's ``sda_dit_<name>`` with ``args`` and ``device``'s
    current stream, on ``device``; counts the launch or raises."""

    fn = getattr(_library or library(), f'sda_dit_{name}')
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')
    counters[f'dit.{name}'] += 1


def _stats(x: Tensor) -> Tuple[Tensor, Tensor]:
    mean = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    return mean, torch.empty_like(mean)


def _sums(x: Tensor, need: bool) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    r"""Scratch for the per-tile sums and the ``(3, B, D)`` float32 sums of
    the vectors' gradients, where ``need``."""

    if not need:
        return None, None
    b, n, d = x.shape
    part = torch.empty((b, -(-n // TILE_ROWS), 3, d), dtype=torch.float32, device=x.device)
    return part, torch.empty((3, b, d), dtype=torch.float32, device=x.device)


def _stat_check(x: Tensor, mean: Tensor, rstd: Tensor) -> None:
    for name, t in (('mean', mean), ('rstd', rstd)):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != x.shape[:2] or not t.is_contiguous():
            raise ValueError(f'{name}: contiguous float32 {tuple(x.shape[:2])} on {x.device} expected')


def launch_norm_modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    r"""Enqueues :func:`norm_modulate_plain`'s function."""

    b, n, d = _rows_of(x)
    h = torch.empty_like(x)
    mean, rstd = _stats(x)
    _launch('norm_mod', x.device, x.data_ptr(), *_vector('shift', shift, x), *_vector('scale', scale, x),
            h.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b, n, d, EPS)
    return h, mean, rstd


def launch_gated_norm_modulate(
    x: Tensor, gate: Tensor, a: Tensor, shift: Tensor, scale: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    r"""Enqueues :func:`gated_norm_modulate_plain`'s function."""

    b, n, d = _rows_of(x)
    _check('a', a, x)
    xp, h = torch.empty_like(x), torch.empty_like(x)
    mean, rstd = _stats(x)
    _launch('gated_norm_mod', x.device, x.data_ptr(), a.data_ptr(), *_vector('gate', gate, x),
            *_vector('shift', shift, x), *_vector('scale', scale, x), xp.data_ptr(), h.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), b, n, d, EPS)
    return xp, h, mean, rstd


def launch_norm_modulate_bwd(
    dh: Tensor, x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor, need_vectors: bool = False,
) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    r"""``dx, dshift, dscale``: :func:`norm_modulate_bwd_plain` and, where
    ``need_vectors``, :func:`vector_grads_plain`'s sums (float32)."""

    b, n, d = _rows_of(x)
    _check('dh', dh, x)
    _stat_check(x, mean, rstd)
    dx = torch.empty_like(x)
    part, sums = _sums(x, need_vectors)
    _launch('norm_mod_bwd', x.device, dh.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            *_vector('scale', scale, x), dx.data_ptr(), _ptr(part), _ptr(sums), b, n, d)
    return (dx, None, None) if sums is None else (dx, sums[0], sums[1])


def launch_gated_norm_modulate_bwd(
    dh: Tensor, ds: Optional[Tensor], xp: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor, gate: Tensor,
    a: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[Tensor], Optional[Tensor]]:
    r"""``dx, da, dshift, dscale, dgate``: :func:`norm_modulate_bwd_plain`
    with ``gate`` and, where ``a`` is given, :func:`vector_grads_plain`'s
    sums (float32; ``dgate`` from the rounded ``dx``)."""

    b, n, d = _rows_of(xp)
    _check('dh', dh, xp)
    if ds is not None:
        _check('ds', ds, xp)
    if a is not None:
        _check('a', a, xp)
    _stat_check(xp, mean, rstd)
    dx, da = torch.empty_like(xp), torch.empty_like(xp)
    part, sums = _sums(xp, a is not None)
    _launch('gated_norm_mod_bwd', xp.device, dh.data_ptr(), _ptr(ds), xp.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), *_vector('scale', scale, xp), *_vector('gate', gate, xp), _ptr(a), dx.data_ptr(),
            da.data_ptr(), _ptr(part), _ptr(sums), b, n, d)
    return (dx, da, None, None, None) if sums is None else (dx, da, sums[0], sums[1], sums[2])


def launch_gated_add(x: Tensor, gate: Tensor, m: Tensor) -> Tensor:
    r"""Enqueues :func:`gated_add_plain`'s function."""

    b, n, d = _rows_of(x)
    _check('m', m, x)
    y = torch.empty_like(x)
    _launch('gated_add', x.device, x.data_ptr(), m.data_ptr(), *_vector('gate', gate, x), y.data_ptr(), b, n, d)
    return y


def launch_gated_add_bwd(dy: Tensor, gate: Tensor, m: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor]]:
    r"""``dm, dgate``: :func:`gated_add_bwd_plain` and, where ``m`` is
    given, ``sum dy m`` (float32)."""

    b, n, d = _rows_of(dy)
    if m is not None:
        _check('m', m, dy)
    dm = torch.empty_like(dy)
    part, sums = _sums(dy, m is not None)
    _launch('gated_add_bwd', dy.device, dy.data_ptr(), _ptr(m), *_vector('gate', gate, dy), dm.data_ptr(),
            _ptr(part), _ptr(sums), b, n, d)
    return dm, None if sums is None else sums[2]


# -- Autograd functions ----------------------------------------------------------


def _cast(g: Optional[Tensor], like: Tensor, need: bool) -> Optional[Tensor]:
    return g.to(like.dtype) if need and g is not None else None


class _NormModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, scale):
        fn = norm_modulate_plain if x.device.type == 'cpu' else launch_norm_modulate
        h, mean, rstd = fn(x, shift, scale)
        ctx.save_for_backward(x, scale, mean, rstd)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, scale, mean, rstd = ctx.saved_tensors
        need_x, need_shift, need_scale = ctx.needs_input_grad
        need = need_shift or need_scale
        dh = dh.contiguous()
        if dh.device.type == 'cpu':
            dx, _ = norm_modulate_bwd_plain(dh, None, x, mean, rstd, scale)
            dshift, dscale, _ = vector_grads_plain(dh, x, mean, rstd) if need else (None, None, None)
        else:
            dx, dshift, dscale = launch_norm_modulate_bwd(dh, x, mean, rstd, scale, need)
        return dx if need_x else None, _cast(dshift, scale, need_shift), _cast(dscale, scale, need_scale)


class _GatedNormModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gate, a, shift, scale):
        fn = gated_norm_modulate_plain if x.device.type == 'cpu' else launch_gated_norm_modulate
        xp, h, mean, rstd = fn(x, gate, a, shift, scale)
        need = any(ctx.needs_input_grad[i] for i in (1, 3, 4))
        ctx.save_for_backward(xp, gate, a if need else None, scale, mean, rstd)
        return xp, h

    @staticmethod
    def backward(ctx, dxp, dh):
        xp, gate, a, scale, mean, rstd = ctx.saved_tensors
        need_x, need_gate, need_a, need_shift, need_scale = ctx.needs_input_grad
        dxp, dh = dxp.contiguous(), dh.contiguous()
        if dh.device.type == 'cpu':
            dx, da = norm_modulate_bwd_plain(dh, dxp, xp, mean, rstd, scale, gate)
            dshift, dscale, dgate = vector_grads_plain(dh, xp, mean, rstd, dx, a) if a is not None else (None,) * 3
        else:
            dx, da, dshift, dscale, dgate = launch_gated_norm_modulate_bwd(dh, dxp, xp, mean, rstd, scale, gate, a)
        return (dx if need_x else None, _cast(dgate, gate, need_gate), da if need_a else None,
                _cast(dshift, scale, need_shift), _cast(dscale, scale, need_scale))


class _GatedAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gate, m):
        fn = gated_add_plain if x.device.type == 'cpu' else launch_gated_add
        ctx.save_for_backward(gate, m if ctx.needs_input_grad[1] else None)
        return fn(x, gate, m)

    @staticmethod
    def backward(ctx, dy):
        gate, m = ctx.saved_tensors
        need_x, need_gate, need_m = ctx.needs_input_grad
        dy = dy.contiguous()
        if dy.device.type == 'cpu':
            dm = gated_add_bwd_plain(dy, gate) if need_m else None
            dgate = vector_grads_plain(None, None, None, None, dy, m)[2] if need_gate else None
        else:
            dm, dgate = launch_gated_add_bwd(dy, gate, m if need_gate else None)
        return dy if need_x else None, _cast(dgate, gate, need_gate), dm if need_m else None


# -- Public entry points -----------------------------------------------------------


def norm_modulate(x: Tensor, shift: Tensor, scale: Tensor) -> Tensor:
    r"""``LN(x) (1 + scale) + shift`` of token rows ``x (B, N, D)`` with
    ``shift, scale (B, D)``: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""

    return _NormModulate.apply(x, shift, scale)


def gated_norm_modulate(x: Tensor, gate: Tensor, a: Tensor, shift: Tensor, scale: Tensor) -> Tuple[Tensor, Tensor]:
    r"""``(x', h)``: ``x' = x + gate a`` and ``h = LN(x') (1 + scale) +
    shift``, of ``x, a (B, N, D)`` with ``(B, D)`` vectors: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""

    return _GatedNormModulate.apply(x, gate, a, shift, scale)


def gated_add(x: Tensor, gate: Tensor, m: Tensor) -> Tensor:
    r"""``x + gate m`` of ``x, m (B, N, D)`` with ``gate (B, D)``: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""

    return _GatedAdd.apply(x, gate, m)

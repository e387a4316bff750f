r"""The truncated real 2-D DFT pair as hand-written CUDA kernels.

Counterpart of :mod:`sda_tpu.ops.pallas_dft` (the only Pallas kernels of the
JAX package). The kernels are in ``csrc/dft.cu``; at first use on a CUDA
tensor this module compiles that file with ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``csrc/build/<source hash>/`` and loads it with
``ctypes``. Nothing is compiled or loaded at import.

Each kernel has its plain version beside it (``rfft2_plain``,
``irfft2_plain``: the einsums of ``sda_tpu/ops/spectral.py``). The public
functions take the plain version only for a tensor on the CPU; on a CUDA
tensor they launch the kernel or raise. Their gradients are the transposed
contractions of ``_rfft2_bwd``/``_irfft2_bwd``, in plain torch.

Layouts: ``x (N, H, W)``, spectra ``(N, Kh, Fw)`` with ``Kh = 2 h_modes - 1``
rows and ``Fw`` half-axis columns; bases ``cos_w, sin_w (Fw, W)``,
``cos_h, sin_h (Kh, H)`` and Hermitian weights ``dw (Fw,)``, all float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'dft.cu'
BUILD = SOURCE.parent / 'build'

#: Launches of each kernel since the last reset (a plain count, incremented
#: only where a kernel is enqueued).
launches = {'rfft2': 0, 'irfft2': 0}

_library: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_command(output: Path) -> list:
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    return [
        nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
        '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
        '-o', str(output), str(SOURCE),
    ]


def build() -> Tuple[Path, str]:
    r"""Compiles ``csrc/dft.cu`` unless a library built from the same source
    exists; returns its path and the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel; empty when reused)."""

    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    target = BUILD / digest / 'libsda_dft.so'
    if target.exists():
        return target, ''

    target.parent.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f'libsda_dft.{os.getpid()}.so')
    done = subprocess.run(nvcc_command(partial), capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f'nvcc failed ({done.returncode}):\n{done.stdout}{done.stderr}')
    os.replace(partial, target)  # atomic: a concurrent process never loads half a file

    return target, done.stdout + done.stderr


def library() -> ctypes.CDLL:
    r"""The kernels' shared library, built and loaded at first call."""

    global _library
    with _lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.sda_rfft2.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
            lib.sda_rfft2.restype = i32
            lib.sda_irfft2.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, i32, ptr]
            lib.sda_irfft2.restype = i32
            _library = lib
    return _library


# -- Plain versions ------------------------------------------------------------


def rfft2_plain(x: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor) -> Tuple[Tensor, Tensor]:
    r"""Forward transform as plain contractions (``spectral.py`` matmul path)."""

    re = torch.einsum('...hw,fw->...hf', x, cw)
    im = -torch.einsum('...hw,fw->...hf', x, sw)

    re2 = torch.einsum('...hf,ah->...af', re, ch) + torch.einsum('...hf,ah->...af', im, sh)
    im2 = torch.einsum('...hf,ah->...af', im, ch) - torch.einsum('...hf,ah->...af', re, sh)

    return re2, im2


def irfft2_plain(
    re: Tensor, im: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor, dw: Tensor,
) -> Tensor:
    r"""Inverse transform as plain contractions (``spectral.py`` matmul path)."""

    height, width = ch.shape[1], cw.shape[1]

    re1 = (
        torch.einsum('...af,ah->...hf', re, ch) - torch.einsum('...af,ah->...hf', im, sh)
    ) / height
    im1 = (
        torch.einsum('...af,ah->...hf', im, ch) + torch.einsum('...af,ah->...hf', re, sh)
    ) / height

    return (
        torch.einsum('...hf,fw->...hw', re1 * dw, cw)
        - torch.einsum('...hf,fw->...hw', im1 * dw, sw)
    ) / width


# -- Kernel launches -------------------------------------------------------------

#: Tile widths the library is built for: the forward's output columns per
#: block, the inverse's output rows per block.
RFFT2_TILES = (1, 2, 4, 8)
IRFFT2_TILES = (2, 4, 8, 16)


def rfft2_tile(n: int) -> int:
    r"""The forward's tile for a batch of ``n`` fields. ``chip_smoke.py``
    times every tile at 1, 4 and 16 fields of 256^2: one column per block is
    fastest up to 4 fields, four columns at 16."""

    return 1 if n <= 4 else 4


def irfft2_tile(n: int) -> int:
    r"""The inverse's tile for a batch of ``n`` spectra: two rows per block
    up to 4 spectra, eight at 16 (as :func:`rfft2_tile`)."""

    return 2 if n <= 4 else 8



def _check(name: str, t: Tensor, shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f'{name}: float32 on {device} expected, got {t.dtype} on {t.device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(shape)} expected, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: a contiguous tensor expected')


def launch_rfft2(
    x: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor, tile: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    r"""Enqueues the forward kernel (``tile`` columns per block, by default
    :func:`rfft2_tile` of the batch); no autograd."""

    if x.ndim != 3:
        raise ValueError(f'x: (N, H, W) expected, got {tuple(x.shape)}')
    n, h, w = x.shape
    kh, fw = ch.shape[0], cw.shape[0]
    if not 0 < n <= 65535:
        raise ValueError(f'x: batch {n} outside the kernel grid (1..65535)')
    tile = rfft2_tile(n) if tile is None else tile
    if tile not in RFFT2_TILES:
        raise ValueError(f'rfft2: tile {tile} not among {RFFT2_TILES}')
    for name, t, shape in (
        ('x', x, (n, h, w)), ('cos_w', cw, (fw, w)), ('sin_w', sw, (fw, w)),
        ('cos_h', ch, (kh, h)), ('sin_h', sh, (kh, h)),
    ):
        _check(name, t, shape, x.device)

    re = torch.empty((n, kh, fw), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().sda_rfft2(
            x.data_ptr(), cw.data_ptr(), sw.data_ptr(), ch.data_ptr(), sh.data_ptr(),
            re.data_ptr(), im.data_ptr(), n, h, w, kh, fw, tile, stream,
        )
    if err != 0:
        raise RuntimeError(f'rfft2 kernel launch failed: CUDA error {err}')
    launches['rfft2'] += 1

    return re, im


def launch_irfft2(
    re: Tensor, im: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor, dw: Tensor,
    tile: Optional[int] = None,
) -> Tensor:
    r"""Enqueues the inverse kernel (``tile`` rows per block, by default
    :func:`irfft2_tile` of the batch); no autograd."""

    if re.ndim != 3:
        raise ValueError(f're: (N, Kh, Fw) expected, got {tuple(re.shape)}')
    n, kh, fw = re.shape
    h, w = ch.shape[1], cw.shape[1]
    if not 0 < n <= 65535:
        raise ValueError(f're: batch {n} outside the kernel grid (1..65535)')
    tile = irfft2_tile(n) if tile is None else tile
    if tile not in IRFFT2_TILES:
        raise ValueError(f'irfft2: tile {tile} not among {IRFFT2_TILES}')
    for name, t, shape in (
        ('re', re, (n, kh, fw)), ('im', im, (n, kh, fw)),
        ('cos_w', cw, (fw, w)), ('sin_w', sw, (fw, w)),
        ('cos_h', ch, (kh, h)), ('sin_h', sh, (kh, h)), ('dw', dw, (fw,)),
    ):
        _check(name, t, shape, re.device)

    x = torch.empty((n, h, w), dtype=torch.float32, device=re.device)

    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().sda_irfft2(
            re.data_ptr(), im.data_ptr(), cw.data_ptr(), sw.data_ptr(),
            ch.data_ptr(), sh.data_ptr(), dw.data_ptr(), x.data_ptr(),
            n, h, w, kh, fw, 1.0 / (h * w), tile, stream,
        )
    if err != 0:
        raise RuntimeError(f'irfft2 kernel launch failed: CUDA error {err}')
    launches['irfft2'] += 1

    return x


class _RFFT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cw, sw, ch, sh):
        ctx.save_for_backward(cw, sw, ch, sh)
        return launch_rfft2(x, cw, sw, ch, sh)

    @staticmethod
    def backward(ctx, gre, gim):
        # Transpose of the linear forward map (_rfft2_bwd, plain contractions).
        cw, sw, ch, sh = ctx.saved_tensors

        gre1 = torch.einsum('naf,ah->nhf', gre, ch) - torch.einsum('naf,ah->nhf', gim, sh)
        gim1 = torch.einsum('naf,ah->nhf', gre, sh) + torch.einsum('naf,ah->nhf', gim, ch)

        gx = torch.einsum('nhf,fw->nhw', gre1, cw) - torch.einsum('nhf,fw->nhw', gim1, sw)

        return gx, None, None, None, None


class _IRFFT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, cw, sw, ch, sh, dw):
        ctx.save_for_backward(cw, sw, ch, sh, dw)
        return launch_irfft2(re, im, cw, sw, ch, sh, dw)

    @staticmethod
    def backward(ctx, gx):
        # Transpose of the linear inverse map (_irfft2_bwd, plain contractions).
        cw, sw, ch, sh, dw = ctx.saved_tensors
        scale = 1.0 / (ch.shape[1] * cw.shape[1])

        g1re = torch.einsum('nhw,fw->nhf', gx, cw) * dw * scale
        g1im = -torch.einsum('nhw,fw->nhf', gx, sw) * dw * scale

        gre = torch.einsum('nhf,ah->naf', g1re, ch) + torch.einsum('nhf,ah->naf', g1im, sh)
        gim = -torch.einsum('nhf,ah->naf', g1re, sh) + torch.einsum('nhf,ah->naf', g1im, ch)

        return gre, gim, None, None, None, None, None


# -- Public entry points -----------------------------------------------------------


def rfft2(x: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor) -> Tuple[Tensor, Tensor]:
    r"""Forward transform of ``x (N, H, W)``: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""

    if x.device.type == 'cpu':
        return rfft2_plain(x, cw, sw, ch, sh)
    return _RFFT2.apply(x, cw, sw, ch, sh)


def irfft2(
    re: Tensor, im: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor, dw: Tensor,
) -> Tensor:
    r"""Inverse transform of ``(re, im) (N, Kh, Fw)``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""

    if re.device.type == 'cpu':
        return irfft2_plain(re, im, cw, sw, ch, sh, dw)
    return _IRFFT2.apply(re, im, cw, sw, ch, sh, dw)

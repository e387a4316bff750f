r"""The truncated real 2-D DFT pair as hand-written CUDA kernels.

Counterpart of :mod:`sda_tpu.ops.pallas_dft` (the only Pallas kernels of the
JAX package). The kernels are in ``csrc/dft.cu``; at first use on a CUDA
tensor this module compiles that file with ``nvcc`` for ``sm_90a`` into a
plain-C shared library under ``csrc/build/<source hash>/`` and loads it with
``ctypes``. Nothing is compiled or loaded at import. The kernels compute
factorised transforms from tables built here once per ``RealDFT2``
(:class:`Plan`); the plain versions and the gradients use the dense bases.

Each kernel has its plain version beside it (``rfft2_plain``,
``irfft2_plain``: the einsums of ``sda_tpu/ops/spectral.py``). The public
functions take the plain version only for a tensor on the CPU; on a CUDA
tensor they launch the kernel or raise. Their gradients are the transposed
contractions of ``_rfft2_bwd``/``_irfft2_bwd``, in plain torch.

Layouts: ``x (N, H, W)``, spectra ``(N, Kh, Fw)`` with ``Kh = 2 h_modes - 1``
rows (or all ``H``) and ``Fw`` half-axis columns; bases ``cos_w, sin_w (Fw, W)``,
``cos_h, sin_h (Kh, H)`` and Hermitian weights ``dw (Fw,)``, all float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Mapping
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..tracing import counters

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'dft.cu'
BUILD = SOURCE.parent / 'build'


class _Launches(Mapping):
    r"""Launches of each kernel since the last reset, by kernel name: the
    counters ``dft.rfft2`` and ``dft.irfft2`` of :mod:`sda_tpu_torch.tracing`,
    incremented only where a kernel is enqueued."""

    def __getitem__(self, name: str) -> int:
        return counters[f'dft.{name}']

    def __iter__(self):
        return iter(('rfft2', 'irfft2'))

    def __len__(self) -> int:
        return 2

    def __repr__(self) -> str:
        return repr(dict(self))


launches = _Launches()

_library: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        counters[f'dft.{name}'] = 0


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
            lib.sda_rfft2.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
            lib.sda_rfft2.restype = i32
            lib.sda_irfft2.argtypes = [ptr] * 6 + [i32] * 6 + [ctypes.c_float, i32, ptr]
            lib.sda_irfft2.restype = i32
            lib.sda_dft_max_clusters.argtypes = [i32] * 7 + [ctypes.POINTER(i32)] * 2
            lib.sda_dft_max_clusters.restype = i32
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


# -- Plans of the factorised transforms ------------------------------------------

#: Longest axis the kernels take: one transform must fit a work buffer.
MAX_LENGTH = 4096
#: Largest prime factor of an axis length (its DFT matrix is a table).
MAX_RADIX = 128


def factorise(n: int) -> Tuple[int, ...]:
    r"""The radices of a length-``n`` transform, in the kernel's order: 16s,
    then a 4, then a 2, then odd primes ascending (each a direct small DFT)."""

    radices = []
    while n % 16 == 0:
        radices.append(16)
        n //= 16
    if n % 4 == 0:
        radices.append(4)
        n //= 4
    if n % 2 == 0:
        radices.append(2)
        n //= 2
    p = 3
    while n > 1:
        while n % p == 0:
            radices.append(p)
            n //= p
        p += 2
    return tuple(radices)


#: Ints of one axis's plan in :attr:`Plan.ints` (``kPlanInts`` in the kernels).
PLAN_INTS = 64


def axis_plan(n: int, offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    r"""The plan and table of one axis's forward transform (``fft`` in
    ``csrc/dft.cu``). Plan (int32, :data:`PLAN_INTS` long, zero padded):
    ``[n, stages, radix..., twiddle offset..., matrix offset...]``, offsets
    in complex entries from the start of the table it is concatenated to,
    ``offset`` entries before this axis's own. Table (float32, ``(entries,
    2)`` complex): for each stage of radix ``r`` after radices of product
    ``ns``, the twiddles ``e^{-2 pi i k q / (ns r)}`` at ``q ns + k``; then
    for each radix other than 2, 4 and 16, its DFT matrix
    ``e^{-2 pi i p q / r}`` at ``p r + q``. Built in float64."""

    if not 0 < n <= MAX_LENGTH:
        raise ValueError(f'axis of length {n}: the kernels take 1..{MAX_LENGTH}')
    radices = factorise(n)
    if radices and max(radices) > MAX_RADIX:
        raise ValueError(f'axis of length {n}: prime factor {max(radices)} above {MAX_RADIX}')

    entries, twiddles, matrices = [], [], []
    size, ns = 0, 1
    for r in radices:
        q, k = np.meshgrid(np.arange(r), np.arange(ns), indexing='ij')
        entries.append(np.exp(-2j * np.pi * k * q / (ns * r)).ravel())
        twiddles.append(offset + size)
        size += ns * r
        ns *= r
    for r in radices:
        if r in (2, 4, 16):
            matrices.append(0)
            continue
        p, q = np.meshgrid(np.arange(r), np.arange(r), indexing='ij')
        entries.append(np.exp(-2j * np.pi * p * q / r).ravel())
        matrices.append(offset + size)
        size += r * r

    table = np.concatenate(entries) if entries else np.zeros(0, np.complex128)
    plan = np.zeros(PLAN_INTS, np.int32)
    plan[:2 + 3 * len(radices)] = [n, len(radices), *radices, *twiddles, *matrices]
    return plan, np.stack((table.real, table.imag), -1).astype(np.float32)


class Plan:
    r"""The kernels' tables for one :class:`~sda_tpu_torch.ops.RealDFT2`, as
    two tensors on ``device`` that each block copies to shared memory:
    ``ints`` (int32) holds the plans of H and W (:func:`axis_plan`) and the
    kept rows ``rows_h`` (frequency mod ``height``, in ``freqs_h`` order);
    ``table`` (float32, ``(entries, 2)``) the two axes' tables."""

    def __init__(self, height: int, width: int, freqs_h, w_modes: int, device):
        if not 0 < w_modes <= width // 2 + 1:
            raise ValueError(f'{w_modes} columns kept of a real axis of {width}')
        rows = np.asarray(freqs_h).astype(np.int64) % height
        if len(set(rows.tolist())) != len(rows):
            raise ValueError('kept rows repeat a frequency')

        plan_h, table_h = axis_plan(height)
        plan_w, table_w = axis_plan(width, offset=len(table_h))

        self.height, self.width = height, width
        self.spectral_shape = (len(rows), w_modes)
        self.ints = torch.as_tensor(np.concatenate((plan_h, plan_w, rows.astype(np.int32))), device=device)
        self.table = torch.as_tensor(np.concatenate((table_h, table_w)), device=device)

    @property
    def plan_h(self) -> Tensor:
        return self.ints[:PLAN_INTS]

    @property
    def plan_w(self) -> Tensor:
        return self.ints[PLAN_INTS:2 * PLAN_INTS]

    @property
    def rows_h(self) -> Tensor:
        return self.ints[2 * PLAN_INTS:]


# -- Kernel launches -------------------------------------------------------------

#: Blocks per field (thread-block cluster sizes) both launchers take.
CLUSTERS = (2, 4, 8, 16)


#: Blocks of either kernel one wave of an H100 holds at 256^2 (the
#: residency ``chip_smoke.py`` prints: 112-132 blocks for every cluster size).
WAVE_BLOCKS = 120


def cluster_size(n: int) -> int:
    r"""Either kernel's cluster size for a batch of ``n`` fields: the largest
    whose ``n`` clusters fit in one wave, so one field spreads over up to 16
    SMs and a large batch keeps each field on few. ``chip_smoke.py`` times
    every size at 1, 2, 4, 16 and 64 fields."""

    return next((c for c in (16, 8, 4) if n * c <= WAVE_BLOCKS), 2)


def max_clusters(inverse: bool, plan: Plan, cluster: int) -> Tuple[int, int]:
    r"""How many clusters of the kernel can be resident on the current card
    at once (``cudaOccupancyMaxActiveClusters``) for ``plan``'s shape, and
    the dynamic shared memory of one block, in bytes."""

    count, smem = ctypes.c_int(0), ctypes.c_int(0)
    kh, fw = plan.spectral_shape
    err = library().sda_dft_max_clusters(
        int(inverse), plan.height, plan.width, kh, fw, len(plan.table), cluster,
        ctypes.byref(count), ctypes.byref(smem),
    )
    if err != 0:
        raise RuntimeError(f'cudaOccupancyMaxActiveClusters failed: CUDA error {err}')
    return count.value, smem.value


def _check(name: str, t: Tensor, shape: Tuple[int, ...], device: torch.device, dtype=torch.float32) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f'{name}: {dtype} on {device} expected, got {t.dtype} on {t.device}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(shape)} expected, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: a contiguous tensor expected')


def _check_plan(plan: Optional[Plan], device: torch.device) -> None:
    if plan is None:
        raise ValueError('the kernels need the RealDFT2 plan of the transform')
    _check('plan ints', plan.ints, plan.ints.shape, device, torch.int32)
    _check('plan table', plan.table, plan.table.shape, device)


def _batch(name: str, n: int) -> None:
    if not 0 < n <= 65535:
        raise ValueError(f'{name}: batch {n} outside the kernel grid (1..65535)')


def launch_rfft2(x: Tensor, plan: Plan, cluster: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    r"""Enqueues the forward kernel (``cluster`` blocks per field, by default
    :func:`cluster_size` of the batch); no autograd."""

    if x.ndim != 3:
        raise ValueError(f'x: (N, H, W) expected, got {tuple(x.shape)}')
    n, h, w = x.shape
    _batch('x', n)
    cluster = cluster_size(n) if cluster is None else cluster
    if cluster not in CLUSTERS:
        raise ValueError(f'rfft2: cluster {cluster} not among {CLUSTERS}')
    _check_plan(plan, x.device)
    _check('x', x, (n, plan.height, plan.width), x.device)
    kh, fw = plan.spectral_shape

    re = torch.empty((n, kh, fw), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().sda_rfft2(
            x.data_ptr(), plan.ints.data_ptr(), plan.table.data_ptr(), re.data_ptr(), im.data_ptr(),
            n, h, w, kh, fw, len(plan.table), cluster, stream,
        )
    if err != 0:
        raise RuntimeError(f'rfft2 kernel launch failed: CUDA error {err}')
    counters['dft.rfft2'] += 1

    return re, im


def launch_irfft2(
    re: Tensor, im: Tensor, dw: Tensor, plan: Plan, cluster: Optional[int] = None,
) -> Tensor:
    r"""Enqueues the inverse kernel (``cluster`` blocks per field, by default
    :func:`cluster_size` of the batch); no autograd."""

    if re.ndim != 3:
        raise ValueError(f're: (N, Kh, Fw) expected, got {tuple(re.shape)}')
    n = re.shape[0]
    _batch('re', n)
    cluster = cluster_size(n) if cluster is None else cluster
    if cluster not in CLUSTERS:
        raise ValueError(f'irfft2: cluster {cluster} not among {CLUSTERS}')
    _check_plan(plan, re.device)
    kh, fw = plan.spectral_shape
    h, w = plan.height, plan.width
    for name, t, shape in (('re', re, (n, kh, fw)), ('im', im, (n, kh, fw)), ('dw', dw, (fw,))):
        _check(name, t, shape, re.device)

    x = torch.empty((n, h, w), dtype=torch.float32, device=re.device)

    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().sda_irfft2(
            re.data_ptr(), im.data_ptr(), plan.ints.data_ptr(), plan.table.data_ptr(), dw.data_ptr(),
            x.data_ptr(), n, h, w, kh, fw, len(plan.table), 1.0 / (h * w), cluster, stream,
        )
    if err != 0:
        raise RuntimeError(f'irfft2 kernel launch failed: CUDA error {err}')
    counters['dft.irfft2'] += 1

    return x


class _RFFT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cw, sw, ch, sh, plan):
        ctx.save_for_backward(cw, sw, ch, sh)
        return launch_rfft2(x, plan)

    @staticmethod
    def backward(ctx, gre, gim):
        # Transpose of the linear forward map (_rfft2_bwd, plain contractions).
        cw, sw, ch, sh = ctx.saved_tensors

        gre1 = torch.einsum('naf,ah->nhf', gre, ch) - torch.einsum('naf,ah->nhf', gim, sh)
        gim1 = torch.einsum('naf,ah->nhf', gre, sh) + torch.einsum('naf,ah->nhf', gim, ch)

        gx = torch.einsum('nhf,fw->nhw', gre1, cw) - torch.einsum('nhf,fw->nhw', gim1, sw)

        return gx, None, None, None, None, None


class _IRFFT2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, cw, sw, ch, sh, dw, plan):
        ctx.save_for_backward(cw, sw, ch, sh, dw)
        return launch_irfft2(re, im, dw, plan)

    @staticmethod
    def backward(ctx, gx):
        # Transpose of the linear inverse map (_irfft2_bwd, plain contractions).
        cw, sw, ch, sh, dw = ctx.saved_tensors
        scale = 1.0 / (ch.shape[1] * cw.shape[1])

        g1re = torch.einsum('nhw,fw->nhf', gx, cw) * dw * scale
        g1im = -torch.einsum('nhw,fw->nhf', gx, sw) * dw * scale

        gre = torch.einsum('nhf,ah->naf', g1re, ch) + torch.einsum('nhf,ah->naf', g1im, sh)
        gim = -torch.einsum('nhf,ah->naf', g1re, sh) + torch.einsum('nhf,ah->naf', g1im, ch)

        return gre, gim, None, None, None, None, None, None


# -- Public entry points -----------------------------------------------------------


def rfft2(
    x: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor, plan: Optional[Plan] = None,
) -> Tuple[Tensor, Tensor]:
    r"""Forward transform of ``x (N, H, W)``: the kernel on a CUDA tensor
    (``plan`` required), the plain version on a CPU tensor."""

    if x.device.type == 'cpu':
        return rfft2_plain(x, cw, sw, ch, sh)
    return _RFFT2.apply(x, cw, sw, ch, sh, plan)


def irfft2(
    re: Tensor, im: Tensor, cw: Tensor, sw: Tensor, ch: Tensor, sh: Tensor, dw: Tensor,
    plan: Optional[Plan] = None,
) -> Tensor:
    r"""Inverse transform of ``(re, im) (N, Kh, Fw)``: the kernel on a CUDA
    tensor (``plan`` required), the plain version on a CPU tensor."""

    if re.device.type == 'cpu':
        return irfft2_plain(re, im, cw, sw, ch, sh, dw)
    return _IRFFT2.apply(re, im, cw, sw, ch, sh, dw, plan)

#!/usr/bin/env python3
r"""Smoke run of sda_tpu_torch on one NVIDIA card.

Drives the port's main path once, on the card, through the entry points a
user calls: a Kolmogorov truth simulated at 256^2 through the CUDA DFT
kernels (``KolmogorovFlow(256, dt=0.2)``: prior, 64 transitions, keep the last
32, coarsen 4x to 64^2), then assimilated in the ``coarse`` scenario by the
committed ``unet_0`` (bf16 compute as its config says; batch 4, 256 steps, 1
Langevin correction). Before that it builds the kernels and holds each one
against its plain PyTorch version; after it, it checks one solver transition
through the kernels against the plain transforms.

    python3 chip_smoke.py

Phases print flushed, timestamped start and end lines. Any failure exits
non-zero without a result. On success the line before the last is the
kernels' JSON summary and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script writes nothing but the kernels' build directory in the checkout.
"""

import contextlib
import json
import math
import subprocess
import time

import torch

from sda_tpu_torch.dynamics import KolmogorovFlow
from sda_tpu_torch.experiments.kolmogorov.assimilate import assimilate
from sda_tpu_torch.experiments.kolmogorov.generate import simulate
from sda_tpu_torch.experiments.kolmogorov.utils import PATH, load_score, make_chain, make_trajectory_eps
from sda_tpu_torch.ops import RealDFT2, dft_kernels

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

SIZE, MODES = 256, 86  # the solver's grid and its 2/3-rule modes
CHUNK = 16  # trajectories per program in experiments/kolmogorov/generate.py
TRUTH_LENGTH, TRUTH_KEEP = 64, 32
SAMPLES, STEPS, CORRECTIONS = 4, 256, 1
RESIDUAL_LIMIT = 0.2  # twice the observation noise

T0 = time.perf_counter()


def log(message):
    stamp = time.strftime('%H:%M:%S')
    print(f'[{stamp} +{time.perf_counter() - T0:7.1f}s] {message}', flush=True)


@contextlib.contextmanager
def phase(name):
    log(f'== {name}: start')
    t = time.perf_counter()
    try:
        yield
    except BaseException as e:
        log(f'== {name}: FAILED ({type(e).__name__}: {e})')
        raise
    log(f'== {name}: end ({time.perf_counter() - t:.1f}s)')


def check(condition, message):
    if not condition:
        raise AssertionError(message)


def device_ms(fn, replays=20, calls=20):
    r"""Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, CUDA events around ``replays`` replays, so no host dispatch
    sits between the launches."""

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def nvidia_smi():
    done = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60,
    )
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 else f'nvidia-smi failed: {done.stderr.strip()}'


def dft_bound_ms(n, h, w, kh, fw):
    r"""Least time the function (either direction) needs, whatever the
    algorithm: the larger of a real 2-D FFT's operations, 2.5 H W log2(H W)
    per field, over the f32 peak, and its bytes, the field and the truncated
    spectrum each moved once, over the memory rate."""

    flops = n * 2.5 * h * w * math.log2(h * w)
    nbytes = 4 * n * (h * w + 2 * kh * fw)
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def library_pair(h, w, hm, wm, device):
    r"""The yardstick: ``torch.fft`` followed by the same truncation."""

    rows = torch.cat((torch.arange(hm), torch.arange(h - hm + 1, h))).to(device)

    def forward(x):
        spec = torch.fft.rfft2(x)[:, rows, :wm]
        return spec.real, spec.imag

    def inverse(re, im):
        full = torch.zeros(re.shape[0], h, w // 2 + 1, dtype=torch.complex64, device=re.device)
        full[:, rows, :wm] = torch.complex(re, im)
        return torch.fft.irfft2(full, s=(h, w))

    return forward, inverse


def check_kernels(device, n, size, modes, timed):
    r"""Both kernels against their plain versions at one shape; returns the
    errors and, if ``timed``, the times."""

    dft = RealDFT2(size, size, method='kernel', h_modes=modes, w_modes=modes, device=device)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    g = torch.Generator(device=device).manual_seed(n * size)
    x = torch.randn(n, size, size, generator=g, device=device)

    re, im = dft_kernels.rfft2(x, *bases)
    re0, im0 = (t.contiguous() for t in dft_kernels.rfft2_plain(x, *bases))
    y = dft_kernels.irfft2(re0, im0, *bases, dft.weight_w)
    y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
    rt = dft_kernels.irfft2(re, im, *bases, dft.weight_w)
    torch.cuda.synchronize()

    fwd_err = max((re - re0).abs().max().item(), (im - im0).abs().max().item())
    inv_err = (y - y0).abs().max().item()
    rt_err = (rt - y0).abs().max().item()

    # tests/test_pallas_dft.py's tolerances at 32^2, the forward one scaled
    # by sqrt(H W / 32^2): unit white noise has spectra of size sqrt(H W).
    fwd_tol = 1e-3 * math.sqrt(size * size / 32**2)
    log(f'  N={n} {size}^2 modes={modes}: max|err| forward {fwd_err:.3e} (tol {fwd_tol:.1e}), '
        f'inverse {inv_err:.3e} (tol 1e-4), round trip {rt_err:.3e} (tol 1e-4)')
    check(fwd_err <= fwd_tol, f'rfft2 kernel disagrees with its plain version: {fwd_err}')
    check(inv_err <= 1e-4, f'irfft2 kernel disagrees with its plain version: {inv_err}')
    check(rt_err <= 1e-4, f'round trip through the kernels disagrees: {rt_err}')

    result = {'rfft2': {'max_abs_err': fwd_err}, 'irfft2': {'max_abs_err': inv_err}}
    if not timed:
        return result

    lib_fwd, lib_inv = library_pair(size, size, modes, modes, device)
    lre, lim = lib_fwd(x)
    lib_err = max((lre - re0).abs().max().item(), (lim - im0).abs().max().item(),
                  (lib_inv(re0, im0) - y0).abs().max().item())
    log(f'  library yardstick (torch.fft + truncation) vs plain: max|err| {lib_err:.3e}')

    kh, fw = dft.spectral_shape
    calls = {
        'rfft2': dict(
            ms=lambda: dft_kernels.rfft2(x, *bases),
            plain_ms=lambda: dft_kernels.rfft2_plain(x, *bases),
            library_ms=lambda: lib_fwd(x),
        ),
        'irfft2': dict(
            ms=lambda: dft_kernels.irfft2(re0, im0, *bases, dft.weight_w),
            plain_ms=lambda: dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w),
            library_ms=lambda: lib_inv(re0, im0),
        ),
    }
    bound, bound_by = dft_bound_ms(n, size, size, kh, fw)
    for name in ('rfft2', 'irfft2'):
        on_device = {key: device_ms(fn) for key, fn in calls[name].items()}
        result[name].update(on_device, bound_ms=bound, bound_by=bound_by)
        log(f'  {name} N={n} device ms (CUDA graph): kernel {on_device["ms"]:.4f}, '
            f'plain {on_device["plain_ms"]:.4f}, library {on_device["library_ms"]:.4f}; '
            f'bound {bound:.6f} ({bound_by})')
    return result


def sweep_tiles(device, batches, size, modes):
    r"""Every tile width of both kernels, at each batch: device ms, and the
    error against the plain version. The wrappers' default tiles are marked."""

    dft = RealDFT2(size, size, method='kernel', h_modes=modes, w_modes=modes, device=device)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    for n in batches:
        g = torch.Generator(device=device).manual_seed(n)
        x = torch.randn(n, size, size, generator=g, device=device)
        re0, im0 = (t.contiguous() for t in dft_kernels.rfft2_plain(x, *bases))
        y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
        for tile in dft_kernels.RFFT2_TILES:
            re, im = dft_kernels.launch_rfft2(x, *bases, tile=tile)
            err = max((re - re0).abs().max().item(), (im - im0).abs().max().item())
            check(err <= 1e-3 * math.sqrt(size * size / 32**2), f'rfft2 tile {tile}: error {err}')
            ms = device_ms(lambda: dft_kernels.launch_rfft2(x, *bases, tile=tile))
            mark = ' (default)' if tile == dft_kernels.rfft2_tile(n) else ''
            log(f'  rfft2 N={n} tile {tile}: {ms:.4f} ms, max|err| {err:.2e}{mark}')
        for tile in dft_kernels.IRFFT2_TILES:
            y = dft_kernels.launch_irfft2(re0, im0, *bases, dft.weight_w, tile=tile)
            err = (y - y0).abs().max().item()
            check(err <= 1e-4, f'irfft2 tile {tile}: error {err}')
            ms = device_ms(lambda: dft_kernels.launch_irfft2(re0, im0, *bases, dft.weight_w, tile=tile))
            mark = ' (default)' if tile == dft_kernels.irfft2_tile(n) else ''
            log(f'  irfft2 N={n} tile {tile}: {ms:.4f} ms, max|err| {err:.2e}{mark}')


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase('device'):
        check(torch.cuda.is_available(), 'no CUDA device: this smoke runs on the card only')
        device = torch.device('cuda')
        kind = torch.cuda.get_device_name(0)
        card = nvidia_smi()
        log(f'torch {torch.__version__} CUDA {torch.version.cuda}; device 0: {kind}; '
            f'{torch.cuda.device_count()} visible')
        log(f'nvidia-smi: {card}')

    with phase('build'):
        t = time.perf_counter()
        path, output = dft_kernels.build()
        log(f'nvcc: {time.perf_counter() - t:.1f}s -> {path}')
        for line in output.splitlines():  # -Xptxas -v: registers, spills, shared memory
            if line.strip():
                log(f'  {line.strip()}')
        dft_kernels.library()

    with phase('kernels against their plain versions'):
        main_shape = check_kernels(device, 1, SIZE, MODES, timed=True)  # the solver's batch of one field
        check_kernels(device, CHUNK, SIZE, MODES, timed=True)
        check_kernels(device, 4, 64, 22, timed=False)

        dft = RealDFT2(32, 32, method='kernel', h_modes=11, w_modes=11, device=device)
        mat = RealDFT2(32, 32, method='matmul', h_modes=11, w_modes=11, device=device)
        x = torch.randn(2, 32, 32, generator=torch.Generator(device=device).manual_seed(3), device=device)

        def grad(d):
            xi = x.clone().requires_grad_(True)
            re, im = d.rfft2(xi)
            y = d.irfft2(re * 0.5 + 1.0, im * 2.0)
            (torch.sum(y**2) + torch.sum(re * im)).backward()
            return xi.grad

        grad_err = (grad(dft) - grad(mat)).abs().max().item()
        log(f'  gradient through both kernels vs plain: max|err| {grad_err:.3e} (tol 1e-2)')
        check(grad_err <= 1e-2, f'kernel gradients disagree: {grad_err}')

    with phase('tile widths'):
        sweep_tiles(device, (1, 4, CHUNK), SIZE, MODES)

    # -- The main path: truth, then assimilation. Counts from here on. ----
    dft_kernels.reset_launches()

    with phase('truth'):
        chain = make_chain(SIZE, device=device)
        check(chain.dft.method == 'kernel', f'solver transforms resolve to {chain.dft.method}')
        log(f'KolmogorovFlow({SIZE}, dt=0.2): {chain.steps} substeps per transition, '
            f'spectra {chain.dft.spectral_shape}')
        torch.cuda.synchronize()
        t = time.perf_counter()
        truth = simulate(
            chain, batch=1, length=TRUTH_LENGTH, keep=TRUTH_KEEP, coarse=4,
            generator=torch.Generator(device=device).manual_seed(0),
        )
        torch.cuda.synchronize()
        truth_s = time.perf_counter() - t
        check(tuple(truth.shape) == (1, TRUTH_KEEP, 2, 64, 64), f'truth shape {tuple(truth.shape)}')
        check(bool(torch.isfinite(truth).all()), 'non-finite truth')
        log(f'truth {tuple(truth.shape)} in {truth_s:.2f}s '
            f'({truth_s / TRUTH_LENGTH * 1e3:.1f} ms per transition); '
            f'|u| max {truth.abs().max().item():.3f}, std {truth.std().item():.3f}')

    with phase('assimilation'):
        torch.cuda.reset_peak_memory_stats()
        score, config = load_score(PATH / 'runs/unet_0', device=device)
        log(f'unet_0: bf16={config["bf16"]}, hidden {config["hidden_channels"]}, window {config["window"]}')
        eps = make_trajectory_eps(score, config['window'])
        torch.cuda.synchronize()
        t = time.perf_counter()
        xs, residual = assimilate(
            eps, truth[0], samples=SAMPLES, steps=STEPS, corrections=CORRECTIONS, tau=0.5, seed=0,
        )
        torch.cuda.synchronize()
        assim_s = time.perf_counter() - t
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f'samples {tuple(xs.shape)} in {assim_s:.2f}s ({assim_s / STEPS * 1e3:.1f} ms per step); '
            f'residual std(A(x) - y) = {residual:.4f} (limit {RESIDUAL_LIMIT}, obs std 0.1); '
            f'peak memory {peak_gib:.2f} GiB')
        check(bool(torch.isfinite(xs).all()), 'non-finite samples')
        check(math.isfinite(residual) and residual < RESIDUAL_LIMIT, f'residual {residual} not below {RESIDUAL_LIMIT}')

    launches = dict(dft_kernels.launches)
    # -- End of the main path. -------------------------------------------
    log(f'kernel launches on the main path: {launches} '
        f'(~{sum(launches.values()) / TRUTH_LENGTH:.0f} per simulated frame)')
    for name, count in launches.items():
        check(count > 0, f'the main path never launched {name}')

    with phase('one transition: kernels vs plain transforms'):
        plain = KolmogorovFlow(SIZE, dt=0.2, dft_method='matmul', device=device)
        x0 = chain.prior((1,), generator=torch.Generator(device=device).manual_seed(1))
        a, b = chain.transition(x0), plain.transition(x0)
        rel = ((a - b).norm() / b.norm()).item()
        log(f'relative difference {rel:.3e} (limit 1e-3)')
        check(rel < 1e-3, f'kernel transition differs from the plain one by {rel}')

    with phase('kernels summary'):
        source = 'sda_tpu_torch/csrc/dft.cu'
        replaces = {'rfft2': 'sda_tpu/ops/pallas_dft.py:78', 'irfft2': 'sda_tpu/ops/pallas_dft.py:127'}
        kernels = []
        for name in ('rfft2', 'irfft2'):
            row = main_shape[name]
            kernels.append({
                'name': name, 'route': 'cuda', 'source': source, 'replaces': replaces[name],
                'launches': launches[name], 'max_abs_err': row['max_abs_err'],
                'ms': row['ms'], 'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
                'bound_by': row['bound_by'], 'library_ms': row['library_ms'],
            })
        log(f'wall {time.perf_counter() - T0:.1f}s; truth {truth_s:.1f}s; assimilation {assim_s:.1f}s')

    print(nvidia_smi(), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
r"""Smoke run of sda_tpu_torch on one NVIDIA card.

Drives the port's main path once, on the card, through the entry points a
user calls: a Kolmogorov truth simulated at 256^2 through the CUDA DFT
kernels (``KolmogorovFlow(256, dt=0.2)``: prior, 64 transitions, keep the last
32, coarsen 4x to 64^2), then assimilated in the ``coarse`` scenario by the
committed ``unet_0`` (bf16 compute as its config says; batch 4, 256 steps, 1
Langevin correction). Before that it builds the kernels, holds each one
against its plain PyTorch version at the solver's shapes and batches and at
odd ones, and times every cluster size; after it, it checks the main path's
launch counts, checks one solver transition through the kernels against the
plain transforms, and profiles one transition at 1 and 16 fields.

Then the training path: ``unet_0``'s eps in bf16 against float32; training
data simulated through the kernels (36 trajectories at 256^2, coarsened to
64^2); one AdamW step of ``unet_0`` on the card against the same step on the
CPU; ``unet_0``'s architecture trained from flax's initialisation at full
width (bf16 compute, batch 32), timed and profiled, its weights written and
read back; and the Lorenz family end to end: the published data simulation,
64 epochs of the local model, the 9 committed Lorenz checkpoints against
their golden entries, and sampled ``log_p`` of ``local_k2_0`` and
``global_0`` against the JAX package's.

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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sda_tpu_torch import prng
from sda_tpu_torch.diffusion import VPSDE
from sda_tpu_torch.dynamics import KolmogorovFlow
from sda_tpu_torch.experiments.kolmogorov.assimilate import assimilate
from sda_tpu_torch.experiments.kolmogorov.generate import simulate
from sda_tpu_torch.experiments.kolmogorov.train import CONFIG as KOLMOGOROV_CONFIG
from sda_tpu_torch.experiments.kolmogorov.utils import load_score, make_chain, make_score, make_trajectory_eps
from sda_tpu_torch.experiments.lorenz import generate as lorenz_generate
from sda_tpu_torch.experiments.lorenz import train as lorenz_train
from sda_tpu_torch.experiments.lorenz import utils as lorenz_utils
from sda_tpu_torch.nn import reset_parameters
from sda_tpu_torch.ops import RealDFT2, dft_kernels
from sda_tpu_torch.train import TrajectoryDataset, Trainer, load_params, params_from_flax, save_params

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

SIZE, MODES = 256, 86  # the solver's grid and its 2/3-rule modes
CHUNK = 16  # trajectories per program in experiments/kolmogorov/generate.py
TRUTH_LENGTH, TRUTH_KEEP = 64, 32
SAMPLES, STEPS, CORRECTIONS = 4, 256, 1
RESIDUAL_LIMIT = 0.2  # twice the observation noise

REPO = Path(__file__).resolve().parent
UNET_0 = REPO / 'experiments/kolmogorov/storage/runs/unet_0'
LORENZ_RUNS = REPO / 'experiments/lorenz/storage/runs'
GOLDEN = REPO / 'tests/golden/committed_artifacts.json'

# unet_0's eps in bf16 against float32 on the golden probe: the CPU test's
# bound on the port's bf16 against the JAX package's (twice what was
# measured there: rms 0.0080, max 0.031).
BF16_RMS, BF16_MAX = 0.015, 0.08

# Training data for unet_0: 32 + 4 trajectories, cut from the experiment's
# 1,024 x 128 transitions (keep 64); 64 transitions as the truth, keep 16.
TRAIN_TRAJ, VALID_TRAJ, DATA_LENGTH, DATA_KEEP = 32, 4, 64, 16
TRAIN_BATCH, TRAIN_STEPS, WARMUP = 32, 32, 3

# One AdamW step, card (TF32 off) against CPU: float32 sums in another
# order. Adam's first update is lr g / (|g| + 1e-8), about lr sign(g)
# whatever |g|, and moves by at most lr |dg| / |g|: a parameter whose
# gradient differs by more than STEP_GRAD_FREE of itself (a gradient at
# float32 noise level) may move by up to 2 lr on one side only. Those are
# counted (at most STEP_UNDETERMINED of all); the others must agree within
# STEP_PARAM_ATOL, which lr STEP_GRAD_FREE = 4e-6 leaves room for.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-4, 1e-5
STEP_GRAD_FREE, STEP_UNDETERMINED = 2e-2, 1e-3

# The JAX package's final Lorenz log_p on the CPU, from
# tests/lorenz_log_p_reference.py (seeds 0, 1, 2): the mean over the seeds
# of each seed's mean and median over windows, and their spread (max - min).
# local_k2_0's mean spread is set by one window off the attractor at seed 2
# (mean -5.73e6), so its mean gate holds nothing and its median gate carries
# the check. The port's value must lie within LOG_P_SPREADS spreads.
LOG_P_REFERENCE = {
    'local_k2_0': {'mean': (-1910583.693745454, 5731757.740476131),
                   'median': (2.404589891433716, 0.0021343231201171875)},
    'global_0': {'mean': (1.3309656381607056, 0.09330224990844727),
                 'median': (1.871457854906718, 0.022673726081848145)},
}
LOG_P_SPREADS = 10

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


def kernel_flops(n, h, w, fw, cluster):
    r"""The operations the kernels do for ``n`` fields (either direction):
    the butterflies and small DFTs of their factorised transforms, counted
    from the radices (radix 16: 15 twiddle products, 9 inner ones and 8
    radix-4 DFTs, 272 flops; radix 4: 3 twiddle products and 8 complex
    additions, 34 flops; radix 2: 10; any other radix r: 14 r^2), for the
    row pairs of each band along W and the ``fw`` columns along H. Packing
    and unpacking add a few percent and are not counted."""

    def transform(length):
        flops = 0
        for r in dft_kernels.factorise(length):
            flops += length // r * {16: 272, 4: 34, 2: 10}.get(r, 14 * r * r)
        return flops

    band = -(-h // cluster)
    pairs = sum((min(band, h - b * band) + 1) // 2 for b in range(cluster) if b * band < h)
    return n * (pairs * transform(w) + fw * transform(h))


def check_kernels(device, n, h, w, hm, wm, timed):
    r"""Both kernels against their plain versions at one shape; returns the
    errors and, if ``timed``, the times."""

    dft = RealDFT2(h, w, method='kernel', h_modes=hm, w_modes=wm, device=device)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    g = torch.Generator(device=device).manual_seed(n * h)
    x = torch.randn(n, h, w, generator=g, device=device)

    re, im = dft_kernels.rfft2(x, *bases, dft.plan)
    re0, im0 = (t.contiguous() for t in dft_kernels.rfft2_plain(x, *bases))
    y = dft_kernels.irfft2(re0, im0, *bases, dft.weight_w, dft.plan)
    y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
    rt = dft_kernels.irfft2(re, im, *bases, dft.weight_w, dft.plan)
    torch.cuda.synchronize()

    fwd_err = max((re - re0).abs().max().item(), (im - im0).abs().max().item())
    inv_err = (y - y0).abs().max().item()
    rt_err = (rt - y0).abs().max().item()

    # tests/test_pallas_dft.py's tolerances at 32^2, the forward one scaled
    # by sqrt(H W / 32^2): unit white noise has spectra of size sqrt(H W).
    fwd_tol = 1e-3 * math.sqrt(h * w / 32**2)
    log(f'  N={n} {h}x{w} modes={hm}/{wm}: max|err| forward {fwd_err:.3e} (tol {fwd_tol:.1e}), '
        f'inverse {inv_err:.3e} (tol 1e-4), round trip {rt_err:.3e} (tol 1e-4)')
    check(fwd_err <= fwd_tol, f'rfft2 kernel disagrees with its plain version: {fwd_err}')
    check(inv_err <= 1e-4, f'irfft2 kernel disagrees with its plain version: {inv_err}')
    check(rt_err <= 1e-4, f'round trip through the kernels disagrees: {rt_err}')

    result = {'rfft2': {'max_abs_err': fwd_err}, 'irfft2': {'max_abs_err': inv_err}}
    if not timed:
        return result

    lib_fwd, lib_inv = library_pair(h, w, hm, wm, device)
    lre, lim = lib_fwd(x)
    lib_err = max((lre - re0).abs().max().item(), (lim - im0).abs().max().item(),
                  (lib_inv(re0, im0) - y0).abs().max().item())
    log(f'  library yardstick (torch.fft + truncation) vs plain: max|err| {lib_err:.3e}')

    kh, fw = dft.spectral_shape
    calls = {
        'rfft2': dict(
            ms=lambda: dft_kernels.rfft2(x, *bases, dft.plan),
            plain_ms=lambda: dft_kernels.rfft2_plain(x, *bases),
            library_ms=lambda: lib_fwd(x),
        ),
        'irfft2': dict(
            ms=lambda: dft_kernels.irfft2(re0, im0, *bases, dft.weight_w, dft.plan),
            plain_ms=lambda: dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w),
            library_ms=lambda: lib_inv(re0, im0),
        ),
    }
    bound, bound_by = dft_bound_ms(n, h, w, kh, fw)
    for name in ('rfft2', 'irfft2'):
        on_device = {key: device_ms(fn) for key, fn in calls[name].items()}
        flops = kernel_flops(n, h, w, fw, dft_kernels.cluster_size(n))
        result[name].update(on_device, bound_ms=bound, bound_by=bound_by)
        log(f'  {name} N={n} device ms (CUDA graph): kernel {on_device["ms"]:.4f}, '
            f'plain {on_device["plain_ms"]:.4f}, library {on_device["library_ms"]:.4f}; '
            f'bound {bound:.6f} ({bound_by}, {bound / on_device["ms"]:.2%} reached); '
            f'kernel does {flops / 1e6:.2f} MFLOP at {flops / on_device["ms"] / 1e9:.3f} TFLOP/s')
    return result


def sweep_clusters(device, batches, size, modes):
    r"""Every cluster size of both kernels, at each batch: device ms, the
    error against the plain version, and how many clusters can be resident.
    The wrappers' defaults are marked."""

    dft = RealDFT2(size, size, method='kernel', h_modes=modes, w_modes=modes, device=device)
    bases = (dft.cos_w, dft.sin_w, dft.cos_h, dft.sin_h)
    for cluster in dft_kernels.CLUSTERS:
        for inverse in (False, True):
            count, smem = dft_kernels.max_clusters(inverse, dft.plan, cluster)
            log(f'  {"irfft2" if inverse else "rfft2"} cluster {cluster}: {smem} B shared memory '
                f'per block, {count} clusters resident at most')
            check(count >= 1, f'cluster {cluster} cannot be resident')
    for n in batches:
        g = torch.Generator(device=device).manual_seed(n)
        x = torch.randn(n, size, size, generator=g, device=device)
        re0, im0 = (t.contiguous() for t in dft_kernels.rfft2_plain(x, *bases))
        y0 = dft_kernels.irfft2_plain(re0, im0, *bases, dft.weight_w)
        for cluster in dft_kernels.CLUSTERS:
            re, im = dft_kernels.launch_rfft2(x, dft.plan, cluster=cluster)
            err = max((re - re0).abs().max().item(), (im - im0).abs().max().item())
            check(err <= 1e-3 * math.sqrt(size * size / 32**2), f'rfft2 cluster {cluster}: error {err}')
            ms = device_ms(lambda: dft_kernels.launch_rfft2(x, dft.plan, cluster=cluster))
            mark = ' (default)' if cluster == dft_kernels.cluster_size(n) else ''
            log(f'  rfft2 N={n} cluster {cluster}: {ms:.4f} ms, max|err| {err:.2e}{mark}')
        for cluster in dft_kernels.CLUSTERS:
            y = dft_kernels.launch_irfft2(re0, im0, dft.weight_w, dft.plan, cluster=cluster)
            err = (y - y0).abs().max().item()
            check(err <= 1e-4, f'irfft2 cluster {cluster}: error {err}')
            ms = device_ms(lambda: dft_kernels.launch_irfft2(re0, im0, dft.weight_w, dft.plan, cluster=cluster))
            mark = ' (default)' if cluster == dft_kernels.cluster_size(n) else ''
            log(f'  irfft2 N={n} cluster {cluster}: {ms:.4f} ms, max|err| {err:.2e}{mark}')


def profile_transition(chain, n, device):
    r"""One solver transition of ``n`` fields under ``torch.profiler``: the
    device's busy share (kernel time over the transition's wall time, which
    the profiler lengthens) and the five kernels that took most device time."""

    from torch.profiler import ProfilerActivity, profile

    x = chain.prior((n,), generator=torch.Generator(device=device).manual_seed(2))
    chain.transition(x)  # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        chain.transition(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6

    device_busy(prof, wall_us, f'N={n}: one transition')


def device_busy(prof, wall_us, label, top=5):
    r"""Logs the device's busy share of a profiled window, the ``top``
    kernels with most device time and the share of convolution and matmul
    kernels (cuDNN's and cuBLAS's). User annotations on the device timeline
    (such as the optimizer's step range) span kernels and are left out."""

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, 'is_user_annotation', False)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, 'the profiler saw no device time')
    products = [e for e in kernels if any(w in e.key.lower() for w in ('conv', 'gemm', 'xmma', 'cutlass', 'sm90'))]
    product_us = sum(e.self_device_time_total for e in products)
    log(f'  {label}: {wall_us / 1e3:.2f} ms wall under the profiler, device busy '
        f'{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), {sum(e.count for e in kernels)} kernel launches; '
        f'convolutions and matmuls {product_us / 1e3:.2f} ms ({product_us / busy_us:.1%} of busy)')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f'    {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}')


def window_batch(dataset, generator, batch):
    r"""``batch`` random windows of ``dataset``, as the trainer crops them."""

    idx, _ = dataset.epoch_batches(batch, generator)
    return dataset.crop(dataset.data[idx[0]], generator)


def unet_0_step(x, t, z, device):
    r"""One AdamW step of the committed ``unet_0`` (float32) on ``x`` with
    the loss's ``t`` and noise given; returns the loss, the gradients and
    the parameters after the step, on the CPU."""

    config = dict(KOLMOGOROV_CONFIG, size=64)
    module = make_score(**config)
    module.load_state_dict(params_from_flax(load_params(UNET_0 / 'state.msgpack')))
    module.to(device)
    data = TrajectoryDataset(x[:, None], device=device)
    trainer = Trainer(VPSDE(shape=tuple(x.shape[1:])), module, data, data, **config)

    loss = trainer.train_step(x.to(device), t.to(device), z.to(device))
    grads = {n: p.grad.detach().cpu() for n, p in module.named_parameters()}
    params = {n: p.detach().cpu() for n, p in module.named_parameters()}
    return loss.item(), grads, params


def lorenz_probe(run, config):
    shape = (2, 3 * config['window']) if run.startswith('local') else (2, 3, 32)
    return prng.normal(0, shape)


def bf16_against_f32(device):
    r"""``unet_0``'s eps with its config's bf16 compute against float32 (TF32
    off) on the golden probe."""

    x = prng.normal(0, (1, 10, 64, 64)).to(device)
    t = torch.full((1,), 0.5, device=device)
    with torch.no_grad():
        bf16 = load_score(UNET_0, device=device)[0](x, t).double()
        f32 = load_score(UNET_0, device=device, bf16=False)[0](x, t).double()
    rms, err = (bf16 - f32).square().mean().sqrt().item(), (bf16 - f32).abs().max().item()
    log(f'unet_0 eps bf16 vs f32 (TF32 off): rms {rms:.5f} (limit {BF16_RMS}), max {err:.5f} (limit {BF16_MAX})')
    check(rms <= BF16_RMS and err <= BF16_MAX, f'bf16 eps differs from f32: rms {rms}, max {err}')


def training_data(chain, device):
    r"""Training and validation windows for ``unet_0``, simulated through the
    solver as ``generate.py`` does (cut to size); returns the two datasets
    and the seconds taken."""

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = simulate(
        chain, batch=TRAIN_TRAJ + VALID_TRAJ, length=DATA_LENGTH, keep=DATA_KEEP, coarse=chain.size // 64,
        generator=torch.Generator(device=device).manual_seed(1),
    )
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    check(tuple(data.shape) == (TRAIN_TRAJ + VALID_TRAJ, DATA_KEEP, 2, 64, 64), f'data {tuple(data.shape)}')
    check(bool(torch.isfinite(data).all()), 'non-finite training data')
    log(f'{TRAIN_TRAJ + VALID_TRAJ} trajectories {tuple(data.shape[1:])} in {data_s:.2f}s '
        f'({data_s / DATA_LENGTH * 1e3:.1f} ms per transition of {TRAIN_TRAJ + VALID_TRAJ} fields); '
        f'std {data.std().item():.3f}')
    trainset = TrajectoryDataset(data[:TRAIN_TRAJ], window=5, flatten=True, device=device)
    validset = TrajectoryDataset(data[TRAIN_TRAJ:], window=5, flatten=True, device=device)
    return trainset, validset, data_s


def step_card_against_cpu(trainset, device):
    r"""One AdamW step of ``unet_0`` in float32 on the card and on the CPU,
    same batch, ``t`` and noise."""

    g = torch.Generator(device=device).manual_seed(2)
    x = window_batch(trainset, g, 2).cpu()
    g = torch.Generator().manual_seed(3)
    t, z = torch.rand(2, generator=g), torch.randn(x.shape, generator=g)
    loss_c, grads_c, params_c = unet_0_step(x, t, z, device)
    loss_h, grads_h, params_h = unet_0_step(x, t, z, 'cpu')

    grad_err = math.sqrt(sum((grads_c[n] - grads_h[n]).square().sum().item() for n in grads_h)
                         / sum(grads_h[n].square().sum().item() for n in grads_h))
    worst, undetermined, total = 0.0, 0, 0
    for n, g_h in grads_h.items():
        free = (grads_c[n] - g_h).abs() > STEP_GRAD_FREE * g_h.abs()
        diff = (params_c[n] - params_h[n]).abs()
        worst = max(worst, diff[~free].max().item() if (~free).any() else 0.0)
        undetermined += int(free.sum())
        total += g_h.numel()
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    log(f'loss card {loss_c:.6f} CPU {loss_h:.6f} (relative {loss_err:.2e}, limit {STEP_LOSS_RTOL}); '
        f'gradients relative L2 {grad_err:.2e} (limit {STEP_GRAD_RTOL}); max |dparam| after the step '
        f'{worst:.2e} (limit {STEP_PARAM_ATOL}) over {total - undetermined} of {total} parameters, '
        f'{undetermined} with a gradient at noise level (limit {STEP_UNDETERMINED * total:.0f})')
    check(loss_err <= STEP_LOSS_RTOL, f'loss differs: {loss_c} vs {loss_h}')
    check(grad_err <= STEP_GRAD_RTOL, f'gradients differ: {grad_err}')
    check(worst <= STEP_PARAM_ATOL, f'parameters differ after the step: {worst}')
    check(undetermined <= STEP_UNDETERMINED * total, f'{undetermined} gradients at noise level')


def full_width_training(trainset, validset, device):
    r"""``unet_0``'s architecture from flax's initialisation, bf16 compute,
    float32 parameters: the committed model against a fresh one, timed
    steps, a profile, one epoch, and its weights written and read back.
    Returns ms per step."""

    config = dict(KOLMOGOROV_CONFIG, bf16=True, size=64, batch_size=TRAIN_BATCH)
    g = torch.Generator(device=device).manual_seed(4)
    fixed = window_batch(trainset, g, TRAIN_BATCH)
    fixed_t = torch.rand(fixed.shape[0], generator=g, device=device)
    fixed_z = torch.randn(fixed.shape, generator=g, device=device)
    sde = VPSDE(shape=tuple(fixed.shape[1:]))

    def fixed_loss(module):
        with torch.no_grad():
            return sde.loss(fixed, eps=module, t=fixed_t, z=fixed_z).item()

    module = reset_parameters(make_score(**config), torch.Generator().manual_seed(0)).to(device)
    committed, fresh = fixed_loss(load_score(UNET_0, device=device)[0]), fixed_loss(module)
    log(f'denoising loss on {len(fixed)} simulated windows: committed unet_0 {committed:.4f}, '
        f'freshly initialised {fresh:.4f}')
    check(committed < fresh, f'the committed model ({committed}) does not beat a fresh one ({fresh})')

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(sde, module, trainset, validset, generator=g, **config)
    losses = [trainer.train_step(window_batch(trainset, g, TRAIN_BATCH)) for _ in range(WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer.train_step(window_batch(trainset, g, TRAIN_BATCH)) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).tolist()
    after = fixed_loss(module)
    log(f'{WARMUP} + {TRAIN_STEPS} AdamW steps at batch {TRAIN_BATCH}, bf16 compute: {step_ms:.2f} ms per step '
        f'(after {WARMUP} warm-up steps), peak memory {peak_gib:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; '
        f'fixed batch {fresh:.4f} -> {after:.4f}')
    check(all(math.isfinite(v) for v in losses), 'non-finite training loss')
    check(after < fresh, f'the fixed batch loss did not fall: {fresh} -> {after}')

    from torch.profiler import ProfilerActivity, profile

    batches = [window_batch(trainset, g, TRAIN_BATCH) for _ in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in batches:
            trainer.train_step(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_busy(prof, wall_us, '3 training steps', top=12)

    stats = trainer.step_epoch()
    log(f'one epoch through step_epoch: {stats}')
    check(all(math.isfinite(stats[k]) for k in ('loss_train', 'loss_valid')), f'epoch {stats}')

    with tempfile.TemporaryDirectory() as tmp:
        save_params(module, Path(tmp) / 'state.msgpack')
        again = make_score(**config)
        again.load_state_dict(params_from_flax(load_params(Path(tmp) / 'state.msgpack')))
        again.to(device)
    with torch.no_grad():
        a, b = module(fixed, fixed_t), again(fixed, fixed_t)
    check(torch.equal(a, b), f'eps after save/load differs by {(a - b).abs().max().item()}')
    log('save_params then load_params on the card: eps bitwise equal')
    return step_ms


def lorenz_end_to_end(device, chains=1024, length=1024, epochs=64):
    r"""The published Lorenz data, the local model trained for ``epochs``,
    the committed checkpoints against their golden entries, and sampled
    ``log_p`` against the JAX package's. Returns the data's seconds and ms
    per epoch."""

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    splits = lorenz_generate.simulate(chains=chains, length=length, burnin=length, seed=0, device=device)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    log(f'simulate: {({k: tuple(v.shape) for k, v in splits.items()})} in {data_s:.2f}s')
    check(tuple(splits['train'].shape) == (int(0.8 * chains), length, 3), 'Lorenz splits')
    check(all(bool(torch.isfinite(v).all()) for v in splits.values()), 'non-finite Lorenz data')

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        log_p = lorenz_train.train('local', 0, epochs=epochs, device=device, path=Path(tmp),
                                   trainset=splits['train'], validset=splits['valid'])
        train_s = time.perf_counter() - t0
        lines = (Path(tmp) / 'runs/local_0/metrics.jsonl').read_text().splitlines()
    records = [json.loads(line) for line in lines if 'loss_train' in line]
    epoch_ms = (records[-1]['time'] - records[0]['time']) / (len(records) - 1) * 1e3
    log(f'local model, {epochs} epochs of {max(len(splits["train"]) // 64, 1)} steps: {epoch_ms:.1f} ms per epoch, '
        f'{train_s:.1f}s with the final sampling; loss {records[0]["loss_train"]:.4f} -> '
        f'{records[-1]["loss_train"]:.4f} (valid {records[-1]["loss_valid"]:.4f}); final log_p {log_p:.3f}')
    check(len(records) == epochs and all(math.isfinite(r['loss_train']) for r in records), 'Lorenz losses')
    check(records[-1]['loss_train'] < records[0]['loss_train'], 'the Lorenz loss did not fall')

    golden = json.loads(GOLDEN.read_text())
    runs = sorted(LORENZ_RUNS.iterdir())
    check(len(runs) == 9, f'expected 9 committed Lorenz runs, found {len(runs)}')
    for rundir in runs:
        run, local = rundir.name, rundir.name.startswith('local')
        module, config = lorenz_utils.load_score(rundir, local=local, device=device)
        x = lorenz_probe(run, config).to(device)
        with torch.no_grad():
            out = module(x, torch.full((2,), 0.5, device=device)).double().cpu().numpy()
        want = golden[f'experiments/lorenz/storage/runs/{run}']
        got = {'mean': out.mean(), 'std': out.std(), 'head': out.ravel()[:4]}
        log(f'  {run}: eps mean {got["mean"]:.6f} (golden {want["mean"]:.6f}), '
            f'std {got["std"]:.6f} (golden {want["std"]:.6f})')
        for key in ('mean', 'std', 'head'):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4, err_msg=f'{run} {key}')

    for run, local, window in (('local_k2_0', True, 5), ('global_0', False, 32)):
        module, _ = lorenz_utils.load_score(LORENZ_RUNS / run, local=local, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_window = lorenz_train.sample_log_p(module, local, window, torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        got = {'mean': per_window.mean().item(), 'median': per_window.median().item()}
        for stat, (value, spread) in LOG_P_REFERENCE[run].items():
            log(f'  {run}: log_p {stat} {got[stat]:.4f}, JAX {value:.4f} +- {LOG_P_SPREADS} x {spread:.4g} '
                f'({len(per_window)} samples at 64 steps in {sample_s:.2f}s)')
            check(abs(got[stat] - value) <= LOG_P_SPREADS * spread, f'{run} log_p {stat} {got[stat]}')

    return data_s, epoch_ms


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
        main_shape = check_kernels(device, 1, SIZE, SIZE, MODES, MODES, timed=True)  # the solver's one field
        for n in (CHUNK, 4 * CHUNK):
            check_kernels(device, n, SIZE, SIZE, MODES, MODES, timed=True)
        for shape in ((4, 64, 64, 22, 22), (3, 32, 32, 11, 11), (2, 45, 80, 12, 22), (3, 37, 50, 13, 17)):
            check_kernels(device, *shape, timed=False)

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

    with phase('cluster sizes'):
        sweep_clusters(device, (1, 2, 4, CHUNK, 4 * CHUNK), SIZE, MODES)

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
        score, config = load_score(UNET_0, device=device)
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
    # Forcing, prior and first to_spectral, then one launch per direction
    # per call site: 3 forward per substep, 3 inverse per substep and one
    # to_velocity per transition.
    expected = {'rfft2': 3 + 3 * TRUTH_LENGTH * chain.steps,
                'irfft2': 1 + TRUTH_LENGTH * (3 * chain.steps + 1)}
    check(launches == expected, f'main path launches {launches}, expected {expected}')

    with phase('one transition: kernels vs plain transforms'):
        plain = KolmogorovFlow(SIZE, dt=0.2, dft_method='matmul', device=device)
        x0 = chain.prior((1,), generator=torch.Generator(device=device).manual_seed(1))
        a, b = chain.transition(x0), plain.transition(x0)
        rel = ((a - b).norm() / b.norm()).item()
        log(f'relative difference {rel:.3e} (limit 1e-3)')
        check(rel < 1e-3, f'kernel transition differs from the plain one by {rel}')

    with phase('profile of one transition'):
        for n in (1, CHUNK):
            profile_transition(chain, n, device)

    # -- The training path. ---------------------------------------------

    with phase('bf16 against f32'):
        bf16_against_f32(device)

    with phase('kolmogorov training data'):
        dft_kernels.reset_launches()
        trainset, validset, data_s = training_data(chain, device)
        data_launches = dict(dft_kernels.launches)
        # As the main path's, less the forcing's transform (the chain exists).
        data_expected = {'rfft2': expected['rfft2'] - 1, 'irfft2': expected['irfft2']}
        log(f'kernel launches {data_launches} (expected {data_expected})')
        check(data_launches == data_expected, f'data launches {data_launches}, expected {data_expected}')

    with phase('unet_0 training step, card against CPU'):
        step_card_against_cpu(trainset, device)

    with phase('unet_0 training at full width'):
        step_ms = full_width_training(trainset, validset, device)

    with phase('lorenz'):
        lorenz_data_s, epoch_ms = lorenz_end_to_end(device)

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
        log(f'wall {time.perf_counter() - T0:.1f}s; truth {truth_s:.1f}s; assimilation {assim_s:.1f}s; '
            f'training data {data_s:.1f}s; unet_0 {step_ms:.1f} ms per step; Lorenz data {lorenz_data_s:.1f}s, '
            f'{epoch_ms:.1f} ms per epoch')

    print(nvidia_smi(), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()

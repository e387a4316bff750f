#!/usr/bin/env python3
r"""The measurements behind the port's float32 precision and its
determinism, on one NVIDIA card.

1. Which TF32 switch torch honours: one float32 convolution at ``unet_0``'s
   widths against float64, under the legacy ``allow_tf32`` flags and (last,
   since the two APIs must not be mixed in one process) the
   ``fp32_precision`` attributes.
2. TF32 against true float32 for ``qg_0``: one chunk of
   ``experiments/qg/generate.py`` at its published settings (as
   ``chip_smoke.py``), then ``upper`` (2 samples x 256 x 1) and
   ``experiments/qg/eval.py``'s posterior row of test index 0 (8 samples),
   each under torch's defaults (cuDNN TF32 on, matmul TF32 off) and with
   both flags off, in turns, against the smoke's gates.
3. cuDNN's default (non-deterministic) algorithms: two samples in one
   process of ``coarse`` (the main path: 32 frames, 4 x 256 x 1,
   ``unet_0`` bf16) and of ``loop`` at its published 127 frames (4 x 256 x
   1), their max |diff| and residual ratios; then the main path's ms per
   step with ``cudnn.deterministic`` off and on, in turns.

The precision is switched with ``torch.backends.cudnn.allow_tf32`` alone;
matmuls stay in float32 throughout, as ``set_float32_precision`` has them.

    python3 chip_study.py [--only precision,determinism]

Prints one JSON line per measurement.
"""

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as smoke
from sda_tpu_torch import mfu_attribution
from sda_tpu_torch.experiments.kolmogorov.assimilate import assimilate, get_scenario
from sda_tpu_torch.experiments.kolmogorov.generate import simulate
from sda_tpu_torch.experiments.kolmogorov.utils import load_score, make_chain, make_trajectory_eps
from sda_tpu_torch.experiments.qg import assimilate as qg_assimilate
from sda_tpu_torch.experiments.qg import eval as qg_eval
from sda_tpu_torch.experiments.qg import utils as qg_utils
from sda_tpu_torch.ops import dft_kernels
from sda_tpu_torch.utils import set_float32_precision


def record(name, **values):
    print(json.dumps({'name': name, **values}), flush=True)


def conv_error(device):
    r"""Max relative error of one float32 convolution at ``unet_0``'s
    middle width against float64 on the card."""

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(16, 192, 32, 32, generator=g, device=device)
    w = torch.randn(192, 192, 3, 3, generator=g, device=device) / 40
    want = F.conv2d(x.double(), w.double(), padding=1)
    got = F.conv2d(x, w, padding=1).double()
    return ((got - want).abs().max() / want.abs().max()).item()


def precision_api(device):
    torch.backends.cudnn.allow_tf32 = True
    legacy_on = conv_error(device)
    torch.backends.cudnn.allow_tf32 = False
    legacy_off = conv_error(device)
    record('legacy allow_tf32 API', torch=torch.__version__, conv_rel_err_tf32=legacy_on,
           conv_rel_err_ieee=legacy_off)


def new_api(device):
    out = {}
    for mode in ('tf32', 'ieee'):
        torch.backends.cudnn.conv.fp32_precision = mode
        out[f'conv_rel_err_{mode}'] = conv_error(device)
    record('fp32_precision API', **out)


def qg_precision(device):
    r"""``upper`` and ``eval.py``'s index-0 posterior row under both
    precisions, in turns: tf32, ieee (upper), ieee, tf32 (index 0)."""

    splits, _, _ = smoke.qg_data(device)
    score, config = qg_utils.load_score(smoke.QG_RUNS / 'qg_0', device=device)
    eps = qg_utils.make_trajectory_eps(score, config['window'])
    x_test = splits['test']
    test_frames = x_test[:, ::max(x_test.shape[1] // 8, 1)].reshape((-1, 2) + tuple(x_test.shape[-2:]))

    for conv_tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = conv_tf32
        (xs, residual, rmse), s = smoke.timed(lambda: qg_assimilate.assimilate(
            eps, x_test[0], 'upper', samples=smoke.QG_SAMPLES, steps=smoke.STEPS, corrections=1, tau=0.5, seed=0))
        record('qg upper', conv_tf32=conv_tf32, samples=smoke.QG_SAMPLES,
               residual_ratio=residual / qg_assimilate.OBS_STD, rmse_bottom=rmse, finite=bool(torch.isfinite(xs).all()), seconds=s, ms_per_step=s / smoke.STEPS * 1e3)

    for conv_tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = conv_tf32
        (xs, residual, _), s = smoke.timed(lambda: qg_assimilate.assimilate(
            eps, x_test[0], 'upper', samples=smoke.QG_EVAL_SAMPLES, steps=smoke.STEPS, corrections=1, tau=0.5,
            seed=100))
        row = qg_eval.posterior_metrics(xs, x_test[0][:xs.shape[1]], residual, qg_assimilate.OBS_STD, test_frames)
        record('qg eval index 0', conv_tf32=conv_tf32, samples=smoke.QG_EVAL_SAMPLES,
               **dict(zip(('residual_ratio', 'rmse_top', 'rmse_bottom', 'spread_skill', 'spec_dist'), row)),
               seconds=s, ms_per_step=s / smoke.STEPS * 1e3)


def truth(device):
    chain = make_chain(smoke.SIZE, device=device)
    x = simulate(chain, batch=1, length=smoke.TRUTH_LENGTH, keep=smoke.TRUTH_KEEP, coarse=4,
                 generator=torch.Generator(device=device).manual_seed(0))
    return chain, x[0]


def determinism(x_star, device):
    r"""Two default-algorithm samples each of ``coarse`` and ``loop``, then
    the main path's ms per step with ``cudnn.deterministic`` off and on."""

    score, config = load_score(smoke.UNET_0, device=device)
    eps = make_trajectory_eps(score, config['window'])
    for scenario in ('coarse', 'loop'):
        std = get_scenario(scenario, x_star, np.random.RandomState(0))[2]
        runs = []
        for _ in range(2):
            (xs, residual), s = smoke.timed(lambda: assimilate(
                eps, x_star, samples=smoke.SAMPLES, steps=smoke.STEPS, corrections=1, tau=0.5, seed=0,
                scenario=scenario))
            runs.append((xs, residual / std, s))
        (a, ra, sa), (b, rb, sb) = runs
        record(f'{scenario}: two default-algorithm samples', shape=list(a.shape),
               max_abs_diff=(a - b).abs().max().item(), max_abs=a.abs().max().item(), residual_ratios=[ra, rb],
               ratio_rel_diff=abs(ra - rb) / ra, seconds=[sa, sb], bitwise=torch.equal(a, b))

    steps = 32
    times = {False: [], True: []}
    for deterministic in (False, True, True, False):
        torch.backends.cudnn.deterministic = deterministic
        (_, _), s = smoke.timed(lambda: assimilate(eps, x_star, samples=smoke.SAMPLES, steps=steps, corrections=1,
                                                   tau=0.5, seed=1))
        times[deterministic].append(s / steps * 1e3)
    torch.backends.cudnn.deterministic = False
    record('main path ms per step, cudnn.deterministic off / on (turns off, on, on, off)', steps=steps,
           off=times[False], on=times[True])


def main(only):
    device = torch.device('cuda')
    record('device', kind=torch.cuda.get_device_name(0), nvidia_smi=mfu_attribution.nvidia_smi(),
           torch=torch.__version__, cuda=torch.version.cuda, cudnn_allow_tf32_default=torch.backends.cudnn.allow_tf32,
           matmul_allow_tf32_default=torch.backends.cuda.matmul.allow_tf32)
    dft_kernels.build()
    precision_api(device)
    if 'precision' in only:
        with smoke.phase('qg precision'):
            qg_precision(device)
    set_float32_precision()
    if 'determinism' in only:
        _, x_star = truth(device)
        with smoke.phase('determinism'):
            determinism(x_star, device)
    new_api(device)
    record('wall', seconds=time.perf_counter() - smoke.T0)


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--only', type=str, default='precision,determinism')
    main(parser.parse_args().only.split(','))

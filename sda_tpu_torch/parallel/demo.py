r"""Multi-process data- and sequence-parallel demo with parity checks.

Counterpart of ``tools/multihost_demo.py`` and of ``dryrun_multichip`` in
``__graft_entry__.py``. It runs the real :class:`~sda_tpu_torch.train.Trainer`
and the real guided sampler across N processes, one rank each:

- three ``Trainer`` epochs under data parallelism, where each rank holds only
  its shard of the dataset (:func:`host_sharded_array`), against the same
  epochs in one process over the whole dataset; the replicas' parameters
  must be equal, bit for bit;
- a guided sample (every 4th frame observed) whose windows are split over
  an ``sp`` mesh (:class:`ShardedMCScoreNet`), against
  :class:`~sda_tpu_torch.diffusion.MCScoreNet` in one process, with the same
  noise; every rank's sample must be the same, bit for bit.

    python -m sda_tpu_torch.parallel.demo --launch 2 [--device cpu]

``--launch`` picks a free port, starts the ranks (this module with
``--rank``), and fails unless every rank prints both parity lines; on any
failure or at the deadline it kills every rank. On the card each rank binds
its own card and the ranks talk over NCCL, which needs a card per rank; with
``--device cpu`` they use gloo.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import set_float32_precision

DEADLINE = 300.0  # seconds for the whole launch
WINDOW, SIZE, BATCH, ROWS, LENGTH = 3, 8, 16, 64, 8


def equal_on_all_ranks(x: torch.Tensor) -> bool:
    r"""Whether ``x`` is bitwise the same on every rank."""

    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return all(torch.equal(parts[0], p) for p in parts)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(
    commands: List[List[str]], deadline: float, env: Optional[dict] = None,
) -> List[Tuple[Optional[int], str]]:
    r"""Runs one process per command, all at once, and returns each one's
    return code and output. Every process still running at the first
    failure or at the ``deadline`` (seconds) is killed (return code ``None``
    then): a rank that died leaves its peers blocked in a collective."""

    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f'rank{r}.log', 'w+') for r in range(len(commands))]
        procs = [subprocess.Popen(c, env=env, stdout=f, stderr=subprocess.STDOUT) for c, f in zip(commands, logs)]
        end = time.monotonic() + deadline
        killed = set()
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < end:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for r, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.add(r)
                p.wait()
        results = []
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            results.append((None if r in killed else p.returncode, f.read()))
            f.close()
    return results


def worker(rank: int, procs: int, port: int, device: str) -> None:
    from ..diffusion import VPSDE, GaussianScore, LocalScoreUNet, MCScoreNet, bind_eps
    from ..nn import reset_parameters
    from ..train import TrajectoryDataset, Trainer
    from . import ShardedMCScoreNet, host_sharded_array, init_multihost, make_mesh

    if device == 'cpu':
        torch.set_num_threads(1)
    device = init_multihost(f'127.0.0.1:{port}', num_processes=procs, process_id=rank, device=device)

    if ROWS % procs:
        raise ValueError(f'dataset rows ({ROWS}) must divide over {procs} ranks')
    data = np.random.RandomState(0).standard_normal((ROWS, LENGTH, 2, SIZE, SIZE)).astype(np.float32)
    per = ROWS // procs
    shard = data[rank * per:(rank + 1) * per]
    k_valid = max(per // 2, 1)

    def module():
        net = LocalScoreUNet(
            channels=WINDOW * 2, size=SIZE, embedding=8, hidden_channels=(8, 16), hidden_blocks=(1, 1),
            activation=torch.nn.functional.silu,
        )
        return reset_parameters(net, torch.Generator().manual_seed(0)).to(device)

    def epochs(mesh, train, valid):
        net = module()
        trainer = Trainer(
            VPSDE(shape=(WINDOW * 2, SIZE, SIZE)), net,
            TrajectoryDataset(train, window=WINDOW, flatten=True, device=device),
            TrajectoryDataset(valid, window=WINDOW, flatten=True, device=device),
            epochs=3, batch_size=BATCH, learning_rate=1e-3, mesh=mesh,
            generator=torch.Generator(device=device).manual_seed(1),
        )
        return [s['loss_train'] for s in trainer], net

    # -- Data parallelism: each rank holds only its rows ---------------------
    mesh = make_mesh({'dp': procs}, device)
    losses, net = epochs(
        mesh, host_sharded_array(shard, mesh, device=device), host_sharded_array(shard[:k_valid], mesh, device=device),
    )
    print(f'[{rank}] dp losses: {losses}', flush=True)

    valid = np.concatenate([data[p * per:p * per + k_valid] for p in range(procs)])
    reference, _ = epochs(None, data, valid)
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, reference))
    flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f'dp losses {losses}')
    if err > 1e-4:
        raise AssertionError(f'dp parity {err}')
    if not equal_on_all_ranks(flat):
        raise AssertionError('the replicas differ')
    print(f'[{rank}] PARITY OK: max relative |loss diff| = {err:.2e}, replicas bitwise equal', flush=True)

    # -- Sequence parallelism: the windows split over the ranks ----------------
    net = module()
    net = bind_eps(net, net.state_dict())
    prior = VPSDE(shape=())

    def kernel(xw, t, c=None):
        # The exact eps of unit Gaussian data, which a trained network
        # approaches, plus the untrained network's: guidance through an
        # untrained network alone diverges.
        mu, sigma = prior.mu(t), prior.sigma(t)
        return sigma * xw / (mu**2 + sigma**2) + 0.01 * net(xw, t, c)

    order, length = WINDOW // 2, 4 * procs
    y = torch.full((length // 4, 2, SIZE, SIZE), 0.3, device=device)

    def A(x):  # every 4th frame, across the shards
        return x[..., ::4, :, :, :]

    def sample(score):
        sde = VPSDE(
            eps=GaussianScore(y=y, A=A, std=0.1, sde=VPSDE(eps=score, shape=()), gamma=1e-2),
            shape=(length, 2, SIZE, SIZE),
        )
        generator = torch.Generator(device=device).manual_seed(3)
        return sde.sample((2,), steps=32, corrections=1, tau=0.5, generator=generator)

    sp_mesh = make_mesh({'sp': procs}, device)
    x_sharded = sample(ShardedMCScoreNet(kernel, order, mesh=sp_mesh))
    x_plain = sample(MCScoreNet(kernel, order))
    sp_err = (x_sharded - x_plain).abs().max().item()
    if not torch.isfinite(x_plain).all():
        raise AssertionError('non-finite sample')
    if sp_err > 1e-4:
        raise AssertionError(f'sp parity {sp_err}')
    if not equal_on_all_ranks(x_sharded):
        raise AssertionError("the ranks' samples differ")
    print(f'[{rank}] SP PARITY OK: max |sample diff| = {sp_err:.2e}, ranks bitwise equal', flush=True)

    import torch.distributed as dist

    dist.destroy_process_group()


def launch(procs: int, device: str, deadline: float = DEADLINE) -> bool:
    r"""Runs ``procs`` ranks of :func:`worker`; prints each rank's parity
    lines and returns whether every rank passed."""

    port = free_port()
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (str(root), os.environ.get('PYTHONPATH')))))
    commands = [
        [sys.executable, '-m', 'sda_tpu_torch.parallel.demo', '--rank', str(r), '--procs', str(procs),
         '--port', str(port), '--device', device]
        for r in range(procs)
    ]
    ok = True
    for r, (code, out) in enumerate(run_ranks(commands, deadline, env)):
        if code == 0 and f'[{r}] PARITY OK' in out and f'[{r}] SP PARITY OK' in out:
            print('\n'.join(line for line in out.splitlines() if line.startswith(f'[{r}]')))
        else:
            ok = False
            print(f'--- rank {r} FAILED (rc={code}) ---')
            print(out[-3000:])
    if ok:
        print(f'MULTIHOST DEMO OK ({procs} ranks, {device})', flush=True)
    return ok


if __name__ == '__main__':
    set_float32_precision()
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--launch', type=int, default=None, help='start N ranks and check their parity')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--rank', type=int, default=None)
    parser.add_argument('--procs', type=int, default=2)
    parser.add_argument('--port', type=int, default=None)
    args = parser.parse_args()

    if args.launch is not None:
        sys.exit(0 if launch(args.launch, args.device) else 1)
    worker(args.rank, args.procs, args.port, args.device)

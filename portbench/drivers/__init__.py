r"""One driver per kind of cell: set-up, one unit of timed work, the outputs
kept for the comparison, and the analytic count of that work."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def one_thread():
    r"""Host tensor work on one thread: the program's parameter
    initialisation on the host (overwritten by the run's parameters), which
    on more threads takes longer and varies with the host's load."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)

r"""One module per score network, found by a configuration's ``"arch"``:
``archs/<arch>.py`` gives

- ``program(config, tree, device)``: the port's window kernel ``eps(x, t)``,
  built through the port's own entry, with ``tree``'s parameters loaded;
- ``reference(params, config, precision)``: the plain PyTorch network
  ``(windows, t) -> eps`` over ``params`` (``tree``'s leaves as float32
  tensors), in ``'float32'``, ``'bfloat16'`` or the control's ``'fp8'``;
- ``init_tree(config, generator)``: parameters drawn from ``generator``, on
  its device, under the names ``program`` loads;
- ``window_flops(config)``: the forward FLOPs of one window;
- ``names(tree)``: the program's parameter name of each leaf of ``tree``.

``reference`` and ``init_tree`` are defined in the arch's own module under
``portbench/reference``, which imports nothing of the program, and the arch
module only names them there. A tree is flat: ``{name: array or tensor}``.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def of(config: dict):
    r"""The module ``archs/<config['arch']>.py``: the configuration's score
    network, program and reference."""

    return importlib.import_module(f"{__name__}.{config['arch']}")


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

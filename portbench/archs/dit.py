r"""The diffusion transformer as the Kolmogorov window kernel (``"arch":
"dit"``): the port's ``LocalScoreDiT`` built by ``make_score``, the plain
``reference.dit.DiT``, and its forward FLOPs, frozen from the port's
``nn/flops.py``.

A tree holds ``models.py``'s names (``blocks.3.attn.qkv.weight``, Linears
``(out, in)``); the program holds them under its ``dit.`` prefix.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.archs import one_thread
from portbench.counts import conv_flops, dense_flops
from portbench.reference import dit as ref

PREFIX = 'dit.'


def program(config: dict, tree: dict, device: torch.device) -> torch.nn.Module:
    r"""The window kernel with ``tree`` loaded. Its parameters are laid out
    on the meta device and allocated on ``device``, since the constructor's
    own draw of 674 M of them on the host would take seconds; the buffers
    the constructor computes (forcing, frequencies, position table) come
    from a build without blocks on the host."""

    from sda_tpu_torch.experiments.kolmogorov.utils import make_score

    with torch.device('meta'):
        module = make_score(**config)
    with one_thread():
        module = module.to_empty(device=device)
        module.load_state_dict({PREFIX + k: torch.as_tensor(v) for k, v in tree.items()})
        for name, buffer in make_score(**dict(config, depth=0)).named_buffers():
            module.get_buffer(name).copy_(buffer)
    return module


reference = ref.DiT
init_tree = ref.init_tree


def names(tree: dict) -> Dict[str, str]:
    return {PREFIX + k: k for k in tree}


def window_flops(config: dict) -> int:
    r"""Forward FLOPs of one window: the patch convolution, the timestep
    embedder, per block the adaLN Linear, four Linears per token and the
    attention's two products (:func:`attention_flops`), and the final
    layer."""

    tokens = ref.tokens(config)
    d, p, c = config['hidden_size'], config['patch_size'], 2 * config['window']
    m = int(d * config['mlp_ratio'])
    block = (dense_flops(d, 6 * d)
             + tokens * (dense_flops(d, 3 * d) + dense_flops(d, d) + dense_flops(d, m) + dense_flops(m, d))
             + attention_flops(config))
    return (conv_flops(tokens, c + 1, d, p * p) + dense_flops(256, d) + dense_flops(d, d)
            + config['depth'] * block + dense_flops(d, 2 * d) + tokens * dense_flops(d, p * p * c))


def attention_flops(config: dict) -> int:
    r"""The attention's forward FLOPs per window and block, ``q k^T`` and
    ``p v``: ``4 N^2 D`` for ``N`` tokens of width ``D``, whatever kernel
    computes them."""

    return 4 * ref.tokens(config) ** 2 * config['hidden_size']

r"""Analytic FLOP accounting for the score networks.

Counterpart of :mod:`sda_tpu.nn.flops`, kept as the port's own copy. These
counters walk the module structure of :class:`sda_tpu_torch.nn.UNet` and
:class:`sda_tpu_torch.diffusion.ScoreUNet` (and of the diffusion transformer,
:class:`sda_tpu_torch.nn.dit.DiT`, which the JAX package does not have) and
count each multiply-accumulate of every convolution and dense layer, and of
attention's two products, as 2 FLOPs. Elementwise work (norms,
activations, additions) is left out: it is O(channels x pixels) against the
convolutions' O(channels^2 x pixels x K^d), and a share of peak leaves it out
by convention.

``tests/test_torch_flops.py`` holds them to the JAX package's counters and
to ``torch.utils.flop_counter.FlopCounterMode`` over the port's modules.
"""

from __future__ import annotations

from typing import Sequence, Union


def _as_tuple(v: Union[int, Sequence[int]], n: int) -> tuple:
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def conv_flops(elems: int, c_in: int, c_out: int, kernel_elems: int) -> int:
    r"""``2 * output_elements * C_in * C_out * prod(kernel)`` — one fused
    multiply-add counted as 2 FLOPs, the MFU convention."""

    return 2 * elems * c_in * c_out * kernel_elems


def dense_flops(features_in: int, features_out: int) -> int:
    return 2 * features_in * features_out


def unet_flops(
    in_channels: int,
    out_channels: int,
    hidden_channels: Sequence[int],
    hidden_blocks: Sequence[int],
    kernel_size: Union[int, Sequence[int]],
    size: Union[int, Sequence[int]],
    spatial: int = 2,
    stride: Union[int, Sequence[int]] = 2,
    embedding: int = 64,
) -> int:
    r"""Forward FLOPs of one :class:`sda_tpu_torch.nn.UNet` evaluation on a
    single event of spatial shape ``size``.

    Mirrors ``UNet.forward`` layer by layer (``sda_tpu_torch/nn/unet.py``):

    - descent: head conv at full resolution, then per depth a strided conv
      and ``hidden_blocks[i]`` modulated residual blocks (2 convs + 1
      modulation dense each);
    - ascent: the same blocks per depth, an upsample conv to the next-higher
      resolution, and the output conv.
    """

    kernel = _as_tuple(kernel_size, spatial)
    strides = _as_tuple(stride, spatial)
    sizes = _as_tuple(size, spatial)

    k_elems = 1
    for k in kernel:
        k_elems *= k

    def elems(depth: int) -> int:
        e = 1
        for s, r in zip(sizes, strides):
            e *= s // (r**depth)
        return e

    total = 0
    depths = len(hidden_blocks)

    def block(depth: int) -> int:
        c = hidden_channels[depth]
        return (
            2 * conv_flops(elems(depth), c, c, k_elems)
            + dense_flops(embedding, c)
        )

    # Descent
    for i in range(depths):
        if i == 0:
            total += conv_flops(elems(0), in_channels, hidden_channels[0], k_elems)
        else:
            total += conv_flops(
                elems(i), hidden_channels[i - 1], hidden_channels[i], k_elems
            )
        total += hidden_blocks[i] * block(i)

    # Ascent
    for i in reversed(range(depths)):
        total += hidden_blocks[i] * block(i)
        if i > 0:
            total += conv_flops(
                elems(i - 1), hidden_channels[i], hidden_channels[i - 1], k_elems
            )
        else:
            total += conv_flops(elems(0), hidden_channels[0], out_channels, k_elems)

    return total


def score_unet_flops(
    channels: int,
    context_channels: int = 0,
    embedding: int = 64,
    hidden_channels: Sequence[int] = (32, 64, 128),
    hidden_blocks: Sequence[int] = (2, 3, 5),
    kernel_size: Union[int, Sequence[int]] = 3,
    size: Union[int, Sequence[int]] = 64,
    spatial: int = 2,
    stride: Union[int, Sequence[int]] = 2,
    **absorb,
) -> int:
    r"""Forward FLOPs of one :class:`ScoreUNet` event evaluation.

    The context is concatenated along the channel axis
    (``sda_tpu_torch/diffusion/scorenet.py``, ``ScoreUNet.forward``), so it
    raises the UNet's input channel count; the time-embedding MLP (32 -> 256
    -> embedding, ``sda_tpu_torch/nn/layers.py``, ``TimeEmbedding``) is
    counted too.
    """

    total = unet_flops(
        in_channels=channels + context_channels,
        out_channels=channels,
        hidden_channels=hidden_channels,
        hidden_blocks=hidden_blocks,
        kernel_size=kernel_size,
        size=size,
        spatial=spatial,
        stride=stride,
        embedding=embedding,
    )
    total += dense_flops(32, 256) + dense_flops(256, embedding)

    return total


def dit_flops(
    in_channels: int,
    out_channels: int,
    input_size: int,
    patch_size: int = 2,
    hidden_size: int = 1152,
    depth: int = 28,
    mlp_ratio: float = 4.0,
    frequency_embedding_size: int = 256,
) -> int:
    r"""Forward FLOPs of one :class:`~sda_tpu_torch.nn.dit.DiT` evaluation on
    a single square field of side ``input_size``, with ``T`` tokens of width
    ``D``: the patch convolution, the timestep embedder's two Linears, per
    block the adaLN Linear (``D -> 6 D``, once per field), the qkv, output and
    two MLP Linears per token and attention's ``q k^T`` and ``p v`` (``4 T^2
    D``), and the final layer's adaLN and Linear."""

    tokens = (input_size // patch_size) ** 2
    d, m = hidden_size, int(hidden_size * mlp_ratio)
    block = (
        dense_flops(d, 6 * d)
        + tokens * (dense_flops(d, 3 * d) + dense_flops(d, d) + dense_flops(d, m) + dense_flops(m, d))
        + 4 * tokens**2 * d
    )
    return (
        conv_flops(tokens, in_channels, d, patch_size**2)
        + dense_flops(frequency_embedding_size, d) + dense_flops(d, d)
        + depth * block
        + dense_flops(d, 2 * d) + tokens * dense_flops(d, patch_size**2 * out_channels)
    )


def guided_sampler_flops(
    window_flops: int,
    n_windows: int,
    batch: int,
    steps: int,
    corrections: int = 0,
    vjp_multiplier: float = 2.0,
) -> float:
    r"""Total FLOPs of one fused guided-sampling program.

    Every predictor step and every Langevin correction evaluates the guided
    eps once (``sda_tpu_torch/diffusion/sde.py``, ``VPSDE.sample``); each
    guided evaluation runs the window kernel over all ``n_windows x batch``
    windows forward *and* pulls a VJP back through it
    (``sda_tpu_torch/diffusion/guidance.py``, ``GaussianScore``).
    ``vjp_multiplier`` is the cost model for that: the guidance
    differentiates with respect to the *state only* (the parameters are
    frozen under sampling), so the weight-gradient convolutions of a
    training backward pass do not run; each conv layer adds one conv of
    equal MAC count for its input gradient, making forward + VJP = 2.0x
    forward. ``FlopCounterMode`` over a forward and ``backward()`` with the
    parameters frozen counts 2.0000x at ``unet_0``'s widths
    (``tests/test_torch_flops.py``). Training steps (gradients with respect
    to the parameters) would use ~3x; guidance with ``remat=True`` adds one
    more forward (3.0x). The guidance itself adds O(observation) work,
    negligible next to the convolutions.
    """

    evals = steps * (1 + corrections)
    return float(window_flops) * n_windows * batch * evals * vjp_multiplier

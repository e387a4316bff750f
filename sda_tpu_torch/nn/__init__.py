r"""Neural-network primitives."""

from .layers import Conv, Dense, ResMLP, TimeEmbedding, layer_norm, reset_parameters  # noqa: F401
from .unet import ModResidualBlock, UNet  # noqa: F401
from .flops import conv_flops, dense_flops, dit_flops, guided_sampler_flops, score_unet_flops, unet_flops  # noqa: F401

r"""Neural-network primitives."""

from .layers import Conv, Dense, ResMLP, TimeEmbedding, layer_norm, reset_parameters  # noqa: F401
from .unet import ModResidualBlock, UNet  # noqa: F401

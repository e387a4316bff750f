r"""Kolmogorov experiment: simulate a truth, assimilate it with ``unet_0``."""

r"""Spectral transforms and the CUDA DFT kernels."""

from .spectral import RealDFT2  # noqa: F401

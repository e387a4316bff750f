r"""Spectral transforms and the CUDA DFT kernels."""

from .spectral import RealDFT2, default_dft_method  # noqa: F401

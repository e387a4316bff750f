r"""Dynamical systems: Markov chains and the Kolmogorov flow."""

from .kolmogorov import KolmogorovFlow  # noqa: F401
from .markov import MarkovChain  # noqa: F401
from .ops import coarsen, vorticity  # noqa: F401

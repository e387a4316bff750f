r"""Dynamical systems: Markov chains, ODEs, the Lorenz family, the
Kolmogorov flow and the two-layer quasi-geostrophic flow."""

from .kolmogorov import KolmogorovFlow  # noqa: F401
from .lorenz import Lorenz63, Lorenz96, NoisyLorenz63  # noqa: F401
from .markov import MarkovChain  # noqa: F401
from .ode import DiscreteODE, rk4  # noqa: F401
from .ops import coarsen, upsample, vorticity  # noqa: F401
from .quasigeostrophic import QuasiGeostrophic  # noqa: F401
from .systems import DampedSpring, LotkaVolterra  # noqa: F401

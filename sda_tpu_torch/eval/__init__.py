r"""Evaluation stack: particle filter, OT/MMD metrics, spectra, variational
baseline."""

from .bpf import bpf  # noqa: F401
from .metrics import emd, mmd, pairwise_distances, sinkhorn  # noqa: F401
from .spectra import energy_spectrum, spectrum_distance  # noqa: F401
from .var4d import lbfgs_minimize, weak_4d_var, weak_4d_var_objective  # noqa: F401

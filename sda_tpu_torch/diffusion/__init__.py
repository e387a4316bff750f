r"""Diffusion engine: SDE, sampler, guidance, windowed score composition."""

from .guidance import DPSGaussianScore, GaussianScore  # noqa: F401
from .scorenet import LocalScoreDiT, LocalScoreUNet, ScoreNet, ScoreUNet, bind_eps  # noqa: F401
from .sde import VPSDE, SubSubVPSDE, SubVPSDE, make_alpha  # noqa: F401
from .windowed import MCScoreNet, MCScoreWrapper, chunked_eval, fold, unfold  # noqa: F401

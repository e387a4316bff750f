r"""The port's counterparts of the experiment helpers under ``experiments/``."""

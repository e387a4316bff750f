r"""Checkpoint reading (training itself is not ported yet)."""

from .checkpoint import load_params, msgpack_restore, params_from_flax  # noqa: F401

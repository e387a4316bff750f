r"""Training runtime: datasets, the train loop, checkpoints, logging."""

from .checkpoint import (  # noqa: F401
    load_params,
    msgpack_restore,
    params_from_flax,
    params_to_flax,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from .data import TrajectoryDataset, load_h5, save_h5  # noqa: F401
from .logging import RunLogger, append_csv, existing_csv_keys  # noqa: F401
from .loop import SCHEDULES, Trainer, loop  # noqa: F401

r"""Experiment tracking: JSONL/CSV metric logging with optional wandb.

Counterpart of :mod:`sda_tpu.train.logging`: the same ``metrics.jsonl``
records (``{'time', **metrics, 'step'}``), and wandb only where it imports
and initialises, else quietly off.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class RunLogger:
    r"""Append-only JSONL metric logger for a run directory.

    Arguments:
        path: The run directory.
        use_wandb: Attempt to mirror metrics to Weights & Biases (silently
            disabled if wandb is unavailable or not configured).
        project / group / config: wandb metadata.
    """

    def __init__(
        self,
        path: Path,
        use_wandb: bool = False,
        project: Optional[str] = None,
        group: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
    ):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.file = open(self.path / 'metrics.jsonl', mode='a')
        self.t0 = time.time()

        self.wandb_run = None
        if use_wandb:
            try:
                import wandb

                self.wandb_run = wandb.init(project=project, group=group, config=config)
            except Exception:
                self.wandb_run = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {'time': time.time() - self.t0, **metrics}
        if step is not None:
            record['step'] = step

        self.file.write(json.dumps(record) + '\n')
        self.file.flush()

        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=step)

    def finish(self) -> None:
        self.file.close()

        if self.wandb_run is not None:
            self.wandb_run.finish()


def append_csv(path: Path, row: str) -> None:
    r"""Appends one line to a CSV results file."""

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    with open(path, mode='a') as f:
        f.write(row.rstrip('\n') + '\n')


def existing_csv_keys(path: Path, columns: int) -> set:
    r"""Key tuples (the first ``columns`` comma-separated fields) of the rows
    already in an :func:`append_csv` file, so that a re-run skips them."""

    path = Path(path)
    keys = set()
    if path.exists():
        for line in path.read_text().splitlines():
            parts = line.split(',')
            if len(parts) >= columns:
                keys.add(tuple(parts[:columns]))
    return keys

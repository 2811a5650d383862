"""Metric logging (counterpart of thermal3d/train/logging.py).

The metric names are the reference's (batch_loss, learning_rate,
global_step, train_loss, val_loss, basic_loss, ...), written as one JSON
object a call to stdout and, with `log_file`, appended to that JSON-lines
file. No wandb is imported: the card's machine has none, and the JAX logger
without wandb keeps only its log file (and logs no images). `use_wandb` and
the run names are accepted for the JAX signature and change nothing.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, project: str = "thermal-3d-vision", run_name: Optional[str] = None,
                 config: Optional[dict] = None, use_wandb: bool = True,
                 log_file: Optional[str] = None):
        del project, run_name, config, use_wandb
        self._file = open(log_file, "a") if log_file else None

    def log(self, metrics: Dict[str, float]) -> None:
        metrics = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                   for k, v in metrics.items()}
        line = json.dumps({"t": time.time(), **metrics})
        print(line, flush=True)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

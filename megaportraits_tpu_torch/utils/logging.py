"""Training metrics: TensorBoard (tensorboardX) and the console (a copy of
``megaportraits_tpu/utils/logging.py``).

Without tensorboardX the writer warns once and records nothing; the drivers
print their metrics to the console either way.
"""

from __future__ import annotations

import logging
from typing import Dict

logger = logging.getLogger("megaportraits_tpu_torch")


class MetricsWriter:
    def __init__(self, log_dir: str = "runs/training_logs"):
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            logger.warning("tensorboardX unavailable; console logging only")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if self._tb is not None:
            for key, value in metrics.items():
                self._tb.add_scalar(key, float(value), step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()

"""Metric logging: CSV streams in the reference's schema, and TensorBoard
(port of ``stgcn_tpu/utils/logging.py``).

The reference exports TensorBoard scalars to CSVs with columns
``(Wall time, Step, Value)`` (src/scripts/report/logs/*.csv headers, consumed
by generate_figures.py:27-37).  :class:`CsvLogger` writes the same schema, one
file per tag, as the JAX package does, so the report tooling re-plots either
package's runs.  :class:`TensorBoardLogger` writes through
``torch.utils.tensorboard`` (the tensorboardX API, which the JAX package
uses) and does nothing where the ``tensorboard`` package is absent.
"""

from __future__ import annotations

import csv
import os
import time


class CsvLogger:
    """One CSV file per metric tag, reference schema: Wall time,Step,Value."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._files: dict[str, object] = {}
        self._writers: dict[str, csv.writer] = {}

    def log(self, tag: str, step: int, value: float) -> None:
        if tag not in self._writers:
            f = open(os.path.join(self.log_dir, f"{tag}.csv"), "a",
                     newline="")
            w = csv.writer(f)
            if f.tell() == 0:
                w.writerow(["Wall time", "Step", "Value"])
            self._files[tag] = f
            self._writers[tag] = w
        self._writers[tag].writerow([time.time(), step, float(value)])
        self._files[tag].flush()

    def log_dict(self, metrics: dict, step: int) -> None:
        for tag, value in metrics.items():
            self.log(tag, step, value)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._writers.clear()


class TensorBoardLogger:
    """TensorBoard scalar logging; does nothing without ``tensorboard``."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir)

    def log(self, tag: str, step: int, value: float) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def log_dict(self, metrics: dict, step: int) -> None:
        for tag, value in metrics.items():
            self.log(tag, step, value)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log(self, tag: str, step: int, value: float) -> None:
        for lg in self.loggers:
            lg.log(tag, step, value)

    def log_dict(self, metrics: dict, step: int) -> None:
        for lg in self.loggers:
            lg.log_dict(metrics, step)

    def close(self) -> None:
        for lg in self.loggers:
            lg.close()

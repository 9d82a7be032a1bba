"""Logging: named console+file loggers and optional TensorBoard scalars.

A copy of the JAX package's ``hcflow_tpu/utils/logging.py``, after the reference's
utils/util.py setup_logger and train_HCFlow.py's SummaryWriter in tb_logger/<name>.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional


def setup_logger(name: str, log_dir: Optional[str] = None, level=logging.INFO,
                 to_file: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)-15s %(levelname)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if to_file and log_dir:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{name}_{time.strftime('%y%m%d-%H%M%S')}.log")
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class TBWriter:
    """TensorBoard scalar writer (torch.utils.tensorboard), a no-op where the
    tensorboard package is not installed."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            os.makedirs(log_dir, exist_ok=True)
            self._w = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def close(self):
        if self._w is not None:
            self._w.close()

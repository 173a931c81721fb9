"""Logging: stdout tee + running meters (a copy of
`cvpr23_lfdm_tpu/utils/logging.py`; reference misc.py:83-93,
LFAE/train.py:16-33 — the AverageMeter duplicated in every script)."""

from __future__ import annotations

import sys
import time


class Logger:
    """Tee stdout to a file (misc.py:83-93). Use as
    `sys.stdout = Logger(path)`."""

    def __init__(self, path: str, mode: str = "a"):
        self.terminal = sys.stdout
        self.file = open(path, mode)

    def write(self, message: str):
        self.terminal.write(message)
        self.file.write(message)

    def flush(self):
        self.terminal.flush()
        self.file.flush()


class AverageMeter:
    """Running average (LFAE/train.py:16-33)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Timer:
    """Wall-clock section timer for batch/data time meters
    (LFAE/train.py:90-103)."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        return dt

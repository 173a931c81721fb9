"""Logging: stdout tee (a copy of the `Logger` of
`cvpr23_lfdm_tpu/utils/logging.py`; reference misc.py:83-93)."""

from __future__ import annotations

import sys


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


"""Stdout tee logger + helpers.

Port of ``refinedet_tpu/utils/logger.py``, the counterpart of the
reference's ``utils/logger.py`` (Logger tee with
fsync, installed as sys.stdout by the train script) and
``utils/osutils.py`` (mkdir_if_missing).
"""

from __future__ import annotations

import errno
import os
import sys


def mkdir_if_missing(path: str) -> None:
    try:
        os.makedirs(path)
    except OSError as e:
        if e.errno != errno.EEXIST:
            raise


class Logger:
    """Tee writes to the console and a log file (flushed + fsynced so tails
    of killed runs survive)."""

    def __init__(self, fpath: str | None = None,
                 console=None):
        self.console = console or sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(os.path.dirname(fpath) or ".")
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def write(self, msg: str) -> None:
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)
            # flush+fsync per write so the tail of a killed/preempted run
            # reaches disk (reference utils/logger.py:9-39 does the same;
            # log lines are ~per-iteration, so the syscall cost is noise).
            self.file.flush()
            os.fsync(self.file.fileno())

    def flush(self) -> None:
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def install(fpath: str) -> Logger:
    """sys.stdout = Logger(...) as the reference does
    (train_refinedet.py:83)."""
    logger = Logger(fpath)
    sys.stdout = logger
    return logger

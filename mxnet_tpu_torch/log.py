"""Logging (counterpart of ``mxnet_tpu/log.py``, ref: python/mxnet/log.py):
a leveled logger factory with MXNet's level aliases and its one-letter,
colour-on-a-terminal prefix."""
from __future__ import annotations

import logging
import sys

__all__ = ['CRITICAL', 'ERROR', 'WARNING', 'INFO', 'DEBUG', 'NOTSET',
           'get_logger', 'getLogger']

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_LEVEL_CHAR = {CRITICAL: 'C', ERROR: 'E', WARNING: 'W',
               INFO: 'I', DEBUG: 'D'}


class _Formatter(logging.Formatter):
    """The level's letter and the time before each message, red on a
    terminal for warnings and errors (ref: log.py _Formatter)."""

    def __init__(self, colored=True):
        super().__init__(datefmt='%m%d %H:%M:%S')
        self._colored = colored and getattr(sys.stderr, 'isatty',
                                            lambda: False)()

    def format(self, record):
        char = _LEVEL_CHAR.get(record.levelno, 'U')
        prefix = f"{char}{self.formatTime(record, self.datefmt)}"
        if self._colored and record.levelno in (CRITICAL, ERROR, WARNING):
            prefix = f"\x1b[31m{prefix}\x1b[0m"
        return f"{prefix} {record.getMessage()}"


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger with one handler (a file's, or stderr's) and ``level``;
    asked again for the same name, the same logger as it is (ref:
    log.py get_logger)."""
    logger = logging.getLogger(name)
    if getattr(logger, '_mxtpu_init', False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or 'a')
    else:
        handler = logging.StreamHandler()
    handler.setFormatter(_Formatter(colored=not filename))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxtpu_init = True
    return logger


getLogger = get_logger  # MXNet's older spelling

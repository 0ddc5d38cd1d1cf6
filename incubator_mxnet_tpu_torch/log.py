"""Colored logging setup (ref: python/mxnet/log.py).

Counterpart of ``incubator_mxnet_tpu/log.py``."""
from __future__ import annotations

import logging
import sys

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

PY3 = True


class _Formatter(logging.Formatter):
    """Customized log formatter with level colors (ref: log.py:37)."""

    def __init__(self):
        datefmt = "%m%d %H:%M:%S"
        super().__init__(datefmt=datefmt)

    def _get_color(self, level):
        if logging.WARNING <= level:
            return "\x1b[31m"
        if logging.INFO <= level:
            return "\x1b[32m"
        return "\x1b[34m"

    def _get_label(self, level):
        if level == logging.CRITICAL:
            return "C"
        if level == logging.ERROR:
            return "E"
        if level == logging.WARNING:
            return "W"
        if level == logging.INFO:
            return "I"
        if level == logging.DEBUG:
            return "D"
        return "U"

    def format(self, record):
        fmt = self._get_color(record.levelno)
        fmt += self._get_label(record.levelno)
        fmt += "%(asctime)s %(process)d %(pathname)s:%(funcName)s:%(lineno)d"
        fmt += "]\x1b[0m"
        fmt += " %(message)s"
        self._style._fmt = fmt
        return super().format(record)


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """(ref: log.py:80, deprecated alias of get_logger)"""
    return get_logger(name, filename, filemode, level)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Get a logger with a colored formatter attached (ref: log.py:90)."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", None):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else "a"
            hdlr = logging.FileHandler(filename, mode)
        else:
            hdlr = logging.StreamHandler(sys.stderr)
            hdlr.setFormatter(_Formatter())
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger

"""Logging utilities of the port (counterpart of ``mxnet_tpu/log.py``;
reference: python/mxnet/log.py): a level-coloured, caller-located
glog-style formatter and the ``get_logger`` factory the example scripts
use."""
import logging
import sys
import warnings

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_LABELS = {CRITICAL: "C", ERROR: "E", WARNING: "W", INFO: "I", DEBUG: "D"}


class _Formatter(logging.Formatter):
    """glog-style line: colored level letter + time + pid + location."""

    def __init__(self, colored=True):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        label = _LABELS.get(record.levelno, "U")
        loc = "%(asctime)s %(process)d %(pathname)s:%(funcName)s:%(lineno)d"
        if self._colored:
            color = ("\x1b[31m" if record.levelno >= WARNING
                     else "\x1b[32m" if record.levelno >= INFO else "\x1b[34m")
            fmt = color + label + loc + "]\x1b[0m %(message)s"
        else:
            fmt = label + loc + "] %(message)s"
        self._style._fmt = fmt
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=None):
    """A logger with the colored glog-style formatter (colors only when the
    target is a tty; files always get plain text).

    ``level`` defaults to WARNING on first initialization; on an
    already-initialized logger, only an EXPLICITLY passed level is applied
    (so a later bare ``get_logger(name)`` never demotes a configured one),
    and a conflicting ``filename`` is flagged instead of silently ignored."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxnet_tpu_init", False):
        if level is not None:
            logger.setLevel(level)
        if filename and not any(
            isinstance(h, logging.FileHandler) for h in logger.handlers
        ):
            warnings.warn(
                "get_logger(%r): logger already initialized without a file; "
                "filename %r ignored" % (name, filename), stacklevel=2,
            )
        return logger
    level = WARNING if level is None else level
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(_Formatter(colored=False))
    else:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(colored=sys.stderr.isatty()))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxnet_tpu_init = True
    return logger


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias (the reference kept it with a warning)."""
    warnings.warn("getLogger is deprecated, use get_logger instead.",
                  DeprecationWarning, stacklevel=2)
    return get_logger(name, filename, filemode, level)

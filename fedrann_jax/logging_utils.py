"""Logging: colored console + plain-text file handler.

Parity with reference fedrann/custom_logging.py:10-62 (ColoredFormatter,
module logger, set_logging_level, add_log_file writing color-free lines to
`fedrann.log`), without the colorama dependency (ANSI codes directly).
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}
_RESET = "\x1b[0m"

_FMT = "%(asctime)s [%(levelname)s] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{text}{_RESET}" if color and sys.stderr.isatty() else text


logger = logging.getLogger("fedrann_jax")
if not logger.handlers:
    _console = logging.StreamHandler(sys.stderr)
    _console.setFormatter(ColoredFormatter(_FMT, _DATEFMT))
    logger.addHandler(_console)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def set_logging_level(level: str | int) -> None:
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)


def add_log_file(path: str) -> logging.Handler:
    """Attach a color-free file handler (reference custom_logging.py:56-62).
    Callers must pass the returned handler to remove_log_file when the run
    ends, or repeated runs in one process append to every prior log."""
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    logger.addHandler(handler)
    return handler


def remove_log_file(handler: logging.Handler) -> None:
    logger.removeHandler(handler)
    handler.close()

"""Console logger (copy of ``ryolo_tpu/utils/logger.py:28-48``)."""

from __future__ import annotations

import logging
import sys
import time

_COLORS = {
    "DEBUG": "\033[34m",
    "INFO": "\033[0m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[31m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelname, "") if sys.stderr.isatty() else ""
        reset = _RESET if color else ""
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(record.created))
        return f"{ts} {color}{record.levelname:<8}{reset} {record.getMessage()}"


def setup_logger(name: str = "ryolo_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(_ColorFormatter())
        h.setLevel(logging.INFO)
        log.addHandler(h)
        log.setLevel(logging.INFO)
        log.propagate = False
    return log


logger = setup_logger()

"""Console logger and the scalar writer (copy of
``ryolo_tpu/utils/logger.py``: ``setup_logger`` :36, ``Logger`` :51)."""

from __future__ import annotations

import json
import logging
import os
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


class Logger:
    """Scalar summary writer: TensorBoard when ``torch.utils.tensorboard``
    imports, else one JSON line per call in ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:  # tensorboard is optional
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def list_of_scalars_summary(self, tag_value_dictionary, step: int):
        if self._writer is not None:
            for tag, value in tag_value_dictionary.items():
                self._writer.add_scalar(tag, value, global_step=step)
            self._writer.flush()
        else:
            rec = {"step": step}
            rec.update({k: float(v) for k, v in tag_value_dictionary.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()

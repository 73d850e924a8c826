"""Logging and directory helpers (port of ``hpfg_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import logging.handlers
import os
import shutil

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def mk_path(path: str, remove: bool = False) -> None:
    """Create a directory; with ``remove``, clear it first."""
    if remove and os.path.exists(path):
        shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)


def get_logger(filename: str | None = None, verbosity: str = "info",
               name: str = "hpfg_tpu_torch") -> logging.Logger:
    """Console logger, plus a file that rotates daily
    (``TimedRotatingFileHandler(when="D")``) for each distinct
    ``filename``; idempotent per process."""
    logger = logging.getLogger(name)
    logger.setLevel(_LEVELS.get(verbosity, logging.INFO))
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s][%(filename)s][line:%(lineno)d][%(levelname)s] "
        "%(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if filename and not any(getattr(h, "baseFilename", None)
                            == os.path.abspath(filename)
                            for h in logger.handlers):
        mk_path(os.path.dirname(filename) or ".")
        fh = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", encoding="utf-8")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger

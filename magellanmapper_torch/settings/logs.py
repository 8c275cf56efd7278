"""Logging setup.

Copy of ``magellanmapper_tpu/settings/logs.py``: root logger configuration
(``setup_logger``), a rotating file handler (``add_file_handler``), and a
stream writer that redirects stdout/stderr into the logger
(``LogWriter``).
"""

from __future__ import annotations

import logging
import logging.handlers
import pathlib
import sys


class LogWriter:
    """File-like object that forwards writes to a logger."""

    def __init__(self, fn_logger, level=logging.INFO):
        self.fn_logger = fn_logger
        self.level = level
        self._buf = ""

    def write(self, msg: str):
        self._buf += msg
        while "\n" in self._buf:
            line, _, self._buf = self._buf.partition("\n")
            if line.strip():
                self.fn_logger(line)

    def flush(self):
        if self._buf.strip():
            self.fn_logger(self._buf)
        self._buf = ""


def setup_logger(name: str = "mmtpu", level: int = logging.INFO
                 ) -> logging.Logger:
    """Configure the framework root logger with a console handler."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
    return logger


def add_file_handler(
        logger: logging.Logger, path: str,
        backup_count: int = 5) -> logging.Handler:
    """Attach a rotating file handler, rotating on each run."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    roll = p.is_file()
    handler = logging.handlers.RotatingFileHandler(
        str(p), backupCount=backup_count)
    if roll:
        handler.doRollover()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(handler)
    return handler


def redirect_std_streams(logger: logging.Logger):
    """Redirect stdout/stderr into the logger (reference ``cli.py:471``)."""
    sys.stdout = LogWriter(logger.info)
    sys.stderr = LogWriter(logger.error)


def update_log_level(logger: logging.Logger, level) -> logging.Logger:
    """Set the level on a logger and all its handlers
    (reference ``logs.update_log_level :37``)."""
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.setLevel(level)
    return logger

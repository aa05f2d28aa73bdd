"""Logging setup with repeated-warning dedup (the JAX package's
``logging_setup.py``).

(reference: src/pint/logging.py — a sink with a LogFilter that
suppresses repeats of known-noisy messages and a ``setup(level=...)``
entry point, on the stdlib logging module.) The logger is
``pint_tpu_torch``.
"""

from __future__ import annotations

import logging
import sys

LOG_NAME = "pint_tpu_torch"


class DedupFilter(logging.Filter):
    """Emit each distinct (level, message) of WARNING and above
    ``max_repeats`` times; drop the repeats (reference:
    pint.logging.LogFilter)."""

    def __init__(self, max_repeats: int = 1):
        super().__init__()
        self.max_repeats = max_repeats
        self._seen: dict[tuple, int] = {}

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno < logging.WARNING:
            return True
        key = (record.levelno, record.getMessage())
        n = self._seen.get(key, 0)
        self._seen[key] = n + 1
        return n < self.max_repeats


def setup(level="INFO", stream=None, dedup=True) -> logging.Logger:
    """Configure the package logger (reference: pint.logging.setup);
    repeated calls reconfigure it. Returns the logger."""
    logger = logging.getLogger(LOG_NAME)
    logger.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"))
    if dedup:
        handler.addFilter(DedupFilter())
    logger.addHandler(handler)
    logger.propagate = False
    return logger


def get_logger(child: str | None = None) -> logging.Logger:
    name = LOG_NAME if child is None else f"{LOG_NAME}.{child}"
    return logging.getLogger(name)

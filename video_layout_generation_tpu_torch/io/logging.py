"""Dual-sink logging, stderr and ``experiment.log`` (the JAX package's
``io/logging.py``): DEBUG level, an ``asctime-message`` format. One logger
per log file, so that runs in one process write their own."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def get_logger(path: Optional[str] = None) -> logging.Logger:
    """The logger of ``path`` (idempotent)."""
    name = "vlg_torch" if path is None else "vlg_torch:" + path
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s-%(message)s")
    handlers = [logging.StreamHandler(sys.stderr)]
    if path is not None:
        handlers.append(logging.FileHandler(path))
    for h in handlers:
        h.setLevel(logging.DEBUG)
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger

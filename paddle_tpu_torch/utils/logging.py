"""Logging setup — a copy of ``paddle_tpu/utils/logging.py`` (glog-style,
the analog of the reference's paddle/utils/Logging.h)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(levelname).1s %(asctime)s %(name)s] %(message)s"


def get_logger(name: str = "paddle_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%m%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


logger = get_logger()

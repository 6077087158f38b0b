"""Logging setup on the standard library (port of
``shapy_tpu/utils/logging.py``): a console sink on stderr, an optional
file sink, and the process's rank in the format (``RANK`` from the
environment, as ``torch.distributed`` launchers set it; 0 otherwise).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "[%(asctime)s] [rank {rank}] %(levelname)s %(name)s: %(message)s"


def _file_handler(log_file: str, fmt) -> logging.FileHandler:
    os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
    fh = logging.FileHandler(log_file)
    if fmt is not None:
        fh.setFormatter(fmt)
    return fh


def get_logger(
    name: str = "shapy_tpu_torch",
    level: str = "INFO",
    log_file: Optional[str] = None,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        # Already configured: still honour a newly requested level / file
        # sink instead of silently dropping them.
        logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        if log_file and not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == os.path.abspath(log_file)
            for h in logger.handlers
        ):
            logger.addHandler(_file_handler(log_file,
                                            logger.handlers[0].formatter))
        return logger
    try:
        rank = int(os.environ.get("RANK", "0"))
    except ValueError:
        rank = 0
    fmt = logging.Formatter(_FORMAT.format(rank=rank))
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_file:
        logger.addHandler(_file_handler(log_file, fmt))
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    return logger

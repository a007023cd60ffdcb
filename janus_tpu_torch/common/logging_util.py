"""Logging setup: console, plus a rotating file of 5 MB × 5 when a log
directory is given."""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

__all__ = ["setup_logging"]


def setup_logging(log_dir: Optional[str] = "logs",
                  filename: str = "janus.log",
                  level: int = logging.INFO) -> None:
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    )

    console = logging.StreamHandler()
    console.setFormatter(fmt)
    root.addHandler(console)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        rotating = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, filename),
            maxBytes=5 * 1024 * 1024,
            backupCount=5,
        )
        rotating.setFormatter(fmt)
        root.addHandler(rotating)

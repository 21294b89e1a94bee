"""Leveled logger controlled by HOROVOD_LOG_LEVEL / HOROVOD_LOG_HIDE_TIME.

The port's copy of ``horovod_tpu/common/logging.py``.

Reference: horovod/common/logging.{cc,h} — a minimal glog-style logger.  We
delegate to the stdlib logging module but honour the same env knobs and tag
records with the global rank once known.
"""
from __future__ import annotations

import logging as _logging
import sys

from . import config

TRACE = 5
_LEVELS = {
    "trace": TRACE,
    "debug": _logging.DEBUG,
    "info": _logging.INFO,
    "warning": _logging.WARNING,
    "error": _logging.ERROR,
    "fatal": _logging.CRITICAL,
}

_logging.addLevelName(TRACE, "TRACE")

logger = _logging.getLogger("horovod_tpu_torch")
_configured = False


def configure(rank: int | None = None) -> None:
    global _configured
    level = _LEVELS.get(str(config.LOG_LEVEL.get()).lower(), _logging.WARNING)
    logger.setLevel(level)
    if not _configured:
        handler = _logging.StreamHandler(sys.stderr)
        fmt = "[%(levelname)s] %(message)s" if config.LOG_HIDE_TIME.get() \
            else "%(asctime)s [%(levelname)s] %(message)s"
        handler.setFormatter(_logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.propagate = False
        _configured = True
    if rank is not None:
        for h in logger.handlers:
            fmt = f"[rank {rank}] %(levelname)s: %(message)s" \
                if config.LOG_HIDE_TIME.get() \
                else f"%(asctime)s [rank {rank}] %(levelname)s: %(message)s"
            h.setFormatter(_logging.Formatter(fmt))


configure()

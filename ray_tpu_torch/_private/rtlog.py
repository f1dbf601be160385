"""Logging for ray_tpu_torch processes.

Analog of the reference's spdlog-based ``RAY_LOG`` plus the Python log monitor
that prefixes driver-shipped worker lines with ``(pid=...)`` (reference:
``src/ray/util/logging.h``, ``python/ray/_private/log_monitor.py``;
SURVEY.md §5.5).  Workers log to ``<session>/logs/<component>.log``; lines a
worker prints are also forwarded to the driver over the control-plane socket
and re-emitted with a ``(component pid=N)`` prefix.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG

_FORMAT = "%(asctime)s %(levelname).1s %(process)d %(name)s] %(message)s"
# Idempotency is tracked PER HANDLER, not per process: the old module
# global `_configured` made setup() first-caller-wins — a second call
# with a log_dir (e.g. a client-mode init followed by attaching to a
# session) never got its file handler, and a different component name
# was silently ignored.
_stream_configured = False
# component -> (resolved log_dir, FileHandler): ONE file handler per
# component, replaced when a later session points it at a new dir — an
# init→shutdown→init cycle must not leave session A's file receiving
# session B's records (and leaking an fd) forever
_file_handlers: dict = {}


def setup(component: str, log_dir: Optional[Path] = None) -> logging.Logger:
    """Configure the process-wide ray_tpu_torch logger; returns the root logger.

    Idempotent per handler: the stderr handler attaches once per
    process, and each distinct (component, log_dir) pair attaches its
    file handler exactly once — repeated calls never duplicate handlers
    and never drop a newly requested log file."""
    global _stream_configured
    logger = logging.getLogger("ray_tpu_torch")
    fmt = logging.Formatter(_FORMAT)
    if not _stream_configured:
        # level only on first configuration: later setup() calls (serve
        # controller boot, session attach) must not clobber a level the
        # user set programmatically mid-session
        logger.setLevel(GLOBAL_CONFIG.log_level)
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
        _stream_configured = True
    if log_dir is not None:
        dirkey = str(Path(log_dir).resolve())
        prev = _file_handlers.get(component)
        if prev is None or prev[0] != dirkey:
            if prev is not None:  # new session dir: retire the old file
                logger.removeHandler(prev[1])
                prev[1].close()
            fh = logging.FileHandler(
                str(Path(log_dir) / f"{component}-{os.getpid()}.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
            _file_handlers[component] = (dirkey, fh)
    return logger


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"ray_tpu_torch.{name}")

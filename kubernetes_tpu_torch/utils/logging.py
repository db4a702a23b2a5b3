"""Leveled logging — the glog analogue.

The reference glog-levels everything, with verbose hot-path guards like
``if glog.V(10)`` (predicates.go:478-483).  Python's stdlib logging maps
cleanly: V(0-1) -> INFO, V(2-4) -> DEBUG, V(>=5) -> the VERBOSE level below
DEBUG; ``--v``/KT_LOG_V picks the threshold.  Hot paths use
``log.isEnabledFor`` (the V() guard) so disabled levels cost one branch.
"""

from __future__ import annotations

import logging
import os
import sys
import typing

VERBOSE = 5  # below DEBUG(10): glog V>=5 territory
logging.addLevelName(VERBOSE, "VERBOSE")

_ROOT = "kubernetes_tpu_torch"
_configured = False


def configure(v: int | None = None,
              stream: typing.TextIO = sys.stderr) -> None:
    """Wire the package root logger once (the daemon entry calls this;
    library users configure logging themselves)."""
    global _configured
    if v is None:
        from kubernetes_tpu_torch.utils import knobs
        v = knobs.get_int("KT_LOG_V")
    level = logging.INFO if v <= 1 else (logging.DEBUG if v < 5 else VERBOSE)
    root = logging.getLogger(_ROOT)
    if not _configured:
        handler = logging.StreamHandler(stream)
        handler.setFormatter(logging.Formatter(
            "%(levelname).1s%(asctime)s %(name)s] %(message)s",
            datefmt="%m%d %H:%M:%S"))
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    root.setLevel(level)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}")

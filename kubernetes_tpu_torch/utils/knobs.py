"""The ``KT_*`` environment knobs this package reads.

A small registry with the same contract as the JAX package's: every knob
is declared once with its default, read through :func:`get_int`,
:func:`get_float` or :func:`get_bool`, and read at import or object init,
never per drain.  Unset or empty means the declared default; garbage
logs a warning and means the default."""

from __future__ import annotations

import logging
import os

log = logging.getLogger("kubernetes_tpu_torch.knobs")

# name -> (default, doc)
REGISTRY: dict[str, tuple[str, str]] = {
    "KT_DYN_TEMPLATES": (
        "64", "Max distinct nonzero-request templates factored out of the "
              "scan body; batches above it keep the in-scan score path"),
    "KT_TRACE": (
        "1", "Span tracer on/off; 0 disables all span recording"),
    "KT_TRACE_RING": ("8192", "Trace ring capacity in spans"),
    "KT_TRACE_SAMPLE": (
        "1", "Root-span sampling fraction 0.0-1.0; children follow the "
             "root"),
    "KT_LOG_V": (
        "0", "Log verbosity (glog -v shape): <=1 INFO, <5 DEBUG, "
             ">=5 VERBOSE"),
    "KT_LOCKTRACE": (
        "0", "Instrumented locks: acquisition chains, order-inversion and "
             "long-hold detection (utils/locktrace.py)"),
    "KT_LOCKTRACE_HOLD_MS": (
        "100", "Lock hold duration past which locktrace records a "
               "long-hold"),
}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def get(name: str) -> str:
    """The raw string value: environment, else the declared default."""
    try:
        default = REGISTRY[name][0]
    except KeyError:
        raise KeyError(f"{name} is not a declared knob of "
                       f"kubernetes_tpu_torch.utils.knobs") from None
    raw = os.environ.get(name)
    if raw is not None and raw.strip():
        return raw.strip()
    return default


def get_int(name: str) -> int:
    raw = get(name)
    try:
        return int(float(raw))
    except ValueError:
        fallback = int(REGISTRY[name][0])
        log.warning("bad %s=%r; using %s", name, raw, fallback)
        return fallback


def get_float(name: str) -> float:
    raw = get(name)
    try:
        return float(raw)
    except ValueError:
        fallback = float(REGISTRY[name][0])
        log.warning("bad %s=%r; using %s", name, raw, fallback)
        return fallback


def get_bool(name: str) -> bool:
    """``1/true/yes/on`` is on and ``0/false/no/off`` is off (any case)."""
    raw = get(name).lower()
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    fallback = REGISTRY[name][0] in _TRUE
    log.warning("bad %s=%r; using %s", name, raw, fallback)
    return fallback

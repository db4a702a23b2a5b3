"""Daemon-thread registry: every background thread is named, started
through one chokepoint, and auditable.

Twelve PRs accumulated 5+ factory-started background threads (commit
worker, SLO tick, verifier, telemetry sampler, shard tick, reflector
pumps) plus per-batch transients (async binds).  A raw
``threading.Thread(...)`` in daemon code is invisible to any stop/join
audit — ktlint's C03 rule flags them; daemon modules start threads
through :func:`spawn` instead, which registers long-lived threads here
so :func:`audit` can answer "what is still running and who started it"
(tests pin that a stopped ConfigFactory leaves no registered live
threads behind).

``transient=True`` marks bounded-lifetime workers (per-batch bind
fan-out): they get the name + daemon-flag discipline but skip the
registry — thousands of entries per drain would be churn, and their
joins are owned by the spawning batch.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

_lock = threading.Lock()
_registry: list[tuple[str, threading.Thread, float]] = []


def spawn(target: Callable, *, name: str, args: tuple = (),
          kwargs: Optional[dict] = None, daemon: bool = True,
          start: bool = True, transient: bool = False) -> threading.Thread:
    """Create (and by default start) a named daemon thread, registered
    for the stop/join audit unless ``transient``."""
    t = threading.Thread(  # ktlint: disable=C03 — the one chokepoint
        target=target, args=args, kwargs=kwargs or {}, daemon=daemon,
        name=name)
    if not transient:
        with _lock:
            _prune_locked()
            _registry.append((name, t, time.monotonic()))
    if start:
        t.start()
    return t


def register(thread: threading.Thread,
             name: Optional[str] = None) -> threading.Thread:
    """Adopt an externally created thread (e.g. a server's
    ``serve_forever`` thread minted by stdlib helpers)."""
    with _lock:
        _prune_locked()
        _registry.append((name or thread.name, thread, time.monotonic()))
    return thread


def _prune_locked() -> None:
    _registry[:] = [(n, t, at) for n, t, at in _registry if t.is_alive()
                    or not t.ident]


def live() -> list[str]:
    """Names of registered threads currently alive."""
    with _lock:
        return [n for n, t, _at in _registry if t.is_alive()]


def audit(expect_stopped: Iterable[str] = ()) -> dict:
    """The stop/join audit surface: what is registered, what is alive,
    and which of ``expect_stopped`` (name prefixes) are still running."""
    with _lock:
        alive = [(n, t) for n, t, _at in _registry if t.is_alive()]
    leaked = [n for n, _t in alive
              if any(n.startswith(p) for p in expect_stopped)]
    return {"registered_live": [n for n, _t in alive],
            "leaked": leaked}

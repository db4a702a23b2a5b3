"""Instrumented lock factory: runtime lock-order + long-hold detection.

ktlint's C01 rule extracts the static ``with <lock>`` nesting graph and
fails tier-1 on cycles — but Python locks also flow through callbacks,
worker threads, and ``.acquire()`` calls no AST walk can prove ordered.
This module is the runtime companion (C02): named locks minted through
:func:`make_lock` / :func:`make_rlock` record, per thread, the chain of
locks held at every acquisition and

* **order inversions** — thread 1 acquires A then B while thread 2 (ever,
  anywhere) acquired B then A: the classic deadlock precondition,
  reported the first time the second edge appears, without needing the
  schedules to actually collide;
* **long holds** — any hold longer than ``KT_LOCKTRACE_HOLD_MS``
  (default 100 ms): a lock held across device work or I/O is a latency
  cliff for every thread behind it.

Both count into ``scheduler_lock_inversions_total`` /
``scheduler_lock_long_holds_total`` and carry bounded detail in
:func:`report`.  The soak runs its HA and tenancy-poison waves with
``KT_LOCKTRACE=1`` and ratchets both columns to zero
(tools/check_bench.py check_soak), so every chaos run doubles as a
race/deadlock detector.

Cost model (the KT_TRACE=0 pattern): with ``KT_LOCKTRACE`` unset the
factory returns **plain** ``threading.Lock``/``RLock`` objects — the one
branch is at construction, and the hot acquire/release path is exactly
what it was before this module existed (pinned by the 100k-acquire
overhead guard in tests/test_locktrace.py).

Lock *names* are shared by class of lock, not instance ("cache.
SchedulerCache", "tenancy.SolverService.engine"): the ordering
discipline is between kinds of locks, and same-name nesting (two cache
instances in one test process) is deliberately not an edge.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Union

from kubernetes_tpu_torch.utils import knobs
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("locktrace")

_enabled = knobs.get_bool("KT_LOCKTRACE")
_hold_threshold_s = knobs.get_float("KT_LOCKTRACE_HOLD_MS") / 1e3

# Global, append-only order evidence.  Guarded by a RAW lock (the
# tracer must not trace itself).
_state_lock = threading.Lock()
_edges: dict[tuple[str, str], str] = {}   # (held, acquired) -> thread
_inversions: list[dict] = []              # bounded detail
_long_holds: list[dict] = []              # bounded detail
_inversion_pairs: set[frozenset] = set()  # each pair reported once
_counts = {"acquires": 0, "inversions": 0, "long_holds": 0}
_DETAIL_CAP = 32

_tls = threading.local()


def set_enabled(flag: bool) -> None:
    """Flip tracing for locks minted AFTER this call (tests, rigs);
    existing plain locks stay plain — the daemon-lifetime discipline."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def set_hold_threshold_ms(ms: float) -> None:
    global _hold_threshold_s
    _hold_threshold_s = max(float(ms), 0.0) / 1e3


def reset() -> None:
    """Drop all recorded evidence (tests and soak-wave windows)."""
    with _state_lock:
        _edges.clear()
        _inversions.clear()
        _long_holds.clear()
        _inversion_pairs.clear()
        for k in _counts:
            _counts[k] = 0


def report() -> dict:
    """Bounded evidence snapshot; the soak stamps its columns from
    this (and from scraped counters for subprocess incarnations)."""
    with _state_lock:
        return {
            "acquires": _counts["acquires"],
            "lock_inversions": _counts["inversions"],
            "long_holds": _counts["long_holds"],
            "inversion_detail": list(_inversions),
            "long_hold_detail": list(_long_holds),
            "edges": sorted(f"{a} -> {b}" for a, b in _edges),
        }


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _metrics():
    # Lazy: utils/metrics mints its own locks through this module, so a
    # module-level import would be circular.
    from kubernetes_tpu_torch.utils import metrics
    return metrics


def _record_acquiring(name: str) -> None:
    """The order edges (and any inversion) of this thread taking ``name``
    on top of the locks it holds.  Traced locks call it before a
    blocking acquire, outside the lock's critical section: bookkeeping
    under the lock itself would hold it across the interpreter lock's
    switches and convoy every thread queued behind it."""
    stack = _held_stack()
    thread = threading.current_thread().name
    inversion = None
    with _state_lock:
        _counts["acquires"] += 1
        for held, _t in stack:
            if held == name:
                continue
            edge = (held, name)
            if edge not in _edges:
                _edges[edge] = thread
            back = (name, held)
            if back in _edges:
                pair = frozenset(edge)
                if pair not in _inversion_pairs:
                    _inversion_pairs.add(pair)
                    _counts["inversions"] += 1
                    inversion = {
                        "locks": [held, name],
                        "thread": thread,
                        "chain": [n for n, _ in stack] + [name],
                        "reverse_thread": _edges[back],
                    }
                    if len(_inversions) < _DETAIL_CAP:
                        _inversions.append(inversion)
    if inversion is not None:
        _metrics().LOCK_INVERSIONS.inc()
        log.warning("lock-order inversion: %s after %s (thread %s; "
                    "reverse order seen on %s)", name,
                    inversion["locks"][0], thread,
                    inversion["reverse_thread"])


def _push_held(name: str) -> None:
    _held_stack().append((name, time.perf_counter()))


def _pop_held(name: str) -> Optional[float]:
    """Seconds this thread held ``name`` (None when it holds none)."""
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name:
            held_s = time.perf_counter() - stack[i][1]
            del stack[i]
            return held_s
    return None


def _report_hold(name: str, held_s: float,
                 hold_override_s: Optional[float] = None) -> None:
    threshold = _hold_threshold_s if hold_override_s is None \
        else hold_override_s
    if threshold > 0 and held_s > threshold:
        with _state_lock:
            _counts["long_holds"] += 1
            if len(_long_holds) < _DETAIL_CAP:
                _long_holds.append({
                    "lock": name,
                    "held_ms": round(held_s * 1e3, 1),
                    "thread": threading.current_thread().name,
                })
        _metrics().LOCK_LONG_HOLDS.inc()
        log.warning("long lock hold: %s held %.0f ms (threshold "
                    "%.0f ms)", name, held_s * 1e3, threshold * 1e3)


class TracedLock:
    """A named ``threading.Lock`` recording acquisition order + holds.

    ``hold_ms`` overrides the global long-hold threshold for this lock
    (0 disables it): a capacity-serializing lock — the tenancy engine
    lock, whose hold time IS the device solve — is not a long-hold bug,
    and its duration is already measured by the solve stage spans.

    Inside the critical section only the hold's start is stamped: the
    order edges are recorded before a blocking acquire and the long-hold
    check runs after the release."""

    _inner_factory = staticmethod(threading.Lock)

    def __init__(self, name: str, hold_ms: Optional[float] = None):
        self.name = name
        self._hold_override_s = None if hold_ms is None \
            else max(float(hold_ms), 0.0) / 1e3
        self._inner = self._inner_factory()

    def _outermost(self) -> bool:
        return True

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        early = blocking and timeout < 0 and self._outermost()
        if early:
            _record_acquiring(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._after_acquire(early)
        return got

    def _after_acquire(self, recorded: bool) -> None:
        if not recorded:
            _record_acquiring(self.name)
        _push_held(self.name)

    def release(self) -> None:
        held_s = self._before_release()
        self._inner.release()
        if held_s is not None:
            _report_hold(self.name, held_s, self._hold_override_s)

    def _before_release(self) -> Optional[float]:
        return _pop_held(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedLock {self.name} {self._inner!r}>"


class TracedRLock(TracedLock):
    """Reentrant variant: order/hold recording happens only on the
    OUTERMOST acquire/release — recursion is not nesting."""

    _inner_factory = staticmethod(threading.RLock)

    def __init__(self, name: str, hold_ms: Optional[float] = None):
        super().__init__(name, hold_ms=hold_ms)
        self._depth = threading.local()

    def _outermost(self) -> bool:
        return getattr(self._depth, "n", 0) == 0

    def _after_acquire(self, recorded: bool) -> None:
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        if depth == 0:
            super()._after_acquire(recorded)

    def _before_release(self) -> Optional[float]:
        depth = getattr(self._depth, "n", 1) - 1
        self._depth.n = depth
        return _pop_held(self.name) if depth == 0 else None


LockLike = Union[threading.Lock, TracedLock]


def make_lock(name: str, hold_ms: Optional[float] = None) -> LockLike:
    """A mutex named ``name`` — traced under KT_LOCKTRACE=1, otherwise
    a PLAIN ``threading.Lock`` (zero added cost on the off path)."""
    return TracedLock(name, hold_ms=hold_ms) if _enabled \
        else threading.Lock()


def make_rlock(name: str, hold_ms: Optional[float] = None
               ) -> "threading.RLock | TracedRLock":
    return TracedRLock(name, hold_ms=hold_ms) if _enabled \
        else threading.RLock()

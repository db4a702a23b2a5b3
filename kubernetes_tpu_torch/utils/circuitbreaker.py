"""Circuit breaker: N consecutive failures open the circuit for T seconds.

The breaker protects a caller from a dead dependency (here: the scheduler
from a dead extender endpoint).  States:

* ``closed``   — calls flow; consecutive failures are counted.
* ``open``     — after ``failure_threshold`` consecutive failures; every
  ``allow()`` is refused until ``reset_timeout`` elapses.
* ``half-open``— one trial call is admitted after the timeout; success
  closes the circuit, failure re-opens it for another timeout.

The reference control plane has no breaker on its extender path — a dead
extender fails every pod's filter call (extender.go:97-125 propagates the
timeout as a scheduling error).  The breaker keeps that per-call semantics
while bounding the blast radius: only the calls made while the breaker is
still closed pay the timeout; once open, the caller can degrade (the
engine falls back to built-in predicates) instead of timing out per pod.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3,
                 reset_timeout: float = 15.0,
                 now: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self._now = now
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive failures while closed
        self._opened_at = 0.0
        self._trial_inflight = False
        self._trial_started = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new: str) -> None:
        old, self._state = self._state, new
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self) -> bool:
        """True when a call may proceed.  While open, refuses until the
        reset timeout elapses, then admits exactly ONE trial (half-open);
        concurrent callers during the trial are refused."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._now() - self._opened_at < self.reset_timeout:
                    return False
                self._transition(HALF_OPEN)
                self._trial_inflight = True
                self._trial_started = self._now()
                return True
            # half-open: only the single trial call is in flight.  A
            # trial whose caller never recorded an outcome (an exception
            # class outside the caller's except list) expires after
            # reset_timeout — the breaker can never wedge half-open.
            if self._trial_inflight and \
                    self._now() - self._trial_started < self.reset_timeout:
                return False
            self._trial_inflight = True
            self._trial_started = self._now()
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._trial_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._trial_inflight = False
            if self._state == HALF_OPEN:
                self._opened_at = self._now()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._opened_at = self._now()
                self._transition(OPEN)

"""APF-style priority-level flow control for the apiserver request loop.

The reference solved control-plane overload with API Priority & Fairness
(KEP-1040: per-priority-level max-inflight, bounded wait queues, 429 +
Retry-After shedding).  This module is the kt-native collapse of that
contract to three levels:

* ``system`` — lease/presence CAS (endpoints, leases) and node status
  heartbeats.  Reserved inflight slots, **no queue**: a renewal either
  runs now or sheds instantly and retries inside its own retry period.
  Because the lane is structurally separate, a pod-create avalanche can
  never timeshare a healthy scheduler's lease renewal past its
  ``renew_deadline`` (ROADMAP 4c).
* ``workload`` — binds, evictions, scheduler watches, solve traffic.
* ``best-effort`` — pod-create storms, LISTs, everything else.

Each queueable level has a max-inflight gate plus a bounded FIFO wait
queue; queue-full or wait-deadline-exceeded sheds with 429 and an honest
Retry-After derived from the wait deadline and current queue occupancy.
Watch streams hold their handler thread for the stream's whole life, so
they are admitted-or-rejected against a dedicated stream cap and never
queued.  ``/healthz``, ``/metrics`` and ``/debug/*`` are exempt: liveness
probes and the observability surface must keep answering precisely when
the server is shedding (upstream APF's ``exempt`` level).

All caps come from the ``KT_APF*`` knob family, read once at construction (the
knobs registry's init-only contract); per-level gauges/counters land in
the shared metric inventory.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.utils import knobs
from kubernetes_tpu_torch.utils.metrics import (APISERVER_INFLIGHT,
                                          APISERVER_QUEUE_DEPTH,
                                          APISERVER_QUEUE_WAIT,
                                          APISERVER_REJECTED)

LEVEL_SYSTEM = "system"
LEVEL_WORKLOAD = "workload"
LEVEL_BEST_EFFORT = "best-effort"
LEVEL_WATCH = "watch"

# Kinds whose traffic IS the control plane's own liveness: shard leases
# and the presence object live in endpoints (leaderelection.py), and the
# leases kind is the reference's coordination.k8s.io successor.
_SYSTEM_RESOURCES = frozenset({"endpoints", "leases"})

# Mux paths outside admission entirely (the exempt level).
_EXEMPT_RESOURCES = frozenset({"healthz", "metrics", "debug"})


def classify(method: str, resource: str, is_watch: bool,
             subresource: str = "") -> Optional[str]:
    """Map one request to its priority level; None = exempt."""
    if resource in _EXEMPT_RESOURCES or not resource:
        return None
    if is_watch:
        return LEVEL_WATCH
    if resource in _SYSTEM_RESOURCES:
        return LEVEL_SYSTEM
    if method == "PUT" and resource == "nodes":
        return LEVEL_SYSTEM  # kubelet status heartbeats
    if resource == "bindings":
        return LEVEL_WORKLOAD
    if subresource == "eviction":
        return LEVEL_WORKLOAD
    if method in ("PUT", "DELETE") and resource == "pods":
        return LEVEL_WORKLOAD  # status publish / preemption deletes
    return LEVEL_BEST_EFFORT


class Ticket:
    """The admission outcome the request loop holds: either admitted
    (release() MUST run when the request — or watch stream — ends) or
    shed (ok=False, retry_after carries the honest hint)."""

    __slots__ = ("ok", "reason", "retry_after", "_release")

    def __init__(self, ok: bool, reason: str = "",
                 retry_after: Optional[float] = None,
                 release: Optional[Callable[[], None]] = None):
        self.ok = ok
        self.reason = reason
        self.retry_after = retry_after
        self._release = release

    def release(self) -> None:
        if self._release is not None:
            self._release()
            self._release = None  # idempotent: finally paths may double-run


_EXEMPT_TICKET = Ticket(True)


class _Level:
    """One priority level: a max-inflight gate plus (when queue_limit >
    0) a bounded FIFO wait queue with a wall-clock wait deadline."""

    def __init__(self, name: str, max_inflight: int, queue_limit: int,
                 queue_wait_s: float, retry_floor: float,
                 now: Callable[[], float] = time.monotonic):
        self.name = name
        self.max_inflight = max(0, int(max_inflight))
        self.queue_limit = max(0, int(queue_limit))
        self.queue_wait_s = max(0.0, float(queue_wait_s))
        self.retry_floor = max(0.05, float(retry_floor))
        self._now = now
        self._cv = threading.Condition(threading.Lock())
        self._inflight = 0
        self._queued = 0
        self.admitted_total = 0
        self.queued_total = 0
        self.rejected: dict[str, int] = {}
        # Labeled children resolved ONCE: acquire/release run per
        # request, and the .labels() tuple build is measurable there.
        self._m_inflight = APISERVER_INFLIGHT.labels(level=name)
        self._m_queue_depth = APISERVER_QUEUE_DEPTH.labels(level=name)
        self._m_queue_wait = APISERVER_QUEUE_WAIT.labels(level=name)
        self._m_inflight.set(0)
        self._m_queue_depth.set(0)

    def _retry_after(self) -> float:
        """Honest hint, caller holds the lock: scale the wait deadline by
        queue occupancy — a full queue earns a longer back-off than a
        freshly saturated gate — floored so clients never busy-spin."""
        occupancy = (self._queued + 1) / max(1, self.queue_limit) \
            if self.queue_limit else 1.0
        return round(max(self.retry_floor,
                         self.queue_wait_s * occupancy), 3)

    def _reject(self, reason: str) -> Ticket:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        APISERVER_REJECTED.labels(level=self.name, reason=reason).inc()
        return Ticket(False, reason, self._retry_after())

    def acquire(self) -> Ticket:
        with self._cv:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                self.admitted_total += 1
                self._m_inflight.set(self._inflight)
                return Ticket(True, release=self._release_slot)
            if self.queue_limit <= 0:
                return self._reject("inflight-full")
            if self._queued >= self.queue_limit:
                return self._reject("queue-full")
            # Park in the bounded FIFO: Condition waiters wake in wait
            # order, so the queue is FIFO by construction.
            self._queued += 1
            self.queued_total += 1
            self._m_queue_depth.set(self._queued)
            t0 = self._now()
            deadline = t0 + self.queue_wait_s
            try:
                while self._inflight >= self.max_inflight:
                    remaining = deadline - self._now()
                    if remaining <= 0:
                        return self._reject("deadline")
                    self._cv.wait(remaining)
                self._inflight += 1
                self.admitted_total += 1
                self._m_inflight.set(self._inflight)
                self._m_queue_wait.observe((self._now() - t0) * 1e6)
                return Ticket(True, release=self._release_slot)
            finally:
                self._queued -= 1
                self._m_queue_depth.set(self._queued)

    def _release_slot(self) -> None:
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            self._m_inflight.set(self._inflight)
            self._cv.notify()

    def report(self) -> dict:
        with self._cv:
            return {"inflight": self._inflight,
                    "maxInflight": self.max_inflight,
                    "queued": self._queued,
                    "queueLimit": self.queue_limit,
                    "admitted": self.admitted_total,
                    "queuedTotal": self.queued_total,
                    "rejected": dict(self.rejected)}


class FlowController:
    """The per-server admission front: classify -> level gate -> ticket.

    Constructed once per serve() (knobs read at init, never per
    request); ``enabled=False`` (KT_APF=0) admits everything through the
    exempt ticket — the unthrottled request loop, one branch."""

    def __init__(self, enabled: bool = True,
                 system_inflight: int = 16, workload_inflight: int = 32,
                 besteffort_inflight: int = 16, watch_inflight: int = 128,
                 queue_limit: int = 64, queue_wait_s: float = 1.0,
                 retry_floor: float = 0.25,
                 now: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self.levels = {
            # system: reserved slots, no queue — renewals shed instantly
            # rather than aging in line behind an avalanche.
            LEVEL_SYSTEM: _Level(LEVEL_SYSTEM, system_inflight, 0,
                                 queue_wait_s, retry_floor, now),
            LEVEL_WORKLOAD: _Level(LEVEL_WORKLOAD, workload_inflight,
                                   queue_limit, queue_wait_s,
                                   retry_floor, now),
            LEVEL_BEST_EFFORT: _Level(LEVEL_BEST_EFFORT,
                                      besteffort_inflight, queue_limit,
                                      queue_wait_s, retry_floor, now),
            # watch: admitted-or-rejected, never queued (a stream holds
            # its handler thread for its whole life).
            LEVEL_WATCH: _Level(LEVEL_WATCH, watch_inflight, 0,
                                queue_wait_s, retry_floor, now),
        }

    @classmethod
    def from_knobs(cls) -> "FlowController":
        return cls(
            enabled=knobs.get_bool("KT_APF"),
            system_inflight=knobs.get_int("KT_APF_SYSTEM_INFLIGHT"),
            workload_inflight=knobs.get_int("KT_APF_WORKLOAD_INFLIGHT"),
            besteffort_inflight=knobs.get_int("KT_APF_BESTEFFORT_INFLIGHT"),
            watch_inflight=knobs.get_int("KT_APF_WATCH_INFLIGHT"),
            queue_limit=knobs.get_int("KT_APF_QUEUE"),
            queue_wait_s=knobs.get_float("KT_APF_QUEUE_WAIT_S"),
            retry_floor=knobs.get_float("KT_APF_RETRY_AFTER_S"))

    def admit(self, method: str, resource: str, is_watch: bool,
              subresource: str = "") -> Ticket:
        if not self.enabled:
            return _EXEMPT_TICKET
        level = classify(method, resource, is_watch, subresource)
        if level is None:
            return _EXEMPT_TICKET
        return self.levels[level].acquire()

    def report(self) -> dict:
        return {"enabled": self.enabled,
                "levels": {name: lvl.report()
                           for name, lvl in self.levels.items()}}

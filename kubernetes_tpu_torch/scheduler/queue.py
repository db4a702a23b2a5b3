"""Pod queue: the scheduler's FIFO (pkg/client/cache/fifo.go), grown into
a priority queue with gang-aware grouping (engine/workloads/).

Same contract the reference's scheduler relies on: items keyed by pod key;
Add/Update replace in place without changing queue position; Delete removes;
Pop blocks until an item is available; re-adding a popped key re-queues it
at the back of its priority class.  ``pop_all`` drains everything at once —
the batched entry point the device solver feeds on.

Two workload-model extensions:

* PRIORITY ORDERING: pops return the highest ``effective_priority``
  first, FIFO within a priority class (the reference's scheduling-queue
  behavior once PodPriority landed).  Priority-less pods (the default 0)
  keep the exact old FIFO order.

* GANG HOLD: a pod carrying ``scheduling.kt.io/gang`` with a declared
  ``gang-size`` > 1 is held aside until that many members are present,
  then all members are released CONTIGUOUSLY at the gang's max member
  priority — a drain therefore sees the whole gang at once, which is what
  makes the solver's all-or-nothing reduction atomic.  Holds expire after
  ``gang_linger_s`` (members released anyway, marked by the annotation
  contract as an incomplete gang the solver will reject) so a gang whose
  member binds got split by faults can still converge instead of
  deadlocking in the hold.

BOUNDED DEGRADATION: past ``high_watermark`` pending items
(``KT_QUEUE_HIGH_WATERMARK``, 0 = unbounded) the queue reports
``degraded()`` and the daemon sheds load gracefully — drains switch to
largest-warmed-bucket-first chunks (``pop_some``) so a storm never
builds one unbounded batch, and NEW gang members bypass the hold (the
solver's all-or-nothing reduction still protects atomicity; what the
bypass drops is only the release-together latency optimization).  A
storm therefore produces slower decisions, never unbounded per-drain
memory growth.
"""

from __future__ import annotations

import heapq
import time
from typing import Optional

import threading

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.utils import knobs

# Degradation threshold default: far above any healthy backlog (the 30k
# density burst fits with headroom) but low enough that a runaway storm
# trips shedding before per-drain allocations hurt.
DEFAULT_HIGH_WATERMARK = 65536


class FIFO:
    # Incomplete gangs release anyway after this long in the hold (see
    # module docstring); the chaos suite compresses it.
    gang_linger_s: float = 5.0

    def __init__(self, high_watermark: Optional[int] = None) -> None:
        self._lock = threading.Condition()
        self._items: dict[str, api.Pod] = {}
        # Load-shedding threshold, read once at construction (the daemon's
        # whole-lifetime discipline, like the stream floor): 0 disables.
        if high_watermark is None:
            high_watermark = knobs.get_int("KT_QUEUE_HIGH_WATERMARK")
        self.high_watermark = high_watermark
        # Churn observability: deepest backlog ever seen (soak artifact).
        self.peak_depth = 0
        # Heap of (-priority, seq, key); stale keys skipped at pop (lazy
        # delete, like the old deque).  Equal priorities pop in seq
        # (FIFO) order.
        self._heap: list[tuple[int, int, str]] = []
        self._seq = 0
        # Gang hold: name -> {key: pod}; deadlines: name -> monotonic
        # release-anyway time.
        self._gang_hold: dict[str, dict[str, api.Pod]] = {}
        self._gang_deadline: dict[str, float] = {}
        self._closed = False

    def _push(self, pod: api.Pod, priority: Optional[int] = None) -> None:
        key = pod.key
        if key not in self._items:
            self._seq += 1
            prio = pod.effective_priority if priority is None else priority
            heapq.heappush(self._heap, (-prio, self._seq, key))
        self._items[key] = pod
        depth = len(self._items) + sum(
            len(h) for h in self._gang_hold.values())
        if depth > self.peak_depth:
            self.peak_depth = depth

    def _degraded_locked(self) -> bool:
        return bool(self.high_watermark) and \
            len(self._items) + sum(len(h)
                                   for h in self._gang_hold.values()) \
            >= self.high_watermark

    def degraded(self) -> bool:
        """True while the backlog sits at/past the high watermark — the
        daemon's signal to shed load (largest-bucket drains, gang holds
        bypassed) and the ``scheduler_queue_degraded`` gauge's truth."""
        with self._lock:
            return self._degraded_locked()

    def add(self, pod: api.Pod) -> None:
        with self._lock:
            key = pod.key
            gname, gsize = pod.gang, pod.gang_size
            if gname and gsize > 1 and self._degraded_locked():
                # Degraded: bypass the hold — holding thousands of gangs
                # during a storm defers work the drain could be shedding,
                # and an incomplete gang is still admitted atomically (or
                # rejected whole) by the solver's reduction.
                gname = ""
            if gname and gsize > 1 and key not in self._items:
                hold = self._gang_hold.setdefault(gname, {})
                if not hold:
                    self._gang_deadline[gname] = \
                        time.monotonic() + self.gang_linger_s
                hold[key] = pod
                if len(hold) < gsize:
                    # Wake every blocked popper even though nothing is
                    # poppable yet: a timeout=None popper computed its
                    # wait BEFORE this hold's deadline existed and must
                    # re-clip to it, or the linger flush never fires.
                    self._lock.notify_all()
                    return
                # A whole gang lands at once: one notify() would wake a
                # single schedule_one worker for gsize items.
                self._release_gang(gname)
                self._lock.notify_all()
            else:
                self._push(pod)
                self._lock.notify()

    def _release_gang(self, name: str) -> None:
        """Push every held member contiguously at the gang's max member
        priority (caller holds the lock)."""
        members = self._gang_hold.pop(name, {})
        self._gang_deadline.pop(name, None)
        if not members:
            return
        prio = max(p.effective_priority for p in members.values())
        for pod in members.values():
            self._push(pod, priority=prio)

    def _flush_overdue_gangs(self) -> None:
        now = time.monotonic()
        for name in [n for n, dl in self._gang_deadline.items()
                     if dl <= now]:
            self._release_gang(name)

    def update(self, pod: api.Pod) -> None:
        with self._lock:
            key = pod.key
            for hold in self._gang_hold.values():
                if key in hold:
                    hold[key] = pod
                    return
            if key in self._items:
                self._items[key] = pod
                return
        self.add(pod)

    def delete(self, pod_key: str) -> None:
        with self._lock:
            self._items.pop(pod_key, None)
            for name, hold in list(self._gang_hold.items()):
                if hold.pop(pod_key, None) is not None and not hold:
                    self._gang_hold.pop(name, None)
                    self._gang_deadline.pop(name, None)
            # Lazy removal: stale heap keys are skipped at pop time.

    def delete_matching(self, pred) -> int:
        """Remove every queued/held pod whose OBJECT matches ``pred`` —
        the shard-handoff drop: an incarnation that lost a shard's lease
        sheds that shard's pods in one pass instead of popping (and
        half-scheduling) them.  Returns the number removed."""
        removed = 0
        with self._lock:
            for key in [k for k, p in self._items.items() if pred(p)]:
                self._items.pop(key, None)
                removed += 1
            for name, hold in list(self._gang_hold.items()):
                for key in [k for k, p in hold.items() if pred(p)]:
                    hold.pop(key, None)
                    removed += 1
                if not hold:
                    self._gang_hold.pop(name, None)
                    self._gang_deadline.pop(name, None)
        return removed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items) + sum(
                len(h) for h in self._gang_hold.values())

    def __contains__(self, pod_key: str) -> bool:
        with self._lock:
            return pod_key in self._items or any(
                pod_key in h for h in self._gang_hold.values())

    def held_gangs(self) -> dict[str, int]:
        """Gang name -> held member count (observability)."""
        with self._lock:
            return {n: len(h) for n, h in self._gang_hold.items()}

    def pop(self, timeout: Optional[float] = None) -> Optional[api.Pod]:
        """Blocking pop of the highest-priority (FIFO within class) pod;
        None on close/timeout.  Waits are clipped to the nearest gang
        hold deadline so a blocked popper (even ``timeout=None``) wakes
        to flush an overdue gang — an incomplete-gang hold must expire
        by wall clock, not only when another add happens to notify."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                self._flush_overdue_gangs()
                while self._heap:
                    _, _, key = heapq.heappop(self._heap)
                    pod = self._items.pop(key, None)
                    if pod is not None:
                        return pod
                if self._closed:
                    return None
                remaining = None if end is None \
                    else end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                wait_t = remaining
                if self._gang_deadline:
                    until_flush = max(
                        min(self._gang_deadline.values())
                        - time.monotonic(), 0.01)
                    wait_t = until_flush if wait_t is None \
                        else min(wait_t, until_flush)
                self._lock.wait(timeout=wait_t)

    def pop_all(self, wait_first: bool = True,
                timeout: Optional[float] = None) -> list[api.Pod]:
        """Drain the whole pending queue (blocks for the first item when
        ``wait_first``).  The batched scheduling entry point; held gangs
        stay held until complete (or overdue)."""
        first = self.pop(timeout=timeout) if wait_first else None
        out = [first] if first is not None else []
        with self._lock:
            self._flush_overdue_gangs()
            while self._heap:
                _, _, key = heapq.heappop(self._heap)
                pod = self._items.pop(key, None)
                if pod is not None:
                    out.append(pod)
        return out

    def pop_some(self, limit: int, wait_first: bool = True,
                 timeout: Optional[float] = None) -> list[api.Pod]:
        """Drain at most ``limit`` pods (highest priority first) — the
        degraded drain's entry point: each iteration solves one bounded,
        pre-warmed bucket instead of materializing the whole storm as a
        single batch, so per-drain memory stays O(limit) regardless of
        backlog depth."""
        if limit <= 0:
            return self.pop_all(wait_first=wait_first, timeout=timeout)
        first = self.pop(timeout=timeout) if wait_first else None
        out = [first] if first is not None else []
        with self._lock:
            self._flush_overdue_gangs()
            while self._heap and len(out) < limit:
                _, _, key = heapq.heappop(self._heap)
                pod = self._items.pop(key, None)
                if pod is not None:
                    out.append(pod)
        return out

"""Deadline-driven batch formation: the serving path's "wait vs solve"
decision, in exactly one place.

The batched drain is only viable as a latency-SLO system if an
individual pod's submit->bind time stays bounded while batches form.
LLM serving systems solve the same tension with continuous/deadline
micro-batching — solve whatever arrived within T rather than waiting
for a batch to fill — and this module is that discipline for the
scheduling queue:

* ``KT_BATCH_DEADLINE_MS`` is the formation budget: once the first pod
  of a batch has been popped, the former tops the batch up from the
  arrival stream for at most that long.  0 (the default) disables
  lingering entirely — a drain solves whatever the pop returned, the
  pre-serving behavior.
* The former exits EARLY on either of two signals: the batch reached
  its adaptive TARGET bucket (a warm bucket's worth arrived — solve
  now), or the arrival stream went IDLE for ``IDLE_WINDOW_S`` (once the
  stream is silent, further lingering is pure latency that cannot grow
  the batch — a lone arrival hands off ~60 ms after it lands, not a
  full deadline later).  A live trickle keeps landing pods inside the
  idle window, so it coalesces toward the deadline; a finished burst
  stops lingering almost immediately.
* The target adapts between the pre-warmed ladder's floor bucket and
  the stream chunk: deadline exits with a small batch shrink it toward
  the floor (trickle — stop waiting for a burst that is not coming),
  filling it grows it toward the chunk (burst — one bigger solve beats
  N floor-bucket solves).  The target is always a pre-warmed ladder
  bucket, so batch formation can never steer a drain onto a shape the
  startup prewarm did not trace.
* DEGRADATION WINS: past the queue's high watermark the former skips
  the deadline entirely and returns one largest-warmed-bucket chunk
  (``pop_some``) immediately — a storm needs shedding, not lingering.
* Held gangs are invisible to the former (the queue releases a gang
  only when complete or overdue), so a deadline firing mid-hold can
  never split a gang across two batches.

``KT_COALESCE`` (seconds — the retired arrival-coalescing linger knob)
is kept as a deprecated alias: it maps onto the deadline so old rig
configs keep their meaning, but the linger loop it used to drive is
gone — the former is the only place that decides "wait vs solve".

Each formed batch records ``scheduler_batch_formation_latency_
microseconds`` and bumps ``scheduler_batch_deadline_misses_total`` when
hand-off overran the deadline (plus a 25% grace — the GIL, a gang
flush, or a slow arrival race ate the budget).  Per-pod admission
timestamps (stamped at enqueue, surviving requeues) ride the pod object
to the commit worker, which closes the loop with
``scheduler_e2e_decision_latency_microseconds`` at bind ack.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.utils import knobs
from kubernetes_tpu_torch.utils import metrics as metrics_mod
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("batchformer")

# Poll period while lingering inside the deadline, and how long a
# silent arrival stream must stay silent before it counts as "went
# idle".  60 ms ≈ three inter-arrival gaps of a 50 pods/s trickle: a
# live trickle almost always lands another pod inside the window (the
# batch keeps coalescing toward the deadline), while a finished burst
# or a lone arrival stops lingering ~60 ms after its last pod — once
# the stream is idle, more waiting is pure latency that cannot grow
# the batch.
POLL_S = 0.005
IDLE_WINDOW_S = 0.06

# A hand-off later than deadline * (1 + grace) counts as a deadline miss.
MISS_GRACE = 0.25


def _env_deadline_s() -> float:
    """Resolve the formation deadline from the environment, once per
    former (the daemon-lifetime discipline every other knob follows).
    ``KT_BATCH_DEADLINE_MS`` wins; ``KT_COALESCE`` (seconds) is the
    deprecated alias for rigs predating the former."""
    raw = knobs.get("KT_BATCH_DEADLINE_MS")
    if raw:
        try:
            return max(float(raw), 0.0) / 1e3
        except ValueError:
            log.warning("bad KT_BATCH_DEADLINE_MS=%r; deadline off", raw)
            return 0.0
    legacy = knobs.get("KT_COALESCE")
    if legacy:
        try:
            val = max(float(legacy), 0.0)
        except ValueError:
            return 0.0
        if val:
            log.warning("KT_COALESCE is deprecated; treating %ss as "
                        "KT_BATCH_DEADLINE_MS=%d", legacy, int(val * 1e3))
        return val
    return 0.0


def prune_first_seen_fair(registry: dict, bound: int,
                          group_of: Optional[Callable[[str], str]] = None
                          ) -> dict:
    """Shrink a first-seen registry to ``bound`` entries PER-GROUP-FAIR.

    The registry backs the e2e decision-latency SLO: losing a pod's
    stamp silently resets its clock.  Global oldest-first pruning has a
    multi-tenant failure mode — one tenant's flood of fresh stamps makes
    every OTHER tenant's (older, still-live) stamps the global-oldest,
    so the noisy tenant evicts the quiet tenants' clocks.  This prune is
    fair instead: entries are dropped oldest-first WITHIN whichever
    group currently holds the most entries, so shedding always lands on
    the flooder and a quiet group's stamps survive untouched.

    ``group_of`` maps a registry key to its fairness group (default: the
    key's namespace — the tenant proxy, and the right boundary even
    without tenancy configured)."""
    if len(registry) <= bound:
        return registry
    if group_of is None:
        def group_of(key: str) -> str:
            return key.partition("/")[0]
    import heapq
    groups: dict[str, list] = {}
    for key, ts in registry.items():
        groups.setdefault(group_of(key), []).append((ts, key))
    for items in groups.values():
        # Newest first, so shedding pops the group's OLDEST from the end.
        items.sort(reverse=True)
    heap = [(-len(items), name) for name, items in groups.items()]
    heapq.heapify(heap)
    excess = len(registry) - bound
    out = dict(registry)
    while excess > 0 and heap:
        neg, name = heapq.heappop(heap)
        items = groups[name]
        if not items:
            continue
        _, key = items.pop()
        out.pop(key, None)
        excess -= 1
        if items:
            heapq.heappush(heap, (-len(items), name))
    return out


def stamp_first_seen(pod) -> None:
    """Stamp the pod OBJECT's queue-admission time (idempotent).  The
    daemon's authoritative record is its key-indexed first-seen
    registry (watch redeliveries arrive as fresh objects, which an
    object-only stamp would let reset the SLO clock); this helper
    serves rigs driving a bare queue."""
    if getattr(pod, "_kt_first_seen", None) is None:
        pod._kt_first_seen = time.perf_counter()


def first_seen(pod) -> Optional[float]:
    return getattr(pod, "_kt_first_seen", None)


@dataclass
class FormedBatch:
    """One formed drain batch plus its formation telemetry."""

    pods: list
    degraded: bool = False
    # When formation began waiting (the queue_wait stage's backdate).
    t_wait: float = 0.0
    # First-pod-popped -> hand-off (0 for an empty/immediate batch).
    formation_s: float = 0.0
    deadline_missed: bool = False
    # The adaptive target bucket in force when this batch formed.
    target: int = 0


@dataclass
class BatchFormer:
    """Forms drain batches from a scheduling FIFO under a deadline.

    ``queue`` is the daemon's FIFO; ``ladder_fn`` returns the pre-warmed
    bucket ladder (``Scheduler.effective_ladder``) and ``chunk_fn`` the
    stream chunk size — the target's floor and ceiling; ``cap_fn``
    returns the degraded-mode drain cap."""

    queue: object
    ladder_fn: Callable[[], list] = lambda: []
    chunk_fn: Callable[[], int] = lambda: 0
    cap_fn: Callable[[], int] = lambda: 0
    deadline_s: float = field(default_factory=_env_deadline_s)
    # Adaptive target bucket; None until the first ladder read.
    _target: Optional[int] = None

    def _buckets(self) -> list[int]:
        """The target's menu: the warmed ladder, capped at the stream
        chunk (a bigger target than one chunk buys nothing — the stream
        path chunks it right back down)."""
        ladder = sorted(set(self.ladder_fn() or []))
        chunk = self.chunk_fn() or 0
        if chunk:
            ladder = [b for b in ladder if b <= chunk] or [chunk]
        return ladder or [1]

    @property
    def target(self) -> int:
        buckets = self._buckets()
        if self._target is None or self._target not in buckets:
            self._target = buckets[0]
        return self._target

    def _adapt(self, formed: int, hit_deadline: bool) -> None:
        """Shrink toward the floor under trickle, grow toward the chunk
        under burst — one bucket step per drain, so one anomalous batch
        cannot whiplash the target."""
        buckets = self._buckets()
        i = buckets.index(self.target)
        if formed >= self.target and i + 1 < len(buckets):
            self._target = buckets[i + 1]
        elif hit_deadline and formed < self.target and i > 0:
            self._target = buckets[i - 1]

    def form(self, wait_first: bool = True,
             timeout: Optional[float] = None) -> FormedBatch:
        """Pop + top-up one drain batch.  Blocking (up to ``timeout``)
        only for the FIRST pod; the deadline clock starts when it
        lands."""
        t_wait = time.perf_counter()
        if self.queue.degraded():
            # Load shedding: one largest-warmed-bucket chunk, no linger
            # — degradation always wins over the deadline.
            metrics_mod.DEGRADED_DRAINS.inc()
            pods = self.queue.pop_some(self.cap_fn(),
                                       wait_first=wait_first,
                                       timeout=timeout)
            formation_s = time.perf_counter() - t_wait
            if pods:
                # Degraded formation is still a formation: the histogram
                # must count every drain or formation-count == drain-count
                # breaks exactly when the daemon is shedding load.
                metrics_mod.BATCH_FORMATION_LATENCY.observe(
                    formation_s * 1e6)
            return FormedBatch(pods, degraded=True, t_wait=t_wait,
                               formation_s=formation_s)
        pods = self.queue.pop_all(wait_first=wait_first, timeout=timeout)
        if not pods:
            return FormedBatch([], t_wait=t_wait)
        deadline_s = self.deadline_s
        chunk = self.chunk_fn() or 0
        cap = chunk if chunk else (1 << 62)
        t0 = time.perf_counter()
        hit_deadline = False
        if deadline_s > 0 and len(pods) < cap:
            target = self.target
            deadline_at = t0 + deadline_s
            idle_since = None
            while len(pods) < cap:
                now = time.perf_counter()
                remaining = deadline_at - now
                if remaining <= 0:
                    hit_deadline = True
                    break
                if len(pods) >= target:
                    break  # a warm bucket's worth arrived: solve now
                if idle_since is not None and \
                        now - idle_since >= IDLE_WINDOW_S:
                    # The stream went quiet: lingering further is pure
                    # latency — it cannot grow the batch.
                    break
                time.sleep(min(POLL_S, remaining))
                more = self.queue.pop_all(wait_first=False)
                if more:
                    pods.extend(more)
                    idle_since = None
                elif idle_since is None:
                    idle_since = time.perf_counter()
                if self.queue.degraded():
                    break  # a storm crossed the watermark mid-linger
            self._adapt(len(pods), hit_deadline)
            # One object per key per batch: the linger's second pop can
            # re-return a pod that was requeued (bind-conflict backoff)
            # or watch-redelivered between pops — and a duplicated key
            # poisons the commit path (the bulk assume skips the second
            # copy, and the skip-filter then drops BOTH, stranding the
            # pod assumed-but-never-bound).  Keep the FIRST object.
            seen_keys: set = set()
            uniq = [pod for pod in pods
                    if not (pod.key in seen_keys
                            or seen_keys.add(pod.key))]
            if len(uniq) != len(pods):
                pods = uniq
        formation_s = time.perf_counter() - t0
        metrics_mod.BATCH_FORMATION_LATENCY.observe(formation_s * 1e6)
        missed = deadline_s > 0 and \
            formation_s > deadline_s * (1.0 + MISS_GRACE)
        if missed:
            metrics_mod.BATCH_DEADLINE_MISSES.inc()
        return FormedBatch(pods, t_wait=t_wait, formation_s=formation_s,
                           deadline_missed=missed, target=self.target)

"""The scheduling daemon loop.

Counterpart of ``kubernetes_tpu/scheduler/scheduler.py`` on the port's
engine.  The reference's ``Scheduler`` (plugin/pkg/scheduler/
scheduler.go:46-154) runs ``scheduleOne`` forever: blocking pop ->
Schedule -> optimistic AssumePod -> async Bind; on bind failure ForgetPod
+ error handler with per-pod backoff requeue (factory.go:512-556).  This
daemon keeps that state machine and adds the batched drain:
``schedule_pending`` pops the queue and solves it as one device batch
(or a stream of chunks), assuming and binding every placement.

The drain itself — batch formation, mode routing, the overlapped
solve/commit worker and crash handling — lives in
``scheduler.pipeline.DrainPipeline``; this module keeps the commit-side
state machine (assume/bind, preemption, failure requeue, backoff) the
pipeline calls back into, plus the daemon lifecycle (run loops, prewarm,
stop/abandon).  A classified device fault on the single-pod path
requeues the pod through backoff (there is no host engine to decide it).
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver.memstore import ConflictError
from kubernetes_tpu_torch.engine.extender_client import ExtenderError
from kubernetes_tpu_torch.engine.guard import DeviceFault
from kubernetes_tpu_torch.engine.generic_scheduler import FitError, GenericScheduler
from kubernetes_tpu_torch.scheduler.backoff import PodBackoff
from kubernetes_tpu_torch.scheduler.batchformer import first_seen
from kubernetes_tpu_torch.scheduler.binder import Binder, BindConflict, InMemoryBinder
from kubernetes_tpu_torch.scheduler.flightrecorder import FlightRecorder
from kubernetes_tpu_torch.scheduler.queue import FIFO
from kubernetes_tpu_torch.utils import knobs, threadreg
from kubernetes_tpu_torch.utils import metrics as metrics_mod
from kubernetes_tpu_torch.utils import trace as trace_mod
from kubernetes_tpu_torch.utils.events import EventRecorder
from kubernetes_tpu_torch.utils.logging import get_logger
from kubernetes_tpu_torch.utils.metrics import SchedulerMetrics
from kubernetes_tpu_torch.utils.trace import stage


def _record_bind_failure(err) -> str:
    """409/CAS conflicts and transport faults are different operator
    stories: count them apart (both forget + requeue with backoff).
    Returns the attempts-counter result label for the failure class."""
    if isinstance(err, (BindConflict, ConflictError)):
        metrics_mod.BIND_CONFLICTS.inc()
        return "bind_conflict"
    metrics_mod.BIND_FAILURES.inc()
    return "bind_error"

log = get_logger("daemon")

DEFAULT_SCHEDULER_NAME = api.DEFAULT_SCHEDULER_NAME


def bucket_ladder(floor: int, stream_threshold: int, pad_limit: int,
                  stream_chunk: int = 0) -> list[int]:
    """The fixed set of chunk sizes a daemon's streamed drains run at,
    as a pure function of its configuration (the JAX package's ladder,
    value for value).  Two sources: the stream chunk, included only
    when the chunked path is reachable (``stream_threshold`` set — at
    its unset sentinel every large drain takes the one-shot path); and
    the small-drain buckets: the floor itself (possibly non-pow2) plus
    each pow2 strictly above it up to the pow2 ceiling of the largest
    small drain."""
    ladder: set[int] = set()
    if stream_threshold < (1 << 62):
        ladder.add(stream_chunk or min(stream_threshold, 8192))
    small_top = min(stream_threshold, pad_limit)
    if small_top > 1:
        floor = max(floor, 1)
        # pow2 ceiling of the largest small drain (small_top - 1).
        top_bucket = 1 << max(small_top - 2, 0).bit_length()
        ladder.add(floor)
        # Reachable buckets are max(pow2ceil(len), floor): the floor,
        # then pow2 values strictly above it (floor=300 gives
        # {300, 512, ...}, never 600).
        b = 1 << floor.bit_length()  # smallest pow2 > floor
        while b <= top_bucket:
            ladder.add(b)
            b <<= 1
    return sorted(ladder)


def prewarm_plan(ladder: list[int], cuda: bool = True,
                 preempt: bool = True, joint: bool = True) -> list[str]:
    """The warm-up plan: every key ``prewarm()`` runs for a given ladder,
    without touching a device.  Torch compiles nothing per shape, so the
    plan names what a live drain would otherwise pay on the clock: the
    ``nvcc`` build of the kernel library (on a card), one scan-kernel
    launch per ladder bucket (``scan_chunk@<bucket>``: a stream chunk of
    that many pods), one launch of the step loop's select kernel and of
    the single-pod select kernel (both always one row wide), the victim
    solve at the cluster's (N, V) shape, the topology spread planes
    (``topo_planes``: their gather and float64 contraction) and a
    spread-constrained one-shot drain at the floor bucket, and, with the
    joint solve on, a joint drain at the floor bucket.  The topology and
    joint keys are the JAX package's program keys."""
    progs = ["build"] if cuda else []
    progs += [f"scan_chunk@{b}" for b in ladder]
    progs += ["select_rows@1", "select_hosts@1"]
    if preempt:
        progs.append("victim_solve")
    if ladder:
        progs += ["topo_planes", f"oneshot_topo@{min(ladder)}"]
    if joint and ladder:
        progs.append(f"joint@{min(ladder)}")
    return sorted(progs)


@dataclass
class SchedulerConfig:
    """The reference's scheduler.Config (scheduler.go:46-77)."""

    algorithm: GenericScheduler
    binder: Binder = field(default_factory=InMemoryBinder)
    recorder: EventRecorder = field(default_factory=EventRecorder)
    metrics: SchedulerMetrics = field(default_factory=SchedulerMetrics)
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    # Pod-condition updater analogue (factory.go:589-600); called with
    # (pod, reason, message) when scheduling fails.
    condition_updater: Optional[Callable[[api.Pod, str, str], None]] = None
    async_bind: bool = True
    # Decision flight recorder (/debug/scheduler/decisions); None disables
    # recording entirely (and the failure-detail device pass with it).
    flight_recorder: Optional[FlightRecorder] = \
        field(default_factory=FlightRecorder)


class Scheduler:
    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.queue = FIFO()
        # Failure-requeue backoff, env-tunable (the reference's
        # --pod-backoff knobs): chaos/soak rigs and latency-sensitive
        # fleets compress it; the defaults are the reference's 1s -> 60s.
        self.backoff = PodBackoff(
            default_duration=knobs.get_float("KT_POD_BACKOFF_S"),
            max_duration=knobs.get_float("KT_POD_BACKOFF_MAX_S"))
        # Stream floor, read ONCE at startup: the pre-warm pass and the
        # small-drain bucket computation must agree on the ladder for the
        # daemon's whole lifetime (a later env change would mint shapes
        # the warmup never traced).
        self.stream_min_bucket = knobs.get_int(
            "KT_STREAM_MIN_BUCKET", default=self.STREAM_MIN_BUCKET)
        # Overlapped solve/bind pipeline: while the device scans chunk N,
        # chunk N-1's readback/assume/bind runs on a dedicated commit
        # worker; at most this many chunks are in flight uncommitted
        # (0 = commit synchronously on the drain thread, the pre-pipeline
        # behavior).
        self.pipeline_window = knobs.get_int("KT_PIPELINE_WINDOW")
        # Workload-subsystem prewarm timings (string-keyed; see
        # _prewarm_workloads) — {} until prewarm() runs.
        self.workloads_prewarm_s: dict = {}
        # Per-key warm-up seconds and kernel builds observed during
        # prewarm (the warm-start audit) — {} until prewarm() runs.
        self.prewarm_cache_stats: dict = {}
        # Live queue depth at expose time (a set-per-mutation gauge would
        # put two lock acquisitions on every enqueue).
        config.metrics.queue_depth.set_fn(lambda: len(self.queue))
        # Bounded-queue degradation surface (live at expose, same reason;
        # the watermark reads through so rigs that retune it after
        # construction stay honest).
        config.metrics.queue_high_watermark.set_fn(
            lambda: self.queue.high_watermark)
        config.metrics.queue_degraded.set_fn(
            lambda: 1.0 if self.queue.degraded() else 0.0)
        # Failure-detail cooldown: an unschedulable pod requeues every
        # backoff period and must not re-pay the explain device pass each
        # round.
        self._explain_ts: dict[str, float] = {}
        # First-seen registry for the e2e decision-latency SLO, keyed by
        # pod key: watch redeliveries (a condition write, any MODIFIED)
        # arrive as FRESH pod objects, so an object-only stamp would
        # reset the SLO clock on exactly the retried tail pods the
        # histogram exists to measure.  Entries clear at bind ack;
        # leftovers (pods deleted while pending) are pruned when the
        # registry outgrows its bound.
        self._first_seen: dict[str, float] = {}
        # The multi-tenant solver service's attachment point (the tenancy
        # slice); None = the single-owner engine, the only mode here.
        self.tenancy_service = None
        self._stop = threading.Event()
        self._bind_threads: list[threading.Thread] = []
        # Single requeue worker over a timer heap (a thread per failed pod
        # would explode on a large unschedulable batch).
        self._requeue_heap: list[tuple[float, int, api.Pod]] = []
        self._requeue_cv = threading.Condition()
        self._requeue_seq = 0
        self._requeue_thread: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None
        # THE drain path: every batched drain goes queue -> DrainPipeline
        # (form -> solve -> commit); constructed last so the former can
        # read the daemon's ladder/chunk/cap knobs.
        from kubernetes_tpu_torch.scheduler.pipeline import DrainPipeline
        self.pipeline = DrainPipeline(self)

    @property
    def _commit_pool(self):
        """The overlapped commit worker now lives on the pipeline; kept
        as a read-through so rigs inspecting the daemon keep working."""
        return self.pipeline._commit_pool

    @property
    def accumulate_s(self) -> float:
        """DEPRECATED alias for the batch former's deadline (the old
        arrival-coalescing linger window): reads/writes map onto
        ``pipeline.former.deadline_s`` so pre-serving rig configs keep
        their meaning, but the linger loop itself is gone — the former
        is the only place that decides wait-vs-solve."""
        return self.pipeline.former.deadline_s

    @accumulate_s.setter
    def accumulate_s(self, value: float) -> None:
        self.pipeline.former.deadline_s = max(float(value), 0.0)

    # -- queue feed (the reflector-handler analogue) ---------------------

    def responsible_for(self, pod: api.Pod) -> bool:
        """Multi-scheduler dispatch by annotation (factory.go:428-434)."""
        return pod.scheduler_name == self.config.scheduler_name

    def enqueue(self, pod: api.Pod) -> None:
        if self.responsible_for(pod) and not pod.node_name:
            # Admission timestamp for the e2e decision-latency SLO
            # (first-seen -> bind ack): the registry keeps the EARLIEST
            # admission per key, so requeues and watch redeliveries
            # (fresh objects) never reset the clock; the object carries
            # a copy for the bind path.
            pod._kt_first_seen = self._first_seen.setdefault(
                pod.key, time.perf_counter())
            if len(self._first_seen) > 65536:
                self._prune_first_seen()
            self.queue.add(pod)

    def _prune_first_seen(self) -> None:
        """Drop registry entries for pods no longer anywhere in flight
        (deleted while pending): keep keys still queued, in backoff, or
        assumed — everything else bound (cleared at ack) or vanished.
        If the registry is STILL over its bound, shed per-namespace-fair
        (oldest first within the largest namespace groups), so one
        namespace's flood never resets another's SLO clock."""
        from kubernetes_tpu_torch.scheduler.batchformer import \
            prune_first_seen_fair
        cache = self.config.algorithm.cache
        with self._requeue_cv:
            backoff = {pod.key for _, _, pod in self._requeue_heap}
        self._first_seen = {
            k: t for k, t in self._first_seen.items()
            if k in backoff or k in self.queue or cache.contains(k)}
        if len(self._first_seen) > 65536:
            self._first_seen = prune_first_seen_fair(
                self._first_seen, 65536)

    # -- one-pod path (scheduleOne, scheduler.go:93-154) -----------------

    def schedule_one(self, timeout: Optional[float] = None) -> bool:
        """Pop + schedule + assume + bind one pod; False if queue empty."""
        pod = self.queue.pop(timeout=timeout)
        if pod is None:
            return False
        start = time.perf_counter()
        root = trace_mod.begin_span("schedule_one", pod=pod.key)
        try:
            try:
                dest = self.config.algorithm.schedule(pod)
            except DeviceFault as fault:
                # Counted by the guard where it struck; with no host
                # engine to decide the pod, it requeues with backoff.
                self._handle_failure(pod, "SchedulingError",
                                     f"device fault: {fault}",
                                     result="error")
                return True
            except (FitError, ExtenderError) as err:
                if isinstance(err, FitError):
                    # The one-pod preemption path (scheduleOne's
                    # post-priority behavior): an executed victim solve
                    # turns the FitError into a nominated placement.
                    filled = self._preempt_failures([pod], [None], {})
                    if filled[0] is not None:
                        pod.nominated_node = filled[0]
                        self._assume_and_bind(pod, filled[0], start)
                        return True
                # Per-predicate failure counts straight off the FitError
                # (failed_predicates: node -> [names]) for the recorder.
                counts: dict[str, int] = {}
                for preds in getattr(err, "failed_predicates",
                                     {}).values():
                    for name in preds:
                        counts[name] = counts.get(name, 0) + 1
                self._handle_failure(pod, "FailedScheduling", str(err),
                                     failed_predicates=counts or None)
                return True
            algo_us = (time.perf_counter() - start) * 1e6
            self.config.metrics.scheduling_algorithm_latency.observe(algo_us)
            if self.config.flight_recorder is not None:
                self.config.flight_recorder.record_batch(
                    [pod], [dest], trace_id=root.trace_id,
                    duration_s=algo_us / 1e6)
            self._assume_and_bind(pod, dest, start)
            return True
        finally:
            root.end()

    # -- batched path (the device drain) ---------------------------------

    # Queue sizes past this drain through the chunked device pipeline
    # (assume/bind of chunk k overlaps the device scan of chunk k+1).
    # Unset by default, as in the JAX package: every drain of _PAD_LIMIT
    # pods or more takes the one-shot path.  KT_STREAM_CHUNK sets it.
    STREAM_THRESHOLD = knobs.get_int("KT_STREAM_CHUNK") or (1 << 62)

    # Drains below this size are routed through the stream path with a
    # power-of-two chunk (live-flag padded), so a live-arrival workload
    # runs at most log2 distinct chunk sizes, the ladder prewarm covers.
    _PAD_LIMIT = 4096

    # Floor on the small-drain bucket (pad rows are inert): the JAX
    # package's value, so both daemons route every drain alike.  The
    # effective value is captured ONCE per daemon in __init__
    # (self.stream_min_bucket), so the ladder prewarm covers never moves.
    STREAM_MIN_BUCKET = 256

    def schedule_pending(self, wait_first: bool = True,
                         timeout: Optional[float] = None) -> int:
        """Drain the queue through the pipeline (form -> solve ->
        commit; scheduler/pipeline.py).  Returns the number of pods
        popped (scheduled or failed).  This is the ONLY batched drain
        entry path — one-shot, streamed, and joint are solve modes the
        pipeline routes internally, not separate control flows."""
        return self.pipeline.drain(wait_first=wait_first, timeout=timeout)

    def _record_batch_decisions(self, pods: list, placements: list,
                                trace_id: str, duration_s: float) -> None:
        """Feed the flight recorder: the placement map always, plus the
        engine's per-predicate failure detail for failed pods not
        explained within the last 30 s (the explain pass costs a small
        device evaluation, paid only when a drain actually failed pods)."""
        recorder = self.config.flight_recorder
        if recorder is None:
            return
        detail = None
        failed = [pod for pod, dest in zip(pods, placements)
                  if dest is None]
        if failed:
            now = time.monotonic()
            fresh = [p for p in failed
                     if now - self._explain_ts.get(p.key, -1e9) > 30.0]
            if fresh:
                try:
                    detail = self.config.algorithm.explain_failures(fresh)
                except Exception:  # noqa: BLE001 — explain is best-effort
                    log.exception("failure-detail pass crashed; recording "
                                  "decisions without predicate counts")
                for p in fresh:
                    self._explain_ts[p.key] = now
                if len(self._explain_ts) > 4096:
                    cutoff = now - 30.0
                    self._explain_ts = {
                        k: t for k, t in self._explain_ts.items()
                        if t > cutoff}
        recorder.record_batch(pods, placements, trace_id=trace_id,
                              duration_s=duration_s,
                              failure_detail=detail)

    def _assume_and_bind_batch(self, pods: list[api.Pod],
                               placements: list, start: float,
                               failure_info: Optional[dict] = None
                               ) -> None:
        """Bulk assume (vectorized), then bind; failures forget + requeue.
        Already-cached pods are skipped, matching the single-pod loop's
        log-and-proceed on assume errors (scheduler.go:116-120).

        ``failure_info`` maps pod key -> (message, result label) for
        failures with a workload-specific story (gang rejections).
        Unschedulable priority pods go through the preemption pass AFTER
        the batch's placements are assumed — the victim solve must see
        this drain's own commitments (else a pod that failed on in-batch
        contention would "preempt" with zero victims onto a node the
        drain just filled, overcommitting it) — and the drain's own
        placements are protected from eviction; an executed decision
        (victims evicted) promotes the pod to placed and it is assumed
        alongside."""
        failure_info = failure_info or {}
        placed = [(pod, dest) for pod, dest in zip(pods, placements)
                  if dest is not None]
        # Sanity-gate backstop (engine/guard.py): a pod whose last solve
        # was gate-rejected and never cleanly re-solved must not bind.
        # Structurally unreachable (the gate raises before placements
        # exist), so the check costs one bool when the rejected set is
        # empty — but a future refactor that swallows DeviceFault would
        # trip the ratcheted scheduler_sanity_rejected_binds_total here
        # instead of binding garbage.
        gd = getattr(self.config.algorithm, "guard", None)
        if gd is not None and gd.enabled and gd.has_rejections():
            placed, refused = gd.filter_rejected(placed)
            for pod, _ in refused:
                self._handle_failure(
                    pod, "SchedulingError",
                    "placement from a sanity-gate-rejected solve refused",
                    result="error")
        with stage("assume", pods=len(placed)):
            skipped = set(self.config.algorithm.cache.assume_pods(
                placed, strict=False,
                agg_handoff=self.config.algorithm.take_agg_handoff()))
        if skipped:
            placed = [(pod, dest) for pod, dest in placed
                      if pod.key not in skipped]
        filled = self._preempt_failures(
            pods, placements, failure_info,
            protected=frozenset(pod.key for pod, _ in placed))
        newly = [(pod, nd) for pod, nd, od in
                 zip(pods, filled, placements)
                 if od is None and nd is not None]
        if newly:
            with stage("assume", pods=len(newly)):
                skipped2 = set(self.config.algorithm.cache.assume_pods(
                    newly, strict=False))
            placed += [(pod, dest) for pod, dest in newly
                       if pod.key not in skipped2]
            placements = filled
        for pod, dest in zip(pods, placements):
            if dest is None:
                msg, result = failure_info.get(
                    pod.key,
                    (f"pod ({pod.name}) failed to fit in any node",
                     "unschedulable"))
                self._handle_failure(pod, "FailedScheduling", msg,
                                     result=result)
        if self.config.async_bind:
            t = threadreg.spawn(self._bind_assumed_batch,
                                args=(placed, start,
                                      trace_mod.current_context()),
                                name="bind-batch", transient=True)
            # Prune finished binders on append: a long-running daemon
            # drains every ~50 ms and must not accumulate dead Thread
            # objects without bound.
            self._bind_threads = [x for x in self._bind_threads
                                  if x.is_alive()]
            self._bind_threads.append(t)
        else:
            self._bind_assumed_batch(placed, start)

    def _preempt_failures(self, pods: list, placements: list,
                          failure_info: dict,
                          protected: frozenset = frozenset()) -> list:
        """The preemption pass: unschedulable priority pods get a victim
        solve (engine.find_preemptions); executed decisions (victims
        evicted, nominated node recorded) rewrite the placement vector so
        the normal assume/bind path commits them.  ``protected`` keys
        (the caller's just-assumed placements) are never victims.  Gang
        members never preempt individually (a partial gang must not
        evict for a placement the reduction would reject)."""
        from kubernetes_tpu_torch.utils.featuregate import DEFAULT_FEATURE_GATE
        if not DEFAULT_FEATURE_GATE.enabled("Preemption"):
            return placements
        cands = [pod for pod, dest in zip(pods, placements)
                 if dest is None and pod.effective_priority > 0
                 and not pod.gang and pod.key not in failure_info]
        if not cands:
            return placements
        try:
            decisions = self.config.algorithm.find_preemptions(
                cands, protected=protected)
        except Exception:  # noqa: BLE001 — preemption is best-effort
            log.exception("preemption pass crashed; pods requeue with "
                          "backoff instead")
            decisions = []
        executed = {}
        for dec in decisions:
            if self._execute_preemption(dec):
                executed[dec.pod_key] = dec
        decided = {d.pod_key for d in decisions}
        for pod in cands:
            if pod.key not in decided:
                metrics_mod.PREEMPTIONS.labels(
                    result="no_candidate").inc()
        if not executed:
            return placements
        out = []
        for pod, dest in zip(pods, placements):
            dec = executed.get(pod.key) if dest is None else None
            if dec is not None:
                pod.nominated_node = dec.node
                out.append(dec.node)
            else:
                out.append(dest)
        return out

    def _execute_preemption(self, dec) -> bool:
        """Evict a decision's victims (cache + binder) so the preemptor
        can assume and bind — the evict->assume->bind path.  Returns
        False (pod stays unschedulable, requeues with backoff) if any
        eviction fails."""
        cache = self.config.algorithm.cache
        evict = getattr(self.config.binder, "evict", None)
        try:
            for vkey in dec.victims:
                vpod = cache.get_pod(vkey)
                if vpod is not None:
                    cache.remove_pod(vpod)
                else:
                    ns, _, name = vkey.partition("/")
                    vpod = api.Pod(name=name or ns,
                                   namespace=ns if name else "default")
                if evict is not None:
                    evict(vpod)
                self.config.recorder.eventf(
                    vkey, "Normal", "Preempted",
                    f"Preempted by {dec.pod_key} (priority) "
                    f"on node {dec.node}")
        except Exception:  # noqa: BLE001 — a failed eviction aborts
            log.exception("preemption eviction failed for %s on %s",
                          dec.pod_key, dec.node)
            metrics_mod.PREEMPTIONS.labels(result="error").inc()
            return False
        metrics_mod.PREEMPTIONS.labels(result="executed").inc()
        metrics_mod.PREEMPTION_VICTIMS.inc(len(dec.victims))
        if self.config.flight_recorder is not None:
            self.config.flight_recorder.record_preemption(
                dec.pod_key, dec.node, dec.victims)
        log.info("preempted %d pod(s) on %s for %s",
                 len(dec.victims), dec.node, dec.pod_key)
        return True

    # Fixed stream chunk override (else derived from STREAM_THRESHOLD).
    stream_chunk: int = 0

    def stream_chunk_size(self) -> int:
        """Chunk size of the streamed drain above STREAM_THRESHOLD."""
        return self.stream_chunk or min(self.STREAM_THRESHOLD, 8192)

    def degraded_drain_cap(self) -> int:
        """Pods per drain while shedding load: the largest bucket the
        pre-warm ran, falling back to the one-shot pad limit when
        streaming is off."""
        ladder = self.effective_ladder()
        return max(ladder) if ladder else self._PAD_LIMIT

    def effective_ladder(self) -> list[int]:
        """The fixed set of chunk sizes this daemon's streamed drains run
        at — pre-warm launches exactly this set, and the guard's OOM
        bisection walks it downward.  See ``bucket_ladder``."""
        return bucket_ladder(self.stream_min_bucket, self.STREAM_THRESHOLD,
                             self._PAD_LIMIT, self.stream_chunk)

    def prewarm_plan(self) -> list[str]:
        """The keys ``prewarm()`` will run for THIS daemon's
        configuration — static introspection, no device.  Mirrors
        ``prewarm()``'s own no-op conditions (StreamingDrain gate off,
        extenders configured, empty cluster -> [])."""
        from kubernetes_tpu_torch.utils.featuregate import \
            DEFAULT_FEATURE_GATE
        alg = self.config.algorithm
        if not DEFAULT_FEATURE_GATE.enabled("StreamingDrain") or \
                alg.extenders or not alg.cache.nodes():
            return []
        return prewarm_plan(
            self.effective_ladder(), cuda=alg.device.type == "cuda",
            preempt=DEFAULT_FEATURE_GATE.enabled("Preemption"),
            joint=DEFAULT_FEATURE_GATE.enabled("JointSolver"))

    def prewarm(self, sample_pods: Optional[list] = None) -> dict:
        """Pay, before the queue opens, what a live drain would otherwise
        pay on the clock (``prewarm_plan``): the ``nvcc`` build and load
        of the kernel library, one stream chunk at every ladder bucket
        (the scan kernel's launch at that size), one launch of the step
        loop's select kernel, one single-pod decision (the single-pod
        select kernel), the victim solve at the cluster's (N, V), the
        topology planes with a spread-constrained drain and, with the
        joint solve on, a joint drain (``_prewarm_workloads``).

        ``sample_pods`` shapes the warm batches (vocab capacities +
        content flags) like the expected workload; without it minimal
        synthetic pods are used.  Returns {bucket: seconds}; no-ops when
        streaming is off, an extender is configured, or the cluster is
        empty.  Chaos injection is suppressed for the duration (there is
        no recovery ladder above prewarm), and the kernel-build watchdog
        arms at the end."""
        import contextlib as _contextlib

        import torch

        from kubernetes_tpu_torch.engine import devicestats
        from kubernetes_tpu_torch.utils.featuregate import \
            DEFAULT_FEATURE_GATE
        alg = self.config.algorithm
        if not DEFAULT_FEATURE_GATE.enabled("StreamingDrain") or \
                alg.extenders or not alg.cache.nodes():
            return {}
        devicestats.disarm()
        cuda = alg.device.type == "cuda"
        suppress = alg.guard.suppressed() if alg.guard.enabled \
            else _contextlib.nullcontext()
        with suppress:
            ladder = self.effective_ladder()
            timings: dict[int, float] = {}
            stats: dict = {}

            def audited(key, fn):
                b0 = devicestats.builds()
                t0 = time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize(alg.device)
                dt = time.perf_counter() - t0
                stats[key] = {"builds": devicestats.builds() - b0,
                              "seconds": round(dt, 3)}
                return dt

            if cuda:
                from kubernetes_tpu_torch.engine import kernels
                audited("build", kernels.library)
            # LARGEST bucket first: the monotonic content-axis caps
            # (padcap) grow while the ladder runs, and descending order
            # reaches their fixed point on the first bucket.
            for bucket in sorted(ladder, reverse=True):
                pods = list(sample_pods[:bucket]) if sample_pods else []
                pods += [api.Pod(name=f"__warm-{i}", namespace="__warm__")
                         for i in range(bucket - len(pods))]

                def run_bucket(pods=pods, bucket=bucket):
                    for _ in alg.schedule_batch_stream(pods,
                                                       chunk_size=bucket):
                        pass

                timings[bucket] = audited(f"scan_chunk@{bucket}",
                                          run_bucket)
            if cuda:
                from kubernetes_tpu_torch.engine import fused
                n = len(alg.cache.nodes())

                def run_select():
                    fused.select_rows(
                        torch.zeros((1, n), dtype=torch.float32,
                                    device=alg.device),
                        torch.zeros(1, dtype=torch.int64,
                                    device=alg.device))

                audited("select_rows@1", run_select)

            def run_single():
                try:
                    alg.schedule(api.Pod(name="__warm-one",
                                         namespace="__warm__"))
                except Exception:  # noqa: BLE001 — FitError etc. still ran
                    pass

            audited("select_hosts@1", run_single)
            self.workloads_prewarm_s = self._prewarm_workloads(audited)
            self.prewarm_cache_stats = stats
        # From here on, any kernel build on a live path is a stall the
        # prewarm should have paid.
        devicestats.arm()
        log.info("pre-warmed stream ladder %s (floor %d, chunk %d): %s "
                 "workloads=%s", ladder, self.stream_min_bucket,
                 self.stream_chunk_size(),
                 {b: f"{s:.2f}s" for b, s in timings.items()},
                 {k: f"{s:.2f}s"
                  for k, s in self.workloads_prewarm_s.items()})
        return timings

    def _prewarm_workloads(self, audited) -> dict:
        """The workloads subsystem's warm-up, as the JAX package runs it:
        the preemption victim solve at the cluster's (N, V) shape, the
        topology spread planes and a drain of 4 pods carrying a zone
        DoNotSchedule term padded to the floor bucket, and, with the
        ``JointSolver`` gate on, 4 pods through ``schedule_batch(joint=
        True)`` at the floor bucket.  Gang one-shot solves reuse the
        ladder's scan launches.  The warm pods are never assumed."""
        from kubernetes_tpu_torch.utils.featuregate import \
            DEFAULT_FEATURE_GATE
        alg = self.config.algorithm
        timings: dict = {}
        ladder = self.effective_ladder()
        floor = min(ladder) if ladder else 0
        try:
            if DEFAULT_FEATURE_GATE.enabled("Preemption"):
                from kubernetes_tpu_torch.engine.workloads import preemption
                timings["preempt"] = audited(
                    "victim_solve", lambda: preemption.prewarm_shapes(
                        len(alg.cache.nodes()), alg.device))
            if floor:
                tsc = json.dumps([{
                    "maxSkew": 1, "topologyKey": api.ZONE_LABEL,
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"kt/warm": "1"}}}])
                spods = [api.Pod(
                    name=f"__warm-topo-{i}", namespace="__warm__",
                    labels={"kt/warm": "1"},
                    annotations={api.TOPOLOGY_SPREAD_ANNOTATION_KEY: tsc})
                    for i in range(min(floor, 4))]
                timings["topology"] = audited(
                    "topo_planes", lambda: self._warm_topo_planes(spods))
                timings["topology"] += audited(
                    f"oneshot_topo@{floor}",
                    lambda: alg.schedule_batch(spods, pad_to=floor))
                if DEFAULT_FEATURE_GATE.enabled("JointSolver"):
                    jpods = [api.Pod(name=f"__warm-joint-{i}",
                                     namespace="__warm__")
                             for i in range(min(floor, 4))]
                    timings["joint"] = audited(
                        f"joint@{floor}", lambda: alg.schedule_batch(
                            jpods, joint=True, pad_to=floor))
        except Exception:  # noqa: BLE001 — warmup must never kill startup
            log.exception("workloads prewarm failed; the first constrained "
                          "drain pays its first launches on the clock")
        return timings

    def _warm_topo_planes(self, pods: list) -> None:
        """The spread planes of ``pods`` on the resident cluster (their
        gather and float64 contraction's first launches)."""
        alg = self.config.algorithm
        _, _, dc, _ = alg._compile(pods)
        planes = alg._topo_planes(dc)
        if planes is not None:
            planes.rows()

    # -- run loops --------------------------------------------------------

    def run(self, batched: bool = True) -> threading.Thread:
        """wait.Until(scheduleOne, 0, stop) (scheduler.go:89-91), in a
        daemon thread; batched mode drains the queue per iteration.  A
        crashing iteration is logged and the loop continues — the
        reference's runtime.HandleCrash keeps its daemons alive the same
        way; without this, one bad drain kills scheduling forever."""
        def loop():
            while not self._stop.is_set():
                try:
                    if batched:
                        self.schedule_pending(timeout=0.05)
                    else:
                        self.schedule_one(timeout=0.05)
                except Exception:  # noqa: BLE001 — HandleCrash analogue
                    log.exception("scheduling iteration crashed; "
                                  "continuing")
                    time.sleep(0.5)
        self._loop_thread = threadreg.spawn(loop, name="scheduler-loop")
        return self._loop_thread

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        # Join the loop before returning: a process exiting while the
        # loop thread is inside a torch op aborts in the C++ runtime.
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=30)
        self.pipeline.shutdown(wait=True)
        for t in self._bind_threads:
            t.join(timeout=5)
        # Graceful shutdown persists the decision ring (KT_FLIGHT_DIR) so
        # `kubectl explain pod` keeps answering across a scheduler bounce.
        recorder = self.config.flight_recorder
        flight_dir = knobs.get("KT_FLIGHT_DIR")
        if recorder is not None and flight_dir:
            try:
                recorder.save(flight_dir)
            except OSError:
                log.exception("flight-recorder dump to %s failed",
                              flight_dir)

    def abandon(self) -> None:
        """SIGKILL-style stop: no graceful drain, no joins, no flight
        dump — the in-flight pipeline window (solved-but-uncommitted
        chunks, dispatched binds) is simply abandoned, exactly what a
        kill between solve and bind leaves behind.  Safety then rests on
        the apiserver's bind CAS (an abandoned bind that still lands
        cannot be double-applied) and the next incarnation's startup
        reconciliation (scheduler/recovery.py), which requeues anything
        left unbound and adopts anything that did land."""
        self._stop.set()
        self.queue.close()
        self.pipeline.shutdown(cancel=True)

    def wait_for_binds(self) -> None:
        for t in list(self._bind_threads):
            t.join()
        self._bind_threads = [t for t in self._bind_threads if t.is_alive()]

    # -- internals --------------------------------------------------------

    def _record_bind_failure(self, err) -> str:
        return _record_bind_failure(err)

    def _forget_quietly(self, pod: api.Pod) -> None:
        """Forget a failed bind's optimistic assume; tolerates the pod
        being gone already (a watch DELETED can race the bind fan-out,
        and the loser must requeue-or-drop, not die in the bind
        thread)."""
        try:
            self.config.algorithm.cache.forget_pod(pod)
        except ValueError:
            pass

    def _assume_and_bind(self, pod: api.Pod, dest: str, start: float) -> None:
        cache = self.config.algorithm.cache
        # Optimistic assume before the async bind; an assume error is logged
        # and binding proceeds anyway (scheduler.go:116-120).
        assumed = True
        try:
            with stage("assume", pods=1):
                cache.assume_pod(pod, dest)
        except ValueError:
            assumed = False
        ctx = trace_mod.current_context()

        def bind():
            with trace_mod.use_context(ctx):
                self._bind_assumed(pod, dest, start, assumed=assumed)

        if self.config.async_bind:
            t = threadreg.spawn(bind, name="bind-one", transient=True)
            self._bind_threads = [x for x in self._bind_threads
                                  if x.is_alive()]
            self._bind_threads.append(t)
        else:
            bind()

    def _bind_assumed(self, pod: api.Pod, dest: str, start: float,
                      assumed: bool = True) -> None:
        bind_start = time.perf_counter()
        try:
            with stage("bind", pods=1):
                self.config.binder.bind(pod, dest)
        except Exception as err:  # noqa: BLE001 — bind errors requeue
            # ForgetPod + error handler (scheduler.go:139-148).  409 and
            # timeout alike: forget the optimistic assume, emit the event,
            # requeue behind per-pod backoff — never silently drop.
            result = self._record_bind_failure(err)
            if assumed:
                self._forget_quietly(pod)
            self._handle_failure(pod, "FailedScheduling",
                                 f"Binding rejected: {err}",
                                 result=result)
            return
        now = time.perf_counter()
        self.config.metrics.binding_latency.observe(
            (now - bind_start) * 1e6)
        self.config.metrics.e2e_scheduling_latency.observe(
            (now - start) * 1e6)
        seen = first_seen(pod)
        if seen is not None:
            metrics_mod.E2E_DECISION_LATENCY.observe(
                (now - seen) * 1e6,
                exemplar=trace_mod.current_trace_id())
        self._first_seen.pop(pod.key, None)
        self.config.metrics.scheduling_attempts.labels(
            result="scheduled").inc()
        self.config.recorder.eventf(
            pod.key, "Normal", "Scheduled",
            f"Successfully assigned {pod.name} to {dest}")

    def _bind_assumed_batch(self, placed: list[tuple[api.Pod, str]],
                            start: float, trace_ctx=None) -> None:
        """Bind a solved batch: per-pod CAS binds (conflicts forget +
        requeue exactly like _bind_assumed), with the per-pod metric
        observations amortized into one bucket pass each.  ``trace_ctx``
        carries the batch's span context into the async bind thread so the
        fan-out (and its HTTP requests) stays on the batch's trace."""
        if trace_ctx is None:  # sync call: stay on the caller's context
            trace_ctx = trace_mod.current_context()
        with trace_mod.use_context(trace_ctx), \
                stage("bind", pods=len(placed)):
            self._bind_assumed_batch_inner(placed, start)

    def _bind_assumed_batch_inner(self, placed: list[tuple[api.Pod, str]],
                                  start: float) -> None:
        recorder = self.config.recorder
        bind_start = time.perf_counter()
        bind_many = getattr(self.config.binder, "bind_many", None)
        bound_pods: list[api.Pod] = []
        if bind_many is not None:
            failed = {pod.key: err for pod, err in bind_many(placed)}
            ok = 0
            items = []
            for pod, dest in placed:
                if pod.key in failed:
                    result = self._record_bind_failure(failed[pod.key])
                    self._forget_quietly(pod)
                    # Surface the real error: a CAS conflict and a
                    # network failure require different operator action.
                    self._handle_failure(
                        pod, "FailedScheduling",
                        f"Binding rejected: {failed[pod.key]}",
                        result=result)
                else:
                    ok += 1
                    bound_pods.append(pod)
                    items.append((pod.key, "Normal", "Scheduled",
                                  f"Successfully assigned {pod.name} to {dest}"))
            recorder.eventf_many(items)
        else:
            ok = 0
            for pod, dest in placed:
                try:
                    self.config.binder.bind(pod, dest)
                except Exception as err:  # noqa: BLE001 — bind errors requeue
                    result = self._record_bind_failure(err)
                    self._forget_quietly(pod)
                    self._handle_failure(pod, "FailedScheduling",
                                         f"Binding rejected: {err}",
                                         result=result)
                    continue
                ok += 1
                bound_pods.append(pod)
                recorder.eventf(
                    pod.key, "Normal", "Scheduled",
                    f"Successfully assigned {pod.name} to {dest}")
        done = time.perf_counter()
        self.config.metrics.binding_latency.observe_many(
            (done - bind_start) * 1e6 / max(len(placed), 1), ok)
        self.config.metrics.e2e_scheduling_latency.observe_many(
            (done - start) * 1e6, ok)
        # The serving SLO number: per-pod first-seen -> bind ack (NOT
        # amortized — every pod carries its own admission stamp, so the
        # histogram captures the real tail the deadline trades against).
        # The batch's trace id rides along as the bucket exemplar: a bad
        # p99 bucket then names the exact trace to pull from the ring.
        tid = trace_mod.current_trace_id()
        for pod in bound_pods:
            seen = first_seen(pod)
            if seen is not None:
                metrics_mod.E2E_DECISION_LATENCY.observe(
                    (done - seen) * 1e6, exemplar=tid)
            self._first_seen.pop(pod.key, None)
        if ok:
            self.config.metrics.scheduling_attempts.labels(
                result="scheduled").inc(ok)

    def _handle_failure(self, pod: api.Pod, reason: str, message: str,
                        result: str = "unschedulable",
                        failed_predicates: Optional[dict] = None) -> None:
        """Event + condition update + backoff requeue (factory.go:512-556).
        Every failure class funnels through here, so this is also where
        the attempts counter and the flight recorder see it."""
        log.debug("scheduling failure for %s: %s", pod.key, message)
        self.config.metrics.scheduling_attempts.labels(result=result).inc()
        if self.config.flight_recorder is not None:
            self.config.flight_recorder.record_failure(
                pod.key, reason, message,
                failed_predicates=failed_predicates)
        self.config.recorder.eventf(pod.key, "Warning", reason, message)
        if self.config.condition_updater is not None:
            self.config.condition_updater(pod, "Unschedulable", message)
        backoff_s = self.backoff.get_backoff(pod.key)
        with self._requeue_cv:
            self._requeue_seq += 1
            heapq.heappush(self._requeue_heap,
                           (time.monotonic() + backoff_s,
                            self._requeue_seq, pod))
            if self._requeue_thread is None or \
                    not self._requeue_thread.is_alive():
                self._requeue_thread = threadreg.spawn(
                    self._requeue_worker, name="backoff-requeue")
            self._requeue_cv.notify()

    def _requeue_worker(self) -> None:
        while not self._stop.is_set():
            with self._requeue_cv:
                while not self._requeue_heap and not self._stop.is_set():
                    self._requeue_cv.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                due, _, pod = self._requeue_heap[0]
                delay = due - time.monotonic()
                if delay > 0:
                    self._requeue_cv.wait(timeout=min(delay, 0.5))
                    continue
                heapq.heappop(self._requeue_heap)
            pod.node_name = ""
            self.queue.add(pod)

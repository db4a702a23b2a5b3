"""The drain pipeline: ONE form -> solve -> commit path for every drain.

Counterpart of ``kubernetes_tpu/scheduler/pipeline.py`` for the
single-owner daemon.  The daemon's ``schedule_pending`` is a single call
into ``drain()``; batch formation (scheduler/batchformer.py), the
degraded-mode cap, mode routing, the overlapped solve/commit worker, the
batch root span and the crash-requeue handler live behind it.  The solve
modes:

* ``stream``  — fixed-shape chunks through ``schedule_batch_stream``,
  with the commit worker overlapping chunk N's device scan against
  chunk N-1's readback/assume/bind (``pipeline_window`` in flight);
* ``oneshot`` — one ``schedule_batch`` solve; gang batches take this
  path padded to a warm bucket (all-or-nothing needs one assignment
  vector), as do extender-constrained and above-pad-limit drains;
* ``joint``   — ``schedule_batch(joint=True)`` (the ``JointSolver``
  gate): prices couple every pod, so the whole queue is one solve,
  padded to a warm bucket like a gang batch.

Every dispatch runs under the device guard's recovery ladder
(``_solve``).  This package has no host engine, so an open breaker
surfaces the fault to ``drain()``'s crash handler, which requeues the
batch.  Not here yet: the multi-tenant packing (the tenancy slice).

Commit-side semantics (assume-before-bind per pod, flight-recorder
feeds, preemption, failure requeue) stay on the daemon, which the
pipeline calls back into.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.engine.guard import ACT_SURFACE, DeviceFault
from kubernetes_tpu_torch.scheduler.batchformer import BatchFormer, FormedBatch
from kubernetes_tpu_torch.utils import trace as trace_mod
from kubernetes_tpu_torch.utils.logging import get_logger
from kubernetes_tpu_torch.utils.trace import Trace

log = get_logger("pipeline")


class DrainPipeline:
    """One drain: form a batch, route it to a solve mode, commit it.

    ``daemon`` is the owning ``scheduler.Scheduler``; the pipeline reads
    its routing knobs (``STREAM_THRESHOLD``, ``stream_chunk``,
    ``pipeline_window``...) live so tests and rigs that retune the
    daemon keep working unchanged."""

    def __init__(self, daemon):
        self.daemon = daemon
        self.former = BatchFormer(
            queue=daemon.queue,
            ladder_fn=daemon.effective_ladder,
            chunk_fn=daemon.stream_chunk_size,
            cap_fn=self._former_cap)
        # The overlapped commit worker (one thread: chunks commit in
        # solve order); created lazily on the first windowed drain.
        self._commit_pool = None
        # The device guard bisects OOM'd batches down the daemon's
        # pre-warmed bucket ladder — it must read the SAME ladder the
        # prewarm traces, or recovery would mint unwarmed shapes.
        guard = getattr(daemon.config.algorithm, "guard", None)
        if guard is not None:
            guard.ladder_fn = daemon.effective_ladder

    def _former_cap(self) -> int:
        """The degraded drain cap."""
        return self.daemon.degraded_drain_cap()

    # -- the single drain entry path -------------------------------------

    def drain(self, wait_first: bool = True,
              timeout: Optional[float] = None) -> int:
        """Form one batch and solve+commit it.  Returns the number of
        pods popped (scheduled or failed) — the daemon's
        ``schedule_pending`` contract."""
        daemon = self.daemon
        batch = self.former.form(wait_first=wait_first, timeout=timeout)
        pods = batch.pods
        if not pods:
            return 0
        # The batch root span is backdated to cover the wait: queue_wait
        # (blocking pop + deadline batch formation) is the pipeline's
        # first stage, even though the batch only existed at its end.
        root = trace_mod.begin_span("schedule_batch", start=batch.t_wait,
                                    pods=len(pods))
        trace_mod.record_stage("queue_wait", start=batch.t_wait,
                               pods=len(pods))
        daemon.config.metrics.batch_size.set(len(pods))
        tr = Trace(f"Scheduling batch of {len(pods)} pods")
        tr.start = batch.t_wait
        tr.step("Queue drained")
        try:
            return self._solve(batch, tr=tr, trace_id=root.trace_id)
        except Exception:  # noqa: BLE001 — HandleCrash analogue
            # The pods were already popped: requeue each through the
            # backoff path (condition + event + delayed retry) so a
            # crashing drain can't silently strand them Pending, and a
            # poison pod retries at most once per 60 s.  A daemon that
            # was stopped/abandoned mid-drain does NOT requeue: the pods
            # belong to the next incarnation (its startup reconciliation
            # relists them), and a dead daemon writing conditions or
            # requeue events would race the replacement's binds.
            if daemon._stop.is_set():
                log.info("drain interrupted by shutdown; %d pods left "
                         "to the next incarnation", len(pods))
                return len(pods)
            if isinstance(sys.exc_info()[1], DeviceFault):
                # The guard's ladder surfaced a fault (breaker open):
                # counted where it struck; the batch requeues.
                log.warning("drain of %d pods surfaced %s; requeueing",
                            len(pods), sys.exc_info()[1])
            else:
                log.exception("drain of %d pods crashed; requeueing",
                              len(pods))
            cache = daemon.config.algorithm.cache
            for pod in pods:
                # Skip pods the crash didn't strand: anything tracked in
                # the cache (assumed by a completed chunk, or already
                # confirmed bound by the watch) made it through.
                if not cache.contains(pod.key):
                    daemon._handle_failure(
                        pod, "SchedulingError",
                        "internal error during scheduling",
                        result="error")
            return len(pods)
        finally:
            root.end()
            # The reference's 20 ms slow-log (generic_scheduler.go:79-85),
            # now fed by the batched drain too; a slow batch also records
            # as a span with the step breakdown.
            tr.log_if_long()

    # -- mode routing + the device-fault recovery ladder -------------------

    def _solve(self, batch: FormedBatch, tr: Optional[Trace] = None,
               trace_id: str = "") -> int:
        """Route the batch to a solve mode under the device guard's
        recovery ladder: a classified ``DeviceFault`` re-dispatches the
        still-uncommitted pods per the guard's decision — unchanged
        (retry) or chunked at the next smaller pre-warmed bucket
        (bisect) — for at most ``max_rounds`` rounds.  An open breaker,
        or an exhausted ladder, surfaces the fault to ``drain()``'s
        crash handler, which requeues rather than drops.  Chunks that
        committed before the fault stay committed (the cache knows
        them), so progress is monotone across rounds."""
        daemon = self.daemon
        pods = batch.pods
        if daemon.tenancy_service is not None:
            raise NotImplementedError(
                "multi-tenant packing is not ported to kubernetes_tpu_torch "
                "yet (tenancy slice)")
        guard = getattr(daemon.config.algorithm, "guard", None)
        if guard is None or not guard.enabled:
            return self._dispatch(pods, tr, trace_id)
        total = len(pods)
        remaining = pods
        fault: Optional[DeviceFault] = None
        for _ in range(max(guard.max_rounds, 1)):
            mode = guard.solve_mode()
            if mode == "open":
                # Breaker open, no probe due: requeue without touching
                # the card.
                raise guard.breaker_fault()
            try:
                self._dispatch(remaining, tr, trace_id)
                guard.note_success(probe=(mode == "probe"))
                return total
            except DeviceFault as f:
                fault = f
                remaining = self._uncommitted(remaining)
                if not remaining:
                    return total
                action = guard.recover(
                    f, can_bisect=self._can_bisect(remaining))
                log.warning("device fault [%s] on %s path: %d pod(s) "
                            "%s", f.kind, f.path, len(remaining),
                            "requeue" if action == ACT_SURFACE
                            else f"re-dispatched via {action}")
                if action == ACT_SURFACE:
                    break
        raise fault  # breaker open or ladder exhausted: requeue

    def _uncommitted(self, pods: list) -> list:
        """The stranded remainder of a faulted dispatch: pods a
        completed chunk already assumed (or the watch confirmed) are in
        the cache, and pods a completed chunk already FAILED are in the
        backoff heap / back on the queue — re-solving those would
        schedule the same pod twice (once here, once when its requeue
        pops)."""
        daemon = self.daemon
        cache = daemon.config.algorithm.cache
        with daemon._requeue_cv:
            handled = {p.key for _, _, p in daemon._requeue_heap}
        return [p for p in pods
                if not cache.contains(p.key)
                and p.key not in handled
                and p.key not in daemon.queue]

    def _can_bisect(self, pods: list) -> bool:
        """OOM bisection re-solves the remainder as stream chunks at a
        smaller warmed bucket — available only where chunking is legal:
        no gang (one assignment vector), no joint (prices couple the
        queue), no extenders, and a non-empty pre-warmed ladder."""
        from kubernetes_tpu_torch.engine.workloads import gang as gang_mod
        from kubernetes_tpu_torch.utils.featuregate import DEFAULT_FEATURE_GATE
        daemon = self.daemon
        if daemon.config.algorithm.extenders:
            return False
        if not DEFAULT_FEATURE_GATE.enabled("StreamingDrain") or \
                DEFAULT_FEATURE_GATE.enabled("JointSolver"):
            return False
        if DEFAULT_FEATURE_GATE.enabled("GangScheduling") and \
                gang_mod.batch_has_gangs(pods):
            return False
        return bool(daemon.effective_ladder())

    def _dispatch(self, pods: list, tr: Optional[Trace] = None,
                  trace_id: str = "") -> int:
        from kubernetes_tpu_torch.engine.workloads import gang as gang_mod
        from kubernetes_tpu_torch.utils.featuregate import DEFAULT_FEATURE_GATE
        daemon = self.daemon
        joint = DEFAULT_FEATURE_GATE.enabled("JointSolver")
        # Gangs must be admitted all-or-nothing over ONE assignment
        # vector — a chunked stream could split a gang across chunk
        # boundaries, so gang batches take the one-shot solve (padded to
        # a warm bucket below).
        gangs = DEFAULT_FEATURE_GATE.enabled("GangScheduling") and \
            gang_mod.batch_has_gangs(pods)
        # The joint solve needs the whole queue at once (prices couple
        # every pod); it supersedes the streaming split.
        streaming = DEFAULT_FEATURE_GATE.enabled("StreamingDrain") \
            and not joint and not gangs \
            and not daemon.config.algorithm.extenders
        guard = getattr(daemon.config.algorithm, "guard", None)
        cap = guard.bucket_cap() \
            if guard is not None and guard.enabled else None
        if streaming and cap is not None:
            # Bisected (or HBM-watermark-capped) regime: every
            # streamable drain chunks at the cap — a pre-warmed ladder
            # bucket, never a fresh shape.
            return self._solve_stream(pods, chunk_size=cap,
                                      trace_id=trace_id)
        if streaming and len(pods) >= daemon.STREAM_THRESHOLD:
            return self._solve_stream(pods, trace_id=trace_id)
        if streaming and len(pods) < daemon._PAD_LIMIT:
            # Small drain: one power-of-two stream chunk (live-flag
            # padded), so arrival races don't mint a new compiled shape
            # per queue length; floored so the tail of the ladder doesn't
            # either.
            bucket = max(1 << (len(pods) - 1).bit_length(),
                         daemon.stream_min_bucket)
            return self._solve_stream(pods, chunk_size=bucket,
                                      trace_id=trace_id)
        return self._solve_oneshot(pods, joint=joint, gangs=gangs,
                                   tr=tr, trace_id=trace_id)

    # -- one-shot / gang solve ----------------------------------------------

    def _solve_oneshot(self, pods: list, joint: bool, gangs: bool,
                       tr: Optional[Trace], trace_id: str) -> int:
        from kubernetes_tpu_torch.engine.workloads import gang as gang_mod
        from kubernetes_tpu_torch.utils import metrics as metrics_mod
        daemon = self.daemon
        start = time.perf_counter()
        # Workload-constrained one-shot drains pad to the same bucket
        # ladder the stream path runs at, so gang solves hit pre-warmed
        # shapes instead of one per queue length.
        pad_to = 0
        if (gangs or joint) and len(pods) < daemon._PAD_LIMIT and \
                not daemon.config.algorithm.extenders:
            pad_to = max(1 << (len(pods) - 1).bit_length(),
                         daemon.stream_min_bucket)
        placements = daemon.config.algorithm.schedule_batch(
            pods, joint=joint, pad_to=pad_to)
        failure_info: dict[str, tuple[str, str]] = {}
        if gangs:
            placements, rejected = gang_mod.reduce_all_or_nothing(
                pods, placements)
            for name, info in rejected.items():
                metrics_mod.GANG_ADMISSIONS.labels(
                    result="rejected").inc()
                msg = gang_mod.gang_failure_message(name, info)
                log.debug("gang rejection: %s", msg)
                for i in info["members"]:
                    failure_info[pods[i].key] = (msg, "gang_rejected")
            admitted = [name for name in gang_mod.gang_groups(pods)
                        if name not in rejected]
            for _ in admitted:
                metrics_mod.GANG_ADMISSIONS.labels(
                    result="admitted").inc()
        if tr is not None:
            tr.step("Computed placements")
        algo_us = (time.perf_counter() - start) * 1e6 / len(pods)
        daemon.config.metrics.scheduling_algorithm_latency.observe_many(
            algo_us, len(pods))
        if log.isEnabledFor(10):  # V(2)-style guard (predicates.go:478)
            placed_n = sum(1 for d in placements if d is not None)
            log.debug("drained %d pods: %d placed, %.0f us/pod algorithm",
                      len(pods), placed_n, algo_us)
        daemon._record_batch_decisions(pods, placements, trace_id,
                                       time.perf_counter() - start)
        daemon._assume_and_bind_batch(pods, placements, start,
                                      failure_info=failure_info)
        if tr is not None:
            tr.step("Assumed and dispatched binds")
        return len(pods)

    # -- streamed solve with the overlapped commit worker ------------------

    def _solve_stream(self, pods: list, chunk_size: Optional[int] = None,
                      trace_id: str = "") -> int:
        """The overlapped drain: while the device scans chunk N, chunk
        N-1's readback/assume/bind runs on a single commit worker, with
        at most ``pipeline_window`` chunks in flight uncommitted.  The
        one worker keeps chunks committing in solve order, and within a
        chunk assume completes before its bind fan-out dispatches — the
        per-pod assume-before-bind ordering of the one-shot path.
        Commits are joined before returning, so the caller-observable
        state machine (every popped pod assumed-or-failed by return) is
        unchanged."""
        daemon = self.daemon
        start = time.perf_counter()
        window = max(daemon.pipeline_window, 0)
        chunk = chunk_size or daemon.stream_chunk_size()
        if window == 0:
            solve_done = start
            for chunk_pods, placements in \
                    daemon.config.algorithm.schedule_batch_stream(
                        pods, chunk_size=chunk):
                solve_done = time.perf_counter()
                daemon._record_batch_decisions(chunk_pods, placements,
                                               trace_id,
                                               solve_done - start)
                daemon._assume_and_bind_batch(chunk_pods, placements,
                                              start)
        else:
            if self._commit_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._commit_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="chunk-commit")
            sem = threading.BoundedSemaphore(window)
            ctx = trace_mod.current_context()
            # A mutable cell: the commit worker stamps when each chunk's
            # readback landed; the last stamp bounds algorithm latency.
            solve_done_cell = [start]
            futures = []
            err = None
            try:
                for _, resolve in \
                        daemon.config.algorithm.schedule_batch_stream(
                            pods, chunk_size=chunk, defer_readback=True):
                    # Bounded in-flight window: block the drain thread
                    # (and with it further device launches) until an
                    # outstanding chunk commits.
                    sem.acquire()
                    futures.append(self._commit_pool.submit(
                        self._commit_chunk, resolve, start, trace_id,
                        sem, ctx, solve_done_cell))
            finally:
                # Join EVERY submitted commit before surfacing anything:
                # drain()'s crash handler requeues pods not yet assumed,
                # and a still-running commit assuming them concurrently
                # would double-track the pod.
                for fut in futures:
                    try:
                        fut.result()
                    except Exception as exc:  # noqa: BLE001 — requeue
                        err = err or exc
            if err is not None:
                # Surface the first commit failure to drain()'s crash
                # handler, which requeues every pod the completed
                # commits didn't assume.
                raise err
            solve_done = solve_done_cell[0]
        # Algorithm latency spans until the LAST chunk's results landed
        # (interleaved assume/bind of earlier chunks overlaps the device
        # and is deliberately excluded, matching the one-shot path).
        algo_us = (solve_done - start) * 1e6 / len(pods)
        daemon.config.metrics.scheduling_algorithm_latency.observe_many(
            algo_us, len(pods))
        return len(pods)

    def _commit_chunk(self, resolve, start: float, trace_id: str, sem,
                      trace_ctx, solve_done_cell: list) -> None:
        """One chunk's commit on the pipeline worker: blocking readback,
        flight-recorder feed, bulk assume, bind dispatch."""
        daemon = self.daemon
        try:
            with trace_mod.use_context(trace_ctx):
                chunk_pods, placements = resolve()
                solve_done_cell[0] = time.perf_counter()
                daemon._record_batch_decisions(
                    chunk_pods, placements, trace_id,
                    solve_done_cell[0] - start)
                daemon._assume_and_bind_batch(chunk_pods, placements,
                                              start)
        finally:
            sem.release()

    # -- lifecycle --------------------------------------------------------

    def shutdown(self, wait: bool = True, cancel: bool = False) -> None:
        if self._commit_pool is not None:
            if cancel:
                self._commit_pool.shutdown(wait=False,
                                           cancel_futures=True)
            else:
                self._commit_pool.shutdown(wait=wait)

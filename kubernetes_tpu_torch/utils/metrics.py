"""Prometheus-style metrics, wire-compatible text exposition.

The scheduler's three histograms (plugin/pkg/scheduler/metrics/metrics.go:
31-55): microseconds, exponential buckets 1ms * 2^k for 15 buckets, exposed
at /metrics in the Prometheus text format every daemon serves.

Label sets are supported the prometheus way: a metric constructed with
``labelnames`` is a family; ``.labels(k=v, ...)`` returns (and memoizes)
the child carrying that label set, and the family's ``value`` aggregates
across children.  Exposition follows the text-format spec: HELP text is
escaped (``\\`` and newlines), label values are escaped (``\\``, ``"``,
newlines), histogram buckets are exposed cumulatively but stored
per-bucket so ``observe()`` is one bisect instead of a walk over every
upper bound.

Histograms additionally accept an OPTIONAL per-observation exemplar (a
trace id): the last exemplar per bucket is kept and emitted in the
OpenMetrics exposition (``expose_openmetrics`` /
``/metrics?format=openmetrics``) as ``# {trace_id="..."} value ts`` on
the ``_bucket`` lines — a slow p99 bucket then links straight to a
trace retrievable from ``/debug/traces``.  The Prometheus text format
(the default ``/metrics`` body) is unchanged; exemplars ride only the
OpenMetrics rendering, which ends with the spec's ``# EOF`` terminator
and names counter families without their ``_total`` suffix.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Callable, Iterable, TypeVar

from kubernetes_tpu_torch.utils import locktrace


def _escape_help(text: str) -> str:
    """HELP escaping per the exposition spec: backslash and line feed."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(text: str) -> str:
    """Label-value escaping: backslash, double-quote, line feed."""
    return text.replace("\\", "\\\\").replace('"', '\\"') \
               .replace("\n", "\\n")


def _label_str(labelnames: tuple, labelvalues: tuple,
               extra: str = "") -> str:
    parts = [f'{n}="{_escape_label_value(str(v))}"'
             for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    """Shared family machinery: labelnames, memoized children, one lock."""

    def __init__(self, name: str, help_text: str,
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help_text
        self._labelnames = tuple(labelnames)
        self._children: dict = {}
        self._lock = locktrace.make_lock(
            f"metrics.{type(self).__name__}")

    def labels(self, **kw: str) -> object:
        """The child metric for this label set (created on first use).
        The steady-state lookup is a lock-free dict read (GIL-atomic) —
        the drain loop resolves a child per stage observation, and a lock
        here would serialize it against every /metrics expose."""
        if not self._labelnames:
            raise ValueError(f"{self.name} has no labels")
        try:
            key = tuple(kw[n] for n in self._labelnames)
        except KeyError:
            raise ValueError(
                f"{self.name} expects labels {self._labelnames}, "
                f"got {tuple(kw)}") from None
        if len(kw) != len(self._labelnames):
            raise ValueError(
                f"{self.name} expects labels {self._labelnames}, "
                f"got {tuple(kw)}")
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child(key)
            return child

    def children(self) -> dict:
        """Label-values tuple -> child metric (a snapshot)."""
        with self._lock:
            return dict(self._children)

    def _check_unlabeled(self) -> None:
        if self._labelnames:
            raise ValueError(
                f"{self.name} is labeled {self._labelnames}; "
                f"use .labels(...)")

    def _sorted_children(self) -> list:
        with self._lock:
            return sorted(self._children.items())

    def _header(self, type_name: str) -> list[str]:
        return [f"# HELP {self.name} {_escape_help(self.help)}",
                f"# TYPE {self.name} {type_name}"]


class Histogram(_Family):
    """prometheus.Histogram with ExponentialBuckets semantics.

    The hot path is LOCK-FREE: ``observe`` is one GIL-atomic list append
    into a pending-events buffer — the drain loop records a stage
    observation per pipeline stage per batch, and taking the family lock
    there serialized the drain against every concurrent /metrics expose.
    The pending buffer folds into the per-bucket counters (non-cumulative;
    one bisect per event) under the lock only at read time (expose /
    ``count`` / ``sum``) or when the buffer passes a size threshold, and
    buckets are cumulated at expose time as before."""

    # Fold threshold: bounds the pending buffer on a daemon nobody
    # scrapes (len() is a GIL-atomic read; the occasional fold amortizes
    # to O(1) per observe).
    _FOLD_AT = 4096

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float],
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_text, labelnames)
        self.uppers = sorted(buckets)
        self._counts = [0] * len(self.uppers)
        self._sum = 0.0
        self._count = 0
        # Pending events: floats (observe), (value, count) tuples
        # (observe_many) or (value, trace_id, ts) exemplar triples.
        # Appends are GIL-atomic; the folder drains a fixed prefix (copy
        # + del of [:n] are each single bytecode ops), so appends racing
        # the fold land past n and survive it.
        self._events: list = []
        # bucket index (len(uppers) = +Inf) -> (value, trace_id, ts):
        # the LAST exemplar observed per bucket, OpenMetrics-rendered.
        self._exemplars: dict[int, tuple[float, str, float]] = {}

    def _make_child(self, key) -> "Histogram":
        child = Histogram(self.name, self.help, self.uppers)
        child._labelvalues = key  # rendered by the family's expose
        return child

    def observe(self, value: float, exemplar: str | None = None) -> None:
        """Record one observation; ``exemplar`` optionally attaches a
        trace id (the hot no-exemplar path stays one list append)."""
        self._check_unlabeled()
        if exemplar:
            self._events.append((value, exemplar, time.time()))
        else:
            self._events.append(value)
        if len(self._events) >= self._FOLD_AT:
            with self._lock:
                self._fold_locked()

    def observe_many(self, value: float, count: int) -> None:
        """``count`` observations of the same value in one event —
        the batched drain amortizes one solve across the whole batch, so
        every pod records the same per-pod latency."""
        if count <= 0:
            return
        self._check_unlabeled()
        self._events.append((value, count))
        if len(self._events) >= self._FOLD_AT:
            with self._lock:
                self._fold_locked()

    def _fold_locked(self) -> None:
        """Drain a prefix of the pending buffer into the bucket counters.
        Caller holds self._lock (single folder at a time)."""
        buf = self._events
        n = len(buf)
        if not n:
            return
        items = buf[:n]
        del buf[:n]
        uppers = self.uppers
        counts = self._counts
        top = len(counts)
        for item in items:
            if type(item) is tuple:
                if len(item) == 3:           # (value, trace_id, ts)
                    value, k = item[0], 1
                else:
                    value, k = item
            else:
                value, k = item, 1
            i = bisect_left(uppers, value)
            self._sum += value * k
            self._count += k
            if i < top:
                counts[i] += k
            if type(item) is tuple and len(item) == 3:
                self._exemplars[i] = item

    @property
    def count(self) -> int:
        if self._labelnames:
            return sum(c.count for _, c in self._sorted_children())
        with self._lock:
            self._fold_locked()
            return self._count

    @property
    def sum(self) -> float:
        if self._labelnames:
            return sum(c.sum for _, c in self._sorted_children())
        with self._lock:
            self._fold_locked()
            return self._sum

    def bucket_counts(self) -> tuple[list[float], list[int], int, float]:
        """(uppers, per-bucket counts (non-cumulative; +Inf excluded),
        total count, sum) as one consistent snapshot — the reader the
        SLO burn monitor and the telemetry ring use to compute
        good-vs-bad counts without re-parsing the exposition."""
        self._check_unlabeled()
        with self._lock:
            self._fold_locked()
            return (list(self.uppers), list(self._counts), self._count,
                    self._sum)

    def _sample_lines(self, labelvalues: tuple = (),
                      openmetrics: bool = False) -> list[str]:
        with self._lock:
            self._fold_locked()
            counts = list(self._counts)
            total, s = self._count, self._sum
            exemplars = dict(self._exemplars) if openmetrics else {}

        def ex(i: int) -> str:
            item = exemplars.get(i)
            if item is None:
                return ""
            value, tid, ts = item
            return (f' # {{trace_id="{_escape_label_value(tid)}"}} '
                    f"{value:g} {ts:.3f}")

        lines = []
        cum = 0
        for i, (upper, n) in enumerate(zip(self.uppers, counts)):
            cum += n
            lab = _label_str(self._family_labelnames, labelvalues,
                             f'le="{upper:g}"')
            lines.append(f"{self.name}_bucket{lab} {cum}{ex(i)}")
        lab = _label_str(self._family_labelnames, labelvalues,
                         'le="+Inf"')
        lines.append(f"{self.name}_bucket{lab} {total}"
                     f"{ex(len(self.uppers))}")
        plain = _label_str(self._family_labelnames, labelvalues)
        lines.append(f"{self.name}_sum{plain} {s:g}")
        lines.append(f"{self.name}_count{plain} {total}")
        return lines

    # Children render with the FAMILY's labelnames; the family itself
    # (unlabeled) renders with none.
    _family_labelnames: tuple = ()

    def expose(self) -> str:
        lines = self._header("histogram")
        if self._labelnames:
            for key, child in self._sorted_children():
                child._family_labelnames = self._labelnames
                lines.extend(child._sample_lines(key))
        else:
            lines.extend(self._sample_lines())
        return "\n".join(lines) + "\n"

    def expose_openmetrics(self) -> str:
        """The family as an OpenMetrics block: same samples, plus the
        per-bucket exemplars on ``_bucket`` lines."""
        lines = [f"# TYPE {self.name} histogram",
                 f"# HELP {self.name} {_escape_help(self.help)}"]
        if self._labelnames:
            for key, child in self._sorted_children():
                child._family_labelnames = self._labelnames
                lines.extend(child._sample_lines(key, openmetrics=True))
        else:
            lines.extend(self._sample_lines(openmetrics=True))
        return "\n".join(lines) + "\n"


class Counter(_Family):
    def __init__(self, name: str, help_text: str,
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_text, labelnames)
        self._value = 0

    def _make_child(self, key) -> "Counter":
        return Counter(self.name, self.help)

    def inc(self, by: int = 1) -> None:
        self._check_unlabeled()
        with self._lock:
            self._value += by

    @property
    def value(self) -> int:
        if self._labelnames:
            return sum(c.value for _, c in self._sorted_children())
        with self._lock:
            return self._value

    def expose(self) -> str:
        lines = self._header("counter")
        if self._labelnames:
            for key, child in self._sorted_children():
                lab = _label_str(self._labelnames, key)
                lines.append(f"{self.name}{lab} {child.value}")
        else:
            lines.append(f"{self.name} {self.value}")
        return "\n".join(lines) + "\n"

    def expose_openmetrics(self) -> str:
        """OpenMetrics names the counter FAMILY without the ``_total``
        suffix the samples carry (the spec's MetricFamily naming)."""
        family = self.name[:-6] if self.name.endswith("_total") \
            else self.name
        lines = [f"# TYPE {family} counter",
                 f"# HELP {family} {_escape_help(self.help)}"]
        if self._labelnames:
            for key, child in self._sorted_children():
                lab = _label_str(self._labelnames, key)
                lines.append(f"{family}_total{lab} {child.value}")
        else:
            lines.append(f"{family}_total {self.value}")
        return "\n".join(lines) + "\n"


class Gauge(_Family):
    """prometheus.Gauge: a value that can go up and down (breaker state,
    queue depths).  ``set_fn`` switches it to a callback gauge computed at
    expose time (prometheus.GaugeFunc) — the right shape when the truth
    lives in object lifetimes (e.g. a WeakSet of open breakers) rather
    than in paired inc/dec calls that a dropped object would unbalance."""

    def __init__(self, name: str, help_text: str,
                 labelnames: Iterable[str] = ()):
        super().__init__(name, help_text, labelnames)
        self._value = 0.0
        self._fn = None

    def _make_child(self, key) -> "Gauge":
        return Gauge(self.name, self.help)

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def set(self, value: float) -> None:
        self._check_unlabeled()
        with self._lock:
            self._value = value

    def inc(self, by: float = 1.0) -> None:
        self._check_unlabeled()
        with self._lock:
            self._value += by

    def dec(self, by: float = 1.0) -> None:
        self.inc(-by)

    @property
    def value(self) -> float:
        if self._labelnames:
            return sum(c.value for _, c in self._sorted_children())
        with self._lock:
            fn = self._fn
        if fn is not None:
            return fn()
        with self._lock:
            return self._value

    def expose(self) -> str:
        lines = self._header("gauge")
        if self._labelnames:
            for key, child in self._sorted_children():
                lab = _label_str(self._labelnames, key)
                lines.append(f"{self.name}{lab} {child.value:g}")
        else:
            lines.append(f"{self.name} {self.value:g}")
        return "\n".join(lines) + "\n"

    def expose_openmetrics(self) -> str:
        lines = [f"# TYPE {self.name} gauge",
                 f"# HELP {self.name} {_escape_help(self.help)}"]
        if self._labelnames:
            for key, child in self._sorted_children():
                lab = _label_str(self._labelnames, key)
                lines.append(f"{self.name}{lab} {child.value:g}")
        else:
            lines.append(f"{self.name} {self.value:g}")
        return "\n".join(lines) + "\n"


def exponential_buckets(start: float, factor: float, count: int) -> list[float]:
    """prometheus.ExponentialBuckets."""
    return [start * factor ** i for i in range(count)]


# -- default registry --------------------------------------------------------
#
# Process-wide metrics the hardened failure paths record into (client
# retries, reflector relists, breaker transitions, degraded decisions).
# They are registered here rather than on a per-daemon metric set because
# the recording sites (APIClient, Reflector, HTTPExtender) are shared
# library code with no daemon handle; every /metrics endpoint appends
# ``expose_registry()`` so the counters are observable wherever they
# accumulate (the reference's prometheus.MustRegister default-registry
# shape).

T = TypeVar("T")

_REGISTRY: list = []
_REGISTRY_LOCK = locktrace.make_lock("metrics.registry")


def register(metric: "T") -> "T":
    """Add a metric to the default registry; returns it for assignment."""
    with _REGISTRY_LOCK:
        _REGISTRY.append(metric)
    return metric


def registry_metrics() -> list:
    with _REGISTRY_LOCK:
        return list(_REGISTRY)


def expose_registry() -> str:
    return "".join(m.expose() for m in registry_metrics())


def openmetrics(metrics: Iterable) -> str:
    """Render ``metrics`` as one OpenMetrics exposition, terminated by
    the spec's mandatory ``# EOF`` line."""
    return "".join(m.expose_openmetrics() for m in metrics) + "# EOF\n"


def expose_registry_openmetrics() -> str:
    return openmetrics(registry_metrics())


# Client -> apiserver path (client/http.py), labeled by verb.
CLIENT_RETRIES = register(Counter(
    "apiclient_retries_total",
    "Retries of idempotent apiserver verbs after 5xx/429/transport faults",
    labelnames=("verb",)))
CLIENT_RETRY_BUDGET_EXHAUSTED = register(Counter(
    "apiclient_retry_budget_exhausted_total",
    "Retries skipped because the client retry budget was empty"))
# Reflector list+watch loop (client/reflector.py), labeled by kind.
REFLECTOR_RELISTS = register(Counter(
    "reflector_relists_total",
    "Reflector relists after watch errors, stream EOF, or 410 Gone",
    labelnames=("kind",)))
# Extender path (engine/extender_client.py + generic_scheduler.py).
EXTENDER_RETRIES = register(Counter(
    "extender_retries_total",
    "Retries of extender filter/prioritize calls after transport faults",
    labelnames=("verb",)))
EXTENDER_BREAKER_TRANSITIONS = register(Counter(
    "extender_breaker_transitions_total",
    "Extender circuit-breaker state transitions, labeled by the state "
    "entered (closed/open/half-open)",
    labelnames=("state",)))
EXTENDER_BREAKER_OPEN = register(Gauge(
    "extender_breaker_open",
    "Number of currently-open extender circuit breakers (0 = none)"))
EXTENDER_DEGRADED_DECISIONS = register(Counter(
    "scheduler_extender_degraded_decisions_total",
    "Scheduling decisions made with built-in predicates only because the "
    "extender breaker was open",
    labelnames=("extender",)))
# Workload-constraints subsystem (engine/workloads/).
GANG_ADMISSIONS = register(Counter(
    "scheduler_gang_admissions_total",
    "Gang all-or-nothing admission outcomes: admitted (every member "
    "placed) vs rejected (incomplete gang nulled atomically and "
    "requeued)",
    labelnames=("result",)))
PREEMPTIONS = register(Counter(
    "scheduler_preemptions_total",
    "Preemption attempts for unschedulable priority pods, by result "
    "(executed/no_candidate)",
    labelnames=("result",)))
PREEMPTION_VICTIMS = register(Counter(
    "scheduler_preemption_victims_total",
    "Pods evicted by executed preemption decisions"))
# Continuous rebalancing (scheduler/defrag.py): the background joint-
# solve defragmenter.  Every migration decision is counted (and flight-
# recorded); the soak's defrag wave ratchets gain > 0 with zero PDB
# violations and zero stranded migrants.
DEFRAG_ROUNDS = register(Counter(
    "scheduler_defrag_rounds_total",
    "Defragmentation rounds executed by the background rebalancer "
    "(each: settle in-flight migrations, probe-solve the blocked set, "
    "plan + gate + execute one bounded migration batch)"))
DEFRAG_MIGRATIONS = register(Counter(
    "scheduler_defrag_migrations_total",
    "Per-pod migration decisions by result: executed (intent stamped + "
    "evicted to pending), vetoed_budget (batch failed the min-gain "
    "cost model or the in-flight disruption budget), vetoed_pdb "
    "(victim protected by PodDisruptionBudget state), cas_conflict "
    "(intent stamp or evict lost the resourceVersion CAS)",
    labelnames=("result",)))
DEFRAG_UNBLOCKED = register(Counter(
    "scheduler_defrag_unblocked_total",
    "Previously-unschedulable pods observed bound after a defrag "
    "migration batch — the numerator of the soak's defrag_gain column"))
DEFRAG_INFLIGHT = register(Gauge(
    "scheduler_defrag_inflight_migrations",
    "Evicted-but-not-yet-rebound migrations currently in flight (the "
    "disruption budget KT_DEFRAG_BUDGET is spent against this)"))
DEFRAG_RECOVERED = register(Counter(
    "scheduler_defrag_recovered_total",
    "Migration intents found by the startup reconciler after a crash, "
    "by action: requeued (evicted-but-not-rebound pod put back on the "
    "queue, intent cleared) or cleared (pod still/again bound; stale "
    "intent dropped)",
    labelnames=("action",)))
# Persistent XLA compilation cache (engine/compile_cache.py): without
# these the 3-4 s \"warm\" start is undiagnosable — a miss here is a
# program that re-paid the full XLA compile despite the cache.
COMPILE_CACHE_HITS = register(Counter(
    "compile_cache_hits_total",
    "Jit compilations served from the persistent XLA compilation cache "
    "(deserialized, not recompiled)"))
COMPILE_CACHE_MISSES = register(Counter(
    "compile_cache_misses_total",
    "Jit compilations that missed the persistent XLA compilation cache "
    "and paid the full compile"))
# Churn & recovery (cache/verifier.py, scheduler/recovery.py): the
# resident-state invariant checker and the restart reconciler.  A nonzero
# violations count is the signal that device-resident state drifted from
# cache (or cache from apiserver) truth — the soak ratchet
# (tools/check_bench.py) fails tier-1 on it.
CACHE_INVARIANT_VIOLATIONS = register(Counter(
    "scheduler_cache_invariant_violations_total",
    "Resident-state invariant violations found by the background "
    "verifier, by kind (aggregates: cache aggregate rows vs a recompute "
    "from tracked pods; device_row: device-resident tensor rows vs host "
    "arrays; apiserver: cache pod placements vs apiserver truth).  Each "
    "triggers a self-heal full re-snapshot",
    labelnames=("kind",)))
RESTART_RECONCILE = register(Counter(
    "scheduler_restart_reconcile_total",
    "Startup reconciliation actions after a scheduler (re)start: "
    "readopted (bound pod re-adopted into the cache), requeued (pending "
    "orphan put back on the queue), expired (stale assume forgotten), "
    "removed (cache ghost with no apiserver record dropped)",
    labelnames=("action",)))
# Bounded-queue degradation (scheduler/queue.py + scheduler.py).
DEGRADED_DRAINS = register(Counter(
    "scheduler_degraded_drains_total",
    "Drains executed in degraded (load-shedding) mode because the "
    "pending queue crossed its high watermark"))
# Serving path (scheduler/batchformer.py + scheduler/pipeline.py): the
# per-decision latency SLO surface.  The e2e decision histogram is the
# number a latency SLO is declared against — first-seen (enqueue) to
# bind ack, spanning batch formation, the solve, and the bind wire
# round-trip, across requeues.
E2E_DECISION_LATENCY = register(Histogram(
    "scheduler_e2e_decision_latency_microseconds",
    "Per-pod decision latency from the pod first entering the "
    "scheduling queue to its bind acknowledgement (the serving SLO "
    "number; spans batch formation, solve, and bind, across requeues)",
    exponential_buckets(1000, 2, 18)))
BATCH_FORMATION_LATENCY = register(Histogram(
    "scheduler_batch_formation_latency_microseconds",
    "Wall time the batch former spent assembling each drained batch "
    "(first pod popped to hand-off at the solve)",
    exponential_buckets(100, 2, 18)))
BATCH_DEADLINE_MISSES = register(Counter(
    "scheduler_batch_deadline_misses_total",
    "Batches the former handed off later than its formation deadline "
    "(KT_BATCH_DEADLINE_MS) plus the 25% grace — formation overran the "
    "latency budget instead of choosing to wait"))
# Device telemetry plane (engine/devicestats.py): per-cause host<->device
# traffic and HBM occupancy — the regressions ROADMAP items 1 and 3 name
# (a silent full re-upload where a dirty-row scatter should run, HBM
# growth toward OOM) are invisible without these.
DEVICE_TRANSFER_BYTES = register(Counter(
    "scheduler_device_transfer_bytes_total",
    "Bytes moved between host and device by the drain path, by cause: "
    "scatter (dirty-row updates into the resident cluster mirror), "
    "full_upload (whole-cluster re-snapshot on relist/capacity growth), "
    "readback (device->host result fetches)",
    labelnames=("cause",)))
DEVICE_TRANSFERS = register(Counter(
    "scheduler_device_transfers_total",
    "Host<->device transfer operations by cause (same label set as the "
    "bytes counter; bytes/ops is the mean transfer size)",
    labelnames=("cause",)))
DEVICE_HBM_LIVE_BYTES = register(Gauge(
    "scheduler_device_hbm_live_bytes",
    "Device memory held by live tensors on the scheduler's device "
    "(torch.cuda.memory_allocated; 0 on a CPU device)"))
DEVICE_HBM_PEAK_BYTES = register(Gauge(
    "scheduler_device_hbm_peak_bytes",
    "Peak device memory on the scheduler's device "
    "(torch.cuda.max_memory_allocated; 0 on a CPU device)"))
POST_PREWARM_COMPILES = register(Counter(
    "scheduler_post_prewarm_compiles_total",
    "Kernel-library builds (nvcc) observed AFTER prewarm() armed the "
    "watchdog, by live path — every one is a build stall on the "
    "serving clock that the prewarm should have paid",
    labelnames=("path",)))
# Device fault-tolerance plane (engine/guard.py): the guarded-execution
# layer's taxonomy, recovery ladder, and sanity gate.
DEVICE_FAULTS = register(Counter(
    "scheduler_device_faults_total",
    "Classified device faults at the guarded solve sites, by kind: "
    "oom (CUDA out of memory), compile (nvcc build failure), lost "
    "(sticky CUDA error or kernel launch failure), corrupt (readback "
    "rejected by the post-solve sanity gate)",
    labelnames=("kind",)))
SOLVE_FALLBACKS = register(Counter(
    "scheduler_solve_fallback_total",
    "Recovery-ladder fallbacks: bisect (batch re-solved in chunks at "
    "the next smaller pre-warmed bucket after OOM + resident-array "
    "eviction)",
    labelnames=("mode",)))
ENGINE_MODE = register(Gauge(
    "scheduler_engine_mode",
    "The device breaker: 0 = closed (drains solve on the device), 1 = "
    "open (drains requeue until a probe drain succeeds)"))
HBM_WATERMARK_TRIPS = register(Counter(
    "scheduler_hbm_watermark_trips_total",
    "Times live device memory crossed KT_HBM_WATERMARK and bucket "
    "growth was "
    "proactively capped at the ladder floor (resident arrays evicted) "
    "BEFORE the allocator could throw"))
GATE_REJECTS = register(Counter(
    "scheduler_sanity_gate_rejects_total",
    "Solve readbacks rejected by the post-solve sanity gate (NaN/inf, "
    "out-of-range or non-integral assignment indices, padded rows "
    "placed, or a sampled placement exceeding the node's allocatable); "
    "each rejection requeues the batch instead of binding garbage"))
GATE_REJECTED_BINDS = register(Counter(
    "scheduler_sanity_rejected_binds_total",
    "Pods that reached the bind path from a sanity-gate-rejected batch "
    "and were refused there — structurally unreachable defense in "
    "depth; the bench ratchet fails tier-1 on any nonzero value"))
# SLO burn plane (scheduler/slo.py): multi-window error-budget burn
# computed from the decision-latency histogram above.
SLO_BURN_RATE = register(Gauge(
    "scheduler_slo_burn_rate",
    "Error-budget burn rate of the decision-latency SLO over a trailing "
    "window (1.0 = exactly exhausting the budget at period end; >1 is "
    "an alerting burn), labeled by window (5m/1h)",
    labelnames=("window",)))
SLO_BUDGET_REMAINING = register(Gauge(
    "scheduler_slo_budget_remaining",
    "Fraction of the decision-latency error budget left over the "
    "longest burn window (1.0 = untouched, 0.0 = exhausted)"))
# Active-active HA plane (scheduler/shards.py): several scheduler
# incarnations share one apiserver, sharded by namespace hash with
# lease-based shard ownership; the bind CAS is the cross-shard safety
# net while leases hand off.
INCARNATION_INFO = register(Gauge(
    "scheduler_incarnation_info",
    "Info gauge (value always 1) naming this process's scheduler "
    "incarnation id — the lease holder identity the shard locks carry",
    labelnames=("incarnation",)))
SHARDS_OWNED = register(Gauge(
    "scheduler_shards_owned",
    "Namespace-hash shards whose lease this incarnation currently "
    "holds (it schedules only pods in owned shards)",
    labelnames=("incarnation",)))
SHARD_LEASE_HANDOFFS = register(Counter(
    "scheduler_shard_lease_handoffs_total",
    "Shard leases this incarnation acquired from a DIFFERENT previous "
    "holder (a takeover after a peer died or released), as opposed to "
    "first-ever acquisitions of a virgin lease",
    labelnames=("incarnation",)))
CROSS_SHARD_CONFLICTS = register(Counter(
    "scheduler_cross_shard_bind_conflicts_total",
    "Bind CAS conflicts observed while running sharded (KT_HA_SHARDS "
    "> 0): another incarnation (or a chaos rule) bound the pod first — "
    "the steady state should keep this near zero; bursts mark lease "
    "handoff windows where two incarnations briefly race one shard"))
# Multi-tenant solver service (kubernetes_tpu/tenancy/): one device
# shared by N tenants — per-tenant SLO, fairness, and fault-isolation
# accounting.  Label values come from the bounded KT_TENANTS set (never
# from client-controlled strings), so the families cannot mint series.
TENANT_DECISION_LATENCY = register(Histogram(
    "scheduler_tenant_decision_latency_microseconds",
    "Per-pod decision latency (first-seen to bind ack) attributed to "
    "the pod's tenant — the per-tenant serving SLO number the "
    "multi-tenant bench and the per-tenant burn gauge read",
    exponential_buckets(1000, 2, 18), labelnames=("tenant",)))
TENANT_BOUND = register(Counter(
    "scheduler_tenant_pods_bound_total",
    "Pods bound per tenant — the fairness observable: under saturation "
    "the per-tenant rates converge to the KT_TENANT_WEIGHTS shares",
    labelnames=("tenant",)))
TENANT_DEFERRED = register(Counter(
    "scheduler_tenant_deferred_pods_total",
    "Pods the cross-tenant packer deferred back to the queue because "
    "the tenant was over its weighted share for the drain (first-seen "
    "stamps survive, so deferral never resets the SLO clock)",
    labelnames=("tenant",)))
TENANT_FAULTS = register(Counter(
    "scheduler_tenant_device_faults_total",
    "Device faults attributed to one tenant's sub-batch after the "
    "mixed-batch attribution split, by tenant and fault kind",
    labelnames=("tenant", "kind")))
TENANT_BREAKER_TRIPS = register(Counter(
    "scheduler_tenant_breaker_trips_total",
    "Per-tenant circuit-breaker trips: KT_TENANT_BREAKER consecutive "
    "attributable faults degraded the tenant to the host engine while "
    "every other tenant stayed on device",
    labelnames=("tenant",)))
TENANT_ENGINE_MODE = register(Gauge(
    "scheduler_tenant_engine_mode",
    "Which solver a tenant's batches route to: 0 = device, 1 = host "
    "(tenant breaker open; probe solves re-promote to 0)",
    labelnames=("tenant",)))
TENANT_TRANSFER_BYTES = register(Counter(
    "scheduler_tenant_transfer_bytes_total",
    "Host<->device transfer bytes attributed to a tenant by its row "
    "share of each solve (the per-tenant slice of the per-cause "
    "transfer plane)",
    labelnames=("tenant",)))
TENANT_HBM_BYTES = register(Gauge(
    "scheduler_tenant_hbm_attributed_bytes",
    "Live device HBM attributed to a tenant by an EMA of its row share "
    "of recent solves (the resident tensors serve every tenant; the "
    "EMA answers whose load the device is carrying)",
    labelnames=("tenant",)))
TENANT_SLO_BURN = register(Gauge(
    "scheduler_tenant_slo_burn_rate",
    "Per-tenant error-budget burn rate of the decision-latency SLO "
    "over the 5m window (1.0 = exactly exhausting the budget; the "
    "global burn gauge's tenant-attributed sibling)",
    labelnames=("tenant",)))
# Concurrency-discipline plane (utils/locktrace.py, KT_LOCKTRACE=1):
# the runtime companion of ktlint's static lock-order graph.  The soak
# scrapes both from every incarnation and ratchets them to zero.
LOCK_INVERSIONS = register(Counter(
    "scheduler_lock_inversions_total",
    "Lock-order inversions observed by the KT_LOCKTRACE instrumented "
    "locks: some thread acquired A then B after another acquired B "
    "then A — a deadlock precondition, counted once per lock pair"))
LOCK_LONG_HOLDS = register(Counter(
    "scheduler_lock_long_holds_total",
    "Traced-lock holds longer than KT_LOCKTRACE_HOLD_MS (default "
    "100 ms): a lock held across device work or I/O is a latency "
    "cliff for every thread queued behind it"))
# Server-side capacity validation at bind (apiserver/memstore.py): the
# apiserver rejects a bind that would overcommit the target node's
# allocatable (watch-lagged schedulers absorb the 409 via forget +
# requeue), so transient overcommit cannot land in the store.
BIND_CAPACITY_REJECTS = register(Counter(
    "apiserver_bind_capacity_rejects_total",
    "Bind requests rejected by the apiserver's server-side capacity "
    "check because the pod's requests exceeded the target node's "
    "remaining allocatable (cpu/memory/pod-count)"))
# Bind path (scheduler/scheduler.py).
BIND_CONFLICTS = register(Counter(
    "scheduler_bind_conflicts_total",
    "Bind attempts rejected by the apiserver CAS (409: nodeName already "
    "set); each forgets the assumed pod and requeues with backoff"))
BIND_FAILURES = register(Counter(
    "scheduler_bind_failures_total",
    "Bind attempts lost to transport faults or timeouts (non-conflict); "
    "each forgets the assumed pod and requeues with backoff"))

# The hot loop's named stages (utils/trace.stage): queue_wait, snapshot,
# compile, transfer, solve, readback, assume, bind.  Registered here (not
# per-daemon) because the recording sites span the engine and the daemon.
STAGE_LATENCY = register(Histogram(
    "scheduler_batch_stage_latency_microseconds",
    "Per-stage wall time of the batched scheduling pipeline "
    "(queue_wait/snapshot/compile/transfer/solve/readback/assume/bind)",
    exponential_buckets(100, 2, 18), labelnames=("stage",)))

# Apiserver request latency by verb/resource/code (the reference's
# apiserver_request_latencies, pkg/apiserver/metrics).  Recorded by the
# Python apiserver's request loop; rides the default registry so the
# apiserver's /metrics endpoint (and only meaningfully that one) shows it.
APISERVER_REQUEST_LATENCY = register(Histogram(
    "apiserver_request_latency_microseconds",
    "Apiserver request latency by verb, resource and response code",
    exponential_buckets(100, 2, 15),
    labelnames=("verb", "resource", "code")))

# APF-style priority-level flow control (apiserver/flowcontrol.py): the
# reference's apiserver_flowcontrol_* family collapsed to the three-level
# kt classification.  Label space is server-controlled (level names are
# the fixed system/workload/best-effort set, plus "watch" for the
# stream-admission gate), so cardinality is bounded by construction.
APISERVER_INFLIGHT = register(Gauge(
    "apiserver_inflight",
    "Requests currently executing per priority level (watch streams "
    "count under their dedicated admission gate)",
    labelnames=("level",)))
APISERVER_QUEUE_DEPTH = register(Gauge(
    "apiserver_queue_depth",
    "Requests currently parked in a priority level's bounded FIFO "
    "wait queue",
    labelnames=("level",)))
APISERVER_REJECTED = register(Counter(
    "apiserver_rejected_total",
    "Requests shed with 429 + Retry-After per priority level, by "
    "reason (queue-full/deadline/inflight-full)",
    labelnames=("level", "reason")))
APISERVER_QUEUE_WAIT = register(Histogram(
    "apiserver_queue_wait_microseconds",
    "Time admitted requests spent parked in a priority level's wait "
    "queue before an inflight slot freed",
    exponential_buckets(100, 2, 15), labelnames=("level",)))

# kt-prof CPU attribution plane (utils/profiler.py + the wire-accounting
# sites in client/http.py, client/reflector.py, apiserver/server.py).
# The seconds/events counter pairs are accumulated PER FRAME or PER
# BATCH, never per event — µs/event is derived at read time (the bench
# `profile` section and the check_profile ratchet), so the hot paths pay
# one counter update per read1 chunk / dispatch batch.
PROCESS_CPU_FRACTION = register(Gauge(
    "process_cpu_fraction",
    "Fraction of one core spent per control-plane component (kt-prof "
    "sampler EWMA: per-thread CPU deltas attributed through sampled "
    "stacks)",
    labelnames=("component",)))
PROCESS_THREAD_CPU = register(Counter(
    "process_thread_cpu_seconds_total",
    "Cumulative CPU seconds per thread role (instance suffixes "
    "collapsed; label space bounded by the kt-prof sampler)",
    labelnames=("thread",)))
WATCH_DECODE_SECONDS = register(Counter(
    "scheduler_watch_decode_seconds_total",
    "CPU-clock seconds HTTPWatcher._pump spent decoding watch bytes "
    "into events, accumulated per read chunk",
    labelnames=("kind",)))
WATCH_DECODE_EVENTS = register(Counter(
    "scheduler_watch_decode_events_total",
    "Watch events decoded by HTTPWatcher._pump (pairs with "
    "scheduler_watch_decode_seconds_total for µs/event)",
    labelnames=("kind",)))
HANDLER_SECONDS = register(Counter(
    "scheduler_handler_seconds_total",
    "Seconds reflector event dispatch spent inside registered handlers, "
    "accumulated per dispatch batch",
    labelnames=("handler",)))
HANDLER_EVENTS = register(Counter(
    "scheduler_handler_events_total",
    "Events dispatched to reflector handlers (pairs with "
    "scheduler_handler_seconds_total for µs/event)",
    labelnames=("handler",)))
APISERVER_SERIALIZE_SECONDS = register(Counter(
    "apiserver_serialize_seconds_total",
    "Seconds the apiserver spent serializing response bodies, by verb "
    "(the native server exports the same family from its own /metrics)",
    labelnames=("verb",)))
APISERVER_SERIALIZE_OPS = register(Counter(
    "apiserver_serialize_ops_total",
    "Response bodies serialized by the apiserver, by verb",
    labelnames=("verb",)))


class SchedulerMetrics:
    """The scheduler's metric set (metrics.go:31-55), microseconds, plus
    the daemon-scoped observability additions: queue-depth and batch-size
    gauges and the per-result scheduling-attempts counter."""

    def __init__(self) -> None:
        buckets = exponential_buckets(1000, 2, 15)
        self.e2e_scheduling_latency = Histogram(
            "scheduler_e2e_scheduling_latency_microseconds",
            "E2e scheduling latency (scheduling algorithm + binding)", buckets)
        self.scheduling_algorithm_latency = Histogram(
            "scheduler_scheduling_algorithm_latency_microseconds",
            "Scheduling algorithm latency", buckets)
        self.binding_latency = Histogram(
            "scheduler_binding_latency_microseconds",
            "Binding latency", buckets)
        self.queue_depth = Gauge(
            "scheduler_pending_queue_depth",
            "Pods currently waiting in the scheduling queue")
        self.batch_size = Gauge(
            "scheduler_last_batch_size",
            "Size of the most recent drained scheduling batch")
        self.scheduling_attempts = Counter(
            "scheduler_pod_scheduling_attempts_total",
            "Pod scheduling attempts by result (scheduled/unschedulable/"
            "bind_conflict/bind_error/error)",
            labelnames=("result",))
        # Bounded-queue degradation surface: the configured watermark and
        # whether the daemon is currently shedding load (live at expose,
        # like queue_depth).
        self.queue_high_watermark = Gauge(
            "scheduler_queue_high_watermark",
            "Pending-queue depth past which the daemon sheds load "
            "(largest-bucket-first drains, gang holds bypassed); 0 = "
            "unbounded")
        self.queue_degraded = Gauge(
            "scheduler_queue_degraded",
            "1 while the pending queue is past its high watermark and "
            "the daemon drains in degraded (load-shedding) mode")

    def all_metrics(self) -> tuple:
        """This set's own metric objects (the default registry rides
        along separately at expose)."""
        return (self.e2e_scheduling_latency,
                self.scheduling_algorithm_latency, self.binding_latency,
                self.queue_depth, self.batch_size,
                self.scheduling_attempts, self.queue_high_watermark,
                self.queue_degraded)

    def expose(self) -> str:
        # The default registry (retry/breaker/degradation counters, stage
        # latencies) rides along so any daemon serving a SchedulerMetrics
        # /metrics endpoint also exposes the shared-path observability.
        return "".join(m.expose() for m in self.all_metrics()) + \
            expose_registry()

    def expose_openmetrics(self) -> str:
        return openmetrics(list(self.all_metrics()) + registry_metrics())

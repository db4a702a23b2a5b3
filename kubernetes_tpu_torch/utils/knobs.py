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
    "KT_PROFILE_DIR": (
        "", "torch.profiler trace dir for device solves (empty = no-op "
            "hook)"),
    "KT_TELEMETRY_RING": (
        "720", "Self-scrape time-series ring capacity in samples"),
    "KT_TELEMETRY_PERIOD": (
        "5", "Self-scrape cadence in seconds (0 = no sampler thread)"),
    "KT_PROF": (
        "1", "kt-prof continuous CPU profiler; 0 = off (one branch, no "
             "sampler thread, /debug/profile answers 404)"),
    "KT_PROF_HZ": (
        "19", "kt-prof max sample rate in Hz (off-beat default so the "
              "sampler never phase-locks with periodic work; the loop "
              "self-paces below this to keep sampler CPU under 2%)"),
    "KT_PROF_RING": (
        "512", "kt-prof folded-stack table bound (distinct stacks; "
               "overflow CPU folds into one ring-truncated bucket)"),
    "KT_LOCKTRACE": (
        "0", "Instrumented locks: acquisition chains, order-inversion and "
             "long-hold detection (utils/locktrace.py)"),
    "KT_LOCKTRACE_HOLD_MS": (
        "100", "Lock hold duration past which locktrace records a "
               "long-hold"),
    # -- the device guard (engine/guard.py) and its fault injector
    "KT_GUARD": ("1", "Guarded device execution; 0 = raw solves"),
    "KT_GUARD_BREAKER": (
        "3", "Consecutive same-kind device faults before the breaker "
             "opens"),
    "KT_GUARD_PROBE_S": (
        "15", "Seconds between device probe drains while the breaker is "
              "open"),
    "KT_GUARD_ROUNDS": ("6", "Bound on guard recovery rounds per drain"),
    "KT_GUARD_CAP_RESET": (
        "4", "Device-healthy drains before a bisected bucket cap lifts"),
    "KT_HBM_WATERMARK": (
        "0", "Proactive device-memory ceiling in bytes (0 = off): past "
             "it, cap drains at the ladder floor and evict"),
    "KT_CHAOS_DEVICE": (
        "", "Device fault-injection spec, e.g. 'oom@7,lost@50:1' "
            "(chaos/device.py)"),
    "KT_PREEMPT_MAX_VICTIMS": (
        "16", "Victim-table depth per node for the preemption solve"),
    # -- the scheduler daemon
    "KT_STREAM_CHUNK": (
        "0", "Stream-path chunk size; 0 = one-shot solves for drains of "
             "4,096 pods or more"),
    "KT_STREAM_MIN_BUCKET": (
        "", "Smallest drain bucket (default Scheduler.STREAM_MIN_BUCKET); "
            "read once at daemon startup"),
    "KT_PREWARM": (
        "0", "Build the kernels and launch each at every ladder bucket "
             "before the queue opens"),
    "KT_RECOVERY": (
        "1", "Startup cache/queue reconciliation against one store "
             "relist"),
    "KT_PIPELINE_WINDOW": (
        "2", "Overlapped solve/commit in-flight chunk window (0 = "
             "synchronous)"),
    "KT_BATCH_DEADLINE_MS": (
        "", "Deadline micro-batching window in ms (empty/0 = off)"),
    "KT_COALESCE": ("", "Deprecated alias of KT_BATCH_DEADLINE_MS, in "
                        "seconds"),
    "KT_QUEUE_HIGH_WATERMARK": (
        "65536", "Queue depth past which drains degrade to bounded pops "
                 "(0 = off)"),
    "KT_POD_BACKOFF_S": ("1", "Initial per-pod requeue backoff in "
                              "seconds"),
    "KT_POD_BACKOFF_MAX_S": ("60", "Per-pod requeue backoff ceiling in "
                                   "seconds"),
    "KT_FLIGHT_DIR": (
        "", "Directory persisting the decision flight ring across "
            "restarts"),
    "KT_SLO_PERIOD": ("5", "SLO burn monitor tick in seconds (0 = off)"),
    "KT_SLO_MS": ("1000", "Decision-latency SLO threshold in ms"),
    "KT_SLO_OBJECTIVE": (
        "99", "SLO objective in percent of decisions inside KT_SLO_MS"),
    "KT_BIND_CAPACITY": (
        "1", "Store-side bind capacity validation (overcommit binds "
             "conflict)"),
    # -- the HTTP client (client/http.py) and the apiservers
    "KT_BIND_PIPELINE": (
        "4", "Persistent connections pipelining bind-chunk POSTs"),
    "KT_AIMD_MIN": (
        "1", "AIMD bind fan-out concurrency floor (ceiling is "
             "KT_BIND_PIPELINE)"),
    "KT_AIMD_BACKOFF": (
        "0.5", "AIMD multiplicative-decrease factor applied on a server "
               "429"),
    "KT_WATCH_FRAMES": (
        "1", "Clients request the framed (length-prefixed multi-event) "
             "watch encoding; 0 = per-event NDJSON lines"),
    "KT_APF": (
        "1", "APF-style priority-level flow control in the apiserver "
             "request loop; 0 = admit everything"),
    "KT_APF_SYSTEM_INFLIGHT": (
        "16", "Reserved max-inflight slots for the system level (lease/"
              "presence CAS, heartbeats); never queued, never starved by "
              "lower levels"),
    "KT_APF_WORKLOAD_INFLIGHT": (
        "32", "Max-inflight for the workload level (binds, evictions, "
              "solve traffic)"),
    "KT_APF_BESTEFFORT_INFLIGHT": (
        "16", "Max-inflight for the best-effort level (pod-create storms, "
              "LISTs)"),
    "KT_APF_QUEUE": (
        "64", "Bounded FIFO wait-queue depth per queueable level; a full "
              "queue sheds 429 + Retry-After"),
    "KT_APF_QUEUE_WAIT_S": (
        "1.0", "Queue wait deadline in seconds; past it the request sheds "
               "429"),
    "KT_APF_WATCH_INFLIGHT": (
        "128", "Concurrent watch-stream cap; watches are admitted or "
               "429d, never queued (a stream holds its handler thread for "
               "its life)"),
    "KT_APF_RETRY_AFTER_S": (
        "0.25", "Floor of the honest Retry-After hint on shed responses"),
    "KT_NATIVE_APISERVER": (
        "1", "Wire rigs use the native apiserver binary "
             "(apiserver/native.py:server_command)"),
    # -- perf rigs
    "KT_WIRE_CHUNK": (
        "", "density_wire stream chunk (default: the setting's, 4,096 "
            "for stream, the whole burst for one-shot)"),
    "KT_WIRE_ACCUM": (
        "", "density_wire batch-formation deadline in ms (default: the "
            "setting's, 20 for stream, 3,000 for one-shot)"),
    "KT_VERIFY_PERIOD": (
        "0", "Resident-state invariant checker cadence in seconds (0 = "
             "off)"),
    # -- active-active HA (scheduler/shards.py)
    "KT_HA_SHARDS": (
        "0", "Namespace-hash shard count; >0 enables active-active HA"),
    "KT_INCARNATION": (
        "", "Stable incarnation identity (default: random "
            "scheduler-<hex>)"),
    "KT_HA_LEASE_S": ("3.0", "Shard lease duration in seconds"),
    "KT_HA_RENEW_S": (
        "", "Lease renew deadline (default KT_HA_LEASE_S * 2/3)"),
    "KT_HA_RETRY_S": (
        "", "Lease acquisition retry period (default KT_HA_LEASE_S / 6)"),
    "KT_HA_SWEEP_S": (
        "10", "Periodic ownership-sweep reconcile cadence in seconds (0 = "
              "off)"),
    "KT_HA_STALE_ASSUME_S": (
        "3", "Sweep-side assume age past any healthy bind round-trip"),
    # -- the multi-tenant solver service (tenancy/)
    "KT_TENANTS": (
        "", "Comma-separated tenant set; non-empty embeds the "
            "SolverService"),
    "KT_TENANT_WEIGHTS": (
        "", "Weighted shares, 't-a:3,t-b:1' (default 1.0 each)"),
    "KT_TENANT_BREAKER": (
        "2", "Consecutive per-tenant faults before that tenant's breaker "
             "opens (its pods requeue until a probe succeeds)"),
    "KT_TENANT_PROBE_S": (
        "10", "Per-tenant device probe cadence while its breaker is open"),
    "KT_TENANT_PACK_MS": ("5", "Packed-submit coalescing window in ms"),
    "KT_TENANT_URGENT_MS": (
        "", "Urgency-lane queue-age override in ms (default: the "
            "formation deadline)"),
    "KT_HA_RECORDS": (
        "", "perf/ha_takeover.py: a directory; each scheduler process it "
            "starts writes its lease thread's records there (empty = "
            "off)"),
    # -- continuous rebalancing (scheduler/defrag.py)
    "KT_DEFRAG": (
        "0", "Background defragmentation loop (scheduler/defrag.py): dry "
             "joint solves over the bound state propose bounded migration "
             "batches"),
    "KT_DEFRAG_PERIOD_S": (
        "30", "Defrag round cadence in seconds (a round = settle in-flight "
              "migrations, probe-solve the blocked set, plan + execute a "
              "batch)"),
    "KT_DEFRAG_MAX_MIGRATIONS": (
        "8", "Hard cap on migrations executed per defrag round (window); a "
             "plan is trimmed to it before the gain gate"),
    "KT_DEFRAG_MIN_GAIN": (
        "0.5", "Cost-model floor: projected placements unblocked per "
               "migration; a batch below it is vetoed (recorded "
               "vetoed-by-budget)"),
    "KT_DEFRAG_BUDGET": (
        "16", "Disruption budget: max evicted-but-not-yet-rebound pods "
              "allowed in flight at once; new batches are vetoed while it "
              "is spent"),
}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def get(name: str, default: "str | None" = None) -> str:
    """The raw string value: environment, else ``default`` (a knob whose
    default is computed at its call site), else the declared default."""
    try:
        declared = REGISTRY[name][0]
    except KeyError:
        raise KeyError(f"{name} is not a declared knob of "
                       f"kubernetes_tpu_torch.utils.knobs") from None
    raw = os.environ.get(name)
    if raw is not None and raw.strip():
        return raw.strip()
    return declared if default is None else default


def get_int(name: str, default: "int | None" = None) -> int:
    raw = get(name, None if default is None else str(default))
    try:
        return int(float(raw)) if raw else 0
    except ValueError:
        fallback = default if default is not None else \
            int(float(REGISTRY[name][0] or "0"))
        log.warning("bad %s=%r; using %s", name, raw, fallback)
        return fallback


def get_float(name: str, default: "float | None" = None) -> float:
    raw = get(name, None if default is None else str(default))
    try:
        return float(raw) if raw else 0.0
    except ValueError:
        fallback = default if default is not None else \
            float(REGISTRY[name][0] or "0")
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

"""Decision flight recorder: a bounded ring of the last N batch decisions.

"Why is my pod unschedulable?" is unanswerable from a running daemon when
the only artifacts are latency histograms — the decision itself (which node
won, which predicates failed where) is gone the moment the drain returns.
The recorder keeps one compact record per drained batch: the placement map
(pod -> node or None), per-pod failure detail (message + per-predicate
failure counts, the ``FitError.failed_predicates`` aggregation), and the
batch's trace id so a decision links to its spans at ``/debug/traces``.

Served at ``/debug/scheduler/decisions`` (batch summaries; ``?pod=ns/name``
explains one pod) and queryable via ``kubectl ... explain pod NAME``.

Recording cost on the hot path is one dict build per batch (the placement
lists the drain already produced); failure *detail* is computed only for
failed pods, capped, and only by the daemon path (the engine's
``explain_failures``)."""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

from kubernetes_tpu_torch.utils import knobs, locktrace

# Ring capacity in BATCHES (a batch may be one pod or thirty thousand).
DEFAULT_CAPACITY = 64
# The ring's on-disk form under KT_FLIGHT_DIR: dumped on graceful
# shutdown, reloaded on startup, so `kubectl explain pod` keeps answering
# across a scheduler bounce (the soak's restart scenario).
FLIGHT_FILE = "flight_ring.json"
# Failure-detail entries kept per batch (explain_failures caps its device
# work the same way).
MAX_FAILURES_PER_BATCH = 256
# Top-k score entries surfaced per explained pod.
TOP_K = 5


class BatchRecord:
    __slots__ = ("batch_id", "trace_id", "ts", "duration_s", "size",
                 "placed", "placements", "failures", "tenants")

    def __init__(self, batch_id: int, trace_id: str, ts: float,
                 duration_s: float, placements: dict,
                 failures: dict, tenants: dict | None = None):
        self.batch_id = batch_id
        self.trace_id = trace_id
        self.ts = ts
        self.duration_s = duration_s
        self.size = len(placements)
        self.placed = sum(1 for v in placements.values() if v is not None)
        self.placements = placements      # pod key -> node name | None
        self.failures = failures          # pod key -> detail dict
        self.tenants = tenants            # tenant -> row count (tenancy on)

    def summary(self) -> dict:
        out = {"batch_id": self.batch_id, "trace_id": self.trace_id,
               "ts": self.ts, "duration_s": round(self.duration_s, 6),
               "size": self.size, "placed": self.placed,
               "failed": self.size - self.placed}
        if self.tenants:
            out["tenants"] = self.tenants
        return out


class FlightRecorder:
    """Thread-safe ring of batch decisions + a side channel for post-batch
    failures (bind conflicts arrive from the async bind fan-out after the
    batch record was written; they amend it in place)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 flight_dir: str | None = None):
        """``flight_dir`` (default: the KT_FLIGHT_DIR env var) names a
        directory whose persisted ring, if any, is reloaded — batch ids
        continue past the reloaded maximum so restart records never
        collide with pre-restart ones."""
        self._ring: deque[BatchRecord] = deque(maxlen=max(1, capacity))
        self._lock = locktrace.make_lock("scheduler.FlightRecorder")
        self._seq = itertools.count(1)
        if flight_dir is None:
            flight_dir = knobs.get("KT_FLIGHT_DIR")
        if flight_dir:
            try:
                self.load(flight_dir)
            except Exception:  # noqa: BLE001 — a torn, wrong-shaped, or
                pass           # absent dump must never block startup

    # -- recording --------------------------------------------------------

    def record_batch(self, pods, placements, trace_id: str = "",
                     duration_s: float = 0.0,
                     failure_detail: dict | None = None,
                     tenants: dict | None = None) -> int:
        """One drained batch: parallel (pods, placements) lists as produced
        by ``schedule_batch``; ``failure_detail`` maps pod key ->
        {"failed_predicates": {...}, ...} for the pods the engine
        explained.  ``tenants`` (tenant -> row count, tenancy rigs only)
        tags the record so ``/debug/scheduler/decisions?tenant=`` can
        filter one tenant's decision history.  Returns the batch id."""
        placement_map = {pod.key: dest
                         for pod, dest in zip(pods, placements)}
        failures: dict = {}
        detail = failure_detail or {}
        failed_keys = [pod.key for pod, dest in zip(pods, placements)
                       if dest is None]
        with self._lock:
            # Backoff loops re-drain the same unschedulable pod every few
            # seconds: a single-pod failed batch whose pod's newest record
            # is the same single-pod failure refreshes that record in
            # place instead of churning real batches out of the ring.
            if len(placement_map) == 1 and len(failed_keys) == 1:
                key = failed_keys[0]
                for rec in reversed(self._ring):
                    if key in rec.placements:
                        if rec.size == 1 and rec.placements[key] is None:
                            rec.ts = time.time()
                            if detail.get(key):
                                rec.failures[key] = detail[key]
                            return rec.batch_id
                        break
            for pod, dest in zip(pods, placements):
                if dest is not None:
                    continue
                if len(failures) >= MAX_FAILURES_PER_BATCH:
                    break
                failures[pod.key] = detail.get(pod.key) or {
                    "message":
                    f"pod ({pod.name}) failed to fit in any node"}
            batch_id = next(self._seq)
            rec = BatchRecord(batch_id, trace_id, time.time(),
                              duration_s, placement_map, failures,
                              tenants=tenants)
            self._ring.append(rec)
        return batch_id

    def record_failure(self, pod_key: str, reason: str, message: str,
                       failed_predicates: dict | None = None) -> None:
        """Amend (or create) the failure entry for a pod — the
        ``_handle_failure`` hook: fit errors, bind conflicts, and drain
        crashes all pass through it.  If the pod belongs to a recorded
        batch, the batch's entry is updated; otherwise a one-pod record is
        appended (the single-pod ``schedule_one`` path)."""
        entry = {"reason": reason, "message": message}
        if failed_predicates:
            entry["failed_predicates"] = dict(failed_predicates)
        with self._lock:
            for rec in reversed(self._ring):
                if pod_key in rec.placements:
                    # Keep the engine's richer detail (predicate counts,
                    # top-scoring nodes) when this amend doesn't carry it.
                    old = rec.failures.get(pod_key)
                    if old:
                        entry = {**old, **entry}
                    if len(rec.failures) < MAX_FAILURES_PER_BATCH or \
                            pod_key in rec.failures:
                        rec.failures[pod_key] = entry
                    if rec.placements.get(pod_key) is not None:
                        # A bind failure demoted a placed pod.
                        rec.placements[pod_key] = None
                        rec.placed -= 1
                    return
            rec = BatchRecord(next(self._seq), "", time.time(), 0.0,
                              {pod_key: None}, {pod_key: entry})
            self._ring.append(rec)

    def record_preemption(self, pod_key: str, node: str,
                          victims: list[str]) -> None:
        """A preemption decision promoted this pod from unschedulable to
        placed-with-evictions: amend its newest record with the nominated
        node and victim set (the reference's status.nominatedNodeName,
        surfaced by ``kubectl explain``)."""
        detail = {"nominated_node": node,
                  "preempted_victims": list(victims)}
        with self._lock:
            for rec in reversed(self._ring):
                if pod_key not in rec.placements:
                    continue
                if rec.placements.get(pod_key) is None:
                    rec.placements[pod_key] = node
                    rec.placed += 1
                old = rec.failures.get(pod_key)
                rec.failures[pod_key] = {**old, **detail} if old else detail
                return
            rec = BatchRecord(next(self._seq), "", time.time(), 0.0,
                              {pod_key: node}, {pod_key: detail})
            self._ring.append(rec)

    def record_defrag(self, pod_key: str, decision: str,
                      from_node: str = "", to_node: str = "",
                      target: str = "") -> None:
        """A defragmentation decision touched this pod
        (scheduler/defrag.py): ``decision`` is one of proposed /
        executed / completed / vetoed_budget / vetoed_pdb /
        cas_conflict / crash-recovered; ``from_node``/``to_node`` frame
        the migration, ``target`` names the blocked pod the move serves.
        Amends the pod's newest record so ``kubectl explain pod``
        answers "why did the rebalancer move me"."""
        detail: dict = {"defrag": decision}
        if from_node:
            detail["migration_from"] = from_node
        if to_node:
            detail["migration_to"] = to_node
        if target:
            detail["migration_for"] = target
        with self._lock:
            for rec in reversed(self._ring):
                if pod_key not in rec.placements:
                    continue
                old = rec.failures.get(pod_key)
                rec.failures[pod_key] = {**old, **detail} if old \
                    else detail
                return
            rec = BatchRecord(next(self._seq), "", time.time(), 0.0,
                              {pod_key: to_node or None},
                              {pod_key: detail})
            self._ring.append(rec)

    # -- persistence across restarts (KT_FLIGHT_DIR) ----------------------

    def save(self, flight_dir: str) -> str:
        """Dump the ring to ``flight_dir/flight_ring.json`` (atomic
        rename, so a crash mid-dump leaves the previous dump intact).
        Called by Scheduler.stop(); returns the written path."""
        os.makedirs(flight_dir, exist_ok=True)
        with self._lock:
            records = [{"batch_id": r.batch_id, "trace_id": r.trace_id,
                        "ts": r.ts, "duration_s": r.duration_s,
                        "placements": r.placements,
                        "failures": r.failures,
                        "tenants": r.tenants}
                       for r in self._ring]
        path = os.path.join(flight_dir, FLIGHT_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"capacity": self._ring.maxlen,
                       "records": records}, f, separators=(",", ":"))
        os.replace(tmp, path)
        return path

    def load(self, flight_dir: str) -> int:
        """Reload a persisted ring (newest records win if the dump holds
        more than capacity); the id sequence resumes past the reloaded
        maximum.  Returns the number of records restored."""
        path = os.path.join(flight_dir, FLIGHT_FILE)
        if not os.path.exists(path):
            return 0
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        max_id = 0
        with self._lock:
            for rec in data.get("records", []):
                self._ring.append(BatchRecord(
                    int(rec["batch_id"]), rec.get("trace_id", ""),
                    float(rec.get("ts", 0.0)),
                    float(rec.get("duration_s", 0.0)),
                    dict(rec.get("placements") or {}),
                    dict(rec.get("failures") or {}),
                    tenants=rec.get("tenants") or None))
                max_id = max(max_id, int(rec["batch_id"]))
            self._seq = itertools.count(max_id + 1)
            return len(data.get("records", []))

    # -- querying ---------------------------------------------------------

    def explain(self, pod_key: str) -> dict | None:
        """The most recent decision for a pod, or None if it aged out.
        Predicate-count detail is backfilled from an older record when
        the newest one lacks it — the engine's explain pass runs under a
        cooldown, so a requeued pod's latest failure often carries only
        the message while an earlier record carries the counts."""
        with self._lock:
            out = None
            for rec in reversed(self._ring):
                if pod_key not in rec.placements:
                    continue
                if out is None:
                    dest = rec.placements[pod_key]
                    out = {"pod": pod_key, "batch_id": rec.batch_id,
                           "trace_id": rec.trace_id, "ts": rec.ts,
                           "result": "scheduled" if dest is not None
                           else "unschedulable",
                           "node": dest}
                    detail = rec.failures.get(pod_key)
                    if detail:
                        out.update(detail)
                    if dest is not None or \
                            "failed_predicates" in out:
                        return out
                    continue
                older = rec.failures.get(pod_key) or {}
                if "failed_predicates" in older:
                    for k, v in older.items():
                        out.setdefault(k, v)
                    return out
            return out

    def snapshot(self, limit: int = 0, tenant: str = "") -> dict:
        """Batch summaries, newest first (the /debug endpoint body).
        ``tenant`` filters to batches carrying that tenant's rows (the
        per-tenant flight-recorder view; untagged records — tenancy
        off — never match a tenant filter)."""
        with self._lock:
            recs = list(self._ring)
        recs.reverse()
        if tenant:
            recs = [r for r in recs if r.tenants and tenant in r.tenants]
        if limit > 0:
            recs = recs[:limit]
        return {"capacity": self._ring.maxlen,
                "batches": [r.summary() for r in recs]}

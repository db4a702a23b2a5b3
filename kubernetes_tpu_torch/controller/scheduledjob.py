"""ScheduledJob controller: cron-driven Job creation.

The reference's scheduledjob controller (pkg/controller/scheduledjob/
controller.go:127-270 syncOne; utils.go:124-180
getRecentUnmetScheduleTimes) polls every 10 s, and for each ScheduledJob:

* reconciles ``status.active`` against the Jobs it created (finished
  jobs leave the active list);
* skips suspended objects;
* computes the unmet schedule times since
  max(status.lastScheduleTime, metadata.creationTimestamp) — more than
  100 missed times is an error (utils.go:169-175), only the LATEST is
  started (controller.go:166-173);
* honors ``startingDeadlineSeconds`` (a too-late start is skipped);
* concurrencyPolicy: Forbid skips while a prior Job is active; Replace
  deletes the active Jobs (and their pods) first (controller.go:191-252);
* creates the Job from ``spec.jobTemplate`` named
  ``<name>-<scheduledTime-unix-minutes>`` (deterministic per slot, so a
  crashed controller can't double-start the same slot) and records
  ``status.lastScheduleTime``.

Created Jobs carry an ownerReference to the ScheduledJob — the garbage
collector reaps them when the ScheduledJob is deleted.

A copy of ``kubernetes_tpu/controller/scheduledjob.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import threading
import time
from datetime import datetime, timezone
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client import cas_update
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils import cron
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("scheduledjob-controller")

SYNC_PERIOD = 1.0   # the reference polls every 10 s (controller.go:103);
# compressed for the hollow rig's time scale, same loop shape.
SJ_LABEL = "scheduled-job-name"


from kubernetes_tpu_torch.utils.timeutil import (format_rfc3339 as _fmt_time,
                                           parse_rfc3339 as _parse_time)


def _job_finished(job: dict) -> bool:
    return any(c.get("type") in ("Complete", "Failed")
               and c.get("status") == "True"
               for c in (job.get("status") or {}).get("conditions") or ())


def unmet_schedule_times(sj: dict, now: datetime) -> list[datetime]:
    """getRecentUnmetScheduleTimes (utils.go:124-180): every schedule
    time after max(lastScheduleTime, creationTimestamp) and not after
    now, oldest first; ValueError past 100 missed starts."""
    sched = cron.parse((sj.get("spec") or {}).get("schedule", ""))
    status = sj.get("status") or {}
    meta = sj.get("metadata") or {}
    if status.get("lastScheduleTime"):
        earliest = _parse_time(status["lastScheduleTime"])
    else:
        earliest = _parse_time(meta.get("creationTimestamp")
                               or _fmt_time(now))
    if earliest > now:
        return []
    starts: list[datetime] = []
    t = sched.next(earliest)
    while t <= now:
        starts.append(t)
        if len(starts) > 100:
            raise ValueError("too many missed start times to list")
        t = sched.next(t)
    return starts


class ScheduledJobController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None, clock=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        # Injectable clock (the reference's syncOne takes ``now`` for
        # exactly this testability, controller.go:127).
        self.clock = clock or (lambda: datetime.now(timezone.utc))
        self._sjs: dict[str, dict] = {}
        self._jobs_by_ns: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "ScheduledJobController":
        for kind, handler in (("scheduledjobs", self._on_sj),
                              ("jobs", self._on_job)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="scheduledjob-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_sj(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._sjs.pop(key, None)
            else:
                self._sjs[key] = obj

    def _on_job(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        with self._lock:
            bucket = self._jobs_by_ns.setdefault(ns, {})
            if etype == "DELETED":
                bucket.pop(key, None)
            else:
                bucket[key] = obj

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("scheduledjob sync crashed; continuing")

    def sync_all(self, now: datetime | None = None) -> None:
        now = now or self.clock()
        with self._lock:
            sjs = list(self._sjs.values())
        for sj in sjs:
            try:
                self.sync_one(sj, now)
            except Exception:  # noqa: BLE001 — one bad SJ can't stall
                log.exception("scheduledjob sync_one failed")

    def _my_jobs(self, ns: str, name: str) -> list[dict]:
        with self._lock:
            jobs = list(self._jobs_by_ns.get(ns, {}).values())
        return [j for j in jobs
                if ((j.get("metadata") or {}).get("labels") or {})
                .get(SJ_LABEL) == name]

    def sync_one(self, sj: dict, now: datetime) -> None:
        meta = sj.get("metadata") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        # Always act on a FRESH read: the reflector copy may predate the
        # previous sync's own lastScheduleTime write, and re-deciding
        # slot T from stale status would (under Replace) cascade-delete
        # the job that very sync just started.
        fresh = self.store.get("scheduledjobs", f"{ns}/{name}")
        if fresh is None:
            return
        sj = fresh
        meta = sj.get("metadata") or {}
        spec = sj.get("spec") or {}
        if not meta.get("creationTimestamp"):
            # Objects recovered from a pre-creationTimestamp snapshot
            # would otherwise never fire (earliest would fall back to
            # "now" forever): backfill once, schedule from here on.
            try:
                cas_update(self.store, "scheduledjobs", {
                    **sj, "metadata": {**meta,
                                       "creationTimestamp":
                                           _fmt_time(now)}})
            except Exception:  # noqa: BLE001 — CAS race: next sync
                pass
            return
        mine = self._my_jobs(ns, name)
        active = [{"namespace": ns,
                   "name": (j.get("metadata") or {}).get("name", "")}
                  for j in mine if not _job_finished(j)]
        status = dict(sj.get("status") or {})
        if status.get("active") != active:
            status["active"] = active
            self._publish(sj, {"active": active})
            sj = {**sj, "status": status}

        if spec.get("suspend"):
            return
        try:
            times = unmet_schedule_times(sj, now)
        except ValueError as err:
            log.warning("scheduledjob %s/%s: %s", ns, name, err)
            return
        if not times:
            return
        scheduled = times[-1]  # only the latest (controller.go:166-173)
        deadline = spec.get("startingDeadlineSeconds")
        if deadline is not None and \
                (now - scheduled).total_seconds() > float(deadline):
            log.warning("scheduledjob %s/%s missed starting window",
                        ns, name)
            return
        policy = spec.get("concurrencyPolicy", "Allow")
        if policy == "Forbid" and active:
            return
        if policy == "Replace":
            for ref in active:
                self._delete_job_cascade(ref["namespace"], ref["name"])
        self._start_job(sj, ns, name, scheduled, status)

    def _delete_job_cascade(self, ns: str, name: str) -> None:
        """JobReaper shape (controller.go:205-252): scale the job to 0,
        delete its pods, then the job."""
        try:
            job = self.store.get("jobs", f"{ns}/{name}")
            if job is not None:
                job = {**job, "spec": {**(job.get("spec") or {}),
                                       "parallelism": 0}}
                try:
                    cas_update(self.store, "jobs", job)
                except Exception:  # noqa: BLE001 — best effort
                    pass
            pods, _ = self.store.list(
                "pods", lambda o: ((o.get("metadata") or {})
                                   .get("labels") or {})
                .get("job-name") == name and
                (o.get("metadata") or {})
                .get("namespace", "default") == ns)
            for p in pods:
                try:
                    self.store.delete(
                        "pods",
                        f"{ns}/{(p.get('metadata') or {}).get('name')}")
                except Exception:  # noqa: BLE001 — already gone
                    pass
            self.store.delete("jobs", f"{ns}/{name}")
        except Exception:  # noqa: BLE001 — next sync retries
            log.exception("replace-delete of job %s/%s failed", ns, name)

    def _start_job(self, sj: dict, ns: str, name: str,
                   scheduled: datetime, status: dict) -> None:
        template = (sj.get("spec") or {}).get("jobTemplate") or {}
        tmeta = dict(template.get("metadata") or {})
        labels = dict(tmeta.get("labels") or {})
        labels[SJ_LABEL] = name
        # Deterministic per-slot name (getJobFromTemplate: the reference
        # hashes the scheduled time the same way): a controller restart
        # mid-slot collides on create instead of double-starting.
        job_name = f"{name}-{int(scheduled.timestamp()) // 60}"
        job = {"metadata": {
                   "name": job_name, "namespace": ns, "labels": labels,
                   "annotations": dict(tmeta.get("annotations") or {}),
                   "ownerReferences": [{
                       "kind": "ScheduledJob", "name": name,
                       "controller": True}]},
               "spec": dict(template.get("spec") or {})}
        try:
            self.store.create("jobs", job)
        except Exception as err:  # noqa: BLE001 — exists = already started
            log.info("job %s/%s not created: %s", ns, job_name, err)
            return
        ref = {"namespace": ns, "name": job_name}
        # The lastScheduleTime publish is NOT best-effort like the active-
        # list reconcile: if it's lost, the next sync re-decides slot T
        # from stale status and (under concurrencyPolicy=Replace)
        # cascade-deletes and recreates the job it just started.  Retry
        # the CAS a few times against a fresh read before giving up.
        self._publish(sj, {"lastScheduleTime": _fmt_time(scheduled)},
                      add_active=ref, retries=3)

    def _publish(self, sj: dict, patch: dict,
                 add_active: dict | None = None, retries: int = 1) -> None:
        """Merge ``patch`` into the FRESH stored status under CAS —
        a whole-status overwrite from a cache-derived dict would clobber
        a lastScheduleTime written between our read and now.  ``retries``
        bounds how many fresh-read + CAS rounds a lost race gets."""
        meta = sj.get("metadata") or {}
        key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        for attempt in range(max(1, retries)):
            try:
                cur = self.store.get("scheduledjobs", key)
                if cur is None:
                    return
                status = dict(cur.get("status") or {})
                status.update(patch)
                if add_active is not None and \
                        add_active not in (status.get("active") or []):
                    status["active"] = list(status.get("active") or []) + \
                        [add_active]
                if (cur.get("status") or {}) != status:
                    cas_update(self.store, "scheduledjobs",
                               {**cur, "status": status})
                return
            except Exception:  # noqa: BLE001 — CAS race or transport
                if attempt + 1 >= max(1, retries):
                    log.warning("scheduledjob %s: status publish %s lost "
                                "after %d attempts", key, list(patch),
                                attempt + 1)
                    return
                time.sleep(0.02 * (attempt + 1))

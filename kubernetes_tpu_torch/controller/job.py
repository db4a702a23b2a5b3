"""Job controller: run-to-completion workloads.

The reference's job controller (pkg/controller/job/controller.go) keeps
``min(parallelism, completions - succeeded)`` pods active until
``completions`` pods have Succeeded, then stamps the Complete condition
and stops.  This is that loop over the apiserver surface: pods are
stamped from the template with a ``job-name`` label (the reference's
generated selector collapses to the same discipline), succeeded pods are
never deleted (they are the Job's record), and status reports
active/succeeded/failed plus the completion condition.

A copy of ``kubernetes_tpu/controller/job.py`` with its imports pointed
at this package.
"""

from __future__ import annotations

import random
import string
import threading
import time
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("job-controller")

SYNC_PERIOD = 0.5
JOB_LABEL = "job-name"


def _phase(pod: dict) -> str:
    return (pod.get("status") or {}).get("phase", "")


def _active(pod: dict) -> bool:
    return _phase(pod) not in ("Succeeded", "Failed") and \
        not (pod.get("metadata") or {}).get("deletionTimestamp")


class JobController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._jobs: dict[str, dict] = {}
        self._pods_by_ns: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []
        self._rand = random.Random()
        # Pending-create expectations, as in the replication manager: a
        # lagging pod watch must not double-create active pods.
        self._pending: dict[str, dict[str, float]] = {}
        self._ttl = max(5.0, 5 * sync_period)

    def run(self) -> "JobController":
        for kind, handler in (("jobs", self._on_job),
                              ("pods", self._on_pod)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="job-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_job(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._jobs.pop(key, None)
                self._pending.pop(key, None)
            else:
                self._jobs[key] = obj

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        with self._lock:
            bucket = self._pods_by_ns.setdefault(ns, {})
            if etype == "DELETED":
                bucket.pop(key, None)
            else:
                bucket[key] = obj

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("job sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            jobs = list(self._jobs.items())
        for key, job in jobs:
            ns = (job.get("metadata") or {}).get("namespace", "default")
            with self._lock:
                pods = list(self._pods_by_ns.get(ns, {}).values())
            self._sync_one(key, job, pods)

    def _sync_one(self, key: str, job: dict, pods: list[dict]) -> None:
        meta = job.get("metadata") or {}
        spec = job.get("spec") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        completions = int(spec.get("completions", 1) or 1)
        parallelism = int(spec.get("parallelism", 1) or 1)
        mine = [p for p in pods
                if ((p.get("metadata") or {}).get("labels") or {})
                .get(JOB_LABEL) == name]
        succeeded = sum(1 for p in mine if _phase(p) == "Succeeded")
        failed = sum(1 for p in mine if _phase(p) == "Failed")
        active = [p for p in mine if _active(p)]

        now = time.time()
        with self._lock:
            if key in self._jobs:
                pending = self._pending.setdefault(key, {})
            else:
                pending = {}
            names = {(p.get("metadata") or {}).get("name", "")
                     for p in mine}
            for n in list(pending):
                if n in names or now > pending[n]:
                    pending.pop(n, None)
            have_active = len(active) + len(pending)

        complete = succeeded >= completions
        if complete:
            # The reference deletes the remaining active pods once
            # completions is reached (job controller manageJob): a watch-
            # lag overshoot pod must not run forever on a Complete job.
            for p in active:
                pmeta = p.get("metadata") or {}
                try:
                    self.store.delete("pods", f"{ns}/{pmeta.get('name')}")
                except Exception:  # noqa: BLE001 — already gone
                    pass
        else:
            want_active = min(parallelism, completions - succeeded)
            if have_active < want_active:
                for _ in range(want_active - have_active):
                    created = self._create_pod(job, ns, name)
                    if created:
                        with self._lock:
                            # Under the lock: a concurrent DELETED handler
                            # may have detached this job's ledger, and a
                            # write outside would land in the orphan.
                            if key in self._jobs:
                                self._pending.setdefault(
                                    key, {})[created] = now + self._ttl
            elif have_active > want_active:
                # Scale down never touches succeeded pods.
                for p in active[: have_active - want_active]:
                    pmeta = p.get("metadata") or {}
                    try:
                        self.store.delete(
                            "pods", f"{ns}/{pmeta.get('name')}")
                    except Exception:  # noqa: BLE001 — already gone
                        pass

        status = {
            "active": len(active), "succeeded": succeeded,
            "failed": failed,
        }
        if complete:
            status["conditions"] = [{"type": "Complete", "status": "True"}]
            # The first completion stamp is the record; later syncs keep
            # it while counts (active draining to 0) stay live.
            status["completionTime"] = \
                (job.get("status") or {}).get("completionTime") \
                or time.time()
        cur = dict(job)
        if (cur.get("status") or {}) != status:
            try:
                self.store.update("jobs", {**cur, "status": status})
            except Exception:  # noqa: BLE001 — CAS race: next sync heals
                pass

    def _create_pod(self, job: dict, ns: str, name: str) -> str | None:
        template = (job.get("spec") or {}).get("template") or {}
        tmeta = dict(template.get("metadata") or {})
        labels = dict(tmeta.get("labels") or {})
        labels[JOB_LABEL] = name
        suffix = "".join(self._rand.choices(
            string.ascii_lowercase + string.digits, k=5))
        pod = {"metadata": {"name": f"{name}-{suffix}", "namespace": ns,
                            "labels": labels,
                            "annotations": dict(tmeta.get("annotations")
                                                or {})},
               "spec": dict(template.get("spec")
                            or {"containers": [{"name": "c"}]})}
        try:
            self.store.create("pods", pod)
            return pod["metadata"]["name"]
        except Exception:  # noqa: BLE001 — apiserver down: next sync
            return None

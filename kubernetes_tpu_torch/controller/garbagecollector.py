"""Garbage collector: ownerReference-driven orphan deletion.

The reference's garbage collector (pkg/controller/garbagecollector/
garbagecollector.go — alpha in 1.4 behind --enable-garbage-collector)
builds a dependency graph from ``metadata.ownerReferences`` and deletes
any object whose owners are all gone.  This is that loop over the
store's simpler identity model: owners are matched by (kind, name) in
the dependent's namespace (the store has no UIDs; names are stable
identities here, which is also why petset pets are safe dependents).

Producers in-tree: the petset controller owns its pets, the
scheduledjob controller owns its Jobs.  Any client may set
ownerReferences and get the same reaping.

An object with ownerReferences is deleted when EVERY owner is absent
(garbagecollector.go processItem: "if none of the owners exist, delete
the item").  Objects without ownerReferences are never touched.

A copy of ``kubernetes_tpu/controller/garbagecollector.py`` with its
imports pointed at this package.
"""

from __future__ import annotations

import threading
from typing import Union

from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("garbage-collector")

SYNC_PERIOD = 2.0

# Owner kind (as written in ownerReferences) -> resource name.  The
# reference maps through RESTMapper; this is that table for the kinds
# served here.
KIND_TO_RESOURCE = {
    "Pod": "pods",
    "ReplicationController": "replicationcontrollers",
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
    "DaemonSet": "daemonsets",
    "Job": "jobs",
    "ScheduledJob": "scheduledjobs",
    "PetSet": "petsets",
    "Service": "services",
    "Namespace": "namespaces",
}

# Kinds scanned for dependents: everything namespaced (dependents name
# their owner; the scan is per-kind LIST, control-plane-rate work).
DEPENDENT_KINDS = tuple(sorted(NAMESPACED_KINDS))


class GarbageCollector:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            # The sweep is LIST-heavy by design (the reference GC is a
            # graph resync too); the default 5-QPS client would make one
            # sweep outlast the sync period on its own rate limiter.
            source = APIClient(source, qps=200, burst=400, token=token,
                               tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run(self) -> "GarbageCollector":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="garbage-collector")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("gc sweep crashed; continuing")

    def _owner_exists(self, ref: dict, ns: str, memo: dict) -> bool:
        resource = KIND_TO_RESOURCE.get(ref.get("kind", ""))
        if resource is None:
            # Unknown owner kind: treat as existing — deleting on a
            # mapping gap would reap live objects.
            return True
        name = ref.get("name", "")
        key = name if resource == "namespaces" or \
            resource not in NAMESPACED_KINDS else f"{ns}/{name}"
        memo_key = (resource, key)
        if memo_key in memo:
            return memo[memo_key]
        try:
            exists = self.store.get(resource, key) is not None
        except Exception:  # noqa: BLE001 — apiserver down: assume alive
            return True  # transient: don't memoize a guess
        memo[memo_key] = exists
        return exists

    def sync_once(self) -> int:
        """One full sweep; returns the number of objects deleted."""
        deleted = 0
        # Owner lookups memoized per sweep: a PetSet with 50 pets is one
        # GET, not 50.
        memo: dict = {}
        for kind in DEPENDENT_KINDS:
            try:
                items, _ = self.store.list(kind)
            except Exception:  # noqa: BLE001 — kind not served: skip
                continue
            for obj in items:
                meta = obj.get("metadata") or {}
                refs = meta.get("ownerReferences") or []
                if not refs:
                    continue
                ns = meta.get("namespace", "default")
                if any(self._owner_exists(r, ns, memo) for r in refs):
                    continue
                key = f"{ns}/{meta.get('name')}" \
                    if kind in NAMESPACED_KINDS else meta.get("name", "")
                try:
                    self.store.delete(kind, key)
                    deleted += 1
                    log.info("gc: deleted orphaned %s %s", kind, key)
                except Exception:  # noqa: BLE001 — already gone
                    pass
        return deleted

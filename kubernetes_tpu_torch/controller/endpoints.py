"""Endpoints controller: keep each Service's Endpoints object equal to
the IPs of its running, selector-matching pods.

The reference's endpoint controller (pkg/controller/endpoint) joins the
service and pod watches and writes Endpoints objects the proxies consume
(pkg/proxy watches Services + Endpoints).  Subset shape matches v1:
``{"subsets": [{"addresses": [{"ip", "targetRef"}]}]}``.

A copy of ``kubernetes_tpu/controller/endpoints.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import threading
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("endpoints-controller")

SYNC_PERIOD = 1.0


class EndpointsController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._services: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        self._endpoints: dict[str, dict] = {}
        self._deleted_services: set[str] = set()
        self._dirty: set[str] = set()  # service keys needing a sync
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "EndpointsController":
        for kind, handler in (("services", self._on_service),
                              ("pods", self._on_pod),
                              ("endpoints", self._on_endpoints)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._sync_loop, daemon=True,
                             name="endpoints-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_service(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                svc = self._services.pop(key, None)
                # Only garbage-collect endpoints this controller manages
                # (selector-bearing services); manual endpoints of
                # selectorless services are left alone.
                if svc is not None and \
                        (svc.get("spec") or {}).get("selector"):
                    self._deleted_services.add(key)
            else:
                self._services[key] = obj
                self._dirty.add(key)

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        with self._lock:
            if etype == "DELETED":
                self._pods.pop(key, None)
            else:
                self._pods[key] = obj
            # A pod event can affect any service in its namespace: mark
            # them dirty rather than rescanning services x pods every
            # sync (the reference controller is queue-driven the same
            # way).
            prefix = f"{ns}/"
            self._dirty.update(k for k in self._services
                               if k.startswith(prefix))

    def _on_endpoints(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._endpoints.pop(key, None)
                # Out-of-band deletion of a managed service's endpoints:
                # re-dirty the service so the object is recreated (the
                # old full-rescan did this implicitly).
                if key in self._services:
                    self._dirty.add(key)
            else:
                self._endpoints[key] = obj

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("endpoints sync crashed; continuing")

    def sync_all(self, full: bool = False) -> None:
        """Sync dirty services (event-driven); ``full`` rescans all."""
        with self._lock:
            if full:
                dirty = set(self._services)
            else:
                dirty = self._dirty
                self._dirty = set()
            services = [self._services[k] for k in dirty
                        if k in self._services]
            pods = list(self._pods.values())
            gone = list(self._deleted_services)
            self._deleted_services.clear()
        # GC endpoints of deleted selector-bearing services.
        from kubernetes_tpu_torch.client.http import APIError
        for key in gone:
            try:
                self.store.delete("endpoints", key)
            except Exception as err:  # noqa: BLE001
                if isinstance(err, KeyError) or \
                        (isinstance(err, APIError) and err.status == 404):
                    continue  # already gone
                # Transient failure (apiserver away): retry next sync —
                # clearing the key here would leak the object forever.
                with self._lock:
                    self._deleted_services.add(key)
        for svc in services:
            self._sync_one(svc, pods)

    def _sync_one(self, svc: dict, pods: list[dict]) -> None:
        meta = svc.get("metadata") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        selector = (svc.get("spec") or {}).get("selector") or {}
        if not selector:
            # Selectorless services carry manually-managed endpoints
            # (external-backend pattern): not ours to touch (the reference
            # controller skips them the same way).
            return
        addresses = []
        for pod in pods:
            pmeta = pod.get("metadata") or {}
            status = pod.get("status") or {}
            if pmeta.get("namespace", "default") != ns:
                continue
            labels = pmeta.get("labels") or {}
            if not all(labels.get(k) == v for k, v in selector.items()):
                continue
            if status.get("phase") != "Running" or \
                    not status.get("podIP"):
                continue
            addresses.append({
                "ip": status["podIP"],
                "targetRef": {"kind": "Pod", "namespace": ns,
                              "name": pmeta.get("name", "")}})
        addresses.sort(key=lambda a: a["ip"])
        subsets = [{"addresses": addresses}] if addresses else []
        key = f"{ns}/{name}"
        # Compare against the WATCHED endpoints cache: the no-change path
        # costs nothing on the wire (one GET per service per sync would
        # saturate a 5-QPS client at five services).
        with self._lock:
            current = self._endpoints.get(key)
        if current is not None and current.get("subsets", []) == subsets:
            return  # no-op sync: don't churn resourceVersions
        try:
            if current is None:
                self.store.create("endpoints", {
                    "metadata": {"name": name, "namespace": ns},
                    "subsets": subsets})
            else:
                updated = dict(current)
                updated["subsets"] = subsets
                from kubernetes_tpu_torch.client import cas_update
                cas_update(self.store, "endpoints", updated)
        except Exception:  # noqa: BLE001 — raced another writer or a
            # transient failure: RE-DIRTY so the event-driven sync
            # retries (a lost write would otherwise wait for the next
            # unrelated pod/service event).
            with self._lock:
                self._dirty.add(key)

"""ResourceQuota controller: periodic usage resync.

The reference's quota controller (pkg/controller/resourcequota/
resource_quota_controller.go: full resync every
--resource-quota-sync-period, plus replenishment on pod deletion)
recalculates each quota's observed usage and publishes
``status.hard``/``status.used``.  Here admission already recomputes
usage on every pod WRITE (apiserver/validation.py ResourceQuota), but
that path never runs on deletes — without this controller,
``status.used`` stays stale after scale-downs until the next create.

Usage formulas match the admission plugin and the reference evaluator
(pkg/quota/evaluator/core/pods.go): non-terminal pods count 1 toward
``pods``; cpu/memory sum container requests; terminal (Succeeded/
Failed) pods stop counting.

A copy of ``kubernetes_tpu/controller/resourcequota.py`` with its
imports pointed at this package.
"""

from __future__ import annotations

import threading
from typing import Union

from kubernetes_tpu_torch.api.quantity import parse_quantity
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client import cas_update
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("resourcequota-controller")

SYNC_PERIOD = 1.0  # --resource-quota-sync-period, compressed for the rig


def _milli(val) -> int:
    try:
        return int(parse_quantity(val) * 1000)
    except (ValueError, TypeError, ArithmeticError):
        return 0


def compute_usage(pods: list[dict]) -> dict:
    """The pod evaluator's usage sums (pods.go podUsageHelper)."""
    n = cpu = mem = 0
    for p in pods:
        if (p.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
            continue
        n += 1
        for c in (p.get("spec") or {}).get("containers") or []:
            req = ((c.get("resources") or {}).get("requests")) \
                if isinstance(c, dict) else None
            req = req if isinstance(req, dict) else {}
            cpu += _milli(req.get("cpu")) if "cpu" in req else 0
            mem += _milli(req.get("memory")) if "memory" in req else 0
    return {"pods": str(n), "requests.cpu": f"{cpu}m",
            "requests.memory": str(mem // 1000)}


class ResourceQuotaController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._quotas: dict[str, dict] = {}
        self._pods_by_ns: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "ResourceQuotaController":
        for kind, handler in (("resourcequotas", self._on_quota),
                              ("pods", self._on_pod)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="resourcequota-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_quota(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._quotas.pop(key, None)
            else:
                self._quotas[key] = obj

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
                log.exception("resourcequota sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            quotas = list(self._quotas.values())
        for q in quotas:
            meta = q.get("metadata") or {}
            ns = meta.get("namespace", "default")
            with self._lock:
                pods = list(self._pods_by_ns.get(ns, {}).values())
            used = compute_usage(pods)
            status = {"hard": dict((q.get("spec") or {}).get("hard")
                                   or {}),
                      "used": used}
            if (q.get("status") or {}) == status:
                continue
            try:
                cur = self.store.get(
                    "resourcequotas",
                    f"{ns}/{meta.get('name', '')}")
                if cur is not None and \
                        (cur.get("status") or {}) != status:
                    cas_update(self.store, "resourcequotas",
                               {**cur, "status": status})
            except Exception:  # noqa: BLE001 — CAS race: next sync heals
                pass

"""Disruption controller: PodDisruptionBudget status.

The reference's disruption controller (pkg/controller/disruption/
disruption.go:447-601 trySync/updatePdbSpec) watches PDBs and their
selected pods and publishes:

* ``expectedPods`` — for an integer minAvailable, the number of selected
  pods; for a percentage, the summed SCALE of the distinct controllers
  owning those pods (disruption.go:464-531 getExpectedPodCount);
* ``desiredHealthy`` — minAvailable resolved against expectedPods
  (percentages round UP, intstr.GetValueFromIntOrPercent);
* ``currentHealthy`` — selected pods Running with Ready=True
  (disruption.go:533-545 countHealthyPods);
* ``disruptionAllowed`` — currentHealthy >= desiredHealthy and
  expectedPods > 0 (disruption.go:568).

The eviction subresource (apiserver/server.py) consumes
``disruptionAllowed`` with a CAS verify-and-decrement, exactly the
EvictionREST flow (pkg/registry/pod/etcd/etcd.go:138-230).

A copy of ``kubernetes_tpu/controller/disruption.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import math
import threading
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client import cas_update
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.controller.replication import _matches
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("disruption-controller")

SYNC_PERIOD = 0.5


def _healthy(pod: dict) -> bool:
    """countHealthyPods: Running AND the Ready condition True."""
    status = pod.get("status") or {}
    if status.get("phase") != "Running":
        return False
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in status.get("conditions") or ())


def resolve_min_available(min_available, expected: int) -> int:
    """intstr semantics: int -> itself; "N%" -> ceil(N% of expected)
    (GetValueFromIntOrPercent with roundUp=true)."""
    if isinstance(min_available, int):
        return min_available
    if isinstance(min_available, str) and min_available.endswith("%"):
        pct = float(min_available[:-1] or "0")
        return int(math.ceil(pct * expected / 100.0))
    raise ValueError(f"minAvailable must be an int or a percentage "
                     f"string, got {min_available!r}")


class DisruptionController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._pdbs: dict[str, dict] = {}
        self._pods_by_ns: dict[str, dict[str, dict]] = {}
        # Scale-carrying controllers the percentage denominator reads
        # (the reference's finders: RC, RS, Deployment; plus petsets).
        self._owners: dict[str, dict[str, dict]] = {
            k: {} for k in ("replicationcontrollers", "replicasets",
                            "deployments", "petsets")}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "DisruptionController":
        specs = [("poddisruptionbudgets", self._on_pdb),
                 ("pods", self._on_pod)]
        specs += [(k, self._owner_handler(k)) for k in self._owners]
        for kind, handler in specs:
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="disruption-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_pdb(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._pdbs.pop(key, None)
            else:
                self._pdbs[key] = obj

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        with self._lock:
            bucket = self._pods_by_ns.setdefault(ns, {})
            if etype == "DELETED":
                bucket.pop(key, None)
            else:
                bucket[key] = obj

    def _owner_handler(self, kind: str):
        def handler(etype: str, obj: dict) -> None:
            key = MemStore.object_key(obj)
            with self._lock:
                if etype == "DELETED":
                    self._owners[kind].pop(key, None)
                else:
                    self._owners[kind][key] = obj
        return handler

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("disruption sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            pdbs = list(self._pdbs.values())
        for pdb in pdbs:
            try:
                self.sync_one(pdb)
            except Exception:  # noqa: BLE001 — per-PDB failSafe below
                log.exception("pdb sync failed")

    def _find_owner_scales(self, pod: dict, ns: str) -> list[tuple]:
        """The reference's finders (disruption.go:341-440): every
        scale-carrying controller whose selector matches the pod, as
        (identity, scale) pairs."""
        out = []
        with self._lock:
            owners = {k: list(v.values()) for k, v in self._owners.items()}
        for kind, objs in owners.items():
            for o in objs:
                ometa = o.get("metadata") or {}
                if ometa.get("namespace", "default") != ns:
                    continue
                sel = (o.get("spec") or {}).get("selector") or {}
                if not _matches(sel, pod):
                    continue
                out.append(((kind, ometa.get("name", "")),
                            int((o.get("spec") or {})
                                .get("replicas", 0) or 0)))
        return out

    def sync_one(self, pdb: dict) -> dict:
        """trySync (disruption.go:447-462): compute + publish status.
        Returns the computed status (tests read it)."""
        meta = pdb.get("metadata") or {}
        ns = meta.get("namespace", "default")
        spec = pdb.get("spec") or {}
        selector = spec.get("selector") or {}
        with self._lock:
            pods = [p for p in self._pods_by_ns.get(ns, {}).values()
                    if _matches(selector, p)]
        min_available = spec.get("minAvailable", 0)
        try:
            if isinstance(min_available, str) and \
                    min_available.endswith("%"):
                # Percentage denominator: sum of the distinct owning
                # controllers' scales; a pod with zero or >1 owners is
                # the reference's hard error (disruption.go:503-511) ->
                # failSafe (status pinned disruptionAllowed=False).
                scales: dict[tuple, int] = {}
                for pod in pods:
                    found = self._find_owner_scales(pod, ns)
                    if len(found) != 1:
                        raise ValueError(
                            f"pod has {len(found)} controllers; "
                            f"percentage minAvailable needs exactly 1")
                    ident, scale = found[0]
                    scales[ident] = scale
                expected = sum(scales.values())
            else:
                expected = len(pods)
            desired = resolve_min_available(min_available, expected)
        except ValueError as err:
            # failSafe (disruption.go:547-560): on any computation error
            # pin disruptionAllowed=False so evictions stay blocked.
            log.warning("pdb %s/%s failsafe: %s", ns, meta.get("name"),
                        err)
            status = dict((pdb.get("status") or {}),
                          disruptionAllowed=False)
            self._publish(pdb, status)
            return status
        healthy = sum(1 for p in pods if _healthy(p))
        status = {
            "disruptionAllowed": healthy >= desired and expected > 0,
            "currentHealthy": healthy,
            "desiredHealthy": desired,
            "expectedPods": expected,
        }
        self._publish(pdb, status)
        return status

    def _publish(self, pdb: dict, status: dict) -> None:
        meta = pdb.get("metadata") or {}
        key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        if (pdb.get("status") or {}) == status:
            return
        try:
            cur = self.store.get("poddisruptionbudgets", key)
            if cur is not None and (cur.get("status") or {}) != status:
                cas_update(self.store, "poddisruptionbudgets",
                           {**cur, "status": status})
        except Exception:  # noqa: BLE001 — CAS race: next sync heals
            pass

"""PetSet controller: ordinal identity with one-at-a-time bring-up.

The reference's petset controller (pkg/controller/petset/pet_set.go:
280-356 Sync; iterator.go walks ordinals; pet.go:85-145 blocks on an
unhealthy pet) gives each replica a STABLE identity — the pod is named
``<petset>-<ordinal>`` for ordinals 0..replicas-1 — and deliberately
refuses parallel churn:

* scale UP creates exactly the lowest missing ordinal, and only when
  every existing pet is healthy (Running and Ready) — pet N never
  starts until pets 0..N-1 are up;
* scale DOWN deletes exactly the highest ordinal, again only when the
  remaining pets are healthy;
* a deleted pet is re-created under its own name (identity, not a
  random suffix — the point of the abstraction).

Pods carry an ownerReference to the PetSet for the garbage collector.
DNS/volume identity is out of scope with the rest of the DNS/cloud
surface (ARCHITECTURE.md scope cuts); the ordinal contract is what the
scheduler/controller stack observes.

A copy of ``kubernetes_tpu/controller/petset.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import threading
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client import cas_update
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.controller.disruption import _healthy
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("petset-controller")

SYNC_PERIOD = 0.5
PETSET_LABEL = "petset-name"


def _ordinal(name: str, base: str) -> int:
    """<base>-<n> -> n; -1 for anything else."""
    prefix = base + "-"
    if not name.startswith(prefix):
        return -1
    tail = name[len(prefix):]
    return int(tail) if tail.isdigit() else -1


class PetSetController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._sets: dict[str, dict] = {}
        self._pods_by_ns: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "PetSetController":
        for kind, handler in (("petsets", self._on_set),
                              ("pods", self._on_pod)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="petset-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_set(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._sets.pop(key, None)
            else:
                self._sets[key] = obj

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
                log.exception("petset sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            sets = list(self._sets.values())
        for ps in sets:
            try:
                self.sync_one(ps)
            except Exception:  # noqa: BLE001 — one bad set can't stall
                log.exception("petset sync_one failed")

    def sync_one(self, ps: dict) -> None:
        meta = ps.get("metadata") or {}
        spec = ps.get("spec") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        want = int(spec.get("replicas", 1) or 0)
        with self._lock:
            pods = list(self._pods_by_ns.get(ns, {}).values())
        pets = {}
        for p in pods:
            pmeta = p.get("metadata") or {}
            if (pmeta.get("labels") or {}).get(PETSET_LABEL) != name:
                continue
            o = _ordinal(pmeta.get("name", ""), name)
            if o >= 0:
                pets[o] = p
        # Status first: observed replica count (pet_set_utils.go
        # updatePetCount).
        status = {"replicas": len(pets)}
        if (ps.get("status") or {}) != status:
            try:
                cur = self.store.get("petsets", f"{ns}/{name}")
                if cur is not None and (cur.get("status") or {}) != status:
                    cas_update(self.store, "petsets",
                               {**cur, "status": status})
            except Exception:  # noqa: BLE001 — CAS race: next sync heals
                pass

        # An unhealthy pet blocks ALL scaling (pet.go:105-115,135-141):
        # identity workloads never churn two members at once.
        unhealthy = [o for o, p in pets.items() if not _healthy(p)]
        missing = [o for o in range(want) if o not in pets]
        extra = sorted((o for o in pets if o >= want), reverse=True)
        if missing:
            # ANY unhealthy pet blocks creation (pet.go:105-115): on
            # initial bring-up that is "pet N waits for 0..N-1", and
            # after a middle deletion it also stops re-creating pet 2
            # while pet 3 is crash-looping — never two members churning.
            if unhealthy:
                log.debug("petset %s/%s blocked on unhealthy pet", ns,
                          name)
                return
            self._create_pet(ps, ns, name, missing[0])
            return  # one pet per sync pass — one-at-a-time bring-up
        if extra:
            if unhealthy and extra[0] not in unhealthy:
                # Deleting while another pet is down would double the
                # disruption; wait (the blocked pet itself may be the
                # one being removed).
                log.debug("petset %s/%s scale-down blocked", ns, name)
                return
            victim = pets[extra[0]]
            vmeta = victim.get("metadata") or {}
            try:
                self.store.delete("pods", f"{ns}/{vmeta.get('name')}")
            except Exception:  # noqa: BLE001 — already gone
                pass
            return  # one pet per sync pass

    def _create_pet(self, ps: dict, ns: str, name: str,
                    ordinal: int) -> None:
        template = (ps.get("spec") or {}).get("template") or {}
        tmeta = dict(template.get("metadata") or {})
        labels = dict(tmeta.get("labels") or {})
        labels[PETSET_LABEL] = name
        pod = {"metadata": {
                   "name": f"{name}-{ordinal}", "namespace": ns,
                   "labels": labels,
                   "annotations": dict(tmeta.get("annotations") or {}),
                   "ownerReferences": [{
                       "kind": "PetSet", "name": name,
                       "controller": True}]},
               "spec": dict(template.get("spec")
                            or {"containers": [{"name": "c"}]})}
        try:
            self.store.create("pods", pod)
        except Exception:  # noqa: BLE001 — exists/apiserver down: retry
            pass

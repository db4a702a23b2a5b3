"""DaemonSet controller: one pod per eligible node.

The reference's daemon controller (pkg/controller/daemon/controller.go)
places a pod directly onto every node whose labels match the template's
nodeSelector — DaemonSet pods BYPASS the scheduler (the controller sets
spec.nodeName itself, controller.go manage()) and run even on
unschedulable nodes (cordoning a node doesn't kill its daemons).  Pods on
nodes that stop being eligible (label removed, node deleted) are deleted;
duplicates on one node are pruned to the oldest.

A copy of ``kubernetes_tpu/controller/daemonset.py`` with its imports
pointed at this package.
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

log = get_logger("daemonset-controller")

SYNC_PERIOD = 0.5
DS_LABEL = "daemonset-name"


def _alive(pod: dict) -> bool:
    return ((pod.get("status") or {}).get("phase")
            not in ("Succeeded", "Failed")) and \
        not (pod.get("metadata") or {}).get("deletionTimestamp")


class DaemonSetController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._sets: dict[str, dict] = {}
        self._nodes: dict[str, dict] = {}
        self._pods_by_ns: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []
        self._rand = random.Random()
        # ds key -> {node name: deadline}: creates whose watch event
        # hasn't landed yet (the expectations discipline).
        self._pending: dict[str, dict[str, float]] = {}
        self._ttl = max(5.0, 5 * sync_period)

    def run(self) -> "DaemonSetController":
        for kind, handler in (("daemonsets", self._on_ds),
                              ("nodes", self._on_node),
                              ("pods", self._on_pod)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="daemonset-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_ds(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._sets.pop(key, None)
                self._pending.pop(key, None)
            else:
                self._sets[key] = obj

    def _on_node(self, etype: str, obj: dict) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        with self._lock:
            if etype == "DELETED":
                self._nodes.pop(name, None)
            else:
                self._nodes[name] = obj

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
                log.exception("daemonset sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            sets = list(self._sets.values())
            nodes = list(self._nodes.values())
        for ds in sets:
            ns = (ds.get("metadata") or {}).get("namespace", "default")
            with self._lock:
                pods = list(self._pods_by_ns.get(ns, {}).values())
            self._sync_one(ds, nodes, pods)

    @staticmethod
    def _eligible(ds: dict, node: dict) -> bool:
        """nodeShouldRunDaemonPod: the template's nodeSelector against the
        node's labels.  Unschedulable is deliberately NOT checked — DS
        pods ignore cordons (controller.go)."""
        template = (ds.get("spec") or {}).get("template") or {}
        selector = ((template.get("spec") or {}).get("nodeSelector")) or {}
        labels = (node.get("metadata") or {}).get("labels") or {}
        return all(labels.get(k) == v for k, v in selector.items())

    def _sync_one(self, ds: dict, nodes: list[dict],
                  pods: list[dict]) -> None:
        meta = ds.get("metadata") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        eligible = {(n.get("metadata") or {}).get("name", "")
                    for n in nodes if self._eligible(ds, n)}
        mine = [p for p in pods
                if ((p.get("metadata") or {}).get("labels") or {})
                .get(DS_LABEL) == name and _alive(p)]
        by_node: dict[str, list[dict]] = {}
        for p in mine:
            by_node.setdefault(
                (p.get("spec") or {}).get("nodeName", ""), []).append(p)

        for node_name, plist in by_node.items():
            keep = 1 if node_name in eligible else 0
            # Prune duplicates (oldest wins, like the reference's sort by
            # creation — RVs are a decimal counter, so compare as ints)
            # and pods on ineligible or vanished nodes (a vanished node
            # is never in `eligible`, so its pods fall out here too).
            plist.sort(key=lambda p: int((p.get("metadata") or {})
                                         .get("resourceVersion", 0) or 0))
            for p in plist[keep:]:
                pmeta = p.get("metadata") or {}
                try:
                    self.store.delete("pods", f"{ns}/{pmeta.get('name')}")
                except Exception:  # noqa: BLE001 — already gone
                    pass

        # Create on covered-less eligible nodes, through a TTL'd
        # pending-create ledger (the replication manager's expectations):
        # over a lagging watch the reflector cache won't show a pod
        # created last sync, and re-creating every 0.5 s then pruning the
        # duplicate is sustained churn across the fleet.
        key = f"{ns}/{name}"
        now = time.time()
        with self._lock:
            pending = self._pending.setdefault(key, {}) \
                if key in self._sets else {}
            for node_name in list(pending):
                if node_name in by_node or now > pending[node_name]:
                    pending.pop(node_name, None)
            covered = set(by_node) | set(pending)
        for node_name in eligible - covered:
            if self._create_pod(ds, ns, name, node_name):
                with self._lock:
                    pending[node_name] = now + self._ttl

        status = {"desiredNumberScheduled": len(eligible),
                  "currentNumberScheduled": sum(
                      1 for n in by_node if n in eligible),
                  "numberReady": sum(
                      1 for n, pl in by_node.items() if n in eligible and
                      any((p.get("status") or {}).get("phase") == "Running"
                          for p in pl))}
        if (ds.get("status") or {}) != status:
            try:
                self.store.update("daemonsets", {**ds, "status": status})
            except Exception:  # noqa: BLE001 — CAS race: next sync heals
                pass

    def _create_pod(self, ds: dict, ns: str, name: str,
                    node_name: str) -> bool:
        template = (ds.get("spec") or {}).get("template") or {}
        tmeta = dict(template.get("metadata") or {})
        labels = dict(tmeta.get("labels") or {})
        labels[DS_LABEL] = name
        suffix = "".join(self._rand.choices(
            string.ascii_lowercase + string.digits, k=5))
        spec = dict(template.get("spec") or {"containers": [{"name": "c"}]})
        spec["nodeName"] = node_name   # direct placement: no scheduler
        pod = {"metadata": {"name": f"{name}-{suffix}", "namespace": ns,
                            "labels": labels,
                            "annotations": dict(tmeta.get("annotations")
                                                or {})},
               "spec": spec}
        try:
            self.store.create("pods", pod)
            return True
        except Exception:  # noqa: BLE001 — apiserver down: next sync
            return False

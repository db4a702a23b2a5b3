"""Node lifecycle controller: health monitoring + pod eviction.

The reference's node controller (pkg/controller/node/nodecontroller.go:
70-160) watches node heartbeats, marks nodes whose kubelet went silent
as Ready=Unknown after a monitor grace period, and after a pod-eviction
timeout evicts their pods through a rate-limited queue so a dead node's
workload reschedules elsewhere.  This is that loop:

* a node is HEALTHY while status.conditions[Ready].lastHeartbeatTime is
  within ``monitor_grace``;
* past the grace period the controller writes Ready=Unknown (the
  scheduler's ready filter then stops placing new pods there);
* past ``eviction_timeout`` the node's pods are deleted (rate limited,
  ``evictions_per_sync`` per pass) — their RC recreates them and the
  scheduler places them on live nodes.

A copy of ``kubernetes_tpu/controller/node.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import threading
import time
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("node-controller")

MONITOR_GRACE = 40.0      # nodeMonitorGracePeriod
EVICTION_TIMEOUT = 60.0   # podEvictionTimeout
SYNC_PERIOD = 5.0         # nodeMonitorPeriod


class NodeLifecycleController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 monitor_grace: float = MONITOR_GRACE,
                 eviction_timeout: float = EVICTION_TIMEOUT,
                 sync_period: float = SYNC_PERIOD,
                 evictions_per_sync: int = 10, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.monitor_grace = monitor_grace
        self.eviction_timeout = eviction_timeout
        self.sync_period = sync_period
        self.evictions_per_sync = evictions_per_sync
        self._nodes: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        # Node -> when its heartbeat was first observed missing.
        self._silent_since: dict[str, float] = {}
        # Node -> when this controller first saw it.  A node that has
        # never heartbeated (created via `kubectl create -f`, or freshly
        # registered) gets a startup grace from first observation — the
        # reference grants nodeStartupGracePeriod from CreationTimestamp
        # when no probe has ever landed (nodecontroller.go:740-744), so
        # static nodes are never condemned on the first monitor sync.
        self._first_seen: dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "NodeLifecycleController":
        for kind, handler in (("nodes", self._on_node),
                              ("pods", self._on_pod)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._monitor_loop, daemon=True,
                             name="node-monitor")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_node(self, etype: str, obj: dict) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        with self._lock:
            if etype == "DELETED":
                self._nodes.pop(name, None)
                self._silent_since.pop(name, None)
                self._first_seen.pop(name, None)
            else:
                self._nodes[name] = obj
                self._first_seen.setdefault(name, time.time())

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._pods.pop(key, None)
            else:
                self._pods[key] = obj

    @staticmethod
    def _last_heartbeat(node: dict) -> float:
        for c in (node.get("status") or {}).get("conditions") or ():
            if c.get("type") == "Ready":
                try:
                    return float(c.get("lastHeartbeatTime") or 0.0)
                except (TypeError, ValueError):
                    return 0.0
        return 0.0

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("node monitor crashed; continuing")

    def sync_once(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            nodes = dict(self._nodes)
            pods = list(self._pods.values())
        for name, node in nodes.items():
            hb = self._last_heartbeat(node)
            if not hb:
                # Never heartbeated: startup grace runs from first
                # observation, not from epoch 0 (which would condemn the
                # node on the very first sync).  Guarded on current
                # membership so a concurrent DELETED (which popped the
                # entry) isn't resurrected as a stale timestamp for a
                # future re-creation of the same name.
                with self._lock:
                    if name not in self._nodes:
                        continue
                    hb = self._first_seen.setdefault(name, now)
            if hb and now - hb <= self.monitor_grace:
                with self._lock:
                    self._silent_since.pop(name, None)
                continue
            # No heartbeat within grace: the kubelet is gone.
            with self._lock:
                since = self._silent_since.setdefault(name, now)
            self._mark_unknown(node)
            if now - since >= self.eviction_timeout or \
                    (hb and now - hb >=
                     self.monitor_grace + self.eviction_timeout):
                self._evict_pods(name, pods)

    def _mark_unknown(self, node: dict) -> None:
        conds = (node.get("status") or {}).get("conditions") or []
        ready = next((c for c in conds if c.get("type") == "Ready"), None)
        if ready is not None and ready.get("status") == "Unknown":
            return
        fresh = self.store.get(
            "nodes", (node.get("metadata") or {}).get("name", ""))
        if fresh is None:
            return
        hb = self._last_heartbeat(fresh)
        if hb and time.time() - hb <= self.monitor_grace:
            # The FRESH object heartbeated within grace: our reflector
            # cache was stale (watch hiccup), not the kubelet.  A healthy
            # node must never be marked Unknown off stale cache.
            name = (fresh.get("metadata") or {}).get("name", "")
            with self._lock:
                self._silent_since.pop(name, None)
            return
        conds = fresh.setdefault("status", {}).setdefault("conditions", [])
        conds[:] = [c for c in conds if c.get("type") != "Ready"]
        conds.append({"type": "Ready", "status": "Unknown",
                      "reason": "NodeStatusUnknown",
                      "lastHeartbeatTime": hb})
        try:
            # CAS on the read rv: a kubelet heartbeat landing between our
            # get and update must win, not be clobbered.
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "nodes", fresh)
            log.info("node %s marked Ready=Unknown (kubelet silent)",
                     (fresh.get("metadata") or {}).get("name"))
        except Exception:  # noqa: BLE001 — next sync retries
            pass

    def _evict_pods(self, node_name: str, pods: list[dict]) -> None:
        evicted = 0
        for pod in pods:
            if evicted >= self.evictions_per_sync:
                return  # rate-limited eviction queue (nodecontroller.go)
            if (pod.get("spec") or {}).get("nodeName") != node_name:
                continue
            meta = pod.get("metadata") or {}
            key = f"{meta.get('namespace', 'default')}/{meta.get('name')}"
            try:
                self.store.delete("pods", key)
                evicted += 1
                log.info("evicted %s from dead node %s", key, node_name)
            except Exception:  # noqa: BLE001 — already gone
                pass

"""Hollow kubelet: the node agent, kubemark-style.

The reference kubelet (pkg/kubelet, 43k LoC) is a container runtime
manager; its *control-plane surface* — what the rest of the system
observes — is much smaller, and kubemark ships exactly that: the real
kubelet with fake runtime deps (pkg/kubemark/hollow_kubelet.go:43-90).
This module is that surface for the TPU control plane:

* self-registration: creates its Node object on startup (kubelet
  --register-node);
* status heartbeats: periodically PUTs status.conditions[Ready] with
  lastHeartbeatTime (kubelet's NodeStatus update loop) — when they stop,
  the node controller marks the node gone;
* pod lifecycle: watches pods bound to its node and "runs" them —
  status.phase=Running — after re-running GeneralPredicates at admission
  (pkg/kubelet/lifecycle/predicate.go runs the SAME functions the
  scheduler uses, which is why GeneralPredicates is factored as one
  unit); pods that no longer fit are rejected with phase=Failed and
  reason=OutOfResources, exactly the kubelet's admission behavior.

The admission check reuses the pure-Python oracle predicates — the
kubelet is a host-side daemon with one node; there is nothing to batch
on a TPU.

A copy of ``kubernetes_tpu/kubelet/kubelet.py`` with its imports
pointed at this package (admission runs this package's ``oracle``).
"""

from __future__ import annotations

import threading
import time
from typing import Union

from kubernetes_tpu_torch import oracle
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("kubelet")

HEARTBEAT_PERIOD = 10.0  # kubelet nodeStatusUpdateFrequency


class HollowKubelet:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 node: api.Node,
                 heartbeat_period: float = HEARTBEAT_PERIOD,
                 token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.node = node
        self.heartbeat_period = heartbeat_period
        self._running: dict[str, api.Pod] = {}  # pods admitted + "running"
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._reflector: Reflector | None = None
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def run(self) -> "HollowKubelet":
        self._register()
        # Fielded watch, the reference kubelet's source exactly
        # (pkg/kubelet/config/apiserver.go NewSourceApiserver:
        # fieldSelector spec.nodeName=<node>): the server filters, so a
        # 500-kubelet fleet no longer fans every pod event to every
        # node's stream.
        self._reflector = Reflector(
            self.store, "pods", self._on_pod,
            field_selector=f"spec.nodeName={self.node.name}")
        self._threads.append(self._reflector.run())
        t = threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name=f"kubelet-heartbeat-{self.node.name}")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        """Stop heartbeating and pod handling (simulates node death: the
        Node object remains; only the heartbeats cease)."""
        self._stop.set()
        if self._reflector is not None:
            self._reflector.stop()

    # -- registration + heartbeat ---------------------------------------

    def _register(self) -> None:
        """--register-node: create the Node object if absent."""
        obj = api.node_to_json(self.node)
        self._stamp_ready(obj)
        try:
            self.store.create("nodes", obj)
            log.info("registered node %s", self.node.name)
        except Exception:  # noqa: BLE001 — already exists: refresh status
            from kubernetes_tpu_torch.client import cas_update
            existing = self.store.get("nodes", self.node.name)
            if existing is not None:
                existing["status"] = obj["status"]
                try:
                    cas_update(self.store, "nodes", existing)
                except Exception:  # noqa: BLE001 — heartbeat will retry
                    pass

    @staticmethod
    def _stamp_ready(obj: dict) -> None:
        conds = obj.setdefault("status", {}).setdefault("conditions", [])
        conds[:] = [c for c in conds if c.get("type") != "Ready"]
        conds.append({"type": "Ready", "status": "True",
                      "lastHeartbeatTime": time.time()})

    def _heartbeat_loop(self) -> None:
        import random
        from kubernetes_tpu_torch.client import cas_update
        # Desynchronize: a fleet started together would otherwise beat in
        # aligned bursts every period (real kubelets drift apart
        # naturally; 500 synchronized CAS writes per burst is a worst
        # case the apiserver never sees in steady state).
        if self._stop.wait(self.heartbeat_period * random.random()):
            return
        while True:
            try:
                obj = self.store.get("nodes", self.node.name)
                if obj is None:
                    self._register()
                else:
                    self._stamp_ready(obj)
                    cas_update(self.store, "nodes", obj)
            except Exception:  # noqa: BLE001 — apiserver down / CAS race:
                pass           # next heartbeat retries
            if self._stop.wait(self.heartbeat_period):
                return

    # -- pod admission + "running" --------------------------------------

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        if etype == "DELETED":
            with self._lock:
                self._running.pop(key, None)
                if hasattr(self, "_ip_leases"):
                    self._ip_leases.pop(key, None)  # free the IP lease
                getattr(self, "_completing", set()).discard(key)
            return
        phase = (obj.get("status") or {}).get("phase", "")
        if phase in ("Running", "Failed", "Succeeded"):
            if phase == "Running":
                with self._lock:
                    self._running.setdefault(key, api.pod_from_json(obj))
                # Re-arm completion on redelivery: a lost CAS on the
                # Running->Succeeded write surfaces as another Running
                # event, and without this the pod (and its Job) would
                # stay Running forever.
                self._maybe_schedule_completion(key, obj)
            return
        pod = api.pod_from_json(obj)
        with self._lock:
            admitted = self._admit(pod, key)
            if admitted:
                self._running[key] = pod
        self._set_phase(obj, "Running" if admitted else "Failed",
                        "" if admitted else "OutOfResources")
        if admitted:
            self._maybe_schedule_completion(key, obj)

    # Run-to-completion simulation (the hollow runtime's analogue of a
    # container exiting 0): a pod annotated with a run duration flips
    # Running -> Succeeded after that many seconds — what Job pods do on
    # a real kubelet when their process exits.
    RUN_DURATION_ANN = "kubemark.kubernetes.io/run-duration"

    def _maybe_schedule_completion(self, key: str, obj: dict) -> None:
        ann = (obj.get("metadata") or {}).get("annotations") or {}
        try:
            dur = float(ann.get(self.RUN_DURATION_ANN, ""))
        except ValueError:
            return
        with self._lock:
            if not hasattr(self, "_completing"):
                self._completing: set[str] = set()
            if key in self._completing:
                return  # one armed timer per pod
            self._completing.add(key)
        # Timers are fire-and-forget daemons (no tracking list to leak);
        # _complete_pod checks _stop, so a stopped kubelet's stragglers
        # are inert.
        t = threading.Timer(max(dur, 0.01), self._complete_pod, args=(key,))
        t.daemon = True
        t.start()

    def _complete_pod(self, key: str) -> None:
        # The timer has fired: clear the armed marker FIRST, so if the
        # Succeeded CAS below loses to a concurrent writer, the watch's
        # Running redelivery arms a fresh timer instead of deadlocking
        # behind a stale marker.
        with self._lock:
            getattr(self, "_completing", set()).discard(key)
        if self._stop.is_set():
            return
        try:
            obj = self.store.get("pods", key)
        except Exception:  # noqa: BLE001 — apiserver down: the next
            return         # Running redelivery re-arms
        if obj is None or (obj.get("spec") or {}).get("nodeName") != \
                self.node.name:
            return
        if (obj.get("status") or {}).get("phase") != "Running":
            return
        with self._lock:
            self._running.pop(key, None)
        self._set_phase(obj, "Succeeded", "Completed")

    def _admit(self, pod: api.Pod, key: str) -> bool:
        """GeneralPredicates at admission (lifecycle/predicate.go) against
        this node and its running pods, via the oracle's re-derivations.
        The pod's own key is excluded so a redelivered admission (lost
        status CAS) doesn't count the pod against itself."""
        node_pods = [p for k, p in self._running.items() if k != key]
        return (oracle.pod_fits_resources(pod, self.node, node_pods)
                and oracle.pod_fits_host(pod, self.node)
                and oracle.pod_fits_host_ports(pod, node_pods)
                and oracle.pod_matches_node_labels(pod, self.node))

    # The fake-cAdvisor analogue: a pod annotated with a simulated CPU
    # usage reports it in status, which the HPA controller consumes as
    # its heapster stand-in.
    CPU_USAGE_ANN = "kubemark.kubernetes.io/cpu-usage"

    def _set_phase(self, obj: dict, phase: str, reason: str) -> None:
        status = obj.setdefault("status", {})
        status["phase"] = phase
        if reason:
            status["reason"] = reason
        if phase == "Running":
            # The real kubelet's status manager stamps the PodReady
            # condition alongside Running (pkg/kubelet/status); the
            # disruption controller counts healthy = Running AND Ready
            # (disruption.go countHealthyPods), so without this a PDB
            # over hollow pods would never see a healthy pod.
            conds = status.setdefault("conditions", [])
            conds[:] = [c for c in conds if c.get("type") != "Ready"]
            conds.append({"type": "Ready", "status": "True"})
            usage = ((obj.get("metadata") or {}).get("annotations")
                     or {}).get(self.CPU_USAGE_ANN)
            if usage:
                status["cpuUsage"] = usage
        if phase == "Running" and not status.get("podIP"):
            # The hollow runtime's IPAM (kubemark's fake runtime assigns
            # pod IPs too): a node-scoped /24 (md5 of the node name — NOT
            # hash(), which is PYTHONHASHSEED-randomized) with leased host
            # octets, probed past addresses still held by running pods —
            # collision-free within a node by construction.  Cross-node
            # collisions need BOTH a node-prefix collision (64k space) and
            # lease-cursor alignment (cursors start at a second per-node
            # hash): negligible at hollow-fleet sizes.
            status["podIP"] = self._lease_pod_ip(MemStore.object_key(obj))
        try:
            # CAS on the watched rv: a concurrent writer (labels,
            # conditions) must win over this watch-stale copy; the watch
            # then redelivers and the handler re-runs.
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "pods", obj)
        except Exception:  # noqa: BLE001 — a newer write wins; watch
            pass           # redelivers and the handler re-runs

    def _lease_pod_ip(self, key: str) -> str:
        """Lease a host octet in the node's /24 (caller holds no lock;
        this method takes it).  Leases free when the pod is deleted, and
        the probe skips octets still leased, so churn can wrap the cursor
        without ever reusing a live pod's address."""
        import hashlib
        with self._lock:
            if not hasattr(self, "_ip_cursor"):
                digest = hashlib.md5(self.node.name.encode()).digest()
                h = int.from_bytes(digest[:4], "big") % (254 * 254)
                self._ip_prefix = f"10.{h // 254}.{h % 254}"
                self._ip_cursor = int.from_bytes(digest[4:6], "big") % 254
                self._ip_leases: dict[str, int] = {}  # pod key -> octet
            prior = self._ip_leases.get(key)
            if prior is not None:  # redelivered admission: same IP
                return f"{self._ip_prefix}.{prior}"
            in_use = set(self._ip_leases.values())
            for _ in range(254):
                self._ip_cursor = self._ip_cursor % 254 + 1
                if self._ip_cursor not in in_use:
                    self._ip_leases[key] = self._ip_cursor
                    return f"{self._ip_prefix}.{self._ip_cursor}"
            # All 254 octets leased (over the 110-pod allocatable cap —
            # can't happen through admission): reuse the cursor slot.
            self._ip_leases[key] = self._ip_cursor
            return f"{self._ip_prefix}.{self._ip_cursor}"

    def running_pods(self) -> list[str]:
        with self._lock:
            return sorted(self._running)

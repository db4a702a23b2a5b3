"""Hollow kube-proxy: the service VIP dataplane, kubemark-style.

The reference kube-proxy (pkg/proxy, iptables/userspace modes) watches
Services and Endpoints and programs a VIP -> backend mapping into the
kernel; kubemark's HollowProxy (cmd/kubemark --morph=proxy) is the same
control loop with the dataplane faked out.  This is that control loop:
the "rules table" is an in-memory dict, and ``resolve()`` answers what an
iptables DNAT would — a round-robin backend pick for a service, exactly
the userspace proxy's LoadBalancerRR (pkg/proxy/userspace/roundrobin.go).

A copy of ``kubernetes_tpu/proxy/proxy.py`` with its imports pointed
at this package.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("kube-proxy")


class HollowProxy:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self._backends: dict[str, list[str]] = {}  # "ns/svc" -> pod IPs
        self._rr: dict[str, int] = {}              # round-robin cursors
        self._lock = threading.Lock()
        self._reflectors: list[Reflector] = []

    def run(self) -> "HollowProxy":
        r = Reflector(self.store, "endpoints", self._on_endpoints)
        self._reflectors.append(r)
        r.run()
        r.wait_for_sync()
        return self

    def stop(self) -> None:
        for r in self._reflectors:
            r.stop()

    def _on_endpoints(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._backends.pop(key, None)
                self._rr.pop(key, None)
                return
            ips = [a.get("ip", "")
                   for subset in obj.get("subsets") or ()
                   for a in subset.get("addresses") or ()]
            self._backends[key] = [ip for ip in ips if ip]

    # -- the "dataplane" -------------------------------------------------

    def backends(self, namespace: str, service: str) -> list[str]:
        with self._lock:
            return list(self._backends.get(f"{namespace}/{service}", ()))

    def resolve(self, namespace: str, service: str) -> Optional[str]:
        """What an iptables DNAT would do for one VIP connection: pick the
        next backend round-robin (LoadBalancerRR semantics); None when the
        service has no ready endpoints."""
        key = f"{namespace}/{service}"
        with self._lock:
            ips = self._backends.get(key)
            if not ips:
                return None
            i = self._rr.get(key, 0) % len(ips)
            self._rr[key] = i + 1
            return ips[i]

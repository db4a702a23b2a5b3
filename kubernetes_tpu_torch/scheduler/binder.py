"""Binding: committing a scheduling decision.

The reference commits by POSTing a Binding to the apiserver, which CAS-sets
``spec.nodeName`` only while it is empty (BindingREST.Create -> assignPod ->
setPodHostAndAnnotations, pkg/registry/pod/etcd/etcd.go:286-330) — the
atomic conflict detector for optimistic concurrency.

``Binder`` is the protocol; ``InMemoryBinder`` reproduces the CAS semantics
for the integration and perf rigs (the in-process-apiserver analogue).
The store binder of the daemon over a ``MemStore`` is
``scheduler/factory.py:MemStoreBinder``.  ``APIClientBinder`` (the wire
binder over the HTTP client) waits for the HTTP client slice.
"""

from __future__ import annotations

import threading
from typing import Optional, Protocol

from kubernetes_tpu_torch.api import types as api


class BindConflict(Exception):
    """spec.nodeName was already set (the CAS failed)."""


class Binder(Protocol):
    def bind(self, pod: api.Pod, node_name: str) -> None: ...


class InMemoryBinder:
    """CAS-binding against an in-memory pod table (etcd.go:299-330)."""

    def __init__(self) -> None:
        self._bound: dict[str, str] = {}
        self._lock = threading.Lock()

    def bind(self, pod: api.Pod, node_name: str) -> None:
        with self._lock:
            current = self._bound.get(pod.key, "")
            if current:
                raise BindConflict(
                    f"pod {pod.key} is already assigned to node {current}")
            self._bound[pod.key] = node_name

    def bind_many(self, bindings: list[tuple[api.Pod, str]]
                  ) -> list[tuple[api.Pod, str]]:
        """Per-pod CAS under one lock acquisition.  Returns the failures as
        (pod, error) — the bind_many contract every binder shares (the
        daemon surfaces the error text in the FailedScheduling event)."""
        conflicts = []
        with self._lock:
            bound = self._bound
            for pod, node_name in bindings:
                current = bound.get(pod.key, "")
                if current:
                    conflicts.append((pod, BindConflict(
                        f"pod {pod.key} is already assigned to node "
                        f"{current}")))
                else:
                    bound[pod.key] = node_name
        return conflicts

    def bound_node(self, pod_key: str) -> Optional[str]:
        with self._lock:
            return self._bound.get(pod_key)

    def unbind(self, pod_key: str) -> None:
        with self._lock:
            self._bound.pop(pod_key, None)

    def evict(self, pod: api.Pod) -> None:
        """Preemption eviction (the daemon's evict->assume->bind path,
        workloads/preemption.py): the victim's binding is released so the
        preemptor's CAS bind can land."""
        self.unbind(pod.key)

    def count(self) -> int:
        with self._lock:
            return len(self._bound)


class APIClientBinder:
    """The wire binder (batch bindings over the HTTP client): not in this
    package yet."""

    def __init__(self, client=None):
        raise NotImplementedError(
            "APIClientBinder is not ported to kubernetes_tpu_torch yet "
            "(HTTP client slice); bind through a MemStore or "
            "InMemoryBinder")

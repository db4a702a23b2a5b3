"""Binding: committing a scheduling decision.

The reference commits by POSTing a Binding to the apiserver, which CAS-sets
``spec.nodeName`` only while it is empty (BindingREST.Create -> assignPod ->
setPodHostAndAnnotations, pkg/registry/pod/etcd/etcd.go:286-330) — the
atomic conflict detector for optimistic concurrency.

``Binder`` is the protocol; ``InMemoryBinder`` reproduces the CAS semantics
for the integration and perf rigs (the in-process-apiserver analogue).
The store binder of the daemon over a ``MemStore`` is
``scheduler/factory.py:MemStoreBinder``, and ``APIClientBinder`` is the
daemon's wire binder: whole solved chunks ride the batch bindings
subresource through ``APIClient.bind_list``, which pipelines the chunk
POSTs over persistent connections (client/http.py) — the bind side of
the overlapped solve/bind pipeline.
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
    """Binder over the wire (factory.go:576-587 POST bindings).

    The batched path rides the batch-bind subresource: the engine decides
    in multi-thousand-pod chunks, so each chunk becomes a handful of
    pipelined bulk requests whose per-pod CAS results map back to
    (pod, err) failures — measured at density rates, per-pod POSTs
    through 16 threads were the wire bottleneck (98 % of engine
    throughput died at the process boundary).  Request chunking and the
    persistent-connection pipelining live in ``APIClient.bind_list``; a
    transport failure falls back to per-pod binds through a persistent
    thread pool so partial progress survives a flaky connection."""

    _POOL = 16  # fallback path concurrency (one goroutine per bind)

    def __init__(self, client):
        self.client = client
        self._pool = None

    def bind(self, pod: api.Pod, node_name: str) -> None:
        self.client.bind(pod.namespace, pod.name, node_name)

    def evict(self, pod: api.Pod) -> None:
        """Preemption eviction over the wire: DELETE the victim pod (the
        reference's preemption deletes victims through the apiserver; the
        watch then confirms the removal cluster-wide)."""
        self.client.delete("pods", pod.key)

    def unbind(self, pod: api.Pod) -> None:
        """Defrag eviction-to-pending (scheduler/defrag.py): clear
        spec.nodeName under CAS so the pod re-enters the pending set
        and the unassigned reflector requeues it — a migration, unlike
        a preemption, must keep the pod alive.  The PUT applies the
        body's resourceVersion as its precondition; a racing writer
        surfaces as the conflict the defragmenter skips on."""
        obj = self.client.get("pods", pod.key)
        if obj is None:
            raise KeyError(f"pods {pod.key} not found")
        obj.setdefault("spec", {})["nodeName"] = ""
        self.client.update("pods", obj)

    def _bind_one(self, item):
        pod, dest = item
        try:
            self.bind(pod, dest)
            return None
        except Exception as err:  # noqa: BLE001 — caller requeues
            return (pod, err)

    def bind_many(self, placed: list) -> list:
        """Bind a batch; returns [(pod, err)] failures (the CAS conflicts
        the batched drain forgets + requeues)."""
        from kubernetes_tpu_torch.apiserver.memstore import ConflictError
        from kubernetes_tpu_torch.client.http import APIError
        from kubernetes_tpu_torch.utils.featuregate import DEFAULT_FEATURE_GATE
        if not DEFAULT_FEATURE_GATE.enabled("BatchBindings"):
            # Gated off: the reference's per-bind-goroutine wire behavior.
            return self._bind_many_fallback(placed)
        if len(placed) <= 2:
            return [f for f in map(self._bind_one, placed) if f is not None]
        try:
            errors = self.client.bind_list(
                [(pod.namespace, pod.name, dest) for pod, dest in placed])
        except Exception:  # noqa: BLE001 — transport hiccup
            return self._bind_many_fallback(placed)
        if len(errors) != len(placed):
            return self._bind_many_fallback(placed)
        # Preserve the per-item status: only a 409 is a CAS conflict;
        # wrapping a 404 (pod deleted mid-bind) as ConflictError would
        # invert the conflict/failure metric split downstream.  One 409
        # inside a pipelined chunk therefore requeues only that pod.
        # Code 0 marks a chunk whose request never completed (transport
        # fault mid-pipeline): re-bind ONLY those pods per-pod — the CAS
        # makes the retry idempotent — leaving the other chunks' results
        # untouched.
        failures = []
        retry = []
        for (pod, dest), res in zip(placed, errors):
            if res is None:
                continue
            code, err = res
            if code == 0:
                retry.append((pod, dest))
            elif code == 409:
                failures.append((pod, ConflictError(err)))
            else:
                failures.append((pod, APIError(code, err)))
        if retry:
            failures.extend(self._bind_many_fallback(retry))
        return failures

    def _bind_many_fallback(self, placed: list) -> list:
        """Per-pod binds through the persistent pool — each worker keeps
        its thread-local keep-alive connection across batches."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self._POOL,
                                            thread_name_prefix="binder")
        return [f for f in self._pool.map(self._bind_one, placed)
                if f is not None]

"""Shared rigs for the control-plane parity tests of the PyTorch port
(``tests/test_torch_{replication,kubelet,node_lifecycle,control_plane}.py``).

Each test builds the same objects on two twin ``MemStore``s, one of each
package, and drives the JAX package's class on one and the port's on the
other.  ``Pump`` replays a store's watch events to a controller's
handlers in store order, which is what its reflectors do, without their
threads: a test decides when the events land, so both sides see the same
sequence."""

from __future__ import annotations

import time
from types import SimpleNamespace

SIDES = ("ref", "port")

# The store's creation stamp: a wall-clock field (the kubelet tests add
# the heartbeat stamps).
WALL_CLOCK_FIELDS = ("creationTimestamp",)


def mods(side: str) -> SimpleNamespace:
    if side == "ref":
        from kubernetes_tpu.api import types as api
        from kubernetes_tpu.apiserver.memstore import MemStore
        from kubernetes_tpu.controller.endpoints import EndpointsController
        from kubernetes_tpu.controller.node import NodeLifecycleController
        from kubernetes_tpu.kubelet.kubelet import HollowKubelet
        from kubernetes_tpu.controller.replication import \
            ReplicationManager
        from kubernetes_tpu.proxy.proxy import HollowProxy
        from kubernetes_tpu.scheduler.factory import ConfigFactory
        factory_kw = {}
    else:
        from kubernetes_tpu_torch.api import types as api
        from kubernetes_tpu_torch.apiserver.memstore import MemStore
        from kubernetes_tpu_torch.controller.endpoints import \
            EndpointsController
        from kubernetes_tpu_torch.controller.node import \
            NodeLifecycleController
        from kubernetes_tpu_torch.kubelet.kubelet import HollowKubelet
        from kubernetes_tpu_torch.controller.replication import \
            ReplicationManager
        from kubernetes_tpu_torch.proxy.proxy import HollowProxy
        from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
        factory_kw = {"device": "cpu"}
    return SimpleNamespace(
        api=api, MemStore=MemStore, ReplicationManager=ReplicationManager,
        EndpointsController=EndpointsController,
        NodeLifecycleController=NodeLifecycleController,
        HollowKubelet=HollowKubelet, HollowProxy=HollowProxy,
        factory=lambda store: ConfigFactory(store, **factory_kw))


class Pump:
    """Replays ``store``'s events of the given kinds to ``handlers``
    (kind -> handler(etype, obj)) in store order, on ``drain()``."""

    def __init__(self, store, handlers: dict):
        self.handlers = handlers
        self.watch = store.watch(tuple(handlers), 0)

    def drain(self) -> int:
        n = 0
        while True:
            ev = self.watch.next(timeout=0)
            if ev is None:
                return n
            self.handlers[ev.kind](ev.type, ev.object)
            n += 1

    def stop(self) -> None:
        self.watch.stop()


def normalise(obj, wall=WALL_CLOCK_FIELDS):
    if isinstance(obj, dict):
        return {k: ("<wall clock>" if k in wall else normalise(v, wall))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [normalise(v, wall) for v in obj]
    return obj


def snapshot(store, kinds=("pods",), wall=WALL_CLOCK_FIELDS) -> dict:
    """Every object of ``kinds``, normalised, by kind and key, with the
    store's resourceVersion."""
    out = {}
    for kind in kinds:
        items, rv = store.list(kind)
        out[kind] = sorted((normalise(o, wall) for o in items),
                           key=lambda o: (o["metadata"].get("namespace", ""),
                                          o["metadata"]["name"]))
    out["rv"] = store.list(kinds[0])[1]
    return out


def wait(cond, timeout: float = 60.0, period: float = 0.1, msg: str = ""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(period)
    raise AssertionError(f"timed out waiting for {msg}")


def rc(name: str, replicas: int, cpu: str = "100m") -> dict:
    """The reference control-plane tests' RC (a ``run=<name>`` map
    selector)."""
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas,
                     "selector": {"run": name},
                     "template": {
                         "metadata": {"labels": {"run": name}},
                         "spec": {"containers": [{
                             "name": "c",
                             "resources": {"requests": {"cpu": cpu}}}]}}}}


def hollow_node(api, name: str, milli_cpu: int = 8000,
                memory_gib: int = 32):
    """The reference control-plane tests' node, in ``api``'s types."""
    return api.Node(
        name=name, labels={api.HOSTNAME_LABEL: name},
        allocatable_milli_cpu=milli_cpu,
        allocatable_memory=memory_gib * 1024 ** 3, allocatable_pods=110,
        conditions=[api.NodeCondition("Ready", "True")])


def pods_of(store, name: str) -> list[dict]:
    items, _ = store.list("pods")
    return [o for o in items
            if ((o.get("metadata") or {}).get("labels") or {})
            .get("run") == name]

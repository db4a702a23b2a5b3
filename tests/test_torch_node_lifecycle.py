"""The PyTorch port's node lifecycle and endpoints controllers
(``kubernetes_tpu_torch.controller.{node,endpoints}``) against the JAX
package's, on the CPU.

Both controllers run on twin ``MemStore``s; ``torch_plane.Pump`` replays
each store's watch events to them in store order.

* Node lifecycle, on the reference fixture's fast clocks (grace 1.2 s,
  eviction 1 s), stepped with ``sync_once(now=...)`` over one seeded
  fleet: a live node, one silent for 1.5 s (Ready=Unknown first, its
  pods evicted once the timeout passes, a few per pass), one silent for
  100 s (evicted at once), one that never heartbeated (its startup
  grace), one that heartbeats again before its eviction, one deleted
  while silent: the same conditions, the same evictions in the same
  passes, the same silence ledger.
* Endpoints: seeded services (selectors over labels, a selectorless one
  with manual endpoints, two namespaces) and pods (Running with and
  without an IP, Pending, Failed): after every pod, service and
  endpoints change, the same Endpoints objects and dirty set; a hollow
  proxy over each store's Endpoints holds the same table."""

from __future__ import annotations

import random
import time

import pytest

from torch_plane import SIDES, Pump, mods, snapshot

GRACE, EVICTION = 1.2, 1.0
PER_PASS = 3


def _node(name: str, hb) -> dict:
    ready = {"type": "Ready", "status": "True"}
    if hb is not None:
        ready["lastHeartbeatTime"] = hb
    return {"metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": "8", "memory": "32Gi",
                                       "pods": "110"},
                       "conditions": [ready]}}


def _fleet(seed: int, base: float) -> tuple[list, list]:
    r = random.Random(seed)
    nodes = [_node("n-alive", base + 1000.0),
             _node("n-dying", base - 1.5),
             _node("n-dead", base - 100.0),
             _node("n-static", None),
             _node("n-flap", base - 1.5),
             _node("n-gone", base - 100.0)]
    pods = []
    for nd in nodes:
        for j in range(r.randint(0, 2 * PER_PASS + 1)):
            pods.append({"metadata": {"name": f"{nd['metadata']['name']}-"
                                              f"{j}",
                                      "namespace": r.choice(("default",
                                                             "team"))},
                         "spec": {"nodeName": nd["metadata"]["name"],
                                  "containers": [{"name": "c"}]}})
    pods += [{"metadata": {"name": f"pending-{j}", "namespace": "default"},
              "spec": {"containers": [{"name": "c"}]}} for j in range(3)]
    r.shuffle(pods)
    return nodes, pods


@pytest.mark.parametrize("seed", range(3))
def test_conditions_and_evictions_match_the_reference(seed):
    base = time.time()
    nodes, pods = _fleet(seed, base)
    steps = (0.0, 0.5, 1.0, 1.5, 3.0, 4.5, 6.0)
    traces = {}
    for side in SIDES:
        m = mods(side)
        store = m.MemStore()
        nc = m.NodeLifecycleController(
            store, monitor_grace=GRACE, eviction_timeout=EVICTION,
            sync_period=3600.0, evictions_per_sync=PER_PASS)
        pump = Pump(store, {"nodes": nc._on_node, "pods": nc._on_pod})
        for obj in nodes:
            store.create("nodes", obj)
        for obj in pods:
            store.create("pods", obj)
        pump.drain()
        # The controller first saw every node at ``base`` (its startup
        # grace runs from there), on both sides.
        nc._first_seen = dict.fromkeys(nc._first_seen, base)
        trace = []
        for i, dt in enumerate(steps):
            nc.sync_once(now=base + dt)
            pump.drain()
            trace.append((snapshot(store, ("nodes", "pods")),
                          dict(nc._silent_since), dict(nc._first_seen)))
            if i == 0:
                # n-flap's kubelet is back before its eviction; n-gone's
                # Node is deleted while it is silent.
                flap = store.get("nodes", "n-flap")
                flap["status"]["conditions"] = [{
                    "type": "Ready", "status": "True",
                    "lastHeartbeatTime": base + 1000.0}]
                store.update("nodes", flap)
                store.delete("nodes", "n-gone")
                pump.drain()
        traces[side] = trace
        pump.stop()
    assert traces["ref"] == traces["port"]
    final = {o["metadata"]["name"]: o for o in traces["port"][-1][0]["nodes"]}
    ready = {n: [c["status"] for c in o["status"]["conditions"]
                 if c["type"] == "Ready"][0] for n, o in final.items()}
    assert ready == {"n-alive": "True", "n-dying": "Unknown",
                     "n-dead": "Unknown", "n-static": "Unknown",
                     "n-flap": "True"}
    left = {o["spec"].get("nodeName") for o in traces["port"][-1][0]["pods"]}
    assert not left & {"n-dying", "n-dead", "n-static"}


def _services(r: random.Random) -> list:
    out = []
    for ns in ("default", "team"):
        for name, sel in (("web", {"app": "web"}),
                          ("fe", {"app": "web", "tier": "fe"}),
                          ("db", {"app": "db"})):
            if r.random() < 0.85:
                out.append({"metadata": {"name": name, "namespace": ns},
                            "spec": {"selector": sel}})
    out.append({"metadata": {"name": "ext", "namespace": "default"},
                "spec": {}})
    return out


def _pod(r: random.Random, i: int) -> dict:
    labels = {"app": r.choice(("web", "db", "other"))}
    if r.random() < 0.5:
        labels["tier"] = r.choice(("fe", "be"))
    status = {}
    roll = r.random()
    if roll < 0.6:
        status["phase"] = "Running"
        if r.random() < 0.9:
            status["podIP"] = f"10.{r.randint(0, 2)}.{r.randint(0, 3)}." \
                              f"{r.randint(1, 250)}"
    elif roll < 0.8:
        status["phase"] = "Pending"
    else:
        status["phase"] = "Failed"
        status["podIP"] = f"10.9.0.{i}"
    return {"metadata": {"name": f"p{i}", "namespace":
                         r.choice(("default", "team")), "labels": labels},
            "spec": {"containers": [{"name": "c"}]}, "status": status}


@pytest.mark.parametrize("seed", range(4))
def test_endpoints_and_the_proxy_table_match_the_reference(seed):
    r = random.Random(seed)
    services = _services(r)
    pods = [_pod(r, i) for i in range(30)]
    edits = [(r.randrange(30), _pod(r, 100 + j)) for j in range(12)]
    traces = {}
    for side in SIDES:
        m = mods(side)
        store = m.MemStore()
        ec = m.EndpointsController(store, sync_period=3600.0)
        proxy = m.HollowProxy(store)
        pump = Pump(store, {"services": ec._on_service, "pods": ec._on_pod,
                            "endpoints": lambda t, o: (
                                ec._on_endpoints(t, o),
                                proxy._on_endpoints(t, o))})
        trace = []

        def sync(full: bool = False):
            pump.drain()
            ec.sync_all(full=full)
            pump.drain()
            table = {f"{ns}/{name}": proxy.backends(ns, name)
                     for ns in ("default", "team")
                     for name in ("web", "fe", "db", "ext")}
            trace.append((snapshot(store, ("endpoints",)),
                          sorted(ec._dirty), table))

        store.create("endpoints", {
            "metadata": {"name": "ext", "namespace": "default"},
            "subsets": [{"addresses": [{"ip": "192.168.9.9"}]}]})
        for svc in services:
            store.create("services", svc)
        for pod in pods[:15]:
            store.create("pods", pod)
        sync()
        for pod in pods[15:]:
            store.create("pods", pod)
        sync()
        for i, (victim, fresh) in enumerate(edits):
            key = f"{pods[victim]['metadata']['namespace']}/p{victim}"
            obj = store.get("pods", key)
            if obj is None:
                continue
            if i % 3 == 0:
                store.delete("pods", key)
            else:
                obj["metadata"]["labels"] = fresh["metadata"]["labels"]
                obj["status"] = fresh["status"]
                store.update("pods", obj)
            sync()
        # An out-of-band delete of a managed Endpoints object is undone;
        # a deleted service's Endpoints are collected; a selector change.
        if store.get("endpoints", "default/web") is not None:
            store.delete("endpoints", "default/web")
        sync()
        for svc in services[:1]:
            store.delete("services", f"{svc['metadata']['namespace']}/"
                                     f"{svc['metadata']['name']}")
        sync()
        svc = store.get("services", "team/db")
        if svc is not None:
            svc["spec"]["selector"] = {"tier": "be"}
            store.update("services", svc)
        sync()
        sync(full=True)
        traces[side] = trace
        pump.stop()
    assert traces["ref"] == traces["port"]
    last = traces["port"][-1]
    assert last[2]["default/ext"] == ["192.168.9.9"]
    assert any(last[2][k] for k in last[2] if k != "default/ext")

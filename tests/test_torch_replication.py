"""The PyTorch port's replication manager (``kubernetes_tpu_torch.
controller.replication``) against the JAX package's, on the CPU.

Both managers run on twin ``MemStore``s with the same seeded suffix
generator (``rm._rand``: the managers themselves draw from an unseeded
one), and their watch events are replayed by ``torch_plane.Pump`` in
store order, so both see the same sequence:

* seeded scenarios of ReplicationControllers and ReplicaSets (map
  selectors, ``matchLabels``, ``matchExpressions`` with In, NotIn,
  Exists and DoesNotExist, an RC without a selector that takes its
  template's labels, an RC and an RS of one name), with orphans to
  adopt, bound, failed and terminating pods: after every full and dirty
  sync, scale up and down, failure and controller deletion, the stores
  hold the same pods (names, labels, annotations, specs,
  resourceVersions) and the managers the same dirty set and
  expectations;
* a template whose labels miss its selector creates nothing on both;
* an expired expectation is re-created on both;
* the label helpers agree on seeded selectors and pods;
* the threaded manager (reflectors and its sync loop) converges to the
  same replicas on both."""

from __future__ import annotations

import random

import pytest

from torch_plane import SIDES, Pump, mods, snapshot, wait

RC, RS = "replicationcontrollers", "replicasets"


def _selector(r: random.Random, kind: str, name: str, tier: str) -> dict:
    if kind == RC:
        return {"app": name} if r.random() < 0.75 else {}
    return r.choice([
        {"matchLabels": {"app": name}},
        {"matchLabels": {"app": name},
         "matchExpressions": [{"key": "tier", "operator": "In",
                               "values": [tier, "edge"]}]},
        {"matchExpressions": [{"key": "app", "operator": "In",
                               "values": [name]},
                              {"key": "env", "operator": "DoesNotExist"}]},
        {"matchLabels": {"app": name},
         "matchExpressions": [{"key": "tier", "operator": "Exists"}]},
    ])


def scenario(seed: int) -> dict:
    """Controllers, pre-existing pods and a script of steps, all drawn
    from ``random.Random(seed)``."""
    r = random.Random(seed)
    ctrls = []
    for i in range(r.randint(2, 4)):
        kind = r.choice((RC, RS))
        name = f"app{i}" if r.random() < 0.8 else "app0"
        if any(k == kind and o["metadata"]["name"] == name
               for k, o in ctrls):
            name = f"app{i}"
        ns = r.choice(("default", "team-b"))
        tier = r.choice(("fe", "be"))
        ctrls.append((kind, {
            "metadata": {"name": name, "namespace": ns},
            "spec": {"replicas": r.randint(0, 6),
                     "selector": _selector(r, kind, name, tier),
                     "template": {
                         "metadata": {
                             "labels": {"app": name, "tier": tier},
                             "annotations": {"note": str(r.randint(0, 9))}},
                         "spec": {"containers": [{
                             "name": "c", "resources": {"requests": {
                                 "cpu": f"{r.choice((50, 100, 250))}m"}}}],
                             "priority": r.randint(0, 3)}}}}))
    pods = []
    for j in range(r.randint(3, 9)):
        _, owner = r.choice(ctrls)
        labels = dict(owner["spec"]["template"]["metadata"]["labels"])
        if r.random() < 0.2:
            labels["app"] = "stray"
        pod = {"metadata": {"name": f"orphan-{j}",
                            "namespace": owner["metadata"]["namespace"],
                            "labels": labels},
               "spec": {"containers": [{"name": "c"}]},
               "status": {}}
        roll = r.random()
        if roll < 0.3:
            pod["spec"]["nodeName"] = f"node-{r.randint(0, 3)}"
            pod["status"]["phase"] = "Running"
        elif roll < 0.4:
            pod["status"]["phase"] = "Failed"
        elif roll < 0.5:
            pod["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        pods.append(pod)
    scales = [[r.randint(0, 8) for _ in ctrls] for _ in range(2)]
    binds = [r.random() for _ in range(64)]
    return {"ctrls": ctrls, "pods": pods, "scales": scales, "binds": binds,
            "kill": r.randint(1, 3), "drop": r.randrange(len(ctrls)),
            "seed": seed}


class Side:
    def __init__(self, side: str, seed: int):
        m = mods(side)
        self.store = m.MemStore()
        self.rm = m.ReplicationManager(self.store, sync_period=3600.0)
        self.rm._rand = random.Random(seed)
        self.pump = Pump(self.store, {
            RC: lambda t, o: self.rm._on_rc(RC, t, o),
            RS: lambda t, o: self.rm._on_rc(RS, t, o),
            "pods": self.rm._on_pod})

    def state(self) -> dict:
        rm = self.rm
        return {"store": snapshot(self.store, ("pods", RC, RS)),
                "dirty": sorted(rm._dirty),
                "creates": {k: sorted(v)
                            for k, v in rm._pending_creates.items()},
                "deletes": {k: sorted(v)
                            for k, v in rm._pending_deletes.items()},
                "cached": {ns: sorted(p) for ns, p in
                           rm._pods_by_ns.items()}}


def _twins(seed: int) -> dict:
    return {side: Side(side, seed) for side in SIDES}


def _step(sides: dict, fn) -> dict:
    states = {}
    for side, s in sides.items():
        fn(s)
        states[side] = s.state()
    assert states["ref"] == states["port"]
    return states["port"]


def _update(store, kind: str, key: str, edit) -> None:
    obj = store.get(kind, key)
    edit(obj)
    store.update(kind, obj)


@pytest.mark.parametrize("seed", range(8))
def test_scenarios_match_the_reference(seed):
    sc = scenario(seed)
    sides = _twins(seed)

    def setup(s):
        for kind, obj in sc["ctrls"]:
            s.store.create(kind, obj)
        for pod in sc["pods"]:
            s.store.create("pods", pod)
        s.pump.drain()
        s.rm.sync_all()
    first = _step(sides, setup)
    assert any(first["creates"].values()) or \
        any(first["deletes"].values())

    # The created pods' watch events have not landed: the expectations
    # keep a second pass from creating them again.
    _step(sides, lambda s: s.rm.sync_all())
    _step(sides, lambda s: (s.pump.drain(), s.rm.sync_dirty()))

    def bind(s):
        items, _ = s.store.list("pods")
        for obj, roll in zip(sorted(items, key=lambda o:
                                    o["metadata"]["name"]), sc["binds"]):
            if roll < 0.5 and not obj["spec"].get("nodeName"):
                s.store.bind(obj["metadata"].get("namespace", "default"),
                             obj["metadata"]["name"], "node-0")
        s.pump.drain()
        s.rm.sync_dirty()
    _step(sides, bind)

    for replicas in sc["scales"]:
        def scale(s, replicas=replicas):
            for (kind, obj), n in zip(sc["ctrls"], replicas):
                key = f"{obj['metadata']['namespace']}/" \
                      f"{obj['metadata']['name']}"

                def edit(o, n=n):
                    o["spec"]["replicas"] = n
                _update(s.store, kind, key, edit)
            s.pump.drain()
            s.rm.sync_dirty()
            s.pump.drain()
            s.rm.sync_dirty()
        _step(sides, scale)

    def kill(s):
        items, _ = s.store.list("pods")
        live = sorted((o for o in items if not o.get("status", {})
                       .get("phase") == "Failed"),
                      key=lambda o: o["metadata"]["name"])
        for obj in live[:sc["kill"]]:
            obj.setdefault("status", {})["phase"] = "Failed"
            s.store.update("pods", obj)
        s.pump.drain()
        s.rm.sync_dirty()
        s.pump.drain()
        s.rm.sync_all()
    _step(sides, kill)

    def drop(s):
        kind, obj = sc["ctrls"][sc["drop"]]
        s.store.delete(kind, f"{obj['metadata']['namespace']}/"
                             f"{obj['metadata']['name']}")
        s.pump.drain()
        s.rm.sync_all()
        s.pump.drain()
        s.rm.sync_dirty()
    last = _step(sides, drop)
    assert last["dirty"] == []


@pytest.mark.parametrize("selector", [
    {"matchLabels": {"app": "w"},
     "matchExpressions": [{"key": "tier", "operator": "NotIn",
                           "values": ["fe"]}]},
    {"matchExpressions": [{"key": "env", "operator": "Exists"}]},
], ids=["notin", "exists"])
def test_a_template_that_misses_its_selector_is_refused(selector):
    """A stamped replica that cannot match its own selector (the template
    labels miss a matchExpressions requirement) is never created."""
    out = {}
    for side in SIDES:
        s = Side(side, 1)
        s.store.create(RS, {
            "metadata": {"name": "w", "namespace": "default"},
            "spec": {"replicas": 3, "selector": selector,
                     "template": {"metadata": {"labels": {
                         "app": "w", "tier": "fe"}},
                         "spec": {"containers": [{"name": "c"}]}}}})
        s.pump.drain()
        s.rm.sync_all()
        out[side] = s.state()
        assert out[side]["store"]["pods"] == []
        assert out[side]["creates"] == {f"{RS}:default/w": []}
    assert out["ref"] == out["port"]


def test_an_expired_expectation_is_created_again():
    """A create whose pod never shows up in the cache (here: deleted
    before its watch event was read) is retried once its expectation
    expires, with the next suffix of the generator, on both sides."""
    states = {}
    for side in SIDES:
        s = Side(side, 5)
        s.store.create(RC, {
            "metadata": {"name": "e", "namespace": "default"},
            "spec": {"replicas": 2, "selector": {"run": "e"},
                     "template": {"metadata": {"labels": {"run": "e"}},
                                  "spec": {"containers": [{"name": "c"}]}}}})
        s.pump.drain()
        s.rm.sync_all()
        first = sorted(o["metadata"]["name"]
                       for o in s.store.list("pods")[0])
        s.store.delete("pods", f"default/{first[0]}")
        s.pump.drain()   # the ADDED and the DELETED of the lost pod
        s.rm._expectation_ttl = -1.0
        for ledger in s.rm._pending_creates.values():
            for name in ledger:
                ledger[name] = 0.0
        s.rm.sync_dirty()
        states[side] = s.state()
        assert len(states[side]["store"]["pods"]) == 2
    assert states["ref"] == states["port"]


def test_label_helpers_match_the_reference():
    from kubernetes_tpu.controller import replication as ref
    from kubernetes_tpu_torch.controller import replication as port
    r = random.Random(11)
    keys = ("app", "tier", "env")
    vals = ("a", "b", "c")
    ops = ("In", "NotIn", "Exists", "DoesNotExist")
    for _ in range(400):
        labels = {k: r.choice(vals) for k in keys if r.random() < 0.6}
        pod = {"metadata": {"labels": labels}}
        if r.random() < 0.2:
            pod["status"] = {"phase": r.choice(("Failed", "Succeeded",
                                                "Running"))}
        if r.random() < 0.1:
            pod["metadata"]["deletionTimestamp"] = "x"
        if r.random() < 0.4:
            sel = {k: r.choice(vals) for k in keys if r.random() < 0.5}
        else:
            sel = {}
            if r.random() < 0.7:
                sel["matchLabels"] = {k: r.choice(vals) for k in keys
                                      if r.random() < 0.4}
            if r.random() < 0.7:
                sel["matchExpressions"] = [
                    {"key": r.choice(keys), "operator": r.choice(ops),
                     "values": r.sample(vals, r.randint(1, 2))}
                    for _ in range(r.randint(0, 2))]
        assert port._matches(sel, pod) == ref._matches(sel, pod)
        assert port._is_label_selector(sel) == ref._is_label_selector(sel)
        assert port._selector_labels(sel) == ref._selector_labels(sel)
        assert port._alive(pod) == ref._alive(pod)


def test_the_threaded_manager_converges_as_the_reference():
    """``run()``: reflectors and the sync loop.  Seven replicas, then a
    scale down to three: the same names are created and the same ones
    deleted (the newest unbound pods survive in creation order)."""
    names = {}
    for side in SIDES:
        m = mods(side)
        store = m.MemStore()
        rm = m.ReplicationManager(store, sync_period=0.05)
        rm._rand = random.Random(3)
        rm.run()
        try:
            store.create(RC, {
                "metadata": {"name": "t", "namespace": "default"},
                "spec": {"replicas": 7, "selector": {"run": "t"},
                         "template": {"metadata": {"labels": {"run": "t"}},
                                      "spec": {"containers": [
                                          {"name": "c"}]}}}})
            wait(lambda: len(store.list("pods")[0]) == 7
                 and not any(rm._pending_creates.values()),
                 msg="7 replicas observed")
            created = sorted(o["metadata"]["name"]
                             for o in store.list("pods")[0])
            rc = store.get(RC, "default/t")
            rc["spec"]["replicas"] = 3
            store.update(RC, rc)
            wait(lambda: len(store.list("pods")[0]) == 3,
                 msg="scale down to 3")
            names[side] = (created, sorted(o["metadata"]["name"]
                                           for o in store.list("pods")[0]))
        finally:
            rm.stop()
    assert names["ref"] == names["port"]

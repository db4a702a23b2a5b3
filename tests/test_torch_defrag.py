"""The PyTorch port's always-on defragmenter (``kubernetes_tpu_torch.
scheduler.defrag``) against the JAX package's, on the CPU.

Each case builds the reference's rigs (tests/test_defrag.py) on both
sides — a ``MemStore`` holding a fragmented fleet, the daemon's cache
holding the same bound pods — and runs the same steps: ``run_once``
rounds, re-binds, PDBs, a restart's reconcile.  After every step the
round report, the controller's stats, every pod's node and migration
intent, the queue and the cache's attachments must be equal.  The
probes are the host feasibility walk (no solver service) and the
solver service's background lane, whose joint solve runs on the port's
engine on the CPU.  The binders' ``unbind`` and the flight recorder's
defrag records are checked on their own."""

from __future__ import annotations

import json

import numpy as np
import pytest

from helpers import make_node, make_pod
from torch_parity import to_port

INTENT = "scheduling.kt.io/defrag-migration"


def _mods(side: str) -> dict:
    if side == "ref":
        from kubernetes_tpu.api import types as api
        from kubernetes_tpu.apiserver.memstore import MemStore
        from kubernetes_tpu.engine.generic_scheduler import GenericScheduler
        from kubernetes_tpu.scheduler import recovery
        from kubernetes_tpu.scheduler.binder import InMemoryBinder
        from kubernetes_tpu.scheduler.defrag import DefragController
        from kubernetes_tpu.scheduler.factory import MemStoreBinder
        from kubernetes_tpu.scheduler.scheduler import (Scheduler,
                                                        SchedulerConfig)
        from kubernetes_tpu.tenancy.service import SolverService
        kw = {}
    else:
        from kubernetes_tpu_torch.api import types as api
        from kubernetes_tpu_torch.apiserver.memstore import MemStore
        from kubernetes_tpu_torch.engine.generic_scheduler import \
            GenericScheduler
        from kubernetes_tpu_torch.scheduler import recovery
        from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
        from kubernetes_tpu_torch.scheduler.defrag import DefragController
        from kubernetes_tpu_torch.scheduler.factory import MemStoreBinder
        from kubernetes_tpu_torch.scheduler.scheduler import (
            Scheduler, SchedulerConfig)
        from kubernetes_tpu_torch.tenancy.service import SolverService
        kw = {"device": "cpu"}
    return dict(api=api, MemStore=MemStore,
                engine=lambda: GenericScheduler(**kw), recovery=recovery,
                InMemoryBinder=InMemoryBinder, Defrag=DefragController,
                MemStoreBinder=MemStoreBinder, Scheduler=Scheduler,
                SchedulerConfig=SchedulerConfig, SolverService=SolverService)


def _obj(obj, side: str):
    return obj if side == "ref" else to_port(obj)


def _node_json(name: str, cpu: str = "1") -> dict:
    return {"metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": "64Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}}


def _pod_json(name: str, cpu: str = "300m", node: str = "",
              labels: dict | None = None,
              annotations: dict | None = None) -> dict:
    d: dict = {"metadata": {"name": name, "namespace": "default"},
               "spec": {"containers": [{
                   "name": "c", "resources": {"requests": {"cpu": cpu}}}]}}
    if labels:
        d["metadata"]["labels"] = dict(labels)
    if annotations:
        d["metadata"]["annotations"] = dict(annotations)
    if node:
        d["spec"]["nodeName"] = node
    return d


class _Rig:
    """The reference's canonical fragmented fleet on one side: 1-cpu
    nodes, each full with ``smalls`` 300m pods (``labels`` on every
    other node's pods when ``split_labels``), and ``bigs`` pending 600m
    pods that fit nowhere whole."""

    def __init__(self, side: str, n_nodes: int = 2, smalls: int = 2,
                 bigs: int = 1, labels: dict | None = None,
                 gang: str | None = None, split_labels: bool = False,
                 probe: bool = False, seed: int | None = None):
        m = self.m = _mods(side)
        self.side = side
        self.store = m["MemStore"]()
        algo = m["engine"]()
        for i in range(n_nodes):
            self.store.create("nodes", _node_json(f"n{i}"))
            algo.cache.add_node(_obj(make_node(f"n{i}", milli_cpu=1000),
                                     side))
        ann = {"scheduling.kt.io/gang": gang} if gang else None
        self.keys = []
        # ``seed``: a random fill (2-3 smalls of 200/250/300m per node,
        # bigs of 750m) in place of the canonical 2 x 300m.
        rng = None if seed is None else np.random.RandomState(seed)
        for i in range(n_nodes):
            lab = labels if (not split_labels or i % 2 == 0) else None
            count = smalls if rng is None else int(rng.randint(2, 4))
            for j in range(count):
                name = f"s{i}-{j}"
                cpu = "300m" if rng is None else \
                    f"{int(rng.choice([200, 250, 300]))}m"
                self.store.create("pods", _pod_json(
                    name, cpu=cpu, node=f"n{i}", labels=lab,
                    annotations=ann))
                p = make_pod(name, cpu=cpu, node_name=f"n{i}",
                             labels=lab)
                if gang:
                    p.annotations["scheduling.kt.io/gang"] = gang
                algo.cache.add_pod(_obj(p, side))
                self.keys.append(f"default/{name}")
        for b in range(bigs):
            self.store.create("pods", _pod_json(
                f"big{b}", cpu="600m" if rng is None else "750m"))
            self.keys.append(f"default/big{b}")
        self.daemon = m["Scheduler"](m["SchedulerConfig"](
            algorithm=algo, binder=m["MemStoreBinder"](self.store),
            async_bind=False))
        self.svc = None
        if probe:
            self.svc = m["SolverService"](engine=algo, tenants=["default"])
        self.noted: list = []
        self.ctrl = self.controller()

    def controller(self):
        spy = type("Spy", (), {"note_defrag":
                               lambda _s, keys: self.noted.extend(keys)})()
        probe = None
        if self.svc is not None:
            probe = lambda pods: self.svc.submit_background(  # noqa: E731
                pods, joint=True)
        return self.m["Defrag"](self.daemon, self.store, probe=probe,
                                verifier=spy)

    def state(self) -> dict:
        """Every pod's node and intent, the queue, the cache."""
        pods = {}
        for obj in self.store.list("pods")[0]:
            ann = (obj.get("metadata") or {}).get("annotations") or {}
            pods[self.m["api"].key_from_json(obj)] = (
                (obj.get("spec") or {}).get("nodeName") or "",
                ann.get(INTENT))
        cache = self.daemon.config.algorithm.cache
        return {"pods": pods,
                "queue": [k for k in self.keys if k in self.daemon.queue],
                "cached": {k: getattr(cache.get_pod(k), "node_name", None)
                           for k in self.keys},
                "stats": self.ctrl.report(), "noted": list(self.noted)}

    def evicted(self) -> list[str]:
        return sorted(k for k, (node, _) in self.state()["pods"].items()
                      if not node and "/big" not in k)

    def stop(self) -> None:
        self.daemon.stop()


def _round(rig, log: list) -> None:
    log.append(("round", rig.ctrl.run_once(), rig.state()))


def _rebind(rig, log: list) -> None:
    """The ordinary drain's work, by hand: each migrant onto the first
    other node with room, then each pending big onto the first node with
    room (1,000m nodes)."""
    pods = rig.state()["pods"]
    cpu = {rig.m["api"].key_from_json(o):
           rig.m["MemStore"]._pod_requests(o)[0]
           for o in rig.store.list("pods")[0]}
    used: dict[str, int] = {}
    for k, (node, _) in pods.items():
        if node:
            used[node] = used.get(node, 0) + cpu[k]
    nodes = sorted(o["metadata"]["name"]
                   for o in rig.store.list("nodes")[0])

    def place(key: str, need: int, avoid: str = "") -> None:
        for n in nodes:
            if n != avoid and used.get(n, 0) + need <= 1000:
                rig.store.bind("default", key.split("/")[1], n)
                used[n] = used.get(n, 0) + need
                return
    for k in rig.evicted():
        src = json.loads(rig.store.get("pods", k)["metadata"]
                         ["annotations"][INTENT])["from"]
        place(k, cpu[k], avoid=src)
    for k, (node, _) in sorted(pods.items()):
        if "/big" in k and not node:
            place(k, cpu[k])
    log.append(("rebind", rig.state()))


def _case_migrate(rig, log):
    _round(rig, log)
    _rebind(rig, log)
    _round(rig, log)


def _case_lost_delivery(rig, log):
    _round(rig, log)
    for k in rig.evicted():
        rig.daemon.queue.delete(k)
    log.append(("lost", rig.state()))
    _round(rig, log)


def _case_crash(rig, log):
    """SIGKILL between the evict and the re-bind: a fresh incarnation's
    reconcile requeues the migrant and clears its intent."""
    _round(rig, log)
    m = rig.m
    d2 = m["Scheduler"](m["SchedulerConfig"](
        algorithm=m["engine"](), binder=m["InMemoryBinder"](),
        async_bind=False))
    try:
        report = m["recovery"].reconcile(d2, rig.store)
        report.pop("duration_s", None)
        log.append(("reconcile", report, rig.state()["pods"],
                    [k for k in rig.keys if k in d2.queue]))
    finally:
        d2.stop()


def _case_pdb(rig, log):
    rig.store.create("poddisruptionbudgets", {
        "metadata": {"name": "pdb", "namespace": "default"},
        "spec": {"minAvailable": 4, "selector": {"app": "prot"}},
        "status": {"disruptionAllowed": False, "currentHealthy": 4,
                   "desiredHealthy": 4, "expectedPods": 4}})
    rig.ctrl = rig.controller()
    _round(rig, log)


def _case_pdb_headroom(rig, log):
    rig.store.create("poddisruptionbudgets", {
        "metadata": {"name": "pdb", "namespace": "default"},
        "spec": {"minAvailable": 3, "selector": {"app": "prot"}},
        "status": {"disruptionAllowed": True, "currentHealthy": 4,
                   "desiredHealthy": 3, "expectedPods": 4}})
    rig.ctrl = rig.controller()
    veto = rig.ctrl._pdb_guard()
    log.append(("guard", [veto(_pod_json("x", labels={"app": "prot"})),
                          veto(_pod_json("x", labels={"app": "prot"})),
                          veto(_pod_json("y"))]))
    rig.ctrl = rig.controller()
    _round(rig, log)
    _rebind(rig, log)
    _round(rig, log)


CASES = {
    "migrate": (_case_migrate, {}, {}),
    "migrate_joint_probe": (_case_migrate, {"probe": True}, {}),
    "many_blocked": (_case_migrate, {"n_nodes": 6, "bigs": 3}, {}),
    "lost_delivery": (_case_lost_delivery, {}, {}),
    "gang_members_immovable": (_case_migrate, {"gang": "g0"}, {}),
    "min_gain_veto": (_case_migrate, {}, {"KT_DEFRAG_MIN_GAIN": "2.0"}),
    "budget_veto": (_case_migrate, {}, {"KT_DEFRAG_BUDGET": "0"}),
    "max_migrations_trim": (_case_migrate, {},
                            {"KT_DEFRAG_MAX_MIGRATIONS": "0"}),
    "pdb_veto": (_case_pdb, {"labels": {"app": "prot"}}, {}),
    "pdb_headroom": (_case_pdb_headroom,
                     {"n_nodes": 4, "bigs": 2, "labels": {"app": "prot"},
                      "split_labels": True}, {}),
    "crash_between_intent_and_evict": (_case_crash, {}, {}),
    "random_fleet": (_case_migrate, {"n_nodes": 40, "bigs": 6, "seed": 5},
                     {}),
    "random_fleet_joint_probe": (_case_migrate,
                                 {"n_nodes": 40, "bigs": 6, "seed": 6,
                                  "probe": True}, {}),
}


def _run(side: str, name: str) -> list:
    fn, rig_kw, _ = CASES[name]
    rig = _Rig(side, **rig_kw)
    log: list = []
    try:
        fn(rig, log)
    finally:
        rig.stop()
    return log


@pytest.mark.parametrize("name", sorted(CASES))
def test_defrag_round_equals_the_reference(name, monkeypatch):
    for knob, value in CASES[name][2].items():
        monkeypatch.setenv(knob, value)
    ref, port = _run("ref", name), _run("port", name)
    assert port == ref
    first = ref[0][1] if ref[0][0] == "round" else ref[1][1]
    assert first["blocked"] >= 1


def test_migrate_case_does_what_it_says():
    """The shape the parity cases rest on: one victim evicted with its
    intent, the anchor requeued, then the settle retires the intent and
    credits the anchor."""
    log = _run("port", "migrate")
    _, rep, state = log[0]
    assert rep["executed"] == 1 and state["stats"]["inflight"] == 1
    evicted = [k for k, (n, i) in state["pods"].items()
               if not n and "/big" not in k]
    assert len(evicted) == 1
    assert json.loads(state["pods"][evicted[0]][1])["from"] in ("n0", "n1")
    assert "default/big0" in state["queue"]
    assert state["cached"][evicted[0]] is None
    _, _, final = log[2]
    assert final["stats"]["migrations_completed"] == 1
    assert final["stats"]["unblocked"] == 1
    assert final["noted"] == evicted
    assert all(i is None for _, i in final["pods"].values())


def test_stale_intent_on_a_bound_pod_is_cleared_as_the_reference_clears():
    out = {}
    for side in ("ref", "port"):
        m = _mods(side)
        store = m["MemStore"]()
        store.create("nodes", _node_json("n0"))
        store.create("pods", _pod_json("p0", node="n0", annotations={
            INTENT: json.dumps({"from": "n0", "round": 3})}))
        d = m["Scheduler"](m["SchedulerConfig"](
            algorithm=m["engine"](), binder=m["InMemoryBinder"](),
            async_bind=False))
        try:
            report = m["recovery"].reconcile(d, store)
            report.pop("duration_s", None)
            obj = store.get("pods", "default/p0")
            out[side] = (report, obj["metadata"].get("annotations"),
                         "default/p0" in d.queue)
        finally:
            d.stop()
    assert out["port"] == out["ref"]
    assert out["ref"][0]["migration_intents_cleared"] == 1


def test_memstore_binder_unbind_equals_the_reference():
    out = {}
    for side in ("ref", "port"):
        m = _mods(side)
        store = m["MemStore"]()
        store.create("nodes", _node_json("n0"))
        store.create("pods", _pod_json("p0", node="n0"))
        binder = m["MemStoreBinder"](store)
        pod = m["api"].pod_from_json(store.get("pods", "default/p0"))
        binder.unbind(pod)
        obj = store.get("pods", "default/p0")
        with pytest.raises(KeyError):
            binder.unbind(m["api"].pod_from_json(_pod_json("gone")))
        out[side] = (obj["spec"].get("nodeName"),
                     obj["metadata"]["resourceVersion"])
    assert out["port"] == out["ref"] == ("", out["ref"][1])


def test_wire_binder_unbind_clears_the_node_over_http():
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.client.http import APIClient
    from kubernetes_tpu_torch.scheduler.binder import APIClientBinder
    store = MemStore()
    srv = serve(store)
    try:
        client = APIClient(f"http://127.0.0.1:{srv.server_address[1]}",
                           qps=0)
        client.create("nodes", _node_json("n0"))
        client.create("pods", _pod_json("p0", node="n0"))
        APIClientBinder(client).unbind(
            api.pod_from_json(store.get("pods", "default/p0")))
        assert store.get("pods", "default/p0")["spec"].get("nodeName") \
            in ("", None)
        with pytest.raises(KeyError):
            APIClientBinder(client).unbind(
                api.pod_from_json(_pod_json("gone")))
    finally:
        srv.shutdown()


def test_flight_recorder_defrag_records_equal_the_reference():
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            from kubernetes_tpu.scheduler.flightrecorder import \
                FlightRecorder
        else:
            from kubernetes_tpu_torch.scheduler.flightrecorder import \
                FlightRecorder
        fr = FlightRecorder(flight_dir="")
        fr.record_batch([make_pod("a", cpu="300m"),
                         make_pod("big", cpu="600m")], ["n0", None])
        fr.record_defrag("default/a", "executed", from_node="n0",
                         target="default/big")
        fr.record_defrag("default/big", "vetoed_budget")
        first = (fr.explain("default/a"), fr.explain("default/big"))
        fr.record_defrag("default/a", "completed", from_node="n0",
                         to_node="n1")
        out[side] = [{k: v for k, v in r.items()
                      if k not in ("ts", "time", "seq", "trace_id")}
                     for r in first + (fr.explain("default/a"),)]
    assert out["port"] == out["ref"]
    assert out["ref"][0]["defrag"] == "executed"
    assert out["ref"][2]["defrag"] == "completed"

"""The PyTorch port's multi-tenant solver service (``kubernetes_tpu_torch.
tenancy`` and its daemon wiring) against the JAX package's, on the CPU.

* tenant identity and weights, and ``TenantPacker.pack`` over seeded
  pod sets, weights, ages, gangs and caps: equal selections, drain after
  drain;
* ``SolverService``: packed-submit placements, concurrent submits, the
  HTTP ``solve_route`` response bytes, the breaker state machine;
* the pipeline's ``_solve_tenants`` under a tenant-scoped poison rule:
  equal attribution splits, faults, trips and victim placements;
* the one known difference, pinned: the JAX package places a tripped
  tenant's pods on its host engine, the port requeues them and places
  them after the probe as the reference's device path would, and
  ``ServiceEngine.schedule_batch_host`` raises;
* the daemon with ``KT_TENANTS`` over a ``MemStore`` (placements, the
  ``/tenancy`` and ``/solve`` routes), the daemon-as-tenant
  ``ServiceEngine`` over a ``SolverClient``, and ``perf/tenancy.collect``
  at toy size with the reference's artifact keys.

Every chaos rule is uninstalled and every daemon stopped in a
``finally``."""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from kubernetes_tpu import tenancy as r_tenancy
from kubernetes_tpu.chaos import device as r_chaos
from kubernetes_tpu.perf import synth as r_synth
from kubernetes_tpu.tenancy import packer as r_packer
from kubernetes_tpu.tenancy import service as r_service
from kubernetes_tpu_torch import tenancy as t_tenancy
from kubernetes_tpu_torch.chaos import device as t_chaos
from kubernetes_tpu_torch.perf import synth as t_synth
from kubernetes_tpu_torch.tenancy import packer as t_packer
from kubernetes_tpu_torch.tenancy import service as t_service
from torch_parity import daemon

TENANTS = ["t-a", "t-b", "t-c"]


def _side(side: str):
    """(tenancy, packer, service, synth, chaos) modules of ``side``."""
    if side == "ref":
        return r_tenancy, r_packer, r_service, r_synth, r_chaos
    return t_tenancy, t_packer, t_service, t_synth, t_chaos


def _engine(side: str, n_nodes: int = 64):
    synth = _side(side)[3]
    kw = {} if side == "ref" else {"device": "cpu"}
    eng, _ = synth.make_rig(n_nodes, 0, profile="mixed", **kw)
    return eng


def _tenant_pods(side: str, tenant: str, n: int, seed: int,
                 prefix: str = "p") -> list:
    synth = _side(side)[3]
    return synth.make_pods(n, seed=seed, profile="mixed", n_services=4,
                           namespace=tenant, name_prefix=f"{prefix}-{tenant}")


# -- identity, weights and the packer ----------------------------------------


def test_tenant_identity_and_weights_equal(monkeypatch):
    names = [f"ns-{i}" for i in range(2000)] + TENANTS + ["", "default"]
    for tenants in (TENANTS, ["solo"], []):
        assert [t_tenancy.tenant_of(ns, tenants) for ns in names] == \
            [r_tenancy.tenant_of(ns, tenants) for ns in names]
    monkeypatch.setenv("KT_TENANTS", "t-a, t-b,t-c")
    monkeypatch.setenv("KT_TENANT_WEIGHTS",
                       "t-a:3, t-b:bogus, nobody:9, t-c:-1")
    assert t_tenancy.tenant_names() == r_tenancy.tenant_names()
    assert t_tenancy.tenant_weights() == r_tenancy.tenant_weights() == \
        {"t-a": 3.0, "t-b": 1.0, "t-c": 1.0}
    assert t_tenancy.enabled() and r_tenancy.enabled()
    monkeypatch.delenv("KT_TENANTS")
    assert not t_tenancy.enabled() and not r_tenancy.enabled()


def _pack_run(side: str, case: dict) -> list:
    """Drains of one packer over a seeded backlog: per drain the
    selected and deferred keys, in order (the DRR deficit carries)."""
    _, packer_mod, _, _, _ = _side(side)
    api = _api(side)
    rng = np.random.RandomState(case["seed"])
    now = 1000.0
    pods = []
    for i in range(case["n"]):
        tenant = TENANTS[int(rng.choice(3, p=case["mix"]))]
        pod = api.Pod(name=f"pk-{i}", namespace=tenant,
                      containers=[api.Container(
                          name="c", requests={"cpu": "10m"})])
        if rng.rand() < case["aged"]:
            pod._kt_first_seen = now - float(rng.uniform(0.0, 2.0))
        if rng.rand() < case["gangs"]:
            g = int(rng.randint(0, 4))
            pod.annotations[api.GANG_ANNOTATION_KEY] = f"g{g}-{tenant}"
            pod.annotations[api.GANG_SIZE_ANNOTATION_KEY] = "4"
        pods.append(pod)
    packer = packer_mod.TenantPacker(
        lambda p: p.namespace, case["weights"],
        urgent_s_fn=lambda: case["urgent_s"])
    out = []
    backlog = list(pods)
    for _ in range(case["drains"]):
        sel, dfr = packer.pack(backlog, case["cap"], now=now)
        out.append(([p.key for p in sel], [p.key for p in dfr]))
        backlog = dfr + backlog[len(sel) + len(dfr):]
        now += 0.05
        if not backlog:
            break
    return out


PACK_CASES = {
    "saturated": dict(seed=1, n=900, mix=[0.5, 0.3, 0.2], aged=0.0,
                      gangs=0.0, weights={"t-a": 2.0, "t-b": 1.0,
                                          "t-c": 1.0},
                      urgent_s=0.0, cap=64, drains=12),
    "urgent": dict(seed=2, n=600, mix=[0.1, 0.8, 0.1], aged=0.3,
                   gangs=0.0, weights={"t-a": 1.0, "t-b": 8.0,
                                       "t-c": 1.0},
                   urgent_s=0.5, cap=48, drains=10),
    "gangs": dict(seed=3, n=400, mix=[0.4, 0.4, 0.2], aged=0.1,
                  gangs=0.3, weights={"t-a": 1.0, "t-b": 1.0, "t-c": 3.0},
                  urgent_s=0.2, cap=16, drains=20),
    "uncapped": dict(seed=4, n=120, mix=[0.3, 0.3, 0.4], aged=0.2,
                     gangs=0.1, weights={"t-a": 1.0, "t-b": 2.0,
                                         "t-c": 1.0},
                     urgent_s=0.3, cap=0, drains=1),
}


def _api(side: str):
    if side == "ref":
        from kubernetes_tpu.api import types
    else:
        from kubernetes_tpu_torch.api import types
    return types


@pytest.mark.parametrize("name", sorted(PACK_CASES))
def test_packer_pack_equals_the_reference(name):
    ref = _pack_run("ref", PACK_CASES[name])
    port = _pack_run("port", PACK_CASES[name])
    assert port == ref
    assert ref and ref[0][0]


# -- the service: breaker, packed submit, HTTP -------------------------------


def test_breaker_state_machine_equals_the_reference():
    trace = {}
    for side in ("ref", "port"):
        svc = _side(side)[2].SolverService(engine=None, tenants=TENANTS)
        svc.breaker_threshold = 2
        svc.probe_period_s = 3600.0
        steps = []
        for tenant, kind, probe in (("t-b", "corrupt", False),
                                    ("t-a", "oom", False),
                                    ("t-b", "corrupt", False),
                                    ("t-b", "corrupt", True),
                                    ("t-c", "lost", False)):
            steps.append(svc.note_fault(tenant, kind, probe=probe))
        svc.note_success("t-a")
        steps.append(svc.note_fault("t-a", "oom"))
        modes = {t: svc.tenant_mode(t) != "device" for t in TENANTS}
        rep = svc.report()["tenants"]
        trace[side] = (steps, modes,
                       {t: (r["faults"], r["breakerTrips"])
                        for t, r in rep.items()})
        svc.note_success("t-b", probe=True)
        trace[side] += (svc.tenant_mode("t-b"),)
    assert trace["port"] == trace["ref"]
    assert trace["ref"][1] == {"t-a": False, "t-b": True, "t-c": False}


def _packed(side: str) -> list:
    svc_mod = _side(side)[2]
    svc = svc_mod.SolverService(engine=_engine(side), tenants=TENANTS)
    out = []
    for rnd in range(3):
        reqs = [{"tenant": t, "pods": _tenant_pods(side, t, 7 + 3 * i,
                                                   seed=10 * rnd + i,
                                                   prefix=f"r{rnd}"),
                 "done": threading.Event(), "result": None, "err": None}
                for i, t in enumerate(TENANTS)]
        svc._solve_packed(reqs)
        out.append([r["result"] for r in reqs])
    out.append(svc.submit("t-b", _tenant_pods(side, "t-b", 9, seed=99)))
    out.append(svc.submit("foreign-ns", _tenant_pods(side, "t-c", 5,
                                                     seed=98)))
    rep = svc.report()
    out.append((rep["packedSolves"], rep["packedRequests"]))
    return out


def test_packed_submit_placements_equal_the_reference():
    ref, port = _packed("ref"), _packed("port")
    assert port == ref
    assert any(d is not None for rnd in ref[:3] for r in rnd for d in r)


def test_concurrent_submits_coalesce_into_one_packed_solve():
    svc = t_service.SolverService(engine=_engine("port", 16),
                                  tenants=["t-a", "t-b"])
    svc.pack_window_s = 0.2
    results = {}

    def run(tenant):
        results[tenant] = svc.submit(
            tenant, _tenant_pods("port", tenant, 3, seed=5))
    ts = [threading.Thread(target=run, args=(t,)) for t in ("t-a", "t-b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert len(results["t-a"]) == 3 and len(results["t-b"]) == 3
    assert all(d is not None for d in results["t-a"] + results["t-b"])
    assert svc.packed_solves == 1 and svc.packed_requests == 2


def test_solve_route_response_bytes_equal_the_reference():
    out = {}
    for side in ("ref", "port"):
        svc_mod = _side(side)[2]
        api = _api(side)
        svc = svc_mod.SolverService(engine=_engine(side), tenants=TENANTS)
        pods = _tenant_pods(side, "t-a", 6, seed=3)
        body = json.dumps({"tenant": "t-a", "pods": [
            api.pod_to_json(p) for p in pods]}).encode()
        out[side] = [svc_mod.solve_route(svc, body),
                     svc_mod.solve_route(svc, b"{not json"),
                     svc_mod.solve_route(svc, b"{}")]
    assert out["port"] == out["ref"]
    assert out["ref"][0][0] == 200 and out["ref"][1][0] == 400


def test_http_solver_round_trip():
    svc = t_service.SolverService(engine=_engine("port", 16),
                                  tenants=["t-a", "t-b"])
    server = t_service.serve_solver(svc)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        client = t_service.SolverClient(url)
        out = client.solve("t-a", _tenant_pods("port", "t-a", 3, seed=1))
        assert len(out) == 3 and all(d is not None for d in out)
        body = json.loads(urllib.request.urlopen(url + "/tenancy",
                                                 timeout=10).read())
        assert set(body["tenants"]) == {"t-a", "t-b"}
    finally:
        server.shutdown()


# -- the pipeline's tenant drain under a poison rule -------------------------


def _poisoned_drain(side: str, count: int) -> dict:
    """One tenant drain of t-a/t-b/t-c pods with a corrupt rule on t-b
    (``count`` firings): attribution splits, faults, trips, and every
    pod's outcome."""
    _, _, svc_mod, _, chaos = _side(side)
    d = daemon(side, n_nodes=64, floor=8)
    svc = svc_mod.SolverService(engine=d.config.algorithm,
                                tenants=TENANTS,
                                ladder_fn=d.effective_ladder)
    svc.breaker_threshold = 2
    svc.probe_period_s = 3600.0
    d.tenancy_service = svc
    chaos.install(chaos.DeviceChaos([chaos.DeviceRule(
        fault="corrupt", every_nth=1, count=count, tenant="t-b")]))
    try:
        pods = []
        for i, t in enumerate(TENANTS):
            pods += _tenant_pods(side, t, 10, seed=20 + i)
        for p in pods:
            d.enqueue(p)
        d.schedule_pending(wait_first=False)
        rep = svc.report()
        bound = dict(d.config.binder._bound)
        with d._requeue_cv:
            backoff = sorted(p.key for _, _, p in d._requeue_heap)
        return {
            "splits": rep["faultSplits"],
            "faults": {t: rep["tenants"][t]["faults"] for t in TENANTS},
            "trips": {t: rep["tenants"][t]["breakerTrips"]
                      for t in TENANTS},
            "open": sorted(t for t in TENANTS
                           if svc.tenant_mode(t) != "device"),
            "victims": {k: v for k, v in bound.items()
                        if not k.startswith("t-b/")},
            "poisoned_bound": sorted(k for k in bound
                                     if k.startswith("t-b/")),
            "backoff": backoff,
            "requeued": rep["tenants"]["t-b"].get("requeuedPods"),
            "counter": int(d.config.algorithm.last_node_index),
            "daemon": d, "svc": svc,
        }
    finally:
        chaos.install(None)
        chaos._reset_for_tests()


def _stop(*outs):
    for o in outs:
        o["daemon"].stop()


@pytest.mark.parametrize("count", [1, 2])
def test_solve_tenants_attribution_without_a_trip_equals_the_reference(
        count):
    """Below the breaker threshold the attribution split re-solves the
    culprit on the device, so every decision is equal."""
    ref, port = _poisoned_drain("ref", count), _poisoned_drain("port",
                                                               count)
    try:
        for key in ("splits", "faults", "trips", "open", "victims",
                    "poisoned_bound", "backoff", "counter"):
            assert port[key] == ref[key], key
        assert ref["splits"] == 1 and not ref["open"]
        assert len(ref["poisoned_bound"]) == 10
    finally:
        _stop(ref, port)


def test_tripped_tenant_is_requeued_then_placed_after_its_probe():
    """The one known difference.  With three firings t-b's breaker
    trips: the JAX package decides t-b's pods on its host engine at
    once, the port requeues them (backoff heap), places nothing of t-b
    on the CPU, and — once the poison is spent and the probe is due —
    places them on the device exactly as the reference's device path
    places the same pods from the same state.  Splits, faults, trips and
    the victims' placements are equal throughout."""
    ref, port = _poisoned_drain("ref", 3), _poisoned_drain("port", 3)
    try:
        for key in ("splits", "faults", "trips", "open", "victims"):
            assert port[key] == ref[key], key
        assert ref["open"] == ["t-b"] and ref["trips"]["t-b"] == 1
        # The reference's host engine placed t-b's pods at once.
        assert len(ref["poisoned_bound"]) == 10
        assert ref["svc"].report()["tenants"]["t-b"]["hostPods"] == 10
        # The port placed none of them and requeued all ten.
        assert port["poisoned_bound"] == []
        assert port["requeued"] == 10
        b_keys = sorted(f"t-b/p-t-b-{i}" for i in range(10))
        assert port["backoff"] == b_keys
        # The probe: the requeued pods come back and ride the device.
        d, svc = port["daemon"], port["svc"]
        counter = int(d.config.algorithm.last_node_index)
        svc.probe_period_s = 0.0
        deadline = time.monotonic() + 30
        while not all(k in d.queue for k in b_keys):
            assert time.monotonic() < deadline, "t-b never requeued"
            time.sleep(0.05)
        d.schedule_pending(wait_first=False)
        assert svc.tenant_mode("t-b") == "device"
        placed = {k: v for k, v in d.config.binder._bound.items()
                  if k.startswith("t-b/")}
        assert sorted(placed) == b_keys
        # The reference's device path from the same state: the victims
        # bound where they are, the same round-robin counter.
        eng = _engine("ref")
        for key, node in port["victims"].items():
            pod = next(p for i, t in enumerate(TENANTS)
                       for p in _tenant_pods("ref", t, 10, seed=20 + i)
                       if p.key == key)
            pod.node_name = node
            eng.cache.add_pod(pod)
        eng.last_node_index = np.uint32(counter)
        b_pods = _tenant_pods("ref", "t-b", 10, seed=21)
        want = eng.schedule_batch(b_pods, pad_to=16)
        assert placed == {p.key: n for p, n in zip(b_pods, want)}
    finally:
        _stop(ref, port)


def test_service_engine_refuses_the_host_verb():
    eng = t_service.ServiceEngine(
        t_service.SolverService(engine=None, tenants=["t-a"]),
        tenant="t-a")
    assert eng.device is None
    with pytest.raises(NotImplementedError, match="no host engine"):
        eng.schedule_batch_host(_tenant_pods("port", "t-a", 2, seed=1))


def test_open_tenant_submit_surfaces_its_fault_until_the_probe():
    """The submit path's counterpart: an open tenant's request is
    refused with its breaker fault (the JAX package answers it from its
    host engine), and the probe re-promotes it on a clean solve."""
    from kubernetes_tpu_torch.engine.guard import DeviceFault
    svc = t_service.SolverService(engine=_engine("port", 16),
                                  tenants=["t-a"])
    svc.breaker_threshold = 1
    svc.probe_period_s = 3600.0
    svc.note_fault("t-a", "corrupt")
    with pytest.raises(DeviceFault, match="breaker open"):
        svc.submit("t-a", _tenant_pods("port", "t-a", 4, seed=1))
    assert svc.report()["tenants"]["t-a"]["requeuedPods"] == 4
    svc.probe_period_s = 0.0
    out = svc.submit("t-a", _tenant_pods("port", "t-a", 4, seed=2))
    assert len(out) == 4 and all(d is not None for d in out)
    assert svc.tenant_mode("t-a") == "device"


# -- the daemon with KT_TENANTS, and the daemon as a tenant ------------------


def _node_json(name: str, cpu: str = "4000m") -> dict:
    return {"metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu,
                                       "memory": str(16 << 30),
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}}


def _pod_json(name: str, ns: str, cpu: str, scheduler: str = "") -> dict:
    meta = {"name": name, "namespace": ns}
    if scheduler:
        meta["annotations"] = {
            "scheduler.alpha.kubernetes.io/name": scheduler}
    return {"metadata": meta,
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": cpu, "memory": "64Mi"}}}]}}


def _fill(store, n_pods: int, scheduler: str = "") -> list[str]:
    rng = np.random.RandomState(11)
    for i in range(12):
        store.create("nodes", _node_json(f"tn-{i:02d}"))
    keys = []
    for i in range(n_pods):
        ns = TENANTS[int(rng.randint(0, 3))] if not scheduler else "t-a"
        cpu = f"{int(rng.choice([50, 100, 250, 400]))}m"
        store.create("pods", _pod_json(f"tp-{i}", ns, cpu, scheduler))
        keys.append(f"{ns}/tp-{i}")
    return keys


def _wait_bound(store, keys, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        nodes = {k: ((store.get("pods", k) or {}).get("spec") or {})
                 .get("nodeName") for k in keys}
        if all(nodes.values()):
            return nodes
        assert time.monotonic() < deadline, \
            [k for k, v in nodes.items() if not v]
        time.sleep(0.05)


def _tenancy_daemon(side: str, monkeypatch) -> tuple:
    monkeypatch.setenv("KT_TENANTS", ",".join(TENANTS))
    monkeypatch.setenv("KT_TENANT_WEIGHTS", "t-a:2,t-b:1,t-c:1")
    if side == "ref":
        from kubernetes_tpu.apiserver.memstore import MemStore
        from kubernetes_tpu.scheduler.factory import ConfigFactory
        kw = {}
    else:
        from kubernetes_tpu_torch.apiserver.memstore import MemStore
        from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
        kw = {"device": "cpu"}
    store = MemStore()
    keys = _fill(store, 150)
    f = ConfigFactory(store, **kw)
    return store, keys, f


def test_tenancy_daemon_over_memstore_equals_the_reference(monkeypatch):
    """Both daemons with KT_TENANTS over their own MemStore holding the
    same objects, the backlog pending before the first drain (packed,
    over-popped and deferred): every pod's node equal."""
    got = {}
    for side in ("ref", "port"):
        store, keys, f = _tenancy_daemon(side, monkeypatch)
        try:
            f.daemon.stream_min_bucket = 8
            f.daemon.degraded_drain_cap = lambda: 64
            assert f.tenancy is not None and \
                f.daemon.tenancy_service is f.tenancy
            f.run()
            got[side] = _wait_bound(store, keys)
            rep = f.tenancy.report()
            assert all(r["mode"] == "device"
                       for r in rep["tenants"].values())
        finally:
            f.stop()
    assert got["port"] == got["ref"]


def test_status_mux_serves_tenancy_and_solve(monkeypatch):
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.scheduler.__main__ import status_mux
    store, keys, f = _tenancy_daemon("port", monkeypatch)
    mux = None
    try:
        f.run()
        _wait_bound(store, keys)
        mux = status_mux(f, {}, 0)
        url = f"http://127.0.0.1:{mux.server_address[1]}"
        rep = json.loads(urllib.request.urlopen(url + "/tenancy",
                                                timeout=10).read())
        assert set(rep["tenants"]) == set(TENANTS)
        dvars = json.loads(urllib.request.urlopen(url + "/debug/vars",
                                                  timeout=10).read())
        assert dvars["tenancy"] == rep and dvars["ha"] is None and \
            dvars["shardRecoveries"] == []
        pods = _tenant_pods("port", "t-c", 3, seed=4)
        req = urllib.request.Request(
            url + "/solve", data=json.dumps({"tenant": "t-c", "pods": [
                api.pod_to_json(p) for p in pods]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        body = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert body["tenant"] == "t-c" and len(body["placements"]) == 3
    finally:
        if mux is not None:
            mux.shutdown()
        f.stop()


def _client_run(side: str) -> dict:
    """A host daemon owning the engine, its SolverService served over
    HTTP, and a client daemon (scheduler name ``svc-client``) whose
    ServiceEngine submits through a SolverClient."""
    if side == "ref":
        from kubernetes_tpu.apiserver.memstore import MemStore
        from kubernetes_tpu.scheduler.factory import ConfigFactory
        kw = {}
    else:
        from kubernetes_tpu_torch.apiserver.memstore import MemStore
        from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
        kw = {"device": "cpu"}
    svc_mod = _side(side)[2]
    store = MemStore()
    keys = _fill(store, 40, scheduler="svc-client")
    host = ConfigFactory(store, **kw)
    host.run()
    svc = svc_mod.SolverService(engine=host.algorithm, tenants=["t-a"])
    server = svc_mod.serve_solver(svc)
    client = None
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        client = ConfigFactory(store, scheduler_name="svc-client",
                               solver_service=svc_mod.SolverClient(url),
                               tenant="t-a", **kw)
        client.run()
        nodes = _wait_bound(store, keys)
        assert svc.packed_requests >= 1
        return nodes
    finally:
        if client is not None:
            client.stop()
        server.shutdown()
        host.stop()


def test_daemon_as_tenant_over_solver_client_equals_the_reference():
    assert _client_run("port") == _client_run("ref")


# -- the tenancy bench at toy size -------------------------------------------


def _keys(obj, path=""):
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            out |= {f"{path}/{k}"} | _keys(v, f"{path}/{k}")
        return out
    return set()


def test_tenancy_collect_artifact_keys_equal_the_reference():
    from kubernetes_tpu.perf import tenancy as r_bench
    from kubernetes_tpu_torch.perf import tenancy as t_bench
    kw = dict(n_nodes=16, trickle_rate=10.0, trickle_s=0.4,
              offered_per_tenant=60, quiet=True)
    ref = r_bench.collect(**kw)
    port = t_bench.collect(device="cpu", **kw)
    # The port's record says what it ran on, and counts the tripped
    # tenant's requeued pods where the reference's host engine placed
    # them.
    assert _keys(port) - _keys(ref) == \
        {"/isolation/requeued_pods"} | \
        {f"/isolation/requeued_pods/{t}" for t in TENANTS}
    assert _keys(ref) - _keys(port) == set()
    assert port["backend"] == "cpu"
    iso = port["isolation"]
    assert iso["cross_tenant_faults"] == 0 and iso["repromoted"] and \
        iso["all_bound"]
    assert iso["breaker_trips"]["t-c"] >= 1
    assert iso["requeued_pods"]["t-c"] > 0
    assert iso["victim_modes"] == {"t-a": "device", "t-b": "device"}
    assert port["fairness"]["bound_total"] == 3 * 60

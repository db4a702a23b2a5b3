"""The kubemark control plane around the PyTorch port's daemon against
the JAX package's, on the CPU: replication manager -> scheduler daemon ->
hollow kubelets -> node death -> node controller eviction -> reschedule,
every component joined through list/watch on one ``MemStore``.

Both planes start from the same state and the same seeded suffix
generator.  The replication manager creates its replicas before the
daemon starts, so the daemon's first drain holds every pending pod and
the placements do not depend on thread timing (the reference tests run
the two concurrently):

* the reference fixture's size (two kubelets, heartbeats every 0.3 s,
  grace 1.2 s, eviction 1 s, syncs every 0.3 s), with a Service, the
  endpoints controller and a hollow proxy: the same replicas on the same
  nodes with the same IPs; one kubelet stopped, its node Ready=Unknown,
  its pods evicted, replaced and run on the survivor: the same replicas,
  the same Endpoints and proxy table;
* ``test_hollow_fleet_scale``'s size (40 nodes, 400 replicas at 50m):
  every replica Running on the node the reference places it on, all 40
  nodes used, at most 20 pods per node;
* ``perf/harness.fleet_metrics`` at a toy size has the reference's keys
  plus the port's, and raises without a card by default before it
  starts anything;
* the bench's ``fleet`` phase: its record and launches in the artifact,
  and a fleet that misses its replicas or raises fails the run."""

from __future__ import annotations

import json
import random
import threading

import pytest
import torch

from torch_plane import SIDES, hollow_node, mods, pods_of, rc, wait


def _running(store, name: str, n: int) -> bool:
    pods = [p for p in pods_of(store, name)
            if not (p.get("metadata") or {}).get("deletionTimestamp")]
    return len(pods) == n and all(
        (p.get("status") or {}).get("phase") == "Running"
        and (p.get("spec") or {}).get("nodeName") for p in pods)


def _placement(store, name: str) -> dict:
    return {p["metadata"]["name"]: p["spec"]["nodeName"]
            for p in pods_of(store, name)}


def _ips_by_node(store, name: str) -> dict:
    out: dict = {}
    for p in pods_of(store, name):
        out.setdefault(p["spec"]["nodeName"], []).append(
            p["status"]["podIP"])
    return {n: sorted(ips) for n, ips in out.items()}


class Plane:
    """Kubelets, the replication manager and (later) the daemon, the node
    controller, the endpoints controller and a proxy, on one store."""

    def __init__(self, side: str, n_nodes: int, milli_cpu: int,
                 heartbeat: float, rm_sync: float, seed: int):
        self.m = m = mods(side)
        self.store = m.MemStore()
        self.kubelets = [
            m.HollowKubelet(self.store,
                            hollow_node(m.api, f"hk-{i:02d}", milli_cpu),
                            heartbeat_period=heartbeat).run()
            for i in range(n_nodes)]
        self.rm = m.ReplicationManager(self.store, sync_period=rm_sync)
        self.rm._rand = random.Random(seed)
        self.rm.run()
        self.others: list = []

    def start(self, obj) -> None:
        self.others.append(obj.run())

    def stop(self) -> None:
        for obj in reversed(self.others):
            obj.stop()
        self.rm.stop()
        for k in self.kubelets:
            k.stop()


def _pending_then_scheduled(plane: Plane, name: str, replicas: int,
                            cpu: str, timeout: float) -> None:
    store = plane.store
    store.create("replicationcontrollers", rc(name, replicas, cpu=cpu))
    wait(lambda: len(pods_of(store, name)) == replicas, timeout=30,
         msg=f"{replicas} pending replicas")
    plane.start(plane.m.factory(store))
    wait(lambda: _running(store, name, replicas), timeout=timeout,
         msg=f"{replicas} replicas Running")


def test_plane_and_node_death_match_the_reference():
    out = {}
    for side in SIDES:
        plane = Plane(side, 2, 8000, heartbeat=0.3, rm_sync=0.3, seed=7)
        store = plane.store
        try:
            store.create("services", {
                "metadata": {"name": "websvc", "namespace": "default"},
                "spec": {"selector": {"run": "web"}}})
            _pending_then_scheduled(plane, "web", 6, "100m", 90)
            before = (_placement(store, "web"), _ips_by_node(store, "web"))
            m = plane.m
            plane.start(m.NodeLifecycleController(
                store, monitor_grace=1.2, eviction_timeout=1.0,
                sync_period=0.3))
            ec = m.EndpointsController(store, sync_period=0.2)
            plane.start(ec)
            proxy = m.HollowProxy(store)
            plane.start(proxy)
            victim = "hk-00" if "hk-00" in before[0].values() else "hk-01"
            survivor = ({"hk-00", "hk-01"} - {victim}).pop()
            plane.kubelets[int(victim[-2:])].stop()

            def unknown():
                conds = {c["type"]: c["status"] for c in
                         store.get("nodes", victim)["status"]["conditions"]}
                return conds.get("Ready") == "Unknown"
            wait(unknown, timeout=15, msg=f"{victim} Ready=Unknown")
            wait(lambda: _running(store, "web", 6) and set(
                _placement(store, "web").values()) == {survivor},
                timeout=60, msg="6 replicas Running on the survivor")

            def endpoints():
                ep = store.get("endpoints", "default/websvc")
                ips = sorted(a["ip"] for s in (ep or {}).get("subsets", ())
                             for a in s["addresses"])
                want = sorted(ip for ips in _ips_by_node(store, "web")
                              .values() for ip in ips)
                return ips == want and proxy.backends(
                    "default", "websvc") == want and ips
            ips = wait(endpoints, timeout=30,
                       msg="Endpoints and the proxy follow the reschedule")
            out[side] = {"before": before,
                         "after": sorted(_placement(store, "web").items()),
                         "endpoints": ips}
        finally:
            plane.stop()
    assert out["ref"] == out["port"]
    assert set(out["port"]["before"][0].values()) == {"hk-00", "hk-01"}


def test_hollow_fleet_scale_matches_the_reference():
    """``test_hollow_fleet_scale``'s fleet: 40 nodes of 16 CPUs self
    register, an RC asks for 400 replicas at 50m."""
    out = {}
    for side in SIDES:
        plane = Plane(side, 40, 16000, heartbeat=2.0, rm_sync=0.5, seed=11)
        try:
            _pending_then_scheduled(plane, "load", 400, "50m", 120)
            out[side] = _placement(plane.store, "load")
        finally:
            plane.stop()
    assert out["ref"] == out["port"]
    per_node: dict = {}
    for node in out["port"].values():
        per_node[node] = per_node.get(node, 0) + 1
    assert len(per_node) == 40 and max(per_node.values()) <= 20


def test_fleet_metrics_has_the_reference_keys():
    from kubernetes_tpu.perf import harness as ref_harness
    from kubernetes_tpu_torch.perf import harness
    ref = ref_harness.fleet_metrics(8, 24, heartbeat_period=2.0)
    got = harness.fleet_metrics(8, 24, heartbeat_period=2.0, device="cpu")
    assert set(got) - set(ref) == {"device", "launches", "cluster_plans"}
    assert set(ref) <= set(got)
    for key in ("nodes", "replicas", "running", "heartbeat_period_s"):
        assert got[key] == ref[key]
    assert got["running"] == 24 and got["device"] == "cpu"
    # The CPU launches no kernel: its drains run the step loop.
    assert got["launches"] == {"scan_chunk": 0, "select_rows": 0,
                               "select_hosts": 0}
    assert got["cluster_plans"] == []


def test_fleet_metrics_raises_without_a_card_before_it_starts():
    from kubernetes_tpu_torch.perf import harness
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.fleet_metrics(4, 4)
    assert threading.active_count() == threads


@pytest.fixture()
def small_bench(monkeypatch):
    from kubernetes_tpu_torch.perf import harness
    for k, v in {"BENCH_NODES": "16", "BENCH_PODS": "48",
                 "BENCH_DENSITY_RUNS": "1", "BENCH_WIRE": "0",
                 "BENCH_JOINT": "0", "BENCH_WORKLOADS": "0",
                 "BENCH_SERVING": "0", "BENCH_SOAK": "0",
                 "BENCH_TENANCY": "0"}.items():
        monkeypatch.setenv(k, v)
    real = harness.fleet_metrics

    def small_fleet(device="cuda"):
        return real(4, 12, device=device)
    monkeypatch.setattr(harness, "fleet_metrics", small_fleet)


def test_the_bench_runs_the_fleet_phase(tmp_path, small_bench):
    from kubernetes_tpu_torch.perf import bench
    out = tmp_path / "BENCH_cpu.json"
    assert bench.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["failures"] == [] and "fleet" not in art["left_out"]
    fleet = art["fleet"]
    assert (fleet["nodes"], fleet["replicas"], fleet["running"]) == \
        (4, 12, 12)
    assert art["launches_by_path"]["fleet"] == fleet["launches"]


@pytest.mark.parametrize("fault", ["short", "raises"])
def test_a_failed_fleet_fails_the_bench(tmp_path, small_bench, monkeypatch,
                                        fault):
    from kubernetes_tpu_torch.perf import bench, harness

    def broken(device="cuda"):
        if fault == "raises":
            raise RuntimeError("the fleet fell over")
        return {"nodes": 4, "replicas": 12, "running": 3, "launches": {}}
    monkeypatch.setattr(harness, "fleet_metrics", broken)
    out = tmp_path / "BENCH_cpu.json"
    assert bench.main(["--device", "cpu", "--out", str(out)]) == 1
    failures = json.loads(out.read_text())["failures"]
    assert len(failures) == 1 and failures[0].startswith("fleet: ")

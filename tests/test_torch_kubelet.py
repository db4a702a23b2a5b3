"""The PyTorch port's hollow kubelet and hollow kube-proxy
(``kubernetes_tpu_torch.{kubelet,proxy}``) against the JAX package's, on
the CPU.

* Registration and the refresh of an existing Node: the same Node
  object on twin ``MemStore``s (heartbeat stamps aside).
* Admission: a seeded stream of pods bound to the node (cpu and memory
  requests up to past the node's capacity, host ports, node selectors, a
  pod bound elsewhere, deletions that free capacity, redelivered Running
  events, a simulated cpu usage) fed to both kubelets in
  the same order: the same verdicts (Running, or Failed with
  OutOfResources), the same status writes (phase, reason, the Ready
  condition, pod IPs from the node's /24 lease) and the same running
  set; a run duration flips a pod to Succeeded on both.
* The threaded kubelet (``run()``): its fielded watch and heartbeat loop
  run the same pods with the same IPs, and the heartbeats advance.
* The proxy: a seeded stream of Endpoints events gives the same backend
  tables and the same round-robin picks.
* The binaries: the same flags (``--help``), the same usage error, and
  the same Node registered over HTTP from the same flags; SIGTERM exits
  0."""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import pytest

from torch_plane import SIDES, hollow_node, mods, normalise, wait
from torch_wire import REPO, env, request, start_python_apiserver, stop

NODE = "hk-0"
HEARTBEAT = ("creationTimestamp", "lastHeartbeatTime")


def _pod_stream(seed: int, n: int = 40) -> list:
    """(op, obj) steps for one node: creates of pods bound to ``NODE``
    and deletes of earlier ones."""
    r = random.Random(seed)
    steps, live = [], []
    for i in range(n):
        if live and r.random() < 0.2:
            steps.append(("delete", live.pop(r.randrange(len(live)))))
            continue
        name = f"p{i}"
        req = {"cpu": f"{r.choice((100, 500, 1000, 2000, 3000))}m"}
        if r.random() < 0.5:
            req["memory"] = f"{r.choice((256, 1024, 8192))}Mi"
        ctr = {"name": "c", "resources": {"requests": req}}
        if r.random() < 0.25:
            ctr["ports"] = [{"containerPort": 80,
                             "hostPort": r.choice((8080, 8081))}]
        pod = {"metadata": {"name": name, "namespace": "default",
                            "annotations": {}},
               "spec": {"nodeName": NODE, "containers": [ctr]}}
        roll = r.random()
        if roll < 0.1:
            pod["spec"]["nodeSelector"] = {"zone": "nowhere"}
        elif roll < 0.2:
            pod["spec"]["nodeSelector"] = {"kubernetes.io/hostname": NODE}
        if r.random() < 0.15:
            pod["metadata"]["annotations"][
                "kubemark.kubernetes.io/cpu-usage"] = str(r.randint(1, 900))
        steps.append(("create", pod))
        live.append(name)
    return steps


def _kubelet(side: str, milli_cpu: int = 8000):
    m = mods(side)
    store = m.MemStore()
    node = hollow_node(m.api, NODE, milli_cpu=milli_cpu, memory_gib=16)
    return store, m.HollowKubelet(store, node, heartbeat_period=3600.0)


def test_registration_matches_the_reference():
    out = {}
    for side in SIDES:
        store, k = _kubelet(side)
        k._register()
        first = normalise(store.get("nodes", NODE), HEARTBEAT)
        # A second registration refreshes the existing Node's status.
        k._register()
        out[side] = (first, normalise(store.get("nodes", NODE), HEARTBEAT))
    assert out["ref"] == out["port"]
    ready = [c for c in out["port"][1]["status"]["conditions"]
             if c["type"] == "Ready"]
    assert [c["status"] for c in ready] == ["True"]


@pytest.mark.parametrize("seed", range(4))
def test_admission_and_status_writes_match_the_reference(seed):
    steps = _pod_stream(seed)
    out = {}
    for side in SIDES:
        store, k = _kubelet(side)
        k._register()
        trace = []
        for op, obj in steps:
            if op == "create":
                store.create("pods", obj)
                key = f"default/{obj['metadata']['name']}"
                k._on_pod("ADDED", store.get("pods", key))
                after = store.get("pods", key)
                # A redelivered Running event changes nothing.
                k._on_pod("MODIFIED", after)
                trace.append(normalise(store.get("pods", key)))
            else:
                key = f"default/{obj}"
                gone = store.get("pods", key)
                store.delete("pods", key)
                k._on_pod("DELETED", gone)
            trace.append(k.running_pods())
        k.stop()
        items = sorted(store.list("pods")[0],
                       key=lambda o: o["metadata"]["name"])
        out[side] = (trace, [normalise(o) for o in items],
                     k.running_pods())
    assert out["ref"] == out["port"]
    phases = {(o.get("status") or {}).get("phase") for o in out["port"][1]}
    assert "Failed" in phases and "Running" in phases
    reasons = {(o.get("status") or {}).get("reason")
               for o in out["port"][1]}
    assert "OutOfResources" in reasons


def test_overcommit_is_rejected_on_both():
    """The reference test's force-bound pod over the node's 8 CPUs."""
    out = {}
    for side in SIDES:
        store, k = _kubelet(side)
        store.create("pods", {
            "metadata": {"name": "fat", "namespace": "default"},
            "spec": {"nodeName": NODE, "containers": [{
                "name": "c", "resources": {"requests": {"cpu": "64"}}}]}})
        k._on_pod("ADDED", store.get("pods", "default/fat"))
        out[side] = normalise(store.get("pods", "default/fat"))
    assert out["ref"] == out["port"]
    assert out["port"]["status"] == {"phase": "Failed",
                                     "reason": "OutOfResources"}


def test_a_run_duration_completes_on_both():
    """A pod annotated with a run duration flips Running -> Succeeded on
    its timer (a Job pod on a real kubelet), and leaves the running set."""
    out = {}
    for side in SIDES:
        store, k = _kubelet(side)
        store.create("pods", {
            "metadata": {"name": "job", "namespace": "default",
                         "annotations": {
                             "kubemark.kubernetes.io/run-duration": "0.05"}},
            "spec": {"nodeName": NODE, "containers": [{"name": "c"}]}})
        k._on_pod("ADDED", store.get("pods", "default/job"))
        running = k.running_pods()
        wait(lambda: store.get("pods", "default/job")["status"]["phase"]
             == "Succeeded", timeout=10, msg="the pod Succeeded")
        k.stop()
        out[side] = (running, normalise(store.get("pods", "default/job")),
                     k.running_pods())
    assert out["ref"] == out["port"]
    assert out["port"][0] == ["default/job"] and out["port"][2] == []
    assert out["port"][1]["status"]["reason"] == "Completed"


def test_the_threaded_kubelet_matches_the_reference():
    out = {}
    for side in SIDES:
        m = mods(side)
        store = m.MemStore()
        k = m.HollowKubelet(store, hollow_node(m.api, NODE),
                            heartbeat_period=0.05).run()
        try:
            for i in range(6):
                store.create("pods", {
                    "metadata": {"name": f"w{i}", "namespace": "default"},
                    "spec": {"nodeName": NODE, "containers": [{
                        "name": "c",
                        "resources": {"requests": {"cpu": "1500m"}}}]}})
            wait(lambda: all((o.get("status") or {}).get("phase")
                             for o in store.list("pods")[0]),
                 msg="every pod admitted or rejected")
            beats = set()
            wait(lambda: beats.add(
                store.get("nodes", NODE)["status"]["conditions"][-1]
                ["lastHeartbeatTime"]) or len(beats) >= 3,
                period=0.02, msg="three heartbeats")
        finally:
            k.stop()
        out[side] = ([normalise(o) for o in sorted(
            store.list("pods")[0], key=lambda o: o["metadata"]["name"])],
            k.running_pods())
    assert out["ref"] == out["port"]
    assert len(out["port"][1]) == 5   # 5 x 1.5 CPU fit in 8; the 6th not


def _endpoint_stream(seed: int, n: int = 60) -> list:
    r = random.Random(seed)
    steps = []
    names = [("default", "a"), ("default", "b"), ("team", "a")]
    for _ in range(n):
        ns, name = r.choice(names)
        if r.random() < 0.15:
            steps.append(("DELETED", {"metadata": {"name": name,
                                                   "namespace": ns}}))
            continue
        subsets = []
        for _ in range(r.randint(0, 2)):
            subsets.append({"addresses": [
                {"ip": r.choice(("", f"10.0.{r.randint(0, 3)}."
                                     f"{r.randint(1, 9)}"))}
                for _ in range(r.randint(0, 4))]})
        steps.append((r.choice(("ADDED", "MODIFIED")),
                      {"metadata": {"name": name, "namespace": ns},
                       "subsets": subsets}))
    return steps


@pytest.mark.parametrize("seed", range(3))
def test_proxy_tables_and_picks_match_the_reference(seed):
    steps = _endpoint_stream(seed)
    picks = random.Random(seed + 100)
    resolves = [picks.randint(0, 4) for _ in steps]
    out = {}
    for side in SIDES:
        m = mods(side)
        proxy = m.HollowProxy(m.MemStore())
        trace = []
        for (etype, obj), n in zip(steps, resolves):
            proxy._on_endpoints(etype, obj)
            for ns, svc in (("default", "a"), ("default", "b"),
                            ("team", "a"), ("team", "b")):
                trace.append(proxy.backends(ns, svc))
                trace.append([proxy.resolve(ns, svc) for _ in range(n)])
        out[side] = trace
    assert out["ref"] == out["port"]


def test_the_proxy_follows_endpoints_through_its_reflector():
    out = {}
    for side in SIDES:
        m = mods(side)
        store = m.MemStore()
        store.create("endpoints", {
            "metadata": {"name": "s", "namespace": "default"},
            "subsets": [{"addresses": [{"ip": "10.1.0.2"},
                                       {"ip": "10.1.0.3"}]}]})
        proxy = m.HollowProxy(store).run()
        try:
            seen = [proxy.backends("default", "s")]
            ep = store.get("endpoints", "default/s")
            ep["subsets"][0]["addresses"].append({"ip": "10.1.0.4"})
            store.update("endpoints", ep)
            wait(lambda: len(proxy.backends("default", "s")) == 3,
                 msg="the proxy's reflector delivers the update")
            seen.append([proxy.resolve("default", "s") for _ in range(4)])
            store.delete("endpoints", "default/s")
            wait(lambda: proxy.resolve("default", "s") is None,
                 msg="the proxy drops the deleted endpoints")
        finally:
            proxy.stop()
        out[side] = seen
    assert out["ref"] == out["port"]


# -- the binaries ----------------------------------------------------------

BINARIES = {"ref": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}


def _run(args: list, timeout: float = 60.0) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env(),
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("binary", ["kubelet", "proxy"])
def test_the_binaries_take_the_reference_flags(binary):
    helps, errors = {}, {}
    for side, pkg in BINARIES.items():
        out = _run([f"{pkg}.{binary}", "--help"])
        assert out.returncode == 0, out.stderr[-2000:]
        # The program names differ in length, so argparse wraps the
        # texts differently: compare their words.
        helps[side] = out.stdout.replace(pkg, "<pkg>").split()
        bad = _run([f"{pkg}.{binary}"])
        assert bad.returncode == 2
        errors[side] = bad.stderr.replace(pkg, "<pkg>").split()
    assert helps["ref"] == helps["port"]
    assert errors["ref"] == errors["port"]
    assert "--api-server" in helps["port"]
    assert "--client-certificate" in helps["port"]


def test_the_kubelet_binary_registers_as_the_reference():
    """The same flags register the same Node over HTTP (the port's Python
    apiserver); SIGTERM exits 0 on both."""
    flags = ["--node-name", "bin-0", "--cpu", "6000", "--memory-gib", "12",
             "--pods", "30", "--label", "zone=z1", "--label", "tier=gpu",
             "--heartbeat-period", "0.2", "--kube-api-token", "tok"]
    api, base = start_python_apiserver()
    nodes = {}
    try:
        for side, pkg in BINARIES.items():
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.kubelet", "--api-server",
                 base, *flags], cwd=REPO, env=env(),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)
            try:
                def registered():
                    status, _, body = request(base, "GET",
                                              "/api/v1/nodes/bin-0")
                    return status == 200
                wait(registered, timeout=60, msg=f"{side} kubelet Node")
                time.sleep(0.5)  # a few heartbeats
                _, _, body = request(base, "GET", "/api/v1/nodes/bin-0")
            finally:
                assert stop(proc) == 0
            obj = json.loads(body)
            obj["metadata"].pop("resourceVersion", None)
            obj["metadata"].pop("uid", None)
            nodes[side] = normalise(obj, HEARTBEAT)
            assert request(base, "DELETE", "/api/v1/nodes/bin-0")[0] == 200
    finally:
        stop(api)
    assert nodes["ref"] == nodes["port"]
    assert nodes["port"]["metadata"]["labels"] == {
        "kubernetes.io/hostname": "bin-0", "zone": "z1", "tier": "gpu"}

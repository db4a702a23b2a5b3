"""The PyTorch port's kubectl (``kubernetes_tpu_torch.kubectl``) against
the JAX package's, on the CPU.

Each side runs its own package's Python apiserver (``serve`` in a
thread) over its own ``MemStore``, and the same script of kubectl
invocations goes through each package's ``main(argv, out)``: every verb
(``get``, ``describe``, ``create``, ``apply``, ``delete``, ``scale``,
``label``, ``annotate``, ``expose``, ``rollout``, ``cordon``,
``uncordon``, ``drain``, ``explain``) on the reference's
``tests/test_kubectl.py`` cases and around them.  Both give the same
exit codes, the same standard output and error (the server's address,
the package's name, the script's folder, trace ids and the creation
stamps that ``describe`` and ``-o json`` print masked; the printers
have no AGE column), and leave the same objects in their stores
(creation stamps aside).  Also
``three_way_merge`` on the reference's cases, a drain under a
PodDisruptionBudget (429, then granted as the disruption controller
reopens the budget) and ``explain`` against the flight recorder of the
port's daemon on the CPU."""

from __future__ import annotations

import contextlib
import functools
import io
import json
import random
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from torch_plane import SIDES, PACKAGES, Pump, module, snapshot, wait

KINDS = ("pods", "nodes", "services", "replicationcontrollers",
         "replicasets", "deployments", "namespaces", "events",
         "poddisruptionbudgets")
WALL = ("creationTimestamp", "deletionTimestamp")


def _mask(text: str, side: str) -> str:
    text = re.sub(r"127\.0\.0\.1:\d+", "<server>", text)
    text = re.sub(r'"(creationTimestamp|deletionTimestamp)": "[^"]*"',
                  r'"\1": "<wall clock>"', text)
    text = re.sub(r'(Trace:\t|"trace_id": ")[0-9a-f]{32}', r"\1<trace id>",
                  text)
    return text.replace(PACKAGES[side], "<pkg>")


class Rig:
    """One side: its package's apiserver over a fresh store."""

    def __init__(self, side: str, tmp_path):
        self.side = side
        self.store = module(side, "apiserver.memstore").MemStore()
        self.srv = module(side, "apiserver.server").serve(self.store,
                                                          port=0)
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.dir = tmp_path / side
        self.dir.mkdir()
        self.main = module(side, "kubectl.__main__").main
        self.ctls: list = []

    def kubectl(self, *argv: str, server: bool = True) -> tuple:
        out, err = io.StringIO(), io.StringIO()
        args = (["--server", self.base] if server else []) + list(argv)
        args = [a.replace("{dir}", str(self.dir)) for a in args]
        with contextlib.redirect_stderr(err):
            try:
                rc = self.main(args, out=out)
            except SystemExit as exit_:
                rc = f"SystemExit({exit_.code})"
            except Exception as exc:  # noqa: BLE001 — both raise alike
                rc = _mask(f"{type(exc).__name__}: {exc}", self.side)
        # The program names differ in length, so argparse wraps its
        # usage differently: compare the error's words.
        err = err.getvalue().replace(str(self.dir), "{dir}")
        return (rc, _mask(out.getvalue(), self.side),
                " ".join(_mask(err, self.side).split()))

    def file(self, name: str, body) -> None:
        text = body if isinstance(body, str) else json.dumps(body)
        (self.dir / name).write_text(text)

    def snap(self) -> dict:
        snap = snapshot(self.store, KINDS, wall=WALL)
        snap.pop("rv")
        return snap

    def stop(self) -> None:
        for c in self.ctls:
            c.stop()
        self.srv.shutdown()


def run_script(tmp_path, script) -> list:
    """``script(rig)`` on each side; returns the port's record after
    asserting it equals the reference's."""
    out = {}
    for side in SIDES:
        rig = Rig(side, tmp_path)
        try:
            out[side] = script(rig) + [rig.snap()]
        finally:
            rig.stop()
    assert out["ref"] == out["port"]
    return out["port"]


def _node(name, ready=True):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": "4", "memory": "16Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True" if ready
                                       else "False"}]}}


def _pod(name, node="", labels=None, phase="", ready=False):
    d = {"metadata": {"name": name, "namespace": "default",
                      "labels": dict(labels or {})},
         "spec": {"containers": [{"name": "c", "resources": {
             "requests": {"cpu": "100m"}}}]}}
    if node:
        d["spec"]["nodeName"] = node
    if phase:
        d["status"] = {"phase": phase}
        if ready:
            d["status"]["conditions"] = [{"type": "Ready",
                                          "status": "True"}]
    return d


def _rc(name="web", replicas=2):
    return {"kind": "ReplicationController",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"run": name},
                     "template": {"metadata": {"labels": {"run": name}},
                                  "spec": {"containers": [{"name": "c"}]}}}}


YAML = """
kind: Node
metadata:
  name: yn-1
status:
  allocatable: {cpu: "4", memory: 16Gi, pods: "110"}
  conditions: [{type: Ready, status: "True"}]
---
kind: Pod
metadata: {name: yp-1, namespace: default}
spec:
  containers:
  - name: c
    resources: {requests: {cpu: 100m}}
"""


def s_get(r):
    r.store.create("nodes", _node("n1"))
    r.store.create("nodes", _node("n2", ready=False))
    r.store.create("pods", _pod("p1", node="n1", labels={"tier": "web"}))
    r.store.create("pods", _pod("p2"))
    r.store.create("pods", {**_pod("p3"), "status": {"conditions": [
        {"type": "PodScheduled", "status": "False"}]}})
    return [r.kubectl("get", "no"), r.kubectl("get", "po"),
            r.kubectl("get", "pods", "-o", "wide"),
            r.kubectl("get", "pods", "p1", "-o", "json"),
            r.kubectl("get", "nodes", "n2"),
            r.kubectl("get", "pods", "missing"),
            r.kubectl("get", "pods", "-n", "other"),
            r.kubectl("get", "bogus"),
            r.kubectl("get", "rc")]


def s_create_delete(r):
    r.file("objs.yaml", YAML)
    r.file("bad.json", {"kind": "Pod", "metadata": {"name": "Bad Name!"},
                        "spec": {"containers": [{"name": "c"}]}})
    r.file("odd.json", [{"kind": "Widget", "metadata": {"name": "w"}},
                        {"kind": "Service", "metadata": {
                            "name": "s", "namespace": "default"},
                         "spec": {"selector": {"a": "b"}}}])
    return [r.kubectl("create", "-f", "{dir}/objs.yaml"),
            r.kubectl("create", "-f", "{dir}/objs.yaml"),
            r.kubectl("delete", "pods", "yp-1"),
            r.kubectl("delete", "pods", "yp-1"),
            r.kubectl("create", "-f", "{dir}/bad.json"),
            r.kubectl("create", "-f", "{dir}/odd.json"),
            r.kubectl("delete", "no", "yn-1")]


def s_cordon_describe(r):
    r.store.create("nodes", _node("cn-1"))
    r.store.create("pods", _pod("dp-1"))
    r.store.create("events", {
        "metadata": {"name": "dp-1.1", "namespace": "default"},
        "involvedObject": {"kind": "Pod", "namespace": "default",
                           "name": "dp-1"},
        "type": "Warning", "reason": "FailedScheduling",
        "message": "no nodes"})
    return [r.kubectl("cordon", "cn-1"), r.kubectl("get", "nodes"),
            r.kubectl("uncordon", "cn-1"), r.kubectl("cordon", "nope"),
            r.kubectl("describe", "pod", "dp-1"),
            r.kubectl("describe", "node", "cn-1"),
            r.kubectl("describe", "pod", "missing"),
            r.kubectl("get", "events")]


def s_drain(r):
    r.store.create("nodes", _node("n1"))
    r.store.create("nodes", _node("n2"))
    r.store.create("nodes", _node("n3"))
    r.store.create("replicationcontrollers", _rc())
    for name, node in (("web-a", "n1"), ("web-b", "n1"), ("web-c", "n2")):
        r.store.create("pods", _pod(name, node=node,
                                    labels={"run": "web"}))
    r.store.create("pods", _pod("naked", node="n2"))
    r.store.create("pods", _pod("logd-abc", node="n3",
                                labels={"daemonset-name": "logd"}))
    return [r.kubectl("drain", "n1"), r.kubectl("drain", "n2"),
            r.kubectl("drain", "n2", "--force"),
            r.kubectl("drain", "n3"),
            r.kubectl("drain", "n3", "--ignore-daemonsets"),
            r.kubectl("drain", "n1"), r.kubectl("drain", "nope")]


def s_apply(r):
    manifest = {"kind": "ReplicationController",
                "metadata": {"name": "web", "namespace": "default"},
                "spec": {"selector": {"run": "web"},
                         "template": {
                             "metadata": {"labels": {"run": "web"}},
                             "spec": {"containers": [
                                 {"name": "c", "image": "app:v1"}]}}}}
    out = []
    r.file("rc.json", manifest)
    out.append(r.kubectl("apply", "-f", "{dir}/rc.json"))
    out.append(r.kubectl("scale", "rc", "web", "--replicas", "7"))
    manifest["spec"]["template"]["spec"]["containers"][0]["image"] = \
        "app:v2"
    r.file("rc.json", manifest)
    out.append(r.kubectl("apply", "-f", "{dir}/rc.json"))
    pod = {"kind": "Pod",
           "metadata": {"name": "p", "namespace": "default",
                        "labels": {"tier": "web", "canary": "yes"}},
           "spec": {"containers": [{"name": "c"}],
                    "nodeSelector": {"disk": "ssd"}}}
    r.file("pod.json", pod)
    out.append(r.kubectl("apply", "-f", "{dir}/pod.json"))
    del pod["metadata"]["labels"]["canary"]
    del pod["spec"]["nodeSelector"]
    r.file("pod.json", pod)
    out.append(r.kubectl("apply", "-f", "{dir}/pod.json"))
    r.file("all.json", {"kind": "List", "items": [
        {"kind": "Namespace", "metadata": {"name": "team-z"}},
        {"kind": "Pod", "metadata": {"name": "p", "namespace": "team-z"},
         "spec": {"containers": [{"name": "c"}]}},
        {"kind": "Gadget", "metadata": {"name": "g"}}]})
    out.append(r.kubectl("apply", "-f", "{dir}/all.json"))
    out.append(r.kubectl("apply", "-f", "{dir}/all.json"))
    return out


def s_label_annotate_expose(r):
    r.store.create("pods", _pod("p1"))
    r.store.create("nodes", _node("n1"))
    r.store.create("replicationcontrollers", _rc())
    r.store.create("deployments", {
        "metadata": {"name": "api", "namespace": "default"},
        "spec": {"replicas": 1,
                 "selector": {"matchLabels": {"run": "api"}}}})
    r.store.create("replicasets", {
        "metadata": {"name": "expr", "namespace": "default"},
        "spec": {"replicas": 1, "selector": {"matchExpressions": [
            {"key": "run", "operator": "Exists"}]}}})
    return [r.kubectl("label", "po", "p1", "tier=web"),
            r.kubectl("label", "po", "p1", "tier=db"),
            r.kubectl("label", "po", "p1", "tier=db", "--overwrite"),
            r.kubectl("label", "po", "p1", "tier-"),
            r.kubectl("label", "po", "p1", "novalue"),
            r.kubectl("label", "po", "ghost", "a=b"),
            r.kubectl("annotate", "no", "n1", "team=infra"),
            r.kubectl("annotate", "no", "n1", "team=x"),
            r.kubectl("expose", "rc", "web", "--port", "80",
                      "--target-port", "8080"),
            r.kubectl("expose", "deploy", "api", "--port", "443",
                      "--service-name", "api-svc"),
            r.kubectl("expose", "rs", "expr", "--port", "1"),
            r.kubectl("expose", "po", "p1", "--port", "1"),
            r.kubectl("expose", "rc", "web", "--port", "80"),
            r.kubectl("scale", "po", "p1", "--replicas", "2"),
            r.kubectl("scale", "rc", "ghost", "--replicas", "2")]


def s_usage(r):
    return [r.kubectl(server=False), r.kubectl("frobnicate"),
            r.kubectl("get"), r.kubectl("drain", "--timeout", "x", "n1"),
            r.kubectl("explain", "svc", "x")]


SCRIPTS = {"get": s_get, "create_delete": s_create_delete,
           "cordon_describe": s_cordon_describe, "drain": s_drain,
           "apply": s_apply, "label_annotate_expose": s_label_annotate_expose,
           "usage": s_usage}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_verbs_match_the_reference(case, tmp_path):
    rec = run_script(tmp_path, SCRIPTS[case])
    codes = [x[0] for x in rec[:-1]]
    store = rec[-1]
    if case == "get":
        assert codes == [0, 0, 0, 0, 0, 1, 0, "SystemExit(error: unknown "
                         'resource type "bogus")', 0]
        assert "NotReady" in rec[0][1] and "cpu=100m" in rec[2][1]
        assert "Pending(Unschedulable)" in rec[1][1]
    elif case == "create_delete":
        assert codes == [0, 'ConflictError: {"error": "nodes yn-1 already '
                         'exists"}', 0, 1, 1, 1, 0]
        assert "node/yn-1 created" in rec[0][1]
        assert [p["metadata"]["name"] for p in store["services"]] == ["s"]
    elif case == "cordon_describe":
        assert codes == [0, 0, 0, 1, 0, 0, 1, 0]
        assert "SchedulingDisabled" in rec[1][1]
        assert "FailedScheduling" in rec[4][1]
    elif case == "drain":
        assert codes == [0, 1, 0, 1, 0, 0, 1]
        assert [p["metadata"]["name"] for p in store["pods"]] == [
            "logd-abc"]
    elif case == "apply":
        assert codes == [0, 0, 0, 0, 0, 1, 1]
        rc = store["replicationcontrollers"][0]
        assert rc["spec"]["replicas"] == 7
        assert rc["spec"]["template"]["spec"]["containers"][0][
            "image"] == "app:v2"
        pod = next(p for p in store["pods"]
                   if p["metadata"]["namespace"] == "default")
        assert pod["metadata"]["labels"] == {"tier": "web"}
        assert "nodeSelector" not in pod["spec"]
    elif case == "label_annotate_expose":
        assert codes[:12] == [0, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1]
        assert codes[12].startswith("ConflictError") and codes[13:] == [1, 1]
        assert [s["spec"]["selector"] for s in store["services"]] == [
            {"run": "api"}, {"run": "web"}]
    elif case == "usage":
        assert codes == ["SystemExit(2)"] * 4 + [1]


@pytest.mark.parametrize("last,new,live", [
    ({}, {"spec": {"replicas": 2}}, {}),
    ({"spec": {"replicas": 2}}, {"spec": {}},
     {"spec": {"replicas": 7}, "status": {"x": 1}}),
    ({"spec": {"template": {"image": "v1"}}},
     {"spec": {"template": {"image": "v2"}}},
     {"spec": {"replicas": 7, "template": {"image": "v1", "x": 1}}}),
    ({"metadata": {"labels": {"a": "1", "b": "2"}}, "spec": {"s": 1}},
     {"metadata": {"labels": {"a": "1"}}},
     {"metadata": {"labels": {"a": "1", "b": "2"}, "uid": "u"},
      "spec": {"s": 1, "t": 2}}),
    ({"metadata": {"name": "x"}, "extra": 1}, {"kind": "Pod"},
     {"metadata": {"name": "x", "resourceVersion": "3"}, "extra": 1}),
    ({"spec": {"containers": [{"name": "a"}]}},
     {"spec": {"containers": [{"name": "b"}]}},
     {"spec": {"containers": [{"name": "a", "image": "i"}]}}),
    ({"spec": {"template": {"metadata": {"labels": {"x": "1"}}}}},
     {"spec": {"template": {}}},
     {"spec": {"template": {"metadata": {"labels": {"x": "1"}}}}}),
])
def test_three_way_merge_matches_the_reference(last, new, live):
    merged = {side: module(side, "kubectl.__main__").three_way_merge(
        json.loads(json.dumps(last)), json.loads(json.dumps(new)),
        json.loads(json.dumps(live))) for side in SIDES}
    assert merged["ref"] == merged["port"]


def _deployment(name="cli", replicas=2):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"app": name}},
                     "strategy": {"type": "RollingUpdate",
                                  "rollingUpdate": {"maxSurge": 1,
                                                    "maxUnavailable": 1}},
                     "template": {
                         "metadata": {"labels": {"app": name,
                                                 "version": "v1"}},
                         "spec": {"containers": [{"name": "app"}]}}}}


class Controllers:
    """The deployment controller and the replication manager of the
    rig's package, stepped by hand; the kubelet's part is played by
    setting every pending pod Running."""

    def __init__(self, r):
        self.r = r
        self.dc = module(r.side, "controller.deployment"
                         ).DeploymentController(r.store)
        self.rm = module(r.side, "controller.replication"
                         ).ReplicationManager(r.store)
        self.rm._rand = random.Random(3)
        self.pumps = [
            Pump(r.store, {"deployments": self.dc._on_deployment,
                           "replicasets": self.dc._on_rs,
                           "pods": self.dc._on_pod}),
            Pump(r.store, {"replicasets": functools.partial(
                self.rm._on_rc, "replicasets"), "pods": self.rm._on_pod})]

    def step(self, n: int = 6) -> None:
        for _ in range(n):
            for p in self.pumps:
                p.drain()
            self.dc.sync_all()
            for p in self.pumps:
                p.drain()
            self.rm.sync_all()
            for o in sorted(self.r.store.list("pods")[0],
                            key=lambda o: o["metadata"]["name"]):
                if not (o.get("status") or {}).get("phase"):
                    o["status"] = {"phase": "Running"}
                    self.r.store.update("pods", o)


def s_rollout(r):
    c = Controllers(r)
    r.store.create("deployments", _deployment())
    out = [r.kubectl("rollout", "status", "deploy", "cli",
                     "--timeout", "0.2")]
    c.step()
    out.append(r.kubectl("rollout", "status", "deployments", "cli"))
    out.append(r.kubectl("scale", "deploy", "cli", "--replicas", "4"))
    c.step()
    dep = r.store.get("deployments", "default/cli")
    dep["spec"]["template"]["metadata"]["labels"]["version"] = "v2"
    r.store.update("deployments", dep)
    c.step()
    out.append(r.kubectl("rollout", "status", "deploy", "cli"))
    out.append(r.kubectl("rollout", "history", "deploy", "cli"))
    out.append(r.kubectl("rollout", "undo", "deploy", "cli"))
    c.step()
    out.append(r.kubectl("rollout", "history", "deploy", "cli"))
    out.append(r.kubectl("rollout", "undo", "deploy", "cli",
                         "--to-revision", "2"))
    c.step()
    out += [r.kubectl("rollout", "status", "deploy", "cli"),
            r.kubectl("rollout", "status", "rc", "cli"),
            r.kubectl("rollout", "undo", "deploy", "ghost"),
            r.kubectl("rollout", "status", "deploy", "ghost")]
    return out


def test_scale_and_rollout_match_the_reference(tmp_path):
    rec = run_script(tmp_path, s_rollout)
    assert [x[0] for x in rec[:-1]] == [1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1]
    assert "Waiting for rollout" in rec[0][1]
    assert "successfully rolled out" in rec[1][1]
    v1 = module("ref", "controller.deployment").template_hash(
        _deployment()["spec"]["template"])
    history = rec[4][1].split()
    assert history[:4] == ["REVISION", "REPLICASET", "1", f"cli-{v1}"]
    assert history[4] == "2" and len(history) == 6
    pods = rec[-1]["pods"]
    assert len(pods) == 4 and {p["metadata"]["labels"]["version"]
                               for p in pods} == {"v2"}


def s_pdb_drain(r):
    """The budget blocks: a direct eviction is 429 and the drain gives up
    at its timeout, the node cordoned; the budget opens and the threaded
    disruption controller reopens it after each spent eviction, so the
    drain finishes."""
    client = module(r.side, "client.http").APIClient(r.base, qps=0)
    api_error = module(r.side, "client.http").APIError
    r.store.create("nodes", _node("n1"))
    r.store.create("replicationcontrollers", _rc())
    for i in range(2):
        r.store.create("pods", _pod(f"w{i}", node="n1",
                                    labels={"run": "web"},
                                    phase="Running", ready=True))
    r.store.create("poddisruptionbudgets", {
        "metadata": {"name": "web-pdb", "namespace": "default"},
        "spec": {"minAvailable": 2, "selector": {"run": "web"}},
        "status": {"disruptionAllowed": False, "currentHealthy": 2,
                   "desiredHealthy": 2, "expectedPods": 2}})
    try:
        client.evict("default", "w0")
        direct = "evicted"
    except api_error as err:
        direct = err.status
    out = [direct, r.kubectl("drain", "n1", "--timeout", "0.5"),
           sorted(o["metadata"]["name"] for o in r.store.list("pods")[0])]
    pdb = r.store.get("poddisruptionbudgets", "default/web-pdb")
    pdb["spec"]["minAvailable"] = 0
    pdb["status"]["disruptionAllowed"] = True
    r.store.update("poddisruptionbudgets", pdb)
    dc = module(r.side, "controller.disruption").DisruptionController(
        r.store, sync_period=0.05)
    r.ctls.append(dc.run())
    out.append(r.kubectl("drain", "n1", "--timeout", "30"))
    wait(lambda: not r.store.list("pods")[0], 30, msg="drained pods")
    dc.stop()
    r.ctls.remove(dc)
    # The controller's last writes race the end of the drain: compare
    # the budget's spec, not its live status.
    pdb = r.store.get("poddisruptionbudgets", "default/web-pdb")
    r.store.delete("poddisruptionbudgets", "default/web-pdb")
    out.append(pdb["spec"])
    return out


def test_drain_under_a_disruption_budget_matches_the_reference(tmp_path):
    rec = run_script(tmp_path, s_pdb_drain)
    assert rec[0] == 429
    assert rec[1][0] == 1 and "NOT fully drained" in rec[1][1]
    assert rec[2] == ["w0", "w1"]
    assert rec[3][0] == 0 and "node/n1 drained" in rec[3][1]
    assert rec[-1]["nodes"][0]["spec"]["unschedulable"] is True


DECISIONS = {
    "default/placed": {"pod": "default/placed", "result": "scheduled",
                       "node": "n-3", "trace_id": "abc"},
    "default/stuck": {"pod": "default/stuck", "result": "unschedulable",
                      "message": "0/4 nodes are available",
                      "failed_predicates": {"PodFitsResources": 3,
                                            "MatchNodeSelector": 1},
                      "top_scores": [{"node": "n-1", "score": 7.5},
                                     {"node": "n-2", "score": 3.0}]},
    "team/prio": {"pod": "team/prio", "result": "scheduled",
                  "node": "n-0", "nominated_node": "n-0",
                  "preempted_victims": ["team/v1", "team/v2"]},
}


class _Recorder(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        pod = self.path.partition("pod=")[2]
        body = DECISIONS.get(pod)
        code = 200 if body is not None else 404
        data = json.dumps(body or {"error": "no recorded decision"}
                          ).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_explain_matches_the_reference(tmp_path):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    sched = f"http://127.0.0.1:{srv.server_address[1]}"
    with socket_closed() as dead:
        def script(r):
            return [r.kubectl("explain", "pod", "placed", "--scheduler",
                              sched),
                    r.kubectl("explain", "pod", "stuck", "--scheduler",
                              sched),
                    r.kubectl("explain", "po", "team/prio", "--scheduler",
                              sched),
                    r.kubectl("explain", "pod", "prio", "-n", "team",
                              "-o", "json", "--scheduler", sched),
                    r.kubectl("explain", "pod", "ghost", "--scheduler",
                              sched),
                    r.kubectl("explain", "pod", "x", "--scheduler", dead)]
        try:
            rec = run_script(tmp_path, script)
        finally:
            srv.shutdown()
    assert [x[0] for x in rec[:-1]] == [0, 0, 0, 0, 1, 1]
    assert "Node:\tn-3" in rec[0][1]
    assert "PodFitsResources\t3" in rec[1][1]
    assert "Preempted victims:\tteam/v1, team/v2" in rec[2][1]


@contextlib.contextmanager
def socket_closed():
    """A URL on which nothing listens."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{s.getsockname()[1]}"
    yield url


def test_explain_reads_the_port_daemons_flight_recorder(tmp_path):
    """A daemon of the port on the CPU places one pod and finds no node
    for another; both packages' kubectl explain them alike from its
    status mux."""
    api = module("port", "api.types")
    store = module("port", "apiserver.memstore").MemStore()
    store.create("nodes", api.node_to_json(api.Node(
        name="en-0", labels={api.HOSTNAME_LABEL: "en-0"},
        allocatable_milli_cpu=2000, allocatable_memory=4 * 1024 ** 3,
        allocatable_pods=110,
        conditions=[api.NodeCondition("Ready", "True")])))
    store.create("pods", _pod("fits"))
    huge = _pod("huge")
    huge["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "64"
    store.create("pods", huge)
    factory = module("port", "scheduler.factory").ConfigFactory(
        store, device="cpu").run()
    mux = module("port", "scheduler.__main__").status_mux(factory, {}, 0)
    sched = f"http://127.0.0.1:{mux.server_address[1]}"
    try:
        wait(lambda: (store.get("pods", "default/fits")["spec"]
                      .get("nodeName")), 60, msg="the pod bound")
        recorder = factory.daemon.config.flight_recorder
        wait(lambda: recorder.explain("default/huge") is not None, 60,
             msg="the unschedulable pod recorded")

        def script(r):
            return [r.kubectl("explain", "pod", "fits", "--scheduler",
                              sched),
                    r.kubectl("explain", "pod", "huge", "--scheduler",
                              sched)]
        rec = run_script(tmp_path, script)
    finally:
        mux.shutdown()
        factory.stop()
    assert rec[0][0] == 0 and "Node:\ten-0" in rec[0][1]
    assert rec[1][0] == 0 and "PodFitsResources" in rec[1][1]

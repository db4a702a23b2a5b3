"""The PyTorch port's controller-manager (``python -m
kubernetes_tpu_torch.controller``) against the JAX package's, on the CPU.

* The binary takes the reference binary's flags: the same ``--help``
  text and the same usage errors (the package's name aside).
* Two controller-managers under leader election, as the reference's
  ``tests/test_cm_leader_election.py`` runs them (elector-gated
  replication managers over the HTTP apiserver): one actor only, an RC
  of 3 yields exactly 3 pods, and killing the leader hands the lease to
  the standby, which replaces a deleted replica.  Each package runs the
  story on its own apiserver; both observe the same sequence.
* A 3-kubelet plane of the port's binaries: its Python apiserver, its
  daemon on the CPU and its controller-manager under ``--leader-elect``,
  with three hollow kubelets: a Deployment applied by the port's kubectl
  rolls out to Running in a ReplicaSet named by the reference's template
  hash, and the reference's round-5 wire story (a PetSet's pets in
  order, a ScheduledJob's Job run to completion, the Job reaped by the
  garbage collector once its owner is deleted) holds."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from torch_plane import PACKAGES, SIDES, module, wait
from torch_wire import REPO, env, start_python_apiserver, stop


def _run(args: list, timeout: float = 60.0) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env(),
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("argv", [["--help"], [], ["--api-server", "x",
                                                   "--port", "ten"]])
def test_the_binary_takes_the_reference_flags(argv):
    got = {}
    for side, pkg in PACKAGES.items():
        out = _run([f"{pkg}.controller", *argv])
        # The program names differ in length, so argparse wraps the
        # texts differently (and may break a word at a hyphen): compare
        # them without their whitespace.
        got[side] = (out.returncode,
                     "".join(out.stdout.replace(pkg, "<pkg>").split()),
                     "".join(out.stderr.replace(pkg, "<pkg>").split()))
    assert got["ref"] == got["port"]
    if argv == ["--help"]:
        text = got["port"][1]
        for flag in ("--leader-elect", "--kube-api-token",
                     "--terminated-pod-gc-threshold", "--port",
                     "--client-certificate", "--leader-elect-retry-period"):
            assert flag in text
    else:
        assert got["port"][0] == 2


class _Replica:
    """One controller-manager candidate: elector-gated loops, the shape
    ``controller/__main__.py`` runs."""

    def __init__(self, side: str, base: str, identity: str):
        le = module(side, "utils.leaderelection")
        self.side, self.base = side, base
        self.controllers: list = []
        self.elector = le.LeaderElector(
            lock=le.APIResourceLock(
                module(side, "client.http").APIClient(base, qps=0),
                name="kube-controller-manager"),
            identity=identity,
            lease_duration=1.5, renew_deadline=1.0, retry_period=0.25,
            on_started_leading=self._start,
            on_stopped_leading=lambda: None)

    def _start(self) -> None:
        self.controllers.append(module(
            self.side, "controller.replication").ReplicationManager(
            self.base, sync_period=0.2).run())

    def run(self):
        self.elector.run()
        return self

    def is_leader(self) -> bool:
        return self.elector.is_leader() and bool(self.controllers)

    def kill(self) -> None:
        self.elector.stop()
        for c in self.controllers:
            c.stop()


def _election(side: str) -> list:
    store = module(side, "apiserver.memstore").MemStore()
    server = module(side, "apiserver.server").serve(store)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    a = _Replica(side, base, "cm-a").run()
    b = _Replica(side, base, "cm-b").run()

    def pods():
        return [o for o in store.list("pods")[0]
                if ((o.get("metadata") or {}).get("labels") or {})
                .get("run") == "ha-rc"]
    out = []
    try:
        wait(lambda: a.is_leader() or b.is_leader(), 30, msg="a leader")
        leader, standby = (a, b) if a.is_leader() else (b, a)
        out.append(("standby idle", not standby.controllers))
        store.create("replicationcontrollers", {
            "metadata": {"name": "ha-rc", "namespace": "default"},
            "spec": {"replicas": 3, "selector": {"run": "ha-rc"},
                     "template": {"metadata": {"labels": {"run": "ha-rc"}},
                                  "spec": {"containers": [{"name": "c"}]}}}})
        wait(lambda: len(pods()) == 3, 30, msg="3 replicas")
        time.sleep(1.5)       # several sync periods with both alive
        out.append(("replicas with both alive", len(pods())))
        leader.kill()
        wait(standby.is_leader, 10, msg="the standby takes the lease")
        holder = json.loads(store.get("endpoints", "kube-system/"
                                      "kube-controller-manager")
                            ["metadata"]["annotations"][
                                "control-plane.alpha.kubernetes.io/leader"])
        out.append(("lease holder is the standby", holder[
            "holderIdentity"] == standby.elector.identity))
        victim = pods()[0]["metadata"]["name"]
        store.delete("pods", f"default/{victim}")
        wait(lambda: len(pods()) == 3 and victim not in
             [p["metadata"]["name"] for p in pods()], 30,
             msg="the standby replaces the deleted replica")
        time.sleep(0.6)
        out.append(("replicas after failover", len(pods())))
    finally:
        a.kill()
        b.kill()
        server.shutdown()
    return out


def test_leader_election_single_actor_and_failover_match_the_reference():
    with ThreadPoolExecutor(2) as pool:
        got = dict(zip(SIDES, pool.map(_election, SIDES)))
    assert got["ref"] == got["port"]
    assert got["port"] == [("standby idle", True),
                           ("replicas with both alive", 3),
                           ("lease holder is the standby", True),
                           ("replicas after failover", 3)]


def _deployment() -> dict:
    return {"kind": "Deployment",
            "metadata": {"name": "web", "namespace": "default"},
            "spec": {"replicas": 3,
                     "selector": {"matchLabels": {"app": "web"}},
                     "template": {
                         "metadata": {"labels": {"app": "web"}},
                         "spec": {"containers": [{
                             "name": "c", "resources": {
                                 "requests": {"cpu": "100m"}}}]}}}}


def test_a_three_kubelet_plane_of_the_port_runs_a_deployment(tmp_path):
    api = module("port", "api.types")
    http = module("port", "client.http")
    kubelet_mod = module("port", "kubelet.kubelet")
    kubectl = module("port", "kubectl.__main__").main
    api_proc, base = start_python_apiserver()
    procs, kubelets = [], []
    try:
        sched = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
             "--api-server", base, "--device", "cpu", "--port", "0",
             "--kube-api-qps", "1000", "--kube-api-burst", "1000"],
            cwd=REPO, env=env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        procs.append(sched)
        cm = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.controller",
             "--api-server", base, "--port", "-1", "--leader-elect",
             "--leader-elect-lease-duration", "2.0",
             "--leader-elect-renew-deadline", "1.5",
             "--leader-elect-retry-period", "0.3"],
            cwd=REPO, env=env(), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        procs.append(cm)
        client = http.APIClient(base, qps=1000, burst=1000)
        for i in range(3):
            node = api.Node(
                name=f"cm-{i}", labels={api.HOSTNAME_LABEL: f"cm-{i}"},
                allocatable_milli_cpu=8000,
                allocatable_memory=32 * 1024 ** 3, allocatable_pods=110,
                conditions=[api.NodeCondition("Ready", "True")])
            kubelets.append(kubelet_mod.HollowKubelet(
                http.APIClient(base, qps=1000, burst=1000), node,
                heartbeat_period=0.4).run())

        manifest = tmp_path / "web.json"
        manifest.write_text(json.dumps(_deployment()))
        out = io.StringIO()
        assert kubectl(["--server", base, "apply", "-f", str(manifest)],
                       out=out) == 0
        out = io.StringIO()
        assert kubectl(["--server", base, "rollout", "status", "deploy",
                        "web", "--timeout", "90"], out=out) == 0, \
            out.getvalue()[-2000:]
        thash = module("ref", "controller.deployment").template_hash(
            _deployment()["spec"]["template"])
        rss = [r["metadata"]["name"] for r in client.list("replicasets")[0]]
        assert rss == [f"web-{thash}"]
        pods = [p for p in client.list("pods")[0]
                if p["metadata"]["labels"].get("app") == "web"]
        assert len(pods) == 3 and all(
            p["status"]["phase"] == "Running" and p["spec"]["nodeName"]
            for p in pods)

        # The round-5 wire story: pets in order, a ScheduledJob's Job run
        # to completion on a hollow kubelet, then reaped with its owner.
        client.create("petsets", {
            "metadata": {"name": "db", "namespace": "default"},
            "spec": {"replicas": 2, "template": {
                "metadata": {"labels": {"app": "db"}},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": "100m"}}}]}}}})
        two_min_ago = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                    time.gmtime(time.time() - 120))
        client.create("scheduledjobs", {
            "metadata": {"name": "tick", "namespace": "default",
                         "creationTimestamp": two_min_ago},
            "spec": {"schedule": "* * * * *", "concurrencyPolicy": "Forbid",
                     "jobTemplate": {"metadata": {}, "spec": {
                         "completions": 1, "parallelism": 1, "template": {
                             "metadata": {"annotations": {
                                 "kubemark.kubernetes.io/run-duration":
                                     "0.3"}},
                             "spec": {"containers": [{"name": "c"}]}}}}}})
        wait(lambda: (client.get("petsets", "default/db").get("status")
                      or {}).get("replicas") == 2, 60, msg="both pets")
        assert sorted(p["metadata"]["name"] for p in client.list("pods")[0]
                      if p["metadata"]["labels"].get("petset-name")
                      == "db") == ["db-0", "db-1"]

        def sj_job():
            jobs = [j for j in client.list("jobs")[0]
                    if (j["metadata"].get("labels") or {})
                    .get("scheduled-job-name") == "tick"]
            return jobs[0] if jobs else None
        job = wait(sj_job, 60, msg="the scheduled job fired")
        assert job["metadata"]["ownerReferences"][0]["kind"] == \
            "ScheduledJob"
        wait(lambda: any(c.get("type") == "Complete" for c in (
            (sj_job() or {}).get("status") or {}).get("conditions") or ()),
            60, msg="the job completed on a hollow kubelet")
        client.delete("scheduledjobs", "default/tick")
        wait(lambda: sj_job() is None, 30,
             msg="the orphaned job reaped by the garbage collector")
    finally:
        for k in kubelets:
            k.stop()
        codes = [stop(p) for p in procs]
        stop(api_proc)
    assert codes == [0, 0]

"""The PyTorch port's deployment controller (``kubernetes_tpu_torch.
controller.deployment``) against the JAX package's, on the CPU, step by
step: the cases of the reference's ``tests/test_deployment.py`` (create,
the rolling update's bounds and hand-over, rollback, Recreate, scale
down), with the maxSurge / maxUnavailable forms around them.

Each side runs its package's ``DeploymentController`` and
``ReplicationManager`` (which turns ReplicaSets into pods, with a suffix
generator seeded alike) on its own ``MemStore``.  A step replays the
watch events (``torch_plane.Pump``), syncs the deployment controller,
then the replication manager, then plays the kubelet: every pending pod
becomes Running, in name order.  After every step both stores hold the
same Deployments, ReplicaSets and pods, and the step keeps the rolling
bounds: the ReplicaSets' replicas sum to at most ``replicas + maxSurge``
and, once the first revision is up, at least ``replicas -
maxUnavailable`` pods are Running."""

from __future__ import annotations

import math
import random

import pytest

from torch_plane import SIDES, Pump, module, snapshot

SEED = 7
KINDS = ("deployments", "replicasets", "pods")


def _deployment(name, replicas=3, image="v1", strategy=None):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {
                "replicas": replicas,
                "selector": {"matchLabels": {"app": name}},
                "strategy": strategy or {
                    "type": "RollingUpdate",
                    "rollingUpdate": {"maxSurge": 1, "maxUnavailable": 1}},
                "template": {
                    "metadata": {"labels": {"app": name,
                                            "version": image}},
                    "spec": {"containers": [{
                        "name": "app", "image": image,
                        "resources": {"requests": {"cpu": "100m"}}}]}}}}


class Plane:
    def __init__(self, side: str):
        self.side = side
        self.dep = module(side, "controller.deployment")
        self.store = module(side, "apiserver.memstore").MemStore()
        self.dc = self.dep.DeploymentController(self.store)
        rm = module(side, "controller.replication").ReplicationManager(
            self.store)
        rm._rand = random.Random(SEED)
        self.rm = rm
        self.pumps = [
            Pump(self.store, {"deployments": self.dc._on_deployment,
                              "replicasets": self.dc._on_rs,
                              "pods": self.dc._on_pod}),
            Pump(self.store, {
                "replicationcontrollers":
                    lambda t, o: rm._on_rc("replicationcontrollers", t, o),
                "replicasets": lambda t, o: rm._on_rc("replicasets", t, o),
                "pods": rm._on_pod})]

    def feed(self):
        for p in self.pumps:
            p.drain()

    def step(self, kubelet: bool = True) -> dict:
        self.feed()
        self.dc.sync_all()
        self.feed()
        self.rm.sync_all()
        if kubelet:
            for o in sorted(self.store.list("pods")[0],
                            key=lambda o: o["metadata"]["name"]):
                if not (o.get("status") or {}).get("phase"):
                    o["status"] = {"phase": "Running", "conditions": [
                        {"type": "Ready", "status": "True"}]}
                    self.store.update("pods", o)
        self.feed()
        return snapshot(self.store, KINDS)

    def edit(self, fn) -> None:
        dep = self.store.get("deployments", "default/web")
        fn(dep)
        self.store.update("deployments", dep)


def _run(side, dep, edits, steps=6, kubelet=True):
    pl = Plane(side)
    pl.store.create("deployments", dep)
    out = []
    for edit in [None] + edits:
        if edit is not None:
            pl.edit(edit)
        out.append([pl.step(kubelet) for _ in range(steps)])
    return out


def both(dep, edits, **kw):
    out = {side: _run(side, dep, edits, **kw) for side in SIDES}
    assert out["ref"] == out["port"]
    return out["port"]


def _alive(pods):
    return [p for p in pods if not (p.get("metadata") or {}).get(
        "deletionTimestamp") and (p.get("status") or {}).get("phase")
        not in ("Failed", "Succeeded")]


def _running(pods):
    return [p for p in _alive(pods)
            if (p.get("status") or {}).get("phase") == "Running"]


def _hash(template):
    return module("ref", "controller.deployment").template_hash(template)


def _v2(dep):
    dep["spec"]["template"]["metadata"]["labels"]["version"] = "v2"
    dep["spec"]["template"]["spec"]["containers"][0]["image"] = "v2"


def _check_bounds(phases, replicas, surge, unavail):
    """Every step of every phase after the first keeps the rolling
    bounds."""
    for i, phase in enumerate(phases):
        for snap in phase:
            total = sum(int(r["spec"].get("replicas", 0))
                        for r in snap["replicasets"])
            assert total <= replicas + surge, (i, total)
            if i:
                assert len(_running(snap["pods"])) >= replicas - unavail


def test_create_makes_one_replicaset_and_its_pods():
    dep = _deployment("web")
    phases = both(dep, [])
    last = phases[0][-1]
    thash = _hash(dep["spec"]["template"])
    hash_label = module("port", "controller.deployment").HASH_LABEL
    rev = module("port", "controller.deployment").REVISION_ANN
    assert [r["metadata"]["name"] for r in last["replicasets"]] == [
        f"web-{thash}"]
    rs = last["replicasets"][0]
    assert rs["metadata"]["labels"][hash_label] == thash
    assert rs["metadata"]["annotations"][rev] == "1"
    assert len(_running(last["pods"])) == 3
    assert all(p["metadata"]["labels"][hash_label] == thash
               for p in last["pods"])
    assert last["deployments"][0]["status"]["availableReplicas"] == 3


@pytest.mark.parametrize("surge,unavail", [
    (1, 1), (0, 1), (2, 0), ("25%", "25%"), ("50%", 0), (0, 0)])
def test_rolling_update_keeps_its_bounds_and_hands_over(surge, unavail):
    replicas = 4
    dep = _deployment("web", replicas=replicas, strategy={
        "type": "RollingUpdate",
        "rollingUpdate": {"maxSurge": surge, "maxUnavailable": unavail}})
    v1 = _hash(dep["spec"]["template"])
    phases = both(dep, [_v2], steps=10)
    s = surge if isinstance(surge, int) else math.ceil(
        float(surge[:-1]) / 100 * replicas)
    u = unavail if isinstance(unavail, int) else math.floor(
        float(unavail[:-1]) / 100 * replicas)
    if s == 0 and u == 0:
        u = 1                                # both zero: one unavailable
    _check_bounds(phases, replicas, s, u)
    last = phases[-1][-1]
    rss = {r["metadata"]["labels"]["pod-template-hash"]: r
           for r in last["replicasets"]}
    v2 = next(h for h in rss if h != v1)
    assert rss[v1]["spec"]["replicas"] == 0
    assert rss[v2]["spec"]["replicas"] == replicas
    assert rss[v1]["metadata"]["annotations"][
        "deployment.kubernetes.io/revision"] == "1"
    assert rss[v2]["metadata"]["annotations"][
        "deployment.kubernetes.io/revision"] == "2"
    new = [p for p in _running(last["pods"])
           if p["metadata"]["labels"]["pod-template-hash"] == v2]
    assert len(new) == replicas


def test_rollback_to_the_previous_revision():
    dep = _deployment("web", replicas=2)
    v1 = _hash(dep["spec"]["template"])

    def back(d):
        d["spec"]["rollbackTo"] = {"revision": 0}
    phases = both(dep, [_v2, back], steps=6)
    last = phases[-1][-1]
    d = last["deployments"][0]
    assert d["spec"].get("rollbackTo") is None
    assert _hash(d["spec"]["template"]) == v1
    pods = _alive(last["pods"])
    assert len(pods) == 2 and all(
        p["metadata"]["labels"]["pod-template-hash"] == v1
        and p["status"]["phase"] == "Running" for p in pods)


@pytest.mark.parametrize("revision", [1, 5])
def test_rollback_to_a_named_or_missing_revision(revision):
    dep = _deployment("web", replicas=2)
    v1 = _hash(dep["spec"]["template"])

    def back(d):
        d["spec"]["rollbackTo"] = {"revision": revision}
    phases = both(dep, [_v2, back], steps=5)
    d = phases[-1][-1]["deployments"][0]
    assert d["spec"].get("rollbackTo") is None
    assert (_hash(d["spec"]["template"]) == v1) == (revision == 1)


def test_recreate_never_runs_both_revisions():
    dep = _deployment("web", replicas=2, strategy={"type": "Recreate"})
    phases = both(dep, [_v2], steps=6)
    for snap in phases[1]:
        versions = {p["metadata"]["labels"]["version"]
                    for p in _running(snap["pods"])}
        assert versions != {"v1", "v2"}
    last = phases[-1][-1]
    assert {p["metadata"]["labels"]["version"]
            for p in _running(last["pods"])} == {"v2"}
    assert len(_running(last["pods"])) == 2


def test_scale_down_shrinks_the_new_replicaset():
    dep = _deployment("web", replicas=5)

    def down(d):
        d["spec"]["replicas"] = 2
    phases = both(dep, [down], steps=4)
    last = phases[-1][-1]
    assert len(_alive(last["pods"])) == 2
    assert [r["spec"]["replicas"] for r in last["replicasets"]] == [2]


def test_a_rollout_without_kubelets_stalls_within_the_surge():
    """Nothing Running: the new revision grows to the surge budget and
    no old replica is taken down."""
    dep = _deployment("web", replicas=4)
    phases = both(dep, [_v2], steps=4, kubelet=False)
    last = phases[-1][-1]
    specs = sorted(r["spec"]["replicas"] for r in last["replicasets"])
    assert specs == [1, 4]


def test_template_hash_matches_the_reference():
    dep = _deployment("web")
    t = dep["spec"]["template"]
    stamped = {**t, "metadata": {**t["metadata"], "labels": {
        **t["metadata"]["labels"], "pod-template-hash": "x"}}}
    for template in (t, stamped, {}, {"spec": {"containers": []}}):
        assert module("ref", "controller.deployment").template_hash(
            template) == module("port", "controller.deployment"
                                ).template_hash(template)

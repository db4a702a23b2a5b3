"""The PyTorch port's controllers (``kubernetes_tpu_torch.controller.
{disruption,daemonset,job,podgc,garbagecollector,namespace,
serviceaccounts,resourcequota,podautoscaler,scheduledjob,petset}``, with
``utils/{cron,timeutil}``) against the JAX package's, on the CPU.

Each case builds the same objects on twin ``MemStore``s, one of each
package, replays each store's watch events to its controller's handlers
in store order (``torch_plane.Pump``) and calls the sync entry point
(``sync_all``, ``sync_one``, ``sync_once``, ``gc_once``,
``gc_namespace``) by hand, never through a thread.  After every step
both stores hold the same objects (creation stamps aside), and the
reference test's own facts hold on the port's side.  There is one case
per behaviour of the reference's ``tests/test_round5_controllers.py``,
``tests/test_workloads.py`` (daemon sets, jobs, pod GC, the autoscaler),
``tests/test_controller_units.py``, ``tests/test_namespace.py`` and
``tests/test_serviceaccounts.py::TestController``.

Random pod suffixes come from a generator seeded alike on both sides
(``_rand``), the wall clock is one fixed value patched into
``time.time`` for both, and token secrets are compared by presence,
type, length and link, never by value."""

from __future__ import annotations

import functools
import random
import re
import time
from datetime import datetime, timedelta, timezone

import pytest

from torch_plane import SIDES, Pump, module, snapshot

SEED = 14
T0 = 1_473_000_000.0          # 2016-09-04, the frozen time.time()
WALL = ("creationTimestamp", "deletionTimestamp")


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)


def _utc(*a) -> datetime:
    return datetime(*a, tzinfo=timezone.utc)


HANDLERS = {
    "DisruptionController": lambda c: {
        "poddisruptionbudgets": c._on_pdb, "pods": c._on_pod,
        **{k: c._owner_handler(k) for k in c._owners}},
    "DaemonSetController": lambda c: {
        "daemonsets": c._on_ds, "nodes": c._on_node, "pods": c._on_pod},
    "JobController": lambda c: {"jobs": c._on_job, "pods": c._on_pod},
    "PodGCController": lambda c: {"pods": c._on_pod},
    "GarbageCollector": lambda c: {},
    "NamespaceController": lambda c: {"namespaces": c._on_ns},
    "ServiceAccountsController": lambda c: {
        "namespaces": c._on_ns, "serviceaccounts": c._on_sa,
        "secrets": c._on_secret},
    "ResourceQuotaController": lambda c: {
        "resourcequotas": c._on_quota, "pods": c._on_pod},
    "HorizontalPodAutoscaler": lambda c: {
        "horizontalpodautoscalers": c._on_hpa, "pods": c._on_pod},
    "ScheduledJobController": lambda c: {
        "scheduledjobs": c._on_sj, "jobs": c._on_job},
    "PetSetController": lambda c: {"petsets": c._on_set, "pods": c._on_pod},
    "NodeLifecycleController": lambda c: {
        "nodes": c._on_node, "pods": c._on_pod},
    "ReplicationManager": lambda c: {
        k: functools.partial(c._on_rc, k)
        for k in ("replicationcontrollers", "replicasets")} | {
        "pods": c._on_pod},
}


class Side:
    """One package's store and controllers, fed by a ``Pump`` each."""

    def __init__(self, side: str):
        self.side = side
        self.store = module(side, "apiserver.memstore").MemStore()
        self.pumps: list[Pump] = []

    def ctl(self, mod: str, cls: str, *, feed: bool = True, **kw):
        c = getattr(module(self.side, f"controller.{mod}"), cls)(
            self.store, **kw)
        if hasattr(c, "_rand"):
            c._rand = random.Random(SEED)
        handlers = HANDLERS[cls](c)
        if feed and handlers:
            self.pumps.append(Pump(self.store, handlers))
        return c

    def feed(self) -> None:
        for p in self.pumps:
            p.drain()

    def snap(self, *kinds: str) -> dict:
        return snapshot(self.store, kinds, wall=WALL)

    def names(self, kind: str = "pods") -> list[str]:
        return sorted(o["metadata"]["name"]
                      for o in self.store.list(kind)[0])

    def update(self, kind: str, key: str, fn) -> None:
        obj = self.store.get(kind, key)
        fn(obj)
        self.store.update(kind, obj)


def both(scenario, *args):
    """``scenario(Side, *args)`` on each package: equal observations."""
    out = {side: scenario(Side(side), *args) for side in SIDES}
    assert out["ref"] == out["port"]
    return out["port"]


def _pod(name, ns="default", labels=None, node="", phase="", ready=False,
         cpu=""):
    obj = {"metadata": {"name": name, "namespace": ns,
                        "labels": dict(labels or {})},
           "spec": {"containers": [{"name": "c"}]}}
    if cpu:
        obj["spec"]["containers"][0]["resources"] = {
            "requests": {"cpu": cpu}}
    if node:
        obj["spec"]["nodeName"] = node
    if phase:
        obj["status"] = {"phase": phase}
        if ready:
            obj["status"]["conditions"] = [{"type": "Ready",
                                            "status": "True"}]
    return obj


def _phase(phase: str, ready: bool = True):
    def set_(obj):
        obj["status"] = {"phase": phase}
        if ready:
            obj["status"]["conditions"] = [{"type": "Ready",
                                            "status": "True"}]
    return set_


# -- cron and the scheduled-job controller ----------------------------------

CRONS = ("* * * * *", "30 4 * * *", "*/15 9-17 * * 1-5", "0 0 13 * 5",
         "0 0 * * 0", "0 0 * * 7", "5,35 */6 1-7 1,6 *")
BAD_CRONS = ("* * * *", "61 * * * *", "* 24 * * *", "a * * * *",
             "*/0 * * * *")
STARTS = (_utc(2016, 9, 1, 12, 0), _utc(2016, 9, 1, 5, 0),
          _utc(2016, 9, 2, 17, 50), _utc(2016, 9, 5, 0, 0),
          _utc(2016, 12, 31, 23, 59))


@pytest.mark.parametrize("expr", CRONS + BAD_CRONS)
def test_cron_matches_the_reference(expr):
    def scenario(s):
        cron = module(s.side, "utils.cron")
        try:
            sched = cron.parse(expr)
        except ValueError as err:
            return ["ValueError", str(err)]
        out = []
        for t in STARTS:
            for _ in range(4):
                t = sched.next(t)
                out.append(t)
        return out
    got = both(scenario)
    if expr in BAD_CRONS:
        assert got[0] == "ValueError"
    elif expr == "*/15 9-17 * * 1-5":
        assert got[8] == _utc(2016, 9, 5, 9, 0)     # Friday 17:50 -> Monday
    elif expr == "0 0 13 * 5":
        assert got[12:14] == [_utc(2016, 9, 9), _utc(2016, 9, 13)]
    elif expr in ("0 0 * * 0", "0 0 * * 7"):
        assert all(t.weekday() == 6 for t in got)


def test_timeutil_matches_the_reference():
    def scenario(s):
        tu = module(s.side, "utils.timeutil")
        stamp = tu.format_rfc3339(_utc(2016, 9, 1, 0, 1, 10))
        out = [stamp, tu.parse_rfc3339(stamp),
               tu.now_utc().tzinfo is not None]
        try:
            tu.parse_rfc3339("2016-09-01T00:01:10.250000Z")
        except ValueError as err:
            out.append(str(err))
        return out
    assert both(scenario)[0] == "2016-09-01T00:01:10Z"


def _sj(name="report", schedule="* * * * *", policy="Allow",
        created="2016-09-01T00:00:00Z", **spec_extra):
    return {"metadata": {"name": name, "namespace": "default",
                         "creationTimestamp": created},
            "spec": {"schedule": schedule, "concurrencyPolicy": policy,
                     "jobTemplate": {
                         "metadata": {"labels": {"app": name}},
                         "spec": {"completions": 1, "parallelism": 1,
                                  "template": {"spec": {"containers": [
                                      {"name": "c"}]}}}},
                     **spec_extra}}


@pytest.mark.parametrize("now", [
    _utc(2016, 9, 1, 0, 5, 30), _utc(2016, 9, 1, 0, 0, 30),
    _utc(2016, 9, 1, 1, 39, 0), _utc(2016, 9, 2, 0, 0, 0)])
def test_unmet_schedule_times_match_the_reference(now):
    def scenario(s):
        sj = module(s.side, "controller.scheduledjob")
        try:
            return sj.unmet_schedule_times(_sj(), now)
        except ValueError as err:
            return ["ValueError", str(err)]
    got = both(scenario)
    if now == _utc(2016, 9, 1, 0, 5, 30):
        assert len(got) == 5 and got[-1] == _utc(2016, 9, 1, 0, 5)
    if now.day == 2:
        assert got[0] == "ValueError"      # more than 100 missed starts


def _sj_steps(s, objs, times, between=None):
    now_box = [times[0]]
    c = s.ctl("scheduledjob", "ScheduledJobController",
              clock=lambda: now_box[0])
    for o in objs:
        s.store.create("scheduledjobs", o)
    out = []
    for i, t in enumerate(times):
        now_box[0] = t
        s.feed()
        c.sync_all(t)
        out.append(s.snap("jobs", "scheduledjobs", "pods"))
        if between is not None:
            between(s, i)
    return out


def _finish_jobs(s, i):
    if i == 1:
        for j in s.store.list("jobs")[0]:
            s.update("jobs", f"default/{j['metadata']['name']}",
                     lambda o: o.update(status={"conditions": [
                         {"type": "Complete", "status": "True"}]}))


SJ_CASES = {
    # Creates the slot's job with its label and owner; the same slot
    # never starts twice.
    "creates": lambda s: _sj_steps(s, [_sj()], [
        _utc(2016, 9, 1, 0, 1, 10)] * 2),
    # Forbid: no start while a job is active; once finished, the next.
    "forbid": lambda s: _sj_steps(s, [_sj(policy="Forbid")], [
        _utc(2016, 9, 1, 0, 1, 10), _utc(2016, 9, 1, 0, 2, 10),
        _utc(2016, 9, 1, 0, 2, 10)], _finish_jobs),
    # Replace: the active job is deleted (cascade) for the new slot.
    "replace": lambda s: _sj_steps(s, [_sj(policy="Replace")], [
        _utc(2016, 9, 1, 0, 1, 10), _utc(2016, 9, 1, 0, 2, 10)]),
    # Suspended never starts; a missed starting deadline skips the slot.
    "suspend_deadline": lambda s: _sj_steps(s, [
        _sj(name="sus", suspend=True),
        _sj(name="late", schedule="1 0 * * *",
            startingDeadlineSeconds=60)], [_utc(2016, 9, 1, 0, 5, 0)]),
    # No creationTimestamp: backfilled once, scheduled from there.
    "backfill": lambda s: _sj_steps(s, [_sj(name="old", created="")], [
        _utc(2016, 9, 1, 0, 1, 10), _utc(2016, 9, 1, 0, 2, 10)]),
}


@pytest.mark.parametrize("case", sorted(SJ_CASES))
def test_scheduledjob_matches_the_reference(case):
    obs = both(SJ_CASES[case])
    jobs = [[j["metadata"]["name"] for j in o["jobs"]] for o in obs]
    if case == "creates":
        slot = int(_utc(2016, 9, 1, 0, 1).timestamp()) // 60
        assert jobs == [[f"report-{slot}"]] * 2
        job = obs[0]["jobs"][0]
        assert job["metadata"]["labels"]["scheduled-job-name"] == "report"
        assert job["metadata"]["ownerReferences"][0]["kind"] == \
            "ScheduledJob"
        sj = obs[0]["scheduledjobs"][0]
        assert sj["status"]["lastScheduleTime"] == "2016-09-01T00:01:00Z"
        assert sj["status"]["active"]
    elif case == "forbid":
        assert [len(j) for j in jobs] == [1, 1, 2]
    elif case == "replace":
        assert len(jobs[1]) == 1 and jobs[0][0] not in jobs[1]
    elif case == "suspend_deadline":
        assert jobs == [[]]
    elif case == "backfill":
        assert jobs[0] == [] and obs[0]["scheduledjobs"][0]["metadata"][
            "creationTimestamp"] == "<wall clock>"


# -- pet sets ----------------------------------------------------------------

def _petset(replicas):
    return {"metadata": {"name": "db", "namespace": "default"},
            "spec": {"replicas": replicas,
                     "template": {"metadata": {"labels": {"app": "db"}},
                                  "spec": {"containers": [{"name": "c"}]}}}}


def _pets(s, c, pre=(), replicas=3, steps=4, ready=True, after=None):
    for name, healthy in pre:
        s.store.create("pods", _pod(name, labels={"petset-name": "db"},
                                    phase="Running", ready=healthy))
    if after is not None:
        after(s)
    s.store.create("petsets", _petset(replicas))
    out = []
    for _ in range(steps):
        s.feed()
        c.sync_all()
        out.append(s.snap("pods", "petsets"))
        if ready:
            for name in s.names():
                pod = s.store.get("pods", f"default/{name}")
                if not (pod.get("status") or {}).get("phase"):
                    s.update("pods", f"default/{name}", _phase("Running"))
                    break
    return out


PETSET_CASES = {
    # One pet at a time, each after its predecessor is Running and Ready.
    "bring_up": lambda s, c: _pets(s, c),
    # Scale down: the highest ordinal first, one per pass.
    "scale_down": lambda s, c: _pets(
        s, c, pre=[(f"db-{i}", True) for i in range(3)], replicas=1,
        steps=3),
    # A deleted middle pet waits while a higher pet is unhealthy.
    "middle_gap": lambda s, c: _pets(
        s, c, pre=[("db-0", True), ("db-1", True), ("db-3", False)],
        replicas=4, steps=1, ready=False),
    # A deleted pet comes back under its own name.
    "identity": lambda s, c: _pets(
        s, c, pre=[("db-0", True), ("db-1", True)], replicas=2, steps=2,
        after=lambda s: s.store.delete("pods", "default/db-0")),
}


@pytest.mark.parametrize("case", sorted(PETSET_CASES))
def test_petset_matches_the_reference(case):
    obs = both(lambda s: PETSET_CASES[case](
        s, s.ctl("petset", "PetSetController")))
    names = [[p["metadata"]["name"] for p in o["pods"]] for o in obs]
    if case == "bring_up":
        assert names[:3] == [["db-0"], ["db-0", "db-1"],
                             ["db-0", "db-1", "db-2"]]
        assert obs[0]["pods"][0]["metadata"]["ownerReferences"][0][
            "kind"] == "PetSet"
        assert obs[3]["petsets"][0]["status"] == {"replicas": 3}
    elif case == "scale_down":
        assert names[:2] == [["db-0", "db-1"], ["db-0"]]
    elif case == "middle_gap":
        assert names == [["db-0", "db-1", "db-3"]]
    elif case == "identity":
        assert names[0] == ["db-0", "db-1"]


def test_healthy_and_min_available_match_the_reference():
    pods = [_pod("a"), _pod("b", phase="Running"),
            _pod("c", phase="Running", ready=True),
            _pod("d", phase="Pending", ready=True)]

    def scenario(s):
        d = module(s.side, "controller.disruption")
        out = [d._healthy(p) for p in pods]
        for value, expected in ((2, 5), ("50%", 3), ("90%", 2000),
                                ("0%", 7), ("x", 3), (1.5, 3)):
            try:
                out.append(d.resolve_min_available(value, expected))
            except ValueError as err:
                out.append(str(err))
        return out
    got = both(scenario)
    assert got[:4] == [False, False, True, False]
    assert got[4:8] == [2, 2, 1800, 0]


# -- disruption budgets --------------------------------------------------

def _pdb(name, min_available, app="web"):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"minAvailable": min_available,
                     "selector": {"app": app}}}


def _budget(s, c, objs, pods):
    for kind, obj in objs:
        s.store.create(kind, obj)
    for p in pods:
        s.store.create("pods", p)
    s.feed()
    c.sync_all()
    out = [s.snap("poddisruptionbudgets")]
    # One pod lost: the budget follows on the next pass.
    s.store.delete("pods", f"default/{pods[0]['metadata']['name']}")
    s.feed()
    out.append([c.sync_one(p) for p in
                s.store.list("poddisruptionbudgets")[0]])
    out.append(s.snap("poddisruptionbudgets"))
    return out


def _web(n, ready=lambda i: True):
    return [_pod(f"w{i}", labels={"app": "web"}, phase="Running",
                 ready=ready(i)) for i in range(n)]


PDB_CASES = {
    "integer": lambda s, c: _budget(
        s, c, [("poddisruptionbudgets", _pdb("web-pdb", 2))],
        _web(3, ready=lambda i: i != 2)),
    "percent_of_scale": lambda s, c: _budget(
        s, c, [("poddisruptionbudgets", _pdb("pct", "50%")),
               ("replicationcontrollers", {
                   "metadata": {"name": "web", "namespace": "default"},
                   "spec": {"replicas": 4, "selector": {"app": "web"}}})],
        _web(3)),
    "percent_without_controller": lambda s, c: _budget(
        s, c, [("poddisruptionbudgets", _pdb("orphan", "50%", "solo"))],
        [_pod("s0", labels={"app": "solo"}, phase="Running", ready=True)]),
    "percent_of_deployment": lambda s, c: _budget(
        s, c, [("poddisruptionbudgets", _pdb("dep", "90%")),
               ("deployments", {
                   "metadata": {"name": "web", "namespace": "default"},
                   "spec": {"replicas": 10,
                            "selector": {"matchLabels": {"app": "web"}}}})],
        _web(10)),
}


@pytest.mark.parametrize("case", sorted(PDB_CASES))
def test_disruption_matches_the_reference(case):
    obs = both(lambda s: PDB_CASES[case](
        s, s.ctl("disruption", "DisruptionController")))
    st = obs[0]["poddisruptionbudgets"][0]["status"]
    if case == "integer":
        assert st == {"disruptionAllowed": True, "currentHealthy": 2,
                      "desiredHealthy": 2, "expectedPods": 3}
        assert obs[2]["poddisruptionbudgets"][0]["status"][
            "disruptionAllowed"] is False
    elif case == "percent_of_scale":
        assert st == {"disruptionAllowed": True, "currentHealthy": 3,
                      "desiredHealthy": 2, "expectedPods": 4}
    elif case == "percent_without_controller":
        assert st["disruptionAllowed"] is False
    elif case == "percent_of_deployment":
        assert st["desiredHealthy"] == 9 and st["disruptionAllowed"]


# -- the autoscaler ----------------------------------------------------------

def _hpa_rig(s, now_box, replicas=2, target=50, lo=1, hi=10):
    c = s.ctl("podautoscaler", "HorizontalPodAutoscaler",
              clock=lambda: now_box[0], upscale_window=180.0,
              downscale_window=300.0)
    s.store.create("replicationcontrollers", {
        "metadata": {"name": "web", "namespace": "default"},
        "spec": {"replicas": replicas, "selector": {"app": "web"}}})
    spec = {"scaleTargetRef": {"kind": "ReplicationController",
                               "name": "web"},
            "minReplicas": lo, "maxReplicas": hi}
    if target is not None:
        spec["targetCPUUtilizationPercentage"] = target
    s.store.create("horizontalpodautoscalers", {
        "metadata": {"name": "web-hpa", "namespace": "default"},
        "spec": spec})
    return c


def _usage(s, n, cpu_each):
    for i in range(n):
        key = f"default/w{i}"
        if s.store.get("pods", key) is None:
            p = _pod(f"w{i}", labels={"app": "web"}, cpu="100m",
                     phase="Running")
            p["status"]["cpuUsage"] = cpu_each
            s.store.create("pods", p)
        else:
            s.update("pods", key, lambda o: o["status"].update(
                cpuUsage=cpu_each))


def _hpa_steps(s, steps, **rig):
    start = _utc(2016, 9, 1, 12, 0)
    now_box = [start]
    c = _hpa_rig(s, now_box, **rig)
    out = []
    for seconds, n, cpu in steps:
        now_box[0] = start + timedelta(seconds=seconds)
        if n:
            _usage(s, n, cpu)
        s.feed()
        c.sync_all()
        out.append(s.snap("replicationcontrollers",
                          "horizontalpodautoscalers"))
    return out


HPA_CASES = {
    # One scale event per upscale window however hot the metric stays.
    "upscale_window": ({}, [(0, 2, "100m"), (2, 0, ""), (30, 0, ""),
                            (120, 0, ""), (179, 0, ""), (181, 0, "")]),
    # The downscale window is longer.
    "downscale_window": ({}, [(0, 2, "100m"), (240, 2, "5m"),
                              (305, 0, "")]),
    # Within the 10% tolerance: no change.
    "tolerance": ({"target": 100, "hi": 5}, [(0, 2, "105m")]),
    # Down to minReplicas.
    "to_min": ({"replicas": 4, "target": 100, "lo": 2, "hi": 8},
               [(0, 4, "10m")]),
    # Scaled to zero: paused.
    "paused": ({"replicas": 0, "target": None, "hi": 5},
               [(0, 1, "300m"), (10, 0, "")]),
}


@pytest.mark.parametrize("case", sorted(HPA_CASES))
def test_autoscaler_matches_the_reference(case):
    rig, steps = HPA_CASES[case]
    obs = both(lambda s: _hpa_steps(s, steps, **rig))
    reps = [o["replicationcontrollers"][0]["spec"]["replicas"] for o in obs]
    if case == "upscale_window":
        assert reps == [4, 4, 4, 4, 4, 8]
        assert obs[0]["horizontalpodautoscalers"][0]["status"][
            "lastScaleTime"] == "2016-09-01T12:00:00Z"
    elif case == "downscale_window":
        assert reps[:2] == [4, 4] and reps[2] < 4
    elif case == "tolerance":
        assert reps == [2]
    elif case == "to_min":
        assert reps == [2]
    elif case == "paused":
        assert reps == [0, 0]


# -- quota, garbage collection, pod GC ---------------------------------------

def test_resourcequota_matches_the_reference():
    def scenario(s):
        c = s.ctl("resourcequota", "ResourceQuotaController")
        s.store.create("resourcequotas", {
            "metadata": {"name": "q", "namespace": "default"},
            "spec": {"hard": {"pods": "10", "requests.cpu": "2",
                              "requests.memory": "1Gi"}}})
        p = _pod("a")
        p["spec"]["containers"][0]["resources"] = {
            "requests": {"cpu": "500m", "memory": "128Mi"}}
        s.store.create("pods", p)
        s.store.create("pods", _pod("b", cpu="250m"))
        s.store.create("pods", _pod("done", cpu="1", phase="Succeeded"))
        out = []
        for step in (None, "default/a", "default/b"):
            if step:
                s.store.delete("pods", step)
            s.feed()
            c.sync_all()
            out.append(s.snap("resourcequotas"))
        return out
    obs = both(scenario)
    used = [o["resourcequotas"][0]["status"]["used"] for o in obs]
    assert used[0]["pods"] == "2" and used[0]["requests.cpu"] == "750m"
    assert used[2]["pods"] == "0"
    assert obs[0]["resourcequotas"][0]["status"]["hard"]["pods"] == "10"


GC_CASES = {
    "orphans_reaped": (
        [("petsets", {"metadata": {"name": "db", "namespace": "default"},
                      "spec": {"replicas": 1, "template": {"spec": {}}}})],
        [("db-0", "PetSet", "db"), ("ghost-0", "PetSet", "ghost"),
         ("standalone", None, None)], "default/db"),
    "unknown_kind": ([], [("custom", "SomethingCustom", "x")], None),
    "any_owner_alive": (
        [("replicasets", {"metadata": {"name": "rs", "namespace": "default"},
                          "spec": {"replicas": 1}})],
        [("shared", "ReplicaSet", "rs"), ("both-gone", "Job", "nope")],
        "default/rs"),
}


@pytest.mark.parametrize("case", sorted(GC_CASES))
def test_garbagecollector_matches_the_reference(case):
    owners, pods, then_delete = GC_CASES[case]

    def scenario(s):
        for kind, obj in owners:
            s.store.create(kind, obj)
        for name, kind, owner in pods:
            p = _pod(name)
            if kind:
                p["metadata"]["ownerReferences"] = [
                    {"kind": kind, "name": owner, "controller": True}]
            if name == "shared":
                p["metadata"]["ownerReferences"].append(
                    {"kind": "Job", "name": "gone"})
            s.store.create("pods", p)
        gc = s.ctl("garbagecollector", "GarbageCollector")
        out = [gc.sync_once(), s.names()]
        if then_delete:
            s.store.delete(owners[0][0], then_delete)
        out += [gc.sync_once(), s.names()]
        return out
    got = both(scenario)
    if case == "orphans_reaped":
        assert got == [1, ["db-0", "standalone"], 1, ["standalone"]]
    elif case == "unknown_kind":
        assert got == [0, ["custom"], 0, ["custom"]]


def test_podgc_matches_the_reference():
    def scenario(s):
        for i in range(8):
            s.store.create("pods", _pod(f"done-{i}", phase=(
                "Succeeded" if i % 3 else "Failed")))
        s.store.create("pods", _pod("alive", phase="Running"))
        c = s.ctl("podgc", "PodGCController", threshold=3)
        s.feed()
        out = [c.gc_once(), s.names()]
        s.feed()
        out += [c.gc_once(), s.names()]
        return out
    got = both(scenario)
    assert got[0] == 5 and got[2] == 0
    assert got[1] == ["alive", "done-5", "done-6", "done-7"]


# -- namespaces and service accounts ----------------------------------------

def _ns_gc(s, c):
    names = []
    while not c._work.empty():
        name = c._work.get_nowait()
        names.append([name, c.gc_namespace(name)])
    return names


def _workloads(ns):
    return [
        ("pods", _pod("p1", ns)), ("pods", _pod("p2", ns)),
        ("services", {"metadata": {"name": "svc", "namespace": ns},
                      "spec": {"selector": {"a": "b"}}}),
        ("replicationcontrollers", {
            "metadata": {"name": "rc", "namespace": ns},
            "spec": {"replicas": 0, "selector": {"x": "y"}}}),
        ("jobs", {"metadata": {"name": "j", "namespace": ns},
                  "spec": {"completions": 1, "parallelism": 1,
                           "template": {"spec": {"containers": [
                               {"name": "c"}]}}}}),
        ("daemonsets", {"metadata": {"name": "d", "namespace": ns},
                        "spec": {"template": {"spec": {"containers": [
                            {"name": "c"}]}}}}),
        ("horizontalpodautoscalers", {
            "metadata": {"name": "h", "namespace": ns},
            "spec": {"scaleTargetRef": {"kind": "Job", "name": "j"},
                     "maxReplicas": 3}}),
        ("roles", {"metadata": {"name": "r", "namespace": ns},
                   "rules": [{"verbs": ["get"], "resources": ["pods"]}]}),
        ("rolebindings", {"metadata": {"name": "rb", "namespace": ns},
                          "subjects": [{"kind": "User", "name": "a"}],
                          "roleRef": {"kind": "Role", "name": "r"}}),
    ]


KINDS = ("pods", "services", "replicationcontrollers", "jobs",
         "daemonsets", "horizontalpodautoscalers", "roles", "rolebindings",
         "namespaces")


def _namespaces(s, trigger):
    c = s.ctl("namespace", "NamespaceController")
    s.store.create("namespaces", {"metadata": {"name": "team-a"}})
    for kind, obj in _workloads("team-a") + [("pods", _pod("keep",
                                                             "team-b"))]:
        s.store.create(kind, obj)
    s.store.create("pods", _pod("implicit", "default"))
    s.feed()
    out = [_ns_gc(s, c)]
    if trigger == "delete":
        s.store.delete("namespaces", "team-a")
    else:
        s.update("namespaces", "team-a",
                 lambda o: o.update(status={"phase": "Terminating"}))
    s.feed()
    out += [_ns_gc(s, c), s.snap(*KINDS)]
    return out


@pytest.mark.parametrize("trigger", ["delete", "terminating"])
def test_namespace_gc_matches_the_reference(trigger):
    obs = both(_namespaces, trigger)
    assert obs[0] == []           # no namespace event: nothing collected
    assert obs[1][0][0] == "team-a" and obs[1][0][1] == 9
    left = obs[2]
    assert [p["metadata"]["name"] for p in left["pods"]] == [
        "implicit", "keep"]
    assert all(not left[k] for k in KINDS[1:])


def test_namespace_gc_order_matches_the_reference():
    got = both(lambda s: [module(s.side, "controller.namespace")._GC_ORDER,
                          sorted(module(s.side, "api.types")
                                 .NAMESPACED_KINDS)])
    assert set(got[1]) <= set(got[0])


def _masked_tokens(snap: dict) -> dict:
    """Token secrets by presence, type, length and link: the random
    suffix of each name and the token itself become their lengths."""
    names = {}
    for sec in snap["secrets"]:
        name = sec["metadata"]["name"]
        prefix, _, suffix = name.rpartition("-")
        token = sec["data"]["token"]
        assert re.fullmatch(r"[0-9a-f]{6}", suffix), name
        assert re.fullmatch(r"[0-9a-f]{32}", token), token
        names[name] = f"{prefix}-<{len(suffix)} hex>"
        sec["metadata"]["name"] = names[name]
        sec["data"]["token"] = f"<{len(token)} hex>"
        sec["metadata"].pop("resourceVersion", None)
    snap["secrets"].sort(key=lambda o: (o["metadata"]["namespace"],
                                        o["metadata"]["name"]))
    for sa in snap["serviceaccounts"]:
        for ref in sa.get("secrets") or ():
            ref["name"] = names.get(ref["name"], "<no such secret>")
        sa["metadata"].pop("resourceVersion", None)
    snap.pop("rv")
    return snap


def test_serviceaccounts_match_the_reference():
    def scenario(s):
        c = s.ctl("serviceaccounts", "ServiceAccountsController")
        out = []

        def step(times=2):
            for _ in range(times):
                s.feed()
                c.sync_all()
            out.append(_masked_tokens(s.snap("serviceaccounts", "secrets",
                                             "namespaces")))
        step()
        s.store.create("namespaces", {"metadata": {"name": "team-a"}})
        step()
        s.store.create("namespaces", {"metadata": {"name": "gone"},
                                      "status": {"phase": "Terminating"}})
        step()
        s.store.delete("serviceaccounts", "team-a/default")
        s.feed()
        s.store.create("serviceaccounts", {"metadata": {
            "name": "default", "namespace": "team-a"}})
        step(1)
        return out
    obs = both(scenario)
    sa = obs[0]["serviceaccounts"][0]
    sec = obs[0]["secrets"][0]
    assert sa["metadata"]["name"] == "default"
    assert sec["type"] == module("port", "apiserver.auth").SA_TOKEN_TYPE
    assert sa["secrets"] == [{"name": sec["metadata"]["name"]}]
    assert {o["metadata"]["namespace"] for o in obs[1]["secrets"]} == {
        "default", "team-a"}
    assert "gone" not in {o["metadata"]["namespace"]
                          for o in obs[2]["serviceaccounts"]}


# -- daemon sets, jobs -------------------------------------------------------

def _node_obj(name, labels=None, unschedulable=False):
    obj = {"metadata": {"name": name, "labels": dict(labels or {})},
           "status": {}}
    if unschedulable:
        obj["spec"] = {"unschedulable": True}
    return obj


def _ds(name="logd", node_selector=None):
    spec = {"containers": [{"name": "c"}]}
    if node_selector:
        spec["nodeSelector"] = node_selector
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"template": {"metadata": {"labels": {"app": name}},
                                  "spec": spec}}}


def _ds_steps(s, nodes, ds, edits):
    c = s.ctl("daemonset", "DaemonSetController")
    for n in nodes:
        s.store.create("nodes", n)
    s.store.create("daemonsets", ds)
    out = []
    for edit in [None] + edits:
        if edit is not None:
            edit(s)
        for _ in range(2):
            s.feed()
            c.sync_all()
        out.append(s.snap("pods", "daemonsets"))
    return out


DS_CASES = {
    # One pod per eligible node, placed by the controller; a new
    # eligible node gets its daemon.
    "per_node": lambda s: _ds_steps(
        s, [_node_obj("n0", {"disk": "ssd"}), _node_obj("n1", {"disk": "ssd"}),
            _node_obj("n2")], _ds(node_selector={"disk": "ssd"}),
        [lambda s: s.store.create("nodes", _node_obj("n3",
                                                     {"disk": "ssd"}))]),
    # A duplicate is pruned to the oldest; a node that loses the label
    # loses its daemon; a deleted node too.
    "prune": lambda s: _ds_steps(
        s, [_node_obj("n0", {"disk": "ssd"}),
            _node_obj("n1", {"disk": "ssd"})],
        _ds(node_selector={"disk": "ssd"}),
        [lambda s: s.store.create("pods", {
            "metadata": {"name": "logd-dup", "namespace": "default",
                         "labels": {"daemonset-name": "logd"}},
            "spec": {"nodeName": "n0", "containers": [{"name": "c"}]}}),
         lambda s: s.update("nodes", "n0",
                            lambda o: o["metadata"].update(labels={})),
         lambda s: s.store.delete("nodes", "n1")]),
    # Cordoned nodes still run their daemons.
    "cordon": lambda s: _ds_steps(
        s, [_node_obj("n0", unschedulable=True), _node_obj("n1")], _ds(),
        []),
}


@pytest.mark.parametrize("case", sorted(DS_CASES))
def test_daemonset_matches_the_reference(case):
    obs = both(DS_CASES[case])
    nodes = [sorted(p["spec"]["nodeName"] for p in o["pods"]) for o in obs]
    if case == "per_node":
        assert nodes == [["n0", "n1"], ["n0", "n1", "n3"]]
        assert obs[0]["daemonsets"][0]["status"][
            "desiredNumberScheduled"] == 2
    elif case == "prune":
        assert nodes == [["n0", "n1"], ["n0", "n1"], ["n1"], []]
        assert "logd-dup" not in [p["metadata"]["name"]
                                  for p in obs[1]["pods"]]
    elif case == "cordon":
        assert nodes == [["n0", "n1"]]


def _job(name="batch", completions=3, parallelism=2):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"completions": completions, "parallelism": parallelism,
                     "template": {
                         "metadata": {"labels": {"app": name},
                                      "annotations": {
                                          "kubemark.kubernetes.io/"
                                          "run-duration": "0.3"}},
                         "spec": {"containers": [{
                             "name": "c", "resources": {
                                 "requests": {"cpu": "100m"}}}]}}}}


def _finish(phase, n=1, prefix=""):
    def edit(s):
        done = 0
        for name in s.names():
            pod = s.store.get("pods", f"default/{name}")
            if name.startswith(prefix) and not (
                    pod.get("status") or {}).get("phase"):
                s.update("pods", f"default/{name}", _phase(phase, False))
                done += 1
                if done == n:
                    return
    return edit


def _job_steps(s, job, edits, syncs=2):
    c = s.ctl("job", "JobController")
    s.store.create("jobs", job)
    out = []
    for edit in [None] + edits:
        if edit is not None:
            edit(s)
        for _ in range(syncs):
            s.feed()
            c.sync_all()
        out.append(s.snap("pods", "jobs"))
    return out


def _overshoot(s):
    """An overshoot pod appears as the first pod succeeds."""
    first = s.names()[0]
    s.store.create("pods", {
        "metadata": {"name": "j-overshoot", "namespace": "default",
                     "labels": {"job-name": "j"}},
        "spec": {"containers": [{"name": "c"}]},
        "status": {"phase": "Running"}})
    s.update("pods", f"default/{first}", _phase("Succeeded", False))


JOB_CASES = {
    # Runs to completion: parallelism bounds the flight, succeeded pods
    # are kept, the job is Complete.
    "completion": lambda s: _job_steps(s, _job(), [
        _finish("Succeeded"), _finish("Succeeded", 2)]),
    # No kubelet: exactly parallelism pods stay active.
    "parallelism": lambda s: _job_steps(
        s, _job("wide", completions=6), [], syncs=4),
    # A failed pod is counted and replaced.
    "failed": lambda s: _job_steps(s, _job("flaky", 2, 1), [
        _finish("Failed"), _finish("Succeeded"), _finish("Succeeded")]),
    # An overshoot pod still active at completion is deleted.
    "overshoot": lambda s: _job_steps(s, _job("j", 1, 1), [_overshoot]),
}


@pytest.mark.parametrize("case", sorted(JOB_CASES))
def test_job_matches_the_reference(case):
    obs = both(JOB_CASES[case])
    status = obs[-1]["jobs"][0].get("status") or {}
    if case == "completion":
        assert status["succeeded"] == 3 and status["active"] == 0
        assert status["conditions"] == [{"type": "Complete",
                                         "status": "True"}]
        assert status["completionTime"] == T0
        assert len(obs[-1]["pods"]) <= 5
        assert [len(o["pods"]) for o in obs][0] == 2
    elif case == "parallelism":
        assert len(obs[0]["pods"]) == 2
    elif case == "failed":
        assert status["failed"] == 1 and status["succeeded"] == 2
    elif case == "overshoot":
        assert status["succeeded"] == 1 and status["active"] == 0
        assert "j-overshoot" not in [p["metadata"]["name"]
                                     for p in obs[-1]["pods"]]


# -- the node controller's startup grace, the manager's expectations ------

def _ready_node(name, hb):
    cond = {"type": "Ready", "status": "True"}
    if hb is not None:
        cond["lastHeartbeatTime"] = hb
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": "8", "memory": "16Gi",
                                       "pods": "110"},
                       "conditions": [cond]}}


@pytest.mark.parametrize("hb,later", [
    (None, None),          # never heartbeated: survives the first sync
    (None, 31.0),          # ... and is condemned after the grace
    (T0 - 120.0, None),    # a stale heartbeat is condemned at once
])
def test_node_startup_grace_matches_the_reference(hb, later):
    def scenario(s):
        nc = s.ctl("node", "NodeLifecycleController", monitor_grace=30.0,
                   eviction_timeout=60.0)
        s.store.create("nodes", _ready_node("n-1", hb))
        s.feed()
        nc.sync_once()
        out = [s.snap("nodes")]
        if later is not None:
            nc.sync_once(now=T0 + later)
            out.append(s.snap("nodes"))
        return out
    obs = both(scenario)
    ready = {c["type"]: c["status"] for c in
             obs[-1]["nodes"][0]["status"]["conditions"]}["Ready"]
    assert ready == ("True" if hb is None and later is None else "Unknown")


def _rc(name="web", replicas=3):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"run": name},
                     "template": {"metadata": {"labels": {"run": name}},
                                  "spec": {"containers": [{"name": "c"}]}}}}


@pytest.mark.parametrize("case", ["overshoot", "redelete"])
def test_lagging_watch_matches_the_reference(case):
    """The pod watch never delivers between syncs: the expectations keep
    the manager from creating or deleting twice."""
    def scenario(s):
        rm = s.ctl("replication", "ReplicationManager", feed=False)
        rc = _rc(replicas=3 if case == "overshoot" else 1)
        s.store.create("replicationcontrollers", rc)
        rm._on_rc("replicationcontrollers", "ADDED", rc)
        if case == "redelete":
            for i in range(3):
                pod = _pod(f"web-{i}", labels={"run": "web"})
                s.store.create("pods", pod)
                rm._on_pod("ADDED", pod)
        out = []
        for _ in range(3):
            rm.sync_all()
            out.append(s.names())
        return out
    got = both(scenario)
    assert [len(n) for n in got] == ([3] * 3 if case == "overshoot"
                                     else [1] * 3)

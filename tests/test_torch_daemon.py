"""The PyTorch port's scheduler daemon (``kubernetes_tpu_torch.scheduler``)
on the CPU.

Three groups:

* the port's FIFO, backoff, ``schedule_one`` state machine, batched
  drain, run loop and drain padding, mirroring ``tests/test_daemon.py``;
* the JAX ``Scheduler`` and the port's on the same synthetic rig and
  queue, through each route of ``DrainPipeline._dispatch`` (pow2 bucket,
  chunked stream, one-shot, gang one-shot): bindings, the round-robin
  counter, every pod's events and the PodScheduled condition writes
  exactly equal;
* both packages' ``ConfigFactory`` over their own ``MemStore`` holding
  the same objects: every pod's ``spec.nodeName`` equal.

Every daemon and factory is stopped in a ``finally``, and every wait has a
deadline that fails the test."""

from __future__ import annotations

import time

import pytest

from helpers import make_node, make_pod
from kubernetes_tpu.api import types as r_api
from kubernetes_tpu.perf import synth as r_synth
from kubernetes_tpu_torch.api import types as t_api
from kubernetes_tpu_torch.engine.generic_scheduler import GenericScheduler
from kubernetes_tpu_torch.perf import synth as t_synth
from kubernetes_tpu_torch.scheduler.backoff import PodBackoff
from kubernetes_tpu_torch.scheduler.binder import (BindConflict,
                                                   InMemoryBinder)
from kubernetes_tpu_torch.scheduler.queue import FIFO
from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                      SchedulerConfig)
from torch_parity import daemon, outcome, to_port


def node(name, **kw):
    return to_port(make_node(name, **kw))


def pod(name, **kw):
    return to_port(make_pod(name, **kw))


def _scheduler(n_nodes=3, **cfg):
    algo = GenericScheduler(device="cpu")
    for i in range(n_nodes):
        algo.cache.add_node(node(f"n{i}"))
    return Scheduler(SchedulerConfig(algorithm=algo, async_bind=False,
                                     **cfg))


def _wait(cond, seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out after {seconds} s waiting for {what}")
        time.sleep(0.02)


# -- the port's daemon, mirroring tests/test_daemon.py ----------------------


class TestFIFO:
    def test_fifo_order_and_update_in_place(self):
        q = FIFO()
        a, b = pod("a"), pod("b")
        q.add(a)
        q.add(b)
        a2 = pod("a")
        a2.labels["v"] = "2"
        q.update(a2)
        got = q.pop()
        assert got.name == "a" and got.labels.get("v") == "2"
        assert q.pop().name == "b"

    def test_delete_skipped_at_pop(self):
        q = FIFO()
        q.add(pod("a"))
        q.add(pod("b"))
        q.delete("default/a")
        assert q.pop().name == "b"

    def test_pop_timeout_and_pop_all(self):
        q = FIFO()
        assert q.pop(timeout=0.05) is None
        for i in range(5):
            q.add(pod(f"p{i}"))
        assert [p.name for p in q.pop_all()] == [f"p{i}" for i in range(5)]
        assert len(q) == 0


class TestBackoff:
    def test_exponential_growth_capped(self):
        clock = [0.0]
        b = PodBackoff(now=lambda: clock[0])
        assert [b.get_backoff("default/p") for _ in range(8)] == \
            [1, 2, 4, 8, 16, 32, 60, 60]

    def test_gc_resets_idle_entries(self):
        clock = [0.0]
        b = PodBackoff(now=lambda: clock[0])
        b.get_backoff("default/p")
        clock[0] += 61
        b.gc()
        assert b.get_backoff("default/p") == 1.0


class TestScheduleOne:
    def test_bind_and_event(self):
        s = _scheduler()
        try:
            s.enqueue(pod("p1"))
            assert s.schedule_one(timeout=0.1)
            assert s.config.binder.bound_node("default/p1") is not None
            evs = s.config.recorder.events("default/p1")
            assert evs and evs[-1].reason == "Scheduled"
            assert s.config.metrics.e2e_scheduling_latency.count == 1
        finally:
            s.stop()

    def test_assumed_pod_visible_to_next_decision(self):
        algo = GenericScheduler(device="cpu")
        algo.cache.add_node(node("n0", milli_cpu=1000))
        algo.cache.add_node(node("n1", milli_cpu=1000))
        s = Scheduler(SchedulerConfig(algorithm=algo, async_bind=False))
        try:
            s.enqueue(pod("p1", cpu="800m"))
            s.enqueue(pod("p2", cpu="800m"))
            assert s.schedule_one(0.1) and s.schedule_one(0.1)
            b = s.config.binder
            assert b.bound_node("default/p1") != b.bound_node("default/p2")
        finally:
            s.stop()

    def test_unschedulable_gets_event_and_requeue(self):
        s = _scheduler(n_nodes=1)
        try:
            s.enqueue(pod("big", cpu="64"))
            assert s.schedule_one(timeout=0.1)
            evs = s.config.recorder.events("default/big")
            assert evs and evs[-1].reason == "FailedScheduling"
            # Requeued after the ~1 s backoff.
            _wait(lambda: len(s.queue) == 1, 5.0, "the backoff requeue")
        finally:
            s.stop()

    def test_bind_conflict_forgets_assumed_pod(self):
        class RejectingBinder(InMemoryBinder):
            def bind(self, pod, node_name):
                raise BindConflict("already bound")

        algo = GenericScheduler(device="cpu")
        algo.cache.add_node(node("n0"))
        s = Scheduler(SchedulerConfig(algorithm=algo,
                                      binder=RejectingBinder(),
                                      async_bind=False))
        try:
            s.enqueue(pod("p1"))
            assert s.schedule_one(timeout=0.1)
            assert algo.cache.pod_count() == 0
            evs = s.config.recorder.events("default/p1")
            assert evs and evs[-1].reason == "FailedScheduling"
        finally:
            s.stop()

    def test_multi_scheduler_annotation_dispatch(self):
        s = _scheduler()
        try:
            other = pod("other")
            other.annotations[t_api.SCHEDULER_NAME_ANNOTATION_KEY] = \
                "my-scheduler"
            s.enqueue(other)
            assert len(s.queue) == 0
            s.enqueue(pod("mine"))
            assert len(s.queue) == 1
        finally:
            s.stop()


class TestBatchedDrain:
    def test_schedule_pending_places_all(self):
        s = _scheduler(n_nodes=4)
        try:
            for i in range(12):
                s.enqueue(pod(f"p{i}"))
            assert s.schedule_pending() == 12
            assert s.config.binder.count() == 12
            nodes = {s.config.binder.bound_node(f"default/p{i}")
                     for i in range(12)}
            assert len(nodes) == 4
        finally:
            s.stop()

    def test_run_loop_drains_queue(self):
        s = _scheduler(n_nodes=2)
        try:
            s.run(batched=True)
            for i in range(6):
                s.enqueue(pod(f"p{i}"))
            _wait(lambda: s.config.binder.count() == 6, 20.0,
                  "the run loop to bind 6 pods")
        finally:
            s.stop()

    def test_metrics_exposition_format(self):
        s = _scheduler()
        try:
            s.enqueue(pod("p1"))
            s.schedule_one(timeout=0.1)
            text = s.config.metrics.expose()
            assert "scheduler_e2e_scheduling_latency_microseconds_bucket" \
                in text
            assert 'le="1000"' in text and 'le="+Inf"' in text
        finally:
            s.stop()

    def test_padding_is_decision_neutral(self):
        """Small drains pad to power-of-two buckets; pad pods are
        infeasible everywhere and change no real pod's placement."""
        algo = GenericScheduler(device="cpu")
        for i in range(5):
            algo.cache.add_node(node(f"n{i}", milli_cpu=2000))
        bare = algo.schedule_batch([pod(f"q{i}", cpu="300m")
                                    for i in range(11)])
        s = _scheduler(n_nodes=0)
        try:
            for i in range(5):
                s.config.algorithm.cache.add_node(node(f"n{i}",
                                                       milli_cpu=2000))
            for i in range(11):
                s.enqueue(pod(f"q{i}", cpu="300m"))
            assert s.schedule_pending() == 11
            b = s.config.binder
            assert [b.bound_node(f"default/q{i}") for i in range(11)] == bare
            assert b.count() == 11
            assert s.config.algorithm.cache.pod_count() == 11
        finally:
            s.stop()

    def test_flight_recorder_explains_a_failed_drain(self):
        s = _scheduler(n_nodes=2)
        try:
            s.enqueue(pod("ok"))
            s.enqueue(pod("huge", cpu="64"))
            assert s.schedule_pending() == 2
            rec = s.config.flight_recorder.explain("default/huge")
            assert rec is not None and rec["result"] == "unschedulable"
            assert s.config.flight_recorder.explain(
                "default/ok")["result"] == "scheduled"
        finally:
            s.stop()


# -- the JAX daemon and the port's, route by route ---------------------------

def _gang_pods(synth_mod, api_mod, n: int) -> list:
    """``n`` mixed pods, then a feasible gang of 3 and a gang of 2 whose
    second member fits nowhere (rejected atomically)."""
    pods = synth_mod.make_pods(n, profile="mixed", n_services=4)
    for name, cpus in (("duo", ("100m",) * 3), ("short", ("100m", "512"))):
        for i, cpu in enumerate(cpus):
            pods.append(api_mod.Pod(
                name=f"{name}-{i}", namespace="default",
                annotations={api_mod.GANG_ANNOTATION_KEY: name,
                             api_mod.GANG_SIZE_ANNOTATION_KEY:
                                 str(len(cpus))},
                containers=[api_mod.Container(
                    name="c", requests={"cpu": cpu})]))
    return pods


# route -> (daemon attributes, mixed pods); every queue also carries one
# pod that fits nowhere.
ROUTES = {
    "pow2_bucket": ({}, 20),
    "stream_chunks": ({"STREAM_THRESHOLD": 16, "stream_chunk": 16}, 40),
    "oneshot": ({"_PAD_LIMIT": 32}, 40),
    "gang_oneshot": ({}, 12),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_reference_and_port_daemons_decide_alike(route):
    attrs, n = ROUTES[route]
    results = {}
    for side, synth_mod, api_mod in (("ref", r_synth, r_api),
                                     ("port", t_synth, t_api)):
        d = daemon(side, 24, **attrs)
        try:
            taken = []
            for mode in ("_solve_stream", "_solve_oneshot"):
                real = getattr(d.pipeline, mode)

                def spy(*a, _real=real, _mode=mode, **kw):
                    taken.append((_mode, kw.get("chunk_size")))
                    return _real(*a, **kw)
                setattr(d.pipeline, mode, spy)
            pods = _gang_pods(synth_mod, api_mod, n) \
                if route == "gang_oneshot" else \
                synth_mod.make_pods(n, profile="mixed", n_services=4)
            pods.append(api_mod.Pod(
                name="huge", namespace="default",
                containers=[api_mod.Container(
                    name="c", requests={"cpu": "512"})]))
            for p in pods:
                d.enqueue(p)
            assert d.schedule_pending(wait_first=False) == len(pods)
            results[side] = (taken, outcome(d, [p.key for p in pods]))
        finally:
            d.stop()
    want_mode = {"pow2_bucket": [("_solve_stream", 32)],
                 "stream_chunks": [("_solve_stream", None)],
                 "oneshot": [("_solve_oneshot", None)],
                 "gang_oneshot": [("_solve_oneshot", None)]}[route]
    assert results["ref"][0] == results["port"][0] == want_mode
    ref, port = results["ref"][1], results["port"][1]
    assert port["bound"] == ref["bound"]
    assert port["counter"] == ref["counter"]
    assert port["events"] == ref["events"]
    assert port["conditions"] == ref["conditions"]
    assert len(ref["bound"]) >= n - 2
    assert ref["conditions"] and \
        any(k == "default/huge" for k, _, _ in ref["conditions"])
    if route == "gang_oneshot":
        assert all(f"default/duo-{i}" in port["bound"] for i in range(3))
        assert not any(f"default/short-{i}" in port["bound"]
                       for i in range(2))


def test_stream_route_commits_through_the_overlapped_worker():
    """The streamed route with the commit worker (KT_PIPELINE_WINDOW's
    default 2) against the synchronous commit (window 0): same
    decisions."""
    out = {}
    for window in (0, 2):
        d = daemon("port", 24, STREAM_THRESHOLD=16, stream_chunk=16,
                   pipeline_window=window)
        try:
            pods = t_synth.make_pods(48, profile="mixed", n_services=4)
            for p in pods:
                d.enqueue(p)
            d.schedule_pending(wait_first=False)
            out[window] = outcome(d, [p.key for p in pods])
            assert (d._commit_pool is not None) == (window > 0)
        finally:
            d.stop()
    assert out[0] == out[2]


# -- both factories over their own MemStore ---------------------------------

def test_factories_bind_every_pod_alike():
    from kubernetes_tpu.apiserver.memstore import MemStore as RStore
    from kubernetes_tpu.scheduler.factory import ConfigFactory as RFactory
    from kubernetes_tpu_torch.apiserver.memstore import MemStore as TStore
    from kubernetes_tpu_torch.scheduler.factory import \
        ConfigFactory as TFactory
    nodes = r_synth.make_nodes(16, profile="mixed")
    pods = r_synth.make_pods(40, profile="mixed", n_services=4)
    pods.append(r_api.Pod(name="huge", namespace="default",
                          containers=[r_api.Container(
                              name="c", requests={"cpu": "512"})]))
    got = {}
    for side, store, factory_cls, kw in (
            ("ref", RStore(), RFactory, {}),
            ("port", TStore(), TFactory, {"device": "cpu"})):
        for nd in nodes:
            store.create("nodes", r_api.node_to_json(nd))
        for p in pods:
            store.create("pods", r_api.pod_to_json(p))
        f = factory_cls(store, **kw)
        try:
            f.run()

            def settled():
                objs = store.list("pods")[0]
                bound = sum(bool((o.get("spec") or {}).get("nodeName"))
                            for o in objs)
                return bound == len(pods) - 1

            _wait(settled, 60.0, f"the {side} factory to bind")
            assert f.last_recovery is not None
            got[side] = {
                f"{o['metadata']['namespace']}/{o['metadata']['name']}":
                    (o.get("spec") or {}).get("nodeName") or ""
                for o in store.list("pods")[0]}
        finally:
            f.stop()
    assert got["port"] == got["ref"]
    assert got["port"]["default/huge"] == ""


# -- prewarm and the kernel-build watchdog -----------------------------------

def test_prewarm_runs_its_plan_and_arms_the_build_watchdog():
    from kubernetes_tpu_torch.engine import devicestats
    d = daemon("port", 16, floor=16, _PAD_LIMIT=64)
    try:
        plan = d.prewarm_plan()
        assert plan == ["oneshot_topo@16", "scan_chunk@16", "scan_chunk@32",
                        "scan_chunk@64", "select_hosts@1", "select_rows@1",
                        "topo_planes", "victim_solve"]
        timings = d.prewarm()
        assert sorted(timings) == [16, 32, 64]
        # On the CPU nothing is built and select_rows has no launch.
        assert sorted(d.prewarm_cache_stats) == \
            [k for k in plan if k != "select_rows@1"]
        assert all(v["builds"] == 0 for v in d.prewarm_cache_stats.values())
        before = devicestats.post_prewarm_compiles()
        with devicestats.live_path("stream"):
            devicestats.record_build(0.5)
        assert devicestats.post_prewarm_compiles() == before + 1
        devicestats.disarm()
        devicestats.record_build(0.5)
        assert devicestats.post_prewarm_compiles() == before + 1
        # Prewarm leaves no state behind but the round-robin counter (its
        # warm pods place, as the JAX package's do): a warmed daemon
        # decides as a cold one started at that counter.
        counter = d.config.algorithm.last_node_index
        pods = t_synth.make_pods(20, profile="mixed", n_services=4)
        for p in pods:
            d.enqueue(p)
        d.schedule_pending(wait_first=False)
        cold = daemon("port", 16, floor=16, _PAD_LIMIT=64)
        cold.config.algorithm.last_node_index = counter
        try:
            for p in t_synth.make_pods(20, profile="mixed", n_services=4):
                cold.enqueue(p)
            cold.schedule_pending(wait_first=False)
            assert cold.config.binder._bound == d.config.binder._bound
        finally:
            cold.stop()
    finally:
        devicestats.disarm()
        d.stop()


def test_factory_refuses_what_later_slices_bring(monkeypatch):
    """Nothing is refused any more: an HTTP source becomes a rate-limited
    APIClient with the wire binder, and each deployment mode the last
    slice brought (the solver-service client, KT_HA_SHARDS, KT_TENANTS,
    KT_DEFRAG, KT_VERIFY_PERIOD) constructs and runs on a MemStore with
    device="cpu", binding the pods it is given."""
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.client.http import APIClient
    from kubernetes_tpu_torch.scheduler.binder import APIClientBinder
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    from kubernetes_tpu_torch.tenancy.service import (ServiceEngine,
                                                      SolverService)
    # An HTTP source: a URL becomes a rate-limited APIClient with the
    # wire binder (nothing is contacted before run()).
    f = ConfigFactory("http://127.0.0.1:1", device="cpu", qps=7, burst=9)
    try:
        assert isinstance(f.store, APIClient)
        assert f.store.limiter.qps == 7 and f.store.limiter.burst == 9
        assert isinstance(f.daemon.config.binder, APIClientBinder)
    finally:
        f.stop()

    def bind_all(store, f, ns: str, n: int = 6) -> None:
        for i in range(n):
            store.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": ns},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": "100m"}}}]}})
        f.run()
        _wait(lambda: all(store.get("pods", f"{ns}/p{i}")["spec"]
                          .get("nodeName") for i in range(n)),
              30, f"{ns} pods bound")

    def fresh_store():
        store = MemStore()
        for i in range(3):
            store.create("nodes", {
                "metadata": {"name": f"n{i}", "labels": {
                    "kubernetes.io/hostname": f"n{i}"}},
                "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                           "pods": "110"},
                           "conditions": [{"type": "Ready",
                                           "status": "True"}]}})
        return store

    # The solver-service client mode: no device of its own.
    host_store = fresh_store()
    host = ConfigFactory(host_store, device="cpu")
    client = ConfigFactory(host_store, device="cpu", tenant="t-a",
                           solver_service=SolverService(
                               engine=host.algorithm, tenants=["t-a"]))
    try:
        assert isinstance(client.algorithm, ServiceEngine)
        host.run()
        bind_all(host_store, client, "t-a")
    finally:
        client.stop()
        host.stop()
    # Active-active HA, one incarnation holding every shard.
    store = fresh_store()
    f = ConfigFactory(store, device="cpu", ha_shards=2, incarnation="i0")
    try:
        assert f.shards is not None and f.daemon.owns_pod is not None
        bind_all(store, f, "ha")
        _wait(lambda: f.shards.owned() == frozenset({0, 1}), 30,
              "the lone incarnation to hold both shards")
    finally:
        f.stop()
    # The multi-tenant solver service, the defragmenter, the verifier.
    for knob, value in (("KT_TENANTS", "t-a,t-b"), ("KT_DEFRAG", "1"),
                        ("KT_VERIFY_PERIOD", "0.2")):
        monkeypatch.setenv(knob, value)
        store = fresh_store()
        f = ConfigFactory(store, device="cpu")
        try:
            bind_all(store, f, "t-b")
            assert {"KT_TENANTS": f.tenancy, "KT_DEFRAG": f.defrag,
                    "KT_VERIFY_PERIOD": f.verifier}[knob] is not None
        finally:
            f.stop()
        monkeypatch.delenv(knob)


def test_factory_freezes_its_startup_heap_until_stop():
    """``run()`` collects and freezes the startup heap before the drain
    loop starts (a generation-2 collection then skips it); ``stop()``
    unfreezes it."""
    import gc

    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    gc.unfreeze()
    f = ConfigFactory(MemStore(), device="cpu")
    try:
        assert gc.get_freeze_count() == 0
        f.run()
        assert gc.get_freeze_count() > 0
    finally:
        f.stop()
    assert gc.get_freeze_count() == 0

"""The PyTorch port's active-active HA (``kubernetes_tpu_torch.scheduler.
shards`` and its daemon wiring) against the JAX package's, on the CPU.

* the shard map: ``shard_of`` equal over 10,000 namespaces at several
  shard counts, and the lease object names;
* ``ShardManager`` over each package's ``MemStore`` (the leases are
  ``APIResourceLock`` annotations there) with a stepped clock: the
  sequence of owned sets, handoff counts and ownership callbacks tick by
  tick, for a split, a takeover after a SIGKILL, a graceful release, a
  late joiner fed by rebalancing and a dead peer pruned from presence;
* the daemon-side gates: the queue feed and the backoff requeue worker
  drop unowned pods, the queue and the cache shed a lost shard, and the
  takeover / sweep reconcile reports equal on the same store;
* two port incarnations over one HTTP apiserver on the CPU: every pod
  bound exactly once, before and after one incarnation is killed.

Leases are driven by an injected clock everywhere but the last group,
which has no timing bar."""

from __future__ import annotations

import threading
import time

import pytest

from kubernetes_tpu.apiserver.memstore import MemStore as RStore
from kubernetes_tpu.scheduler import recovery as r_recovery
from kubernetes_tpu.scheduler import shards as r_shards
from kubernetes_tpu_torch.apiserver.memstore import MemStore as TStore
from kubernetes_tpu_torch.scheduler import recovery as t_recovery
from kubernetes_tpu_torch.scheduler import shards as t_shards


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- the shard map -----------------------------------------------------------


@pytest.mark.parametrize("n_shards", [0, 1, 2, 8, 13])
def test_shard_of_equals_the_reference(n_shards):
    names = [f"ns-{i}" for i in range(10_000)] + \
        ["", "default", "kube-system", "t-a", "ünïcode-ns"]
    assert [t_shards.shard_of(ns, n_shards) for ns in names] == \
        [r_shards.shard_of(ns, n_shards) for ns in names]


def test_shard_lock_names_equal():
    assert [t_shards.shard_lock_name(i) for i in range(16)] == \
        [r_shards.shard_lock_name(i) for i in range(16)]
    assert t_shards.SHARD_LOCK_PREFIX == r_shards.SHARD_LOCK_PREFIX


# -- ShardManager with a stepped clock ---------------------------------------


class _Run:
    """One package's managers over one store and one clock; ``log``
    records, after every tick round, each manager's owned set and
    handoff count, and every ownership callback as it is delivered."""

    def __init__(self, mod, store_cls, n_shards: int, lease: float = 2.0):
        self.mod = mod
        self.store = store_cls()
        self.clock = FakeClock()
        self.n_shards = n_shards
        self.lease = lease
        self.managers: list = []
        self.log: list = []

    def add(self, ident: str):
        def acquired(shard, handoff, ident=ident):
            self.log.append(("acquired", ident, shard, handoff))

        def lost(shard, ident=ident):
            self.log.append(("lost", ident, shard))

        m = self.mod.ShardManager(
            self.store, incarnation=ident, n_shards=self.n_shards,
            lease_duration=self.lease,
            renew_deadline=self.lease * 2 / 3,
            retry_period=self.lease / 8, jitter=0.0, now=self.clock,
            on_acquired=acquired, on_lost=lost)
        self.managers.append(m)
        return m

    def settle(self, live: list, rounds: int, step: float = 0.3) -> None:
        for _ in range(rounds):
            for m in live:
                m.tick()
                # Deliver the queued callbacks in order, on this thread
                # (no callback thread runs here).
                while m._callbacks:
                    cb, args = m._callbacks.pop(0)
                    cb(*args)
            self.clock.advance(step)
            self.log.append(tuple(
                (m.incarnation, tuple(sorted(m.owned())), m.handoffs)
                for m in self.managers))


def _split(run):
    ms = [run.add(i) for i in ("a", "b", "c")]
    run.settle(ms, 64)
    return ms


def _takeover(run):
    a, b, c = _split(run)
    a.abandon()
    run.settle([b, c], 32, step=0.25)
    return [b, c]


def _graceful(run):
    a, b = run.add("a"), run.add("b")
    run.settle([a, b], 32)
    a.stop()
    run.settle([b], 24)
    return [b]


def _late_joiner(run):
    early = run.add("early")
    run.settle([early], 24)
    late = run.add("late")
    run.settle([early, late], 96)
    return [early, late]


def _dead_peer(run):
    a, b = run.add("a"), run.add("b")
    run.settle([a, b], 48)
    b.abandon()
    run.settle([a], 120)
    return [a]


SCENARIOS = {"split": (_split, 8), "takeover": (_takeover, 6),
             "graceful": (_graceful, 4), "late_joiner": (_late_joiner, 4),
             "dead_peer": (_dead_peer, 4)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_shard_manager_sequence_equals_the_reference(name):
    fn, n_shards = SCENARIOS[name]
    ref = _Run(r_shards, RStore, n_shards)
    port = _Run(t_shards, TStore, n_shards)
    ref_live = fn(ref)
    port_live = fn(port)
    assert port.log == ref.log
    assert [m.report() for m in port_live] == \
        [m.report() for m in ref_live]
    # The end state is whole and disjoint on both sides.
    owned = [set(m.owned()) for m in port_live]
    assert set().union(*owned) == set(range(n_shards))
    assert sum(len(o) for o in owned) == n_shards


def test_dead_peer_is_pruned_from_presence_as_the_reference_prunes():
    tables = []
    for mod, store_cls in ((r_shards, RStore), (t_shards, TStore)):
        run = _Run(mod, store_cls, 4)
        _dead_peer(run)
        raw = run.store.get("endpoints",
                            "kube-system/kube-scheduler-incarnations")
        ann = raw["metadata"]["annotations"]
        tables.append(sorted(__import__("json").loads(
            next(iter(ann.values())))))
    assert tables[0] == tables[1] == ["a"]


# -- the daemon-side gates ---------------------------------------------------


def _daemon(side: str):
    if side == "ref":
        from kubernetes_tpu.engine.generic_scheduler import GenericScheduler
        from kubernetes_tpu.scheduler.scheduler import (Scheduler,
                                                        SchedulerConfig)
        eng = GenericScheduler()
    else:
        from kubernetes_tpu_torch.engine.generic_scheduler import \
            GenericScheduler
        from kubernetes_tpu_torch.scheduler.scheduler import (
            Scheduler, SchedulerConfig)
        eng = GenericScheduler(device="cpu")
    return Scheduler(SchedulerConfig(algorithm=eng, async_bind=False))


def _api(side: str):
    if side == "ref":
        from kubernetes_tpu.api import types
    else:
        from kubernetes_tpu_torch.api import types
    return types


def _pod(side: str, name: str, ns: str):
    api = _api(side)
    return api.Pod(name=name, namespace=ns, containers=[api.Container(
        name="c", requests={"cpu": "10m", "memory": "16Mi"})])


def _node(side: str, name: str):
    api = _api(side)
    return api.Node(name=name, allocatable_milli_cpu=32000,
                    allocatable_memory=64 << 30, allocatable_pods=110,
                    conditions=[api.NodeCondition("Ready", "True")])


def _pod_json(name: str, ns: str) -> dict:
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {"cpu": "10m"}}}]}}


def _gates(side: str) -> dict:
    """Queue feed, queue shed, cache shed and owns_pod on one daemon."""
    d = _daemon(side)
    try:
        n = 8
        mod = r_shards if side == "ref" else t_shards
        owned = {0, 3, 5}
        d.owns_pod = lambda p: mod.shard_of(p.namespace, n) in owned
        names = [f"ns-{i}" for i in range(24)]
        keys = [f"{ns}/p{i}" for i, ns in enumerate(names)]
        for i, ns in enumerate(names):
            d.enqueue(_pod(side, f"p{i}", ns))
        queued = [k for k in keys if k in d.queue]
        cache = d.config.algorithm.cache
        cache.add_node(_node(side, "n1"))
        for i, ns in enumerate(names):
            cache.assume_pod(_pod(side, f"a{i}", ns), "n1")
        bound = _pod(side, "bound", names[0])
        bound.node_name = "n1"
        cache.add_pod(bound)
        lost = 3
        dropped = d.queue.delete_matching(
            lambda p: mod.shard_of(p.namespace, n) == lost)
        forgotten = cache.forget_pods_matching(
            lambda p: mod.shard_of(p.namespace, n) == lost)
        return {"queued": queued, "dropped": dropped,
                "forgotten": sorted(forgotten),
                "left": [k for k in keys if k in d.queue],
                "cached": cache.pod_count()}
    finally:
        d.stop()


def test_owns_pod_filtering_equals_the_reference():
    ref, port = _gates("ref"), _gates("port")
    assert port == ref
    assert ref["queued"] and ref["dropped"] and ref["forgotten"]


def test_requeue_worker_drops_pods_of_lost_shards():
    from kubernetes_tpu_torch.scheduler.backoff import PodBackoff
    d = _daemon("port")
    try:
        d.backoff = PodBackoff(default_duration=0.05, max_duration=0.05)
        owned = {"mine"}
        d.owns_pod = lambda p: p.namespace in owned
        keep, drop = _pod("port", "keep", "mine"), _pod("port", "drop",
                                                        "mine")
        d._handle_failure(keep, "FailedScheduling", "test")
        d._handle_failure(drop, "FailedScheduling", "test")
        drop.namespace = "moved"  # its shard moved while in backoff
        deadline = time.monotonic() + 10
        while "mine/keep" not in d.queue:
            assert time.monotonic() < deadline, "keep never requeued"
            time.sleep(0.01)
        with d._requeue_cv:
            while d._requeue_heap:
                assert time.monotonic() < deadline, "heap never drained"
                d._requeue_cv.wait(0.05)
        assert "moved/drop" not in d.queue and len(d.queue) == 1
    finally:
        d.stop()


def _reconcile(side: str) -> list[dict]:
    """The sweep (age-gated) and the takeover (acquisition-gated)
    reconcile over the same store contents, as both packages run them."""
    d = _daemon(side)
    store = RStore() if side == "ref" else TStore()
    rec = r_recovery if side == "ref" else t_recovery
    mod = r_shards if side == "ref" else t_shards
    try:
        cache = d.config.algorithm.cache
        cache.add_node(_node(side, "n1"))
        for i in range(12):
            ns = f"ns-{i % 5}"
            store.create("pods", _pod_json(f"pend-{i}", ns))
            if i % 3 == 0:
                cache.assume_pod(_pod(side, f"pend-{i}", ns), "n1")
            elif i % 4 == 1:
                # A leaked assume, older than the sweep's age gate.
                cache.assume_pod(_pod(side, f"pend-{i}", ns), "n1")
                cache._pod_states[f"{ns}/pend-{i}"].deadline -= 10.0
        for i in range(4):
            store.create("pods", _pod_json(f"bound-{i}", "ns-1"))
            store.bind("ns-1", f"bound-{i}", "n1")
        reports = []
        sweep = rec.reconcile_shard(d, store, -1, lambda ns: True,
                                    min_assume_age_s=3.0)
        reports.append(sweep)
        owns = (lambda s: lambda ns: mod.shard_of(ns, 4) == s)
        for shard in range(4):
            reports.append(rec.reconcile_shard(
                d, store, shard, owns(shard),
                assumed_before=time.monotonic() + 1.0))
        for r in reports:
            r.pop("duration_s")
        keys = [f"ns-{i % 5}/pend-{i}" for i in range(12)] + \
            [f"ns-1/bound-{i}" for i in range(4)]
        reports.append({"queue": [k for k in keys if k in d.queue],
                        "assumed": sorted(
                            k for k, _, a in cache.tracked_pods() if a)})
        return reports
    finally:
        d.stop()


def test_takeover_reconcile_report_equals_the_reference():
    ref, port = _reconcile("ref"), _reconcile("port")
    assert port == ref
    assert ref[0]["expired"] and ref[0]["requeued"]


def _takeover_rig(side: str, d, store) -> list[str]:
    """Pending pods in 5 namespaces on ``store``, some assumed on ``d``'s
    cache, a few bound; returns the keys."""
    cache = d.config.algorithm.cache
    cache.add_node(_node(side, "n1"))
    for i in range(12):
        ns = f"ns-{i % 5}"
        store.create("pods", _pod_json(f"pend-{i}", ns))
        if i % 3 == 0:
            cache.assume_pod(_pod(side, f"pend-{i}", ns), "n1")
    for i in range(4):
        store.create("pods", _pod_json(f"bound-{i}", "ns-1"))
        store.bind("ns-1", f"bound-{i}", "n1")
    return [f"ns-{i % 5}/pend-{i}" for i in range(12)] + \
        [f"ns-1/bound-{i}" for i in range(4)]


def test_takeovers_share_one_relist_and_report_as_the_reference(
        monkeypatch):
    """Three shards acquired together: the port's factory reconciles all
    of them from one relist, on the first callback, with the reports,
    queue and assumes of the reference's per-shard reconciles; the later
    callbacks only set their handoff flag; a re-acquired shard relists
    again."""
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    cut = time.monotonic() + 1.0
    d = _daemon("ref")
    store = RStore()
    try:
        keys = _takeover_rig("ref", d, store)
        ref = [r_recovery.reconcile_shard(
            d, store, s, lambda ns, s=s: r_shards.shard_of(ns, 4) == s,
            assumed_before=cut) for s in range(3)]
        ref_state = ([k for k in keys if k in d.queue], sorted(
            k for k, _, a in d.config.algorithm.cache.tracked_pods() if a))
    finally:
        d.stop()
    store = TStore()
    f = ConfigFactory(store, device="cpu", ha_shards=4, incarnation="t")
    lists = []
    real = t_recovery.list_pending
    monkeypatch.setattr(t_recovery, "list_pending",
                        lambda st: lists.append(1) or real(st))
    try:
        keys = _takeover_rig("port", f.daemon, store)
        f.shards._owned = {0, 1, 2}
        f.shards._acquired_at = {0: cut, 1: cut, 2: cut}
        for s, handoff in ((0, True), (1, False), (2, True)):
            f._on_shard_acquired(s, handoff)
        port = [dict(r) for r in f.shard_recoveries]
        cache = f.daemon.config.algorithm.cache
        port_state = ([k for k in keys if k in f.daemon.queue], sorted(
            k for k, _, a in cache.tracked_pods() if a))
        assert len(lists) == 1
        assert [r.pop("handoff") for r in port] == [True, False, True]
        for r in port + ref:
            r.pop("duration_s")
        assert port == ref and port_state == ref_state
        assert sum(r["requeued"] for r in ref) > 0
        f.shards._acquired_at[1] = cut + 1.0
        f._on_shard_acquired(1, True)
        assert len(lists) == 2 and f.shard_recoveries[-1]["shard"] == 1
    finally:
        f.daemon.stop()


# -- two port incarnations over HTTP -----------------------------------------


def test_two_incarnations_over_http_bind_every_pod_once(monkeypatch):
    """Both incarnations schedule, one is killed mid-run, and the
    survivor converges: every pod bound, none bound twice, none moved."""
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.client.http import APIClient
    from kubernetes_tpu_torch.scheduler.backoff import PodBackoff
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    lease = 0.4
    monkeypatch.setenv("KT_HA_LEASE_S", str(lease))
    monkeypatch.setenv("KT_HA_RENEW_S", str(lease * 0.75))
    monkeypatch.setenv("KT_HA_RETRY_S", str(lease / 8))
    store = TStore()
    srv = serve(store)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    direct = APIClient(url, qps=0)
    for i in range(4):
        direct.create("nodes", {
            "metadata": {"name": f"ha-n{i}",
                         "labels": {"kubernetes.io/hostname": f"ha-n{i}"}},
            "status": {"allocatable": {"cpu": "32", "memory": "64Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}})
    binds: dict[str, list] = {}
    watcher = store.watch(["pods"], from_rv=store.list("pods")[1])
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            ev = watcher.next(timeout=0.2)
            if ev is None or ev.type == "DELETED":
                continue
            node = (ev.object.get("spec") or {}).get("nodeName") or ""
            seen = binds.setdefault(ev.key, [])
            if node and (not seen or seen[-1] != node):
                seen.append(node)
    t = threading.Thread(target=pump, daemon=True)
    t.start()
    factories = []
    try:
        for i in range(2):
            f = ConfigFactory(url, qps=0, ha_shards=4,
                              incarnation=f"inc-{i}", device="cpu")
            f.daemon.backoff = PodBackoff(default_duration=0.05,
                                          max_duration=0.5)
            factories.append(f)
        for f in factories:
            f.run()
        deadline = time.monotonic() + 60
        while not all(f.shards.owned() for f in factories) or \
                set().union(*[f.shards.owned() for f in factories]) != \
                set(range(4)):
            assert time.monotonic() < deadline, "shards never balanced"
            time.sleep(0.02)
        namespaces = [f"e2e-ns-{i}" for i in range(8)]
        keys = []
        for i in range(40):
            ns = namespaces[i % 8]
            direct.create("pods", _pod_json(f"pod-{i}", ns))
            keys.append(f"{ns}/pod-{i}")
            if i == 20:
                factories[0].abandon()
        survivor = factories[1]
        while set(survivor.shards.owned()) != set(range(4)):
            assert time.monotonic() < deadline, "survivor never took over"
            time.sleep(0.02)
        while not all((store.get("pods", k)["spec"].get("nodeName"))
                      for k in keys):
            assert time.monotonic() < deadline, "pods never bound"
            time.sleep(0.05)
        time.sleep(0.3)
        assert all(len(binds.get(k, [])) == 1 for k in keys), \
            {k: v for k, v in binds.items() if len(v) != 1}
        assert survivor.shards.handoffs >= 1
    finally:
        stop.set()
        for f in factories:
            try:
                f.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        watcher.stop()
        srv.shutdown()


def test_ha_takeover_summary_reads_the_window_after_the_kill():
    """``perf/ha_takeover.summarize``: the longest collection, lease round
    trip and tick of each incarnation from 0.2 s before the kill to a
    second after it, and the relists with their start after the kill."""
    from kubernetes_tpu_torch.perf.ha_takeover import SITE, summarize
    compile(SITE, "sitecustomize.py", "exec")
    recs = {"inc-1": [
        {"ev": "gc", "gen": 2, "d": 0.9, "t": 9.0},
        {"ev": "gc", "gen": 0, "d": 0.02, "t": 10.1},
        {"ev": "try", "s": 3, "d": 0.2, "t": 10.5},
        {"ev": "tick", "start": 10.3, "d": 0.3, "t": 10.6},
        {"ev": "relist", "start": 10.4, "n": 1956, "d": 0.1, "t": 10.5},
        {"ev": "try", "s": 3, "d": 0.5, "t": 11.5}],
        "inc-2": []}
    assert summarize(recs, 10.0) == {
        "inc-1": {"gc_max_s": 0.02, "round_trip_max_s": 0.2,
                  "tick_max_s": 0.3, "relists": [(0.4, 1956, 0.1)]},
        "inc-2": {"gc_max_s": 0.0, "round_trip_max_s": 0.0,
                  "tick_max_s": 0.0, "relists": []}}

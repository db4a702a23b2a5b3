"""The port's scheduler daemon over HTTP, on the CPU.

* Pods created before the daemon starts (``mixed`` 64 x 300 and ``rich``
  32 x 128): the reflector's first list sets the queue order, so
  sequential greedy is deterministic whatever chunks the batch former
  cuts.  The port's ``ConfigFactory(url, device="cpu")`` against the
  port's apiserver must bind every pod as the JAX ``ConfigFactory``
  does against the JAX apiserver, and as the port's factory over a
  ``MemStore``; the events its batch sink posts must have the same
  reasons and counts.
* Unschedulable, then capacity frees (``tests/test_http_wire.py``'s
  case): the PodScheduled=False condition is posted over the wire, and
  the pod binds once a big node appears.
* Leader election (``tests/test_leaderelection_ha.py``'s cases, against
  the port's ``utils/leaderelection.py``): clock-driven expiry, the CAS
  of ``APIResourceLock`` on a ``MemStore`` and over HTTP (two electors
  never lead at once), renew jitter, and the elector loop handing over.
* The binary: ``--serve-apiserver`` and ``--leader-elect``.

Every daemon is stopped in a ``finally`` and every wait has a deadline.
"""

from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
import threading
import time

import pytest

from kubernetes_tpu.api import types as r_api
from kubernetes_tpu.apiserver import memstore as r_memstore
from kubernetes_tpu.apiserver import server as r_server
from kubernetes_tpu.perf import synth as r_synth
from kubernetes_tpu.scheduler import factory as r_factory
from kubernetes_tpu_torch.api import types as t_api
from kubernetes_tpu_torch.apiserver import memstore as t_memstore
from kubernetes_tpu_torch.apiserver import server as t_server
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.scheduler import factory as t_factory
from kubernetes_tpu_torch.utils.leaderelection import (LEADER_ANNOTATION_KEY,
                                                       APIResourceLock,
                                                       InMemoryLock,
                                                       LeaderElectionRecord,
                                                       LeaderElector)
from torch_wire import (REPO, env, free_port, request, start_python_apiserver,
                        stop, wait_until)

RIGS = {"mixed": (64, 300), "rich": (32, 128)}


@contextlib.contextmanager
def served(memstore, server):
    store = memstore.MemStore()
    srv = server.serve(store, port=0)
    try:
        yield store, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def _seed(store, profile: str) -> int:
    n_nodes, n_pods = RIGS[profile]
    for nd in r_synth.make_nodes(n_nodes, profile=profile, n_zones=4):
        store.create("nodes", r_api.node_to_json(nd))
    for p in r_synth.make_pods(n_pods, profile=profile, n_services=4):
        store.create("pods", r_api.pod_to_json(p))
    return n_pods


def _pod_nodes(store) -> dict:
    return {f"{o['metadata']['namespace']}/{o['metadata']['name']}":
            (o.get("spec") or {}).get("nodeName") or ""
            for o in store.list("pods")[0]}


def _run(store, factory, settle) -> tuple[dict, collections.Counter]:
    """Run ``factory`` until ``settle(bound)`` holds and the events have
    landed; (pod -> node, Counter of event reasons)."""
    try:
        factory.run()
        wait_until(lambda: settle(sum(map(bool, _pod_nodes(store)
                                          .values()))),
                   90, "the daemon to bind")
        placed = _pod_nodes(store)
        n = len(placed)
        if isinstance(factory.store, t_memstore.MemStore):
            return placed, collections.Counter()

        def reasons():
            return collections.Counter(
                e.get("reason") for e in store.list("events")[0])
        wait_until(lambda: sum(reasons().values()) >= n, 60,
                   "the batch sink's events")
        return placed, reasons()
    finally:
        factory.stop()


def _stable(seconds: float = 1.0):
    """A settle test: the bound count has held still for ``seconds``."""
    last = {"n": -1, "t": time.monotonic()}

    def settle(bound: int) -> bool:
        now = time.monotonic()
        if bound != last["n"]:
            last.update(n=bound, t=now)
            return False
        return bound > 0 and now - last["t"] >= seconds
    return settle


@pytest.mark.parametrize("profile", sorted(RIGS))
def test_pods_created_first_bind_alike_over_http(profile, monkeypatch):
    # No retry of an unschedulable pod inside the test's window: each
    # gets exactly one FailedScheduling event on every side.
    monkeypatch.setenv("KT_POD_BACKOFF_S", "600")
    monkeypatch.setenv("KT_POD_BACKOFF_MAX_S", "600")
    store = t_memstore.MemStore()
    n = _seed(store, profile)
    local, _ = _run(store, t_factory.ConfigFactory(store, device="cpu"),
                    _stable())
    want = sum(map(bool, local.values()))
    assert want >= n // 2
    got = {}
    for side, memstore, server, factory_cls, kw in (
            ("port", t_memstore, t_server, t_factory.ConfigFactory,
             {"device": "cpu"}),
            ("ref", r_memstore, r_server, r_factory.ConfigFactory, {})):
        with served(memstore, server) as (st, url):
            _seed(st, profile)
            got[side] = _run(st, factory_cls(url, qps=5000, burst=5000,
                                             **kw), lambda b: b >= want)
    assert got["port"][0] == got["ref"][0] == local
    assert got["port"][1] == got["ref"][1]
    assert got["port"][1]["Scheduled"] == want
    assert got["port"][1].get("FailedScheduling", 0) == n - want


def test_unschedulable_then_capacity_frees():
    with served(t_memstore, t_server) as (store, url):
        client = APIClient(url, qps=0)
        client.create("nodes", {
            "metadata": {"name": "small",
                         "labels": {"kubernetes.io/hostname": "small"}},
            "status": {"allocatable": {"cpu": "1", "memory": "4Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}})
        f = t_factory.ConfigFactory(url, device="cpu").run()
        try:
            client.create("pods", {
                "metadata": {"name": "huge", "namespace": "default"},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": "900"}}}]}})

            def condition():
                obj = store.get("pods", "default/huge")
                assert not (obj.get("spec") or {}).get("nodeName")
                return any(c.get("type") == "PodScheduled" and
                           c.get("status") == "False"
                           for c in (obj.get("status") or {})
                           .get("conditions") or [])
            wait_until(condition, 30, "PodScheduled=False over the wire")
            client.create("nodes", {
                "metadata": {"name": "huge-node", "labels": {
                    "kubernetes.io/hostname": "huge-node"}},
                "status": {"allocatable": {"cpu": "1000", "memory": "64Gi",
                                           "pods": "110"},
                           "conditions": [{"type": "Ready",
                                           "status": "True"}]}})
            wait_until(lambda: store.get("pods", "default/huge")["spec"]
                       .get("nodeName") == "huge-node", 60,
                       "the huge pod to bind on the new node")
            # The daemon posts its events through an asynchronous batch
            # sink, after the bind the store already shows.
            wait_until(lambda: {"FailedScheduling", "Scheduled"} <= {
                e.get("reason") for e in store.list("events")[0]}, 30,
                "the FailedScheduling and Scheduled events")
        finally:
            f.stop()


# -- leader election (tests/test_leaderelection_ha.py's cases) ---------------

class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _elector(lock, ident, clock, lease=10.0):
    return LeaderElector(lock=lock, identity=ident, lease_duration=lease,
                         renew_deadline=lease * 2 / 3,
                         retry_period=lease / 10, now=clock)


class TestClockInjectedExpiry:
    def test_standby_cannot_steal_live_lease(self):
        clock = FakeClock()
        lock = InMemoryLock()
        a, b = _elector(lock, "a", clock), _elector(lock, "b", clock)
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
        assert a.is_leader() and not b.is_leader()
        clock.advance(9.99)
        assert not b.try_acquire_or_renew()
        assert not b.lease_dead()

    def test_standby_steals_exactly_at_expiry(self):
        clock = FakeClock()
        lock = InMemoryLock()
        a, b = _elector(lock, "a", clock), _elector(lock, "b", clock)
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
        clock.advance(10.0)
        assert b.lease_dead()
        assert b.try_acquire_or_renew()
        assert b.is_leader()
        assert not a.try_acquire_or_renew()
        assert not a.is_leader()

    def test_renewal_extends_the_lease(self):
        clock = FakeClock()
        lock = InMemoryLock()
        a, b = _elector(lock, "a", clock), _elector(lock, "b", clock)
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
        clock.advance(6.0)
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
        clock.advance(6.0)
        assert not b.try_acquire_or_renew()
        assert a.is_leader() and not b.is_leader()

    def test_transitions_count_only_on_holder_change(self):
        clock = FakeClock()
        lock = InMemoryLock()
        a, b = _elector(lock, "a", clock), _elector(lock, "b", clock)
        assert a.try_acquire_or_renew()
        assert a.try_acquire_or_renew()
        assert not b.try_acquire_or_renew()
        clock.advance(10.0)
        assert b.try_acquire_or_renew()
        assert b._observed.leader_transitions == 1


def _race(make_lock, rounds: int = 30) -> list[list[str]]:
    """N threads x M rounds of try_acquire_or_renew on one short-lease
    lock; the electors that believed they led after each round."""
    clock = FakeClock()
    electors = [LeaderElector(lock=make_lock(), identity=f"c{i}",
                              lease_duration=5.0, renew_deadline=3.0,
                              retry_period=0.5, now=clock)
                for i in range(4)]
    barrier = threading.Barrier(len(electors))
    leaders: list[list[str]] = [[] for _ in range(rounds)]

    def race(el: LeaderElector) -> None:
        for r in range(rounds):
            barrier.wait()
            el.try_acquire_or_renew()
            if el.is_leader():
                leaders[r].append(el.identity)
            barrier.wait()
            if r % 7 == 6 and el.identity == "c0":
                clock.advance(6.0)

    threads = [threading.Thread(target=race, args=(el,)) for el in electors]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return leaders


class TestAPIResourceLockCAS:
    def test_memstore_lock_update_is_a_real_cas(self):
        lock = APIResourceLock(t_memstore.MemStore())
        _, version = lock.get()
        assert lock.update("first", version)
        assert not lock.update("second", version)
        assert lock.get()[0] == "first"

    def test_http_lock_update_is_a_real_cas(self):
        with served(t_memstore, t_server) as (_, url):
            lock = APIResourceLock(APIClient(url, qps=0))
            _, version = lock.get()
            assert lock.update("first", version)
            assert not lock.update("second", version)
            assert lock.get()[0] == "first"

    @pytest.mark.parametrize("transport", ["memstore", "http"])
    def test_racing_acquirers_never_both_lead(self, transport):
        with served(t_memstore, t_server) as (store, url):
            if transport == "memstore":
                leaders = _race(lambda: APIResourceLock(store))
            else:
                leaders = _race(lambda: APIResourceLock(
                    APIClient(url, qps=0)), rounds=14)
        for r, names in enumerate(leaders):
            assert len(names) <= 1, f"round {r}: {names} all led"
        assert any(leaders), "nobody ever acquired the lease"


class TestRenewJitter:
    def test_jittered_sleep_stays_in_band(self):
        el = LeaderElector(lock=InMemoryLock(), identity="j",
                           retry_period=1.0, jitter=0.25)
        draws = {el._sleep() for _ in range(200)}
        assert all(1.0 <= d <= 1.25 for d in draws)
        assert len(draws) > 10

    def test_zero_jitter_is_exact(self):
        el = LeaderElector(lock=InMemoryLock(), identity="j",
                           retry_period=0.7)
        assert el._sleep() == 0.7


def test_elector_loop_hands_over_over_http():
    """Two electors' run() loops over one HTTP lock: one leads; when it
    stops renewing, the other takes over after the lease."""
    with served(t_memstore, t_server) as (store, url):
        started = {"a": threading.Event(), "b": threading.Event()}
        els = {name: LeaderElector(
            lock=APIResourceLock(APIClient(url, qps=0)), identity=name,
            lease_duration=0.6, renew_deadline=0.4, retry_period=0.05,
            on_started_leading=started[name].set)
            for name in ("a", "b")}
        els["a"].run()
        wait_until(started["a"].is_set, 10, "a to lead")
        els["b"].run()
        try:
            wait_until(lambda: els["b"].observed_holder() == "a", 10,
                       "b to observe a")
            assert not started["b"].is_set()
            els["a"].stop()
            wait_until(started["b"].is_set, 10, "b to take over")
            obj = store.get("endpoints", "kube-system/kube-scheduler")
            rec = LeaderElectionRecord.from_json(
                obj["metadata"]["annotations"][LEADER_ANNOTATION_KEY])
            assert rec.holder_identity == "b" and rec.leader_transitions == 1
        finally:
            for el in els.values():
                el.stop()


# -- the binary: --serve-apiserver and --leader-elect ------------------------

def _daemon(*flags) -> tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.scheduler", "--device",
         "cpu", "--port", "0", *flags], cwd=REPO, env=env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        return proc, json.loads(proc.stdout.readline())["port"]
    except BaseException:
        stop(proc)
        raise


def _node_and_pod(base: str, name: str) -> None:
    for kind, obj in (("nodes", t_api.node_to_json(
            r_synth.make_nodes(1, profile="mixed")[0])),
                      ("pods", {"metadata": {"name": name,
                                             "namespace": "default"},
                                "spec": {"containers": [{"name": "c"}]}})):
        status, _, body = request(base, "POST", f"/api/v1/{kind}", obj)
        assert status == 201, body


def _bound(base: str, name: str) -> bool:
    status, _, body = request(base, "GET",
                              f"/api/v1/namespaces/default/pods/{name}")
    return status == 200 and bool(json.loads(body)["spec"].get("nodeName"))


def test_the_binary_serves_its_own_apiserver():
    api_port = free_port()
    proc, _ = _daemon("--serve-apiserver", str(api_port))
    try:
        base = f"http://127.0.0.1:{api_port}"
        wait_until(lambda: _reachable(base), 30, "the in-process apiserver")
        _node_and_pod(base, "served")
        wait_until(lambda: _bound(base, "served"), 60, "the pod to bind")
    finally:
        assert stop(proc) == 0


def _reachable(base: str) -> bool:
    try:
        return request(base, "GET", "/healthz")[0] == 200
    except OSError:
        return False


def test_the_binary_leads_before_it_schedules():
    api, base = start_python_apiserver()
    try:
        proc, port = _daemon("--api-server", base, "--leader-elect",
                             "--leader-elect-lease-duration", "2",
                             "--leader-elect-renew-deadline", "1",
                             "--leader-elect-retry-period", "0.2")
        try:
            _node_and_pod(base, "led")
            wait_until(lambda: _bound(base, "led"), 60, "the pod to bind")
            status, _, body = request(
                base, "GET", "/api/v1/namespaces/kube-system/endpoints/"
                "kube-scheduler")
            rec = LeaderElectionRecord.from_json(json.loads(body)[
                "metadata"]["annotations"][LEADER_ANNOTATION_KEY])
            assert rec.holder_identity.endswith(f"-{proc.pid}")
            status, _, body = request(f"http://127.0.0.1:{port}", "GET",
                                      "/configz")
            cfg = json.loads(body)
            assert cfg["leaderElect"] and cfg["apiServer"] == base
        finally:
            assert stop(proc) == 0
    finally:
        stop(api)

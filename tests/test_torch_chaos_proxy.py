"""The port's chaos proxy and bind monitor against the JAX package's.

* Every rule helper (``heartbeat_drop``, ``node_flap``,
  ``watch_cut_on_relist``, ``overload``, ``bind_conflict_storm``) builds
  the same ``Rule`` fields as the JAX helper.
* One request sequence through the JAX ``ChaosProxy`` and through the
  port's, each in front of its own package's apiserver over a
  ``MemStore`` holding the same objects: the same statuses, the same
  ``stats()["injected"]``, the same admin-endpoint answers, the same
  mid-event watch cut and the same forced 410.
* A probability rule draws from the proxy's seeded generator: two port
  proxies with one seed inject the same faults.
* ``BindMonitor`` counts the same binds, double binds and migration
  windows on the same event sequence.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu import chaos as ref_chaos
from kubernetes_tpu.apiserver import memstore as ref_memstore
from kubernetes_tpu.apiserver import server as ref_server
from kubernetes_tpu.client import http as ref_http
from kubernetes_tpu_torch import chaos
from kubernetes_tpu_torch.apiserver import memstore, server
from kubernetes_tpu_torch.client import http

SIDES = {
    "ref": (ref_chaos, ref_memstore, ref_server, ref_http),
    "port": (chaos, memstore, server, http),
}

HELPERS = [
    ("heartbeat_drop", {}),
    ("heartbeat_drop", {"every_nth": 5, "name": "n-1.a", "status": 500,
                        "count": 3}),
    ("node_flap", {}),
    ("node_flap", {"kind": "drop", "period": 4, "name": "flappy"}),
    ("node_flap", {"kind": "latency", "delay_s": 0.05, "count": 2}),
    ("watch_cut_on_relist", {}),
    ("watch_cut_on_relist", {"kind": "nodes", "every_nth": 3,
                             "after_events": 2, "count": 8}),
    ("overload", {}),
    ("overload", {"kind": 503, "retry_after_s": None, "path": "/pods",
                  "method": "POST", "every_nth": 2, "count": 5}),
    ("bind_conflict_storm", {}),
    ("bind_conflict_storm", {"every_nth": 7, "count": 1}),
]


def test_the_package_exports_the_reference_names():
    assert chaos.__all__ == ref_chaos.__all__
    for name in ("FAULT_ERROR", "FAULT_RESET", "FAULT_LATENCY",
                 "FAULT_CUT_STREAM"):
        assert getattr(chaos, name) == getattr(ref_chaos, name)


@pytest.mark.parametrize("name,kw", HELPERS)
def test_rule_helpers_build_the_reference_fields(name, kw):
    got = [r.to_json() for r in getattr(chaos, name)(**kw)]
    want = [r.to_json() for r in getattr(ref_chaos, name)(**kw)]
    assert got == want and got


def test_node_flap_refuses_an_unknown_kind_on_both():
    for mod in (chaos, ref_chaos):
        with pytest.raises(ValueError, match="unknown node_flap kind"):
            mod.node_flap(kind="nonsense")
        with pytest.raises(ValueError, match="unknown fault"):
            mod.Rule(fault="nonsense")


class _Rig:
    """A ``MemStore`` with two nodes and a pod, that package's apiserver,
    its proxy, and a client through the proxy that never retries."""

    def __init__(self, side: str, seed: int = 0):
        mod_chaos, mod_store, mod_server, mod_http = SIDES[side]
        self.side = side
        self.http = mod_http
        self.store = mod_store.MemStore()
        for name in ("n1", "n2"):
            self.store.create("nodes", {"metadata": {"name": name}})
        self.store.create("pods", {
            "metadata": {"name": "p1", "namespace": "default"},
            "spec": {"containers": [{"name": "c"}]}})
        self.srv = mod_server.serve(self.store)
        self.upstream = f"http://127.0.0.1:{self.srv.server_address[1]}"
        kw = {"seed": seed} if side == "port" else {}
        self.proxy = mod_chaos.ChaosProxy(self.upstream, **kw).start()
        self.client = mod_http.APIClient(self.proxy.base_url, qps=0,
                                         max_retries=0)
        self.too_old = mod_store.TooOldError

    def status(self, fn, *args):
        """200 on success, the status of an ``APIError``, else the name
        of the error's class (``ConflictError``, a transport error)."""
        try:
            fn(*args)
            return 200
        except self.http.APIError as err:
            return err.status
        except Exception as err:  # noqa: BLE001 — compared by name
            return type(err).__name__

    def admin(self, method: str, path: str, obj=None):
        data = json.dumps(obj).encode() if obj is not None else None
        req = urllib.request.Request(self.proxy.base_url + path, data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read() or b"null")

    def close(self) -> None:
        self.proxy.stop()
        self.srv.shutdown()


@pytest.fixture()
def rigs():
    made = {side: _Rig(side) for side in SIDES}
    yield made
    for rig in made.values():
        rig.close()


def _drive(rig: _Rig) -> dict:
    """One request sequence; everything observable, in order."""
    c, out = rig.client, {}
    # Healthy pass-through of every verb.
    node = c.get("nodes", "n1")
    node["metadata"]["labels"] = {"a": "b"}
    out["passthrough"] = [rig.status(c.update, "nodes", node),
                          rig.status(c.list, "nodes"),
                          rig.status(c.get, "pods", "default/p1")]
    # A counted error rule, a heartbeat cadence, a bind-409 storm, an
    # overload storm with Retry-After, a reset and a latency rule.
    rig.proxy.add_rule(fault="error", method="GET", path="/nodes/n2",
                       status=500, count=2)
    rig.proxy.add_rules(rig_mod(rig).heartbeat_drop(every_nth=2))
    rig.proxy.add_rules(rig_mod(rig).bind_conflict_storm(every_nth=2))
    rig.proxy.add_rules(rig_mod(rig).overload(path=r"^/api/v1/pods(\?|$)",
                                              method="GET",
                                              retry_after_s=0.01,
                                              count=2))
    rig.proxy.add_rule(fault="latency", method="GET", path="/nodes/n1",
                       delay_s=0.01, count=1)
    statuses = [rig.status(c.get, "nodes", "n2") for _ in range(3)]
    for i in range(4):
        node = c.get("nodes", "n1")
        node["metadata"]["labels"] = {"beat": str(i)}
        statuses.append(rig.status(c.update, "nodes", node))
    for i in range(4):
        c.create("pods", {"metadata": {"name": f"b{i}",
                                       "namespace": "default"},
                          "spec": {"containers": [{"name": "c"}]}})
        statuses.append(rig.status(c.bind, "default", f"b{i}", "n1"))
    statuses += [rig.status(c.list, "pods") for _ in range(3)]
    rig.proxy.add_rule(fault="reset", method="DELETE", count=1)
    statuses.append(rig.status(c.delete, "pods", "default/b0"))
    statuses.append(rig.status(c.delete, "pods", "default/b0"))
    out["statuses"] = statuses
    out["bound"] = sorted(
        (o["metadata"]["name"], (o.get("spec") or {}).get("nodeName"))
        for o in rig.store.list("pods")[0])
    stats = rig.proxy.stats()
    out["injected"] = stats["injected"]
    out["rules"] = [{k: v for k, v in r.items() if k != "id"}
                    for r in stats["rules"]]
    # The admin endpoint.
    admin = [rig.admin("DELETE", "/chaos/rules")]
    admin.append(rig.admin("POST", "/chaos/rules",
                           {"fault": "error", "method": "GET",
                            "path": "/pods", "status": 503, "count": 1}))
    rid = admin[-1][1]["id"]
    admin.append(rig.admin("GET", "/chaos/rules"))
    out["after_admin_rule"] = rig.status(c.get, "pods", "default/p1")
    admin.append(rig.admin("DELETE", f"/chaos/rules/{rid}"))
    admin.append(rig.admin("DELETE", f"/chaos/rules/{rid}"))
    admin.append(rig.admin("POST", "/chaos/rules", {"fault": "nonsense"}))
    status, body = rig.admin("GET", "/chaos/stats")
    admin.append((status, {k: body[k] for k in ("injected", "rules")}))
    out["admin"] = admin
    # A mid-event watch cut: one event passes, the next is half sent.
    rig.proxy.add_rule(fault="cut-stream", path=r"watch=1",
                       after_events=1, count=1)
    w = c.watch("nodes", 0, frames=False)
    types = []
    for _ in range(4):
        ev = w.next(timeout=3)
        if ev is None:
            break
        types.append(ev.type)
        if ev.type == "ERROR":
            break
    w.stop()
    out["cut"] = types
    # A forced 410 on the watch, then healthy again.
    rig.proxy.add_rule(fault="error", path=r"watch=1", status=410,
                       count=1)
    try:
        c.watch("nodes", 0)
        out["gone"] = "opened"
    except rig.too_old:
        out["gone"] = "TooOldError"
    w = c.watch("nodes", 0)
    out["after_gone"] = w.next(timeout=3).type
    w.stop()
    out["final_injected"] = rig.proxy.stats()["injected"]
    return out


def rig_mod(rig: _Rig):
    return SIDES[rig.side][0]


def test_one_sequence_answers_alike_through_both_proxies(rigs):
    got = _drive(rigs["port"])
    want = _drive(rigs["ref"])
    assert got == want
    # The sequence exercised what it claims to.
    assert got["statuses"][:3] == [500, 500, 200]
    assert 503 in got["statuses"] and 429 in got["statuses"]
    assert "ConflictError" in got["statuses"]
    assert [st for st in got["statuses"]
            if isinstance(st, str) and st != "ConflictError"]
    assert got["cut"] == ["ADDED", "ERROR"]
    assert got["gone"] == "TooOldError" and got["after_gone"] == "ADDED"
    assert got["admin"][-2][0] == 400


def test_a_probability_rule_repeats_under_one_seed():
    def run(seed: int) -> list:
        rig = _Rig("port", seed=seed)
        try:
            rig.proxy.add_rule(fault="error", method="GET", status=503,
                               probability=0.5)
            return [rig.status(rig.client.get, "nodes", "n1")
                    for _ in range(24)]
        finally:
            rig.close()
    first, again, other = run(7), run(7), run(8)
    assert first == again
    assert 503 in first and 200 in first
    assert first != other


def _monitor_events(store, mod) -> None:
    """Bind, unbind with the migration annotation, rebind (a completed
    migration), a double bind, a migrating pod moved without the pending
    hop, and a delete + recreate (a fresh bind, not a double one)."""
    key = mod.DEFRAG_MIGRATION_ANNOTATION_KEY

    def put(name: str, node: str, ann: dict | None = None):
        obj = store.get("pods", f"default/{name}")
        obj["spec"]["nodeName"] = node
        obj["metadata"]["annotations"] = ann or {}
        store.update("pods", obj)

    for name in ("a", "b", "c", "d"):
        store.create("pods", {"metadata": {"name": name,
                                           "namespace": "default"},
                              "spec": {"containers": [{"name": "c"}]}})
    for name in ("a", "b", "c", "d"):
        put(name, "n1")
    put("a", "", {key: "n2"})
    put("a", "n2", {key: "n2"})
    put("b", "n2")
    put("c", "", {key: "n3"})
    put("c", "n3", {key: "n3"})
    put("c", "n1", {key: "n1"})
    store.delete("pods", "default/d")
    store.create("pods", {"metadata": {"name": "d", "namespace": "default"},
                          "spec": {"containers": [{"name": "c"}],
                                   "nodeName": "n2"}})


def test_bind_monitor_counts_as_the_reference():
    import time

    from kubernetes_tpu.api import types as ref_types
    from kubernetes_tpu_torch.api import types
    counts = {}
    for side, mod_types in (("ref", ref_types), ("port", types)):
        mod_chaos, mod_store = SIDES[side][:2]
        store = mod_store.MemStore()
        monitor = mod_chaos.BindMonitor(store)
        try:
            _monitor_events(store, mod_types)
            deadline = time.monotonic() + 10
            while monitor.binds < 7 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.2)
            counts[side] = {
                k: getattr(monitor, k) for k in (
                    "binds", "unbinds", "double_binds",
                    "double_bind_keys", "migrations_started",
                    "migrations_completed", "double_capacity",
                    "double_capacity_keys")}
            with pytest.raises(AssertionError, match="double binds"):
                monitor.assert_clean()
        finally:
            monitor.stop()
    assert counts["port"] == counts["ref"]
    assert counts["port"]["double_binds"] == 2
    assert counts["port"]["double_capacity"] == 1
    assert counts["port"]["migrations_completed"] == 2

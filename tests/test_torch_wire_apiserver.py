"""The port's Python apiserver against the JAX package's, request for
request.

Both run in this process (``serve(store, port=0)``; neither apiserver
imports JAX) over their own ``MemStore``, and one scripted sequence of
raw HTTP requests goes to each.  Every step must give the same status,
the same ``Content-Type`` (and ``Retry-After`` where there is one) and
the same JSON body.  The one field normalised is ``creationTimestamp``:
``MemStore`` stamps it from the wall clock (``memstore._now_rfc3339``).

The script covers CRUD and ``List`` creates, the field-selected list and
watch, the framed and NDJSON watch with replay from a resourceVersion
and the 410 past the window, batch bindings with a CAS 409 and a
capacity 409 (``KT_BIND_CAPACITY``), a validation error body, an APF 429
with ``Retry-After`` at an in-flight limit of 0, and a 401 and a 403
under token authentication and RBAC.
"""

from __future__ import annotations

import contextlib
import pytest

from kubernetes_tpu.apiserver import auth as r_auth
from kubernetes_tpu.apiserver import flowcontrol as r_flow
from kubernetes_tpu.apiserver import memstore as r_memstore
from kubernetes_tpu.apiserver import server as r_server
from kubernetes_tpu_torch.apiserver import auth as t_auth
from kubernetes_tpu_torch.apiserver import flowcontrol as t_flow
from kubernetes_tpu_torch.apiserver import memstore as t_memstore
from kubernetes_tpu_torch.apiserver import server as t_server
from torch_wire import Recorder, crud_script, pod, request

SIDES = {"ref": (r_memstore, r_server, r_flow, r_auth),
         "port": (t_memstore, t_server, t_flow, t_auth)}

@contextlib.contextmanager
def served(side: str, store_hook=None, **kw):
    memstore, server, _, _ = SIDES[side]
    store = memstore.MemStore()
    if store_hook is not None:
        kw.update(store_hook(store))
    srv = server.serve(store, port=0, **kw)
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def assert_same(ref: list[tuple], port: list[tuple]) -> None:
    assert [s[0] for s in port] == [s[0] for s in ref]
    for a, b in zip(ref, port):
        assert b == a, f"step {a[0]!r}: port {b!r} != reference {a!r}"


def test_crud_lists_bindings_and_watches_answer_alike(monkeypatch):
    monkeypatch.setenv("KT_BIND_CAPACITY", "1")
    got = {}
    for side in SIDES:
        with served(side) as base:
            got[side] = crud_script(base)
    assert_same(got["ref"], got["port"])
    steps = {s[0]: s for s in got["ref"]}
    assert steps["update stale (CAS 409)"][1] == 409
    assert steps["validation error"][1] == 422
    results = steps["bind triples (capacity 409)"][4]["results"]
    assert results[1]["code"] == 409 and "overcommit" in results[1]["error"]
    assert [e["type"] for e in steps["watch unbound from rv0"][2]].count(
        "DELETED") >= 3
    assert steps["watch too old (410)"][1] == 410


def test_flow_control_sheds_with_retry_after():
    got = {}
    for side, (_, _, flow, _) in SIDES.items():
        ctl = flow.FlowController(besteffort_inflight=0, queue_limit=0,
                                  retry_floor=0.25)
        with served(side, flow=ctl) as base:
            r = Recorder(base)
            r("list at inflight 0 (429)", "GET", "/api/v1/pods")
            r("healthz is exempt", "GET", "/healthz")
            r("bindings take the workload level", "POST",
              "/api/v1/namespaces/default/bindings",
              {"kind": "BindingList", "triples": []})
            r("flow report", "GET", "/debug/vars")
            got[side] = r.steps
    assert_same(got["ref"], got["port"])
    shed = got["port"][0]
    assert shed[1] == 429 and shed[3] == "1"  # the 1 s queue wait


def _auth(side):
    _, _, _, auth = SIDES[side]

    def hook(store):
        return {"auth": auth.AuthConfig(
            authenticator=auth.TokenAuthenticator({
                "alice-token": auth.UserInfo(name="alice"),
                "admin-token": auth.UserInfo(
                    name="root", groups=("system:masters",))}),
            authorizer=auth.RBACAuthorizer(store))}
    return hook


def test_tokens_and_rbac_answer_alike():
    got = {}
    for side in SIDES:
        with served(side, store_hook=_auth(side)) as base:
            r = Recorder(base)
            alice = {"Authorization": "Bearer alice-token"}
            admin = {"Authorization": "Bearer admin-token"}
            r("no token (401)", "GET", "/api/v1/pods")
            r("bad token (401)", "GET", "/api/v1/pods",
              headers={"Authorization": "Bearer wrong"})
            r("alice without a grant (403)", "GET", "/api/v1/pods",
              headers=alice)
            r("admin", "GET", "/api/v1/pods", headers=admin)
            r("admin creates a role", "POST", "/api/v1/clusterroles",
              {"metadata": {"name": "reader"},
               "rules": [{"verbs": ["get", "list"],
                          "resources": ["pods"]}]}, admin)
            r("admin binds it to alice", "POST",
              "/api/v1/clusterrolebindings",
              {"metadata": {"name": "alice-reads"},
               "subjects": [{"kind": "User", "name": "alice"}],
               "roleRef": {"kind": "ClusterRole", "name": "reader"}},
              admin)
            r("alice reads", "GET", "/api/v1/pods", headers=alice)
            r("alice may not write (403)", "POST", "/api/v1/pods",
              pod("nope"), alice)
            got[side] = r.steps
    assert_same(got["ref"], got["port"])
    codes = [s[1] for s in got["port"]]
    assert codes == [401, 401, 403, 200, 201, 201, 200, 403]


@pytest.mark.parametrize("path", ["/debug/timeseries", "/debug/dashboard",
                                  "/debug/profile"])
def test_telemetry_routes_answer_501_naming_their_slice(path):
    with served("port") as base:
        status, _, body = request(base, "GET", path)
    assert status == 501 and b"not ported" in body
    with served("port") as base:
        assert request(base, "GET", "/debug/traces")[0] == 200
        status, _, body = request(base, "GET", "/metrics")
    assert status == 200 and b"apiserver_request_latency" in body

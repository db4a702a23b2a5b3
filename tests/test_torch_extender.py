"""The port's scheduler-extender sidecar (kubernetes_tpu_torch/server/
extender.py) against the JAX package's, on the same raw request bodies.

``ExtenderCore.handle`` of both packages answers one sequence of wire
verbs at 64 ``rich`` nodes: filter then prioritize of one body (the
raw-body memo), more probes of the same template (the template memo and
the node-list span fast path), fresh templates, a pod with a node
selector, a pod that fits nowhere, a changed node list (new
``resourceVersion``s), capitalised and lowercase keys, a node list
without versions, and bodies that are not ExtenderArgs.  Tolerance:
every response identical byte for byte.

Then one HTTP round trip through the port's ``serve_in_thread`` on the
CPU (verbs, /healthz, /metrics, /configz, the telemetry and profiler
routes with the JAX package's statuses and content types) and
``main``'s argument parsing."""

from __future__ import annotations

import json
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from kubernetes_tpu.server import extender as ref_ext
from kubernetes_tpu_torch.api import types as t_api
from kubernetes_tpu_torch.perf import synth
from kubernetes_tpu_torch.server import extender as t_ext

N_NODES = 64


def _items(rv_base: int, versions: bool = True) -> list[dict]:
    nodes = synth.make_nodes(N_NODES, profile="rich", n_zones=4)
    items = []
    for i, node in enumerate(nodes):
        item = t_api.node_to_json(node)
        if versions:
            item["metadata"]["resourceVersion"] = str(rv_base + i)
        items.append(item)
    return items


def _pod(name: str, cpu: str = "100m", memory: str = "128Mi",
         selector: dict | None = None) -> dict:
    spec: dict = {"containers": [{"name": "c", "resources": {
        "requests": {"cpu": cpu, "memory": memory}}}]}
    if selector:
        spec["nodeSelector"] = selector
    return {"metadata": {"name": name, "namespace": "default",
                         "labels": {"app": "probe"}}, "spec": spec}


def _body(pod: dict, items: list[dict], caps: bool = True) -> bytes:
    if caps:
        return json.dumps({"Pod": pod, "Nodes": {"Items": items}}).encode()
    return json.dumps({"pod": pod, "nodes": {"items": items}}).encode()


def _exchanges() -> list[tuple[str, bytes]]:
    """The wire sequence: each body as filter then prioritize."""
    first, second = _items(1), _items(1001)
    bodies = []
    for k in range(12):
        cpu = f"{100 + k}m" if k % 4 == 0 else "100m"
        bodies.append(_body(_pod(f"probe-{k}", cpu=cpu), first))
    bodies.append(_body(_pod("pinned", selector={"kt/pool": "pool-1"}),
                        first))
    bodies.append(_body(_pod("huge", cpu="512", memory="1Ti"), first))
    bodies.append(_body(_pod("after-change"), second))
    bodies.append(_body(_pod("lower-keys"), second, caps=False))
    bodies.append(_body(_pod("probe-0"), first))
    bodies.append(_body(_pod("unversioned"), _items(0, versions=False)))
    out = [(verb, b) for b in bodies for verb in ("filter", "prioritize")]
    bad_pod = json.dumps({"Pod": 1, "Nodes": {"Items": first[:2]}}).encode()
    for bad in (b'{"Pod": {"metadata": {"name": "x"}}, "Nodes": ',
                b"[1, 2]", bad_pod):
        out += [("filter", bad), ("prioritize", bad)]
    return out


def test_handle_matches_reference_byte_for_byte():
    ref = ref_ext.ExtenderCore()
    port = t_ext.ExtenderCore(device="cpu")
    seen_errors = 0
    kept = set()
    for verb, raw in _exchanges():
        want = ref.handle(verb, raw)
        got = port.handle(verb, raw)
        assert got == want, (verb, raw[:120], got[:300], want[:300])
        if verb == "filter":
            resp = json.loads(got)
            seen_errors += "error" in resp
            kept.add(len(resp["nodes"]["items"]))
    assert seen_errors >= 3
    # Some node lists keep everything feasible, some nothing, some part.
    assert 0 in kept and len(kept) >= 3


def test_an_empty_node_list_is_an_error_in_both():
    """No nodes: each package's evaluate fails on an empty max (the
    message names its own array library), so filter answers the wire
    contract's error and prioritize an empty list."""
    ref = ref_ext.ExtenderCore()
    port = t_ext.ExtenderCore(device="cpu")
    for raw in (b"{}", _body(_pod("none"), [])):
        want = json.loads(ref.handle("filter", raw))
        got = json.loads(port.handle("filter", raw))
        assert got["error"] and want["error"]
        assert {**got, "error": ""} == {**want, "error": ""} == \
            {"nodes": {"items": []}, "failedNodes": {}, "error": ""}
        assert port.handle("prioritize", raw) == \
            ref.handle("prioritize", raw) == b"[]"


def test_filter_and_prioritize_dict_entry_points_match_reference():
    args = {"pod": _pod("dict"), "nodes": {"items": _items(1)}}
    ref = ref_ext.ExtenderCore()
    port = t_ext.ExtenderCore(device="cpu")
    assert port.filter(args) == ref.filter(args)
    assert port.prioritize(args) == ref.prioritize(args)
    bad = {"pod": 1}
    assert port.filter(bad) == ref.filter(bad)
    assert port.prioritize(bad) == ref.prioritize(bad)


def test_concurrent_handles_answer_as_sequential_ones():
    """Eight threads (more than the test's cores) share one core and its
    memos, with a short switch interval: every answer equals the
    sequential one."""
    first, second = _items(1), _items(1001)
    work = [(verb, _body(_pod(f"c-{k}", cpu=f"{100 + k % 3}m"),
                         first if k % 2 else second))
            for k in range(6) for verb in ("filter", "prioritize")]
    seq = t_ext.ExtenderCore(device="cpu")
    want = [seq.handle(verb, raw) for verb, raw in work]
    core = t_ext.ExtenderCore(device="cpu")
    bad: list = []

    def client(shift: int) -> None:
        order = work[shift:] + work[:shift]
        expect = want[shift:] + want[:shift]
        for (verb, raw), w in zip(order, expect):
            if core.handle(verb, raw) != w:
                bad.append((shift, verb))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def _get(url: str) -> tuple[int, bytes, str]:
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as err:
        return err.code, err.read(), err.headers.get("Content-Type", "")


def test_http_round_trip_on_the_cpu():
    server = t_ext.serve_in_thread(port=0, device="cpu")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        raw = _body(_pod("wire"), _items(1))
        core = t_ext.ExtenderCore(device="cpu")
        for verb in ("filter", "prioritize"):
            req = urllib.request.Request(
                f"{url}/scheduler/{verb}", data=raw, method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
                assert r.read() == core.handle(verb, raw)
        assert _get(f"{url}/healthz")[:2] == (200, b"ok")
        code, body, _ = _get(f"{url}/metrics")
        assert code == 200
        assert b"scheduling_algorithm_latency_microseconds" in body
        code, _, ctype = _get(f"{url}/metrics?format=openmetrics")
        assert code == 200 and ctype.startswith("application/openmetrics")
        code, body, _ = _get(f"{url}/configz")
        cfg = json.loads(body)
        assert code == 200 and "GeneralPredicates" in cfg["predicates"]
        code, body, _ = _get(f"{url}/debug/traces")
        assert code == 200 and "traceEvents" in json.loads(body)
        from kubernetes_tpu.utils import debugmux as ref_mux
        for route in ("/debug/timeseries", "/debug/dashboard",
                      "/debug/pprof/goroutine", "/debug/profile"):
            code, body, ctype = _get(f"{url}{route}")
            want = ref_mux.common_route(route)
            assert (code, ctype) == (want[0], want[2]), route
            assert body, route
        assert _get(f"{url}/nope")[0] == 404
        req = urllib.request.Request(f"{url}/scheduler/bind", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_main_parses_device_and_defaults_to_cuda():
    opts = t_ext.parse_args([])
    assert (opts.port, opts.host, opts.device) == (12346, "0.0.0.0", "cuda")
    opts = t_ext.parse_args(["--port", "0", "--host", "127.0.0.1",
                             "--device", "cpu",
                             "--policy-config-file", "p.json"])
    assert (opts.port, opts.host, opts.device, opts.policy_config_file) == \
        (0, "127.0.0.1", "cpu", "p.json")


def test_main_validates_the_policy_file(tmp_path):
    bad = tmp_path / "policy.json"
    bad.write_text(json.dumps({"kind": "Policy", "apiVersion": "v1",
                               "predicates": [{"name": "NoSuchPredicate"}],
                               "priorities": []}))
    with pytest.raises(ValueError, match="NoSuchPredicate"):
        t_ext.main(["--port", "0", "--device", "cpu",
                    "--policy-config-file", str(bad)])


def test_core_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ext.ExtenderCore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ext.main(["--port", "0"])

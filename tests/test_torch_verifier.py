"""The PyTorch port's resident-state verifier (``kubernetes_tpu_torch.
cache.verifier``) and ``ResidentCluster.in_sync``/``readback_rows``
against the JAX package's, on the CPU.

* ``verify_once`` over the same cache on both sides, with injected
  drift of every kind — a host aggregate row, a resident device row, an
  apiserver ghost, a missing bound pod, a pod on the wrong node, an
  in-flight assume, a settled defrag migrant that disagrees with truth,
  a mirror awaiting re-upload: equal violations (kind and text), equal
  heals, and a clean second pass on both;
* ``readback_rows`` of the same sampled rows equal to the reference's
  (whose narrow planes decode to the same values) and to the host
  arrays;
* a corrupted resident row on the port's CPU engine is named, healed by
  a full re-upload, and a follow-up drain places pods as an uncorrupted
  engine does;
* ``KT_VERIFY_PERIOD`` on the port's daemon over a ``MemStore``;
* the port's ``streams`` guard: an apiserver mismatch counts only while
  the same pod watch streams were open over the check's window, and a
  reflector's ``stream_token`` follows its streams."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from helpers import make_node, make_pod
from torch_parity import to_port


def _mods(side: str) -> dict:
    if side == "ref":
        from kubernetes_tpu.apiserver.memstore import MemStore
        from kubernetes_tpu.cache.verifier import Verifier
        from kubernetes_tpu.engine.generic_scheduler import GenericScheduler
        kw = {}
    else:
        from kubernetes_tpu_torch.apiserver.memstore import MemStore
        from kubernetes_tpu_torch.cache.verifier import Verifier
        from kubernetes_tpu_torch.engine.generic_scheduler import \
            GenericScheduler
        kw = {"device": "cpu"}
    return dict(MemStore=MemStore, Verifier=Verifier,
                engine=lambda: GenericScheduler(**kw))


def _o(obj, side: str):
    return obj if side == "ref" else to_port(obj)


def _node_json(name: str, cpu: str = "32") -> dict:
    return {"metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": "64Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}}


def _pod_json(name: str, cpu: str = "100m") -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {"cpu": cpu}}}]}}


def _corrupt_device_row(side: str, algo, row: int) -> None:
    dc = algo.resident.dc
    if side == "port":
        req = dc.requested.clone()
        req[row, 0] += 999
        algo.resident.dc = dc._replace(requested=req)
    elif hasattr(dc, "res16"):  # the reference's narrow form: cpu = col 3
        algo.resident.dc = dc._replace(res16=dc.res16.at[row, 3].add(999))
    else:
        algo.resident.dc = dc._replace(
            requested=dc.requested.at[row, 0].add(999))


def _scenario(side: str, name: str) -> dict:
    m = _mods(side)
    store = m["MemStore"]()
    algo = m["engine"]()
    for i in range(6):
        algo.cache.add_node(_o(make_node(f"vn{i}"), side))
        store.create("nodes", _node_json(f"vn{i}"))
    kw = dict(resident=algo.resident, grace_s=0.05)
    if name != "out_of_sync":
        kw["truth"] = lambda: store.list("pods")[0]
    # A drain syncs the mirror; a second scatters its dirty rows, so
    # the rows the checker samples carry no pending deltas.
    first = [_o(make_pod(f"v{i}", cpu="50m"), side) for i in range(4)]
    for pod, dest in zip(first, algo.schedule_batch(first)):
        algo.cache.assume_pod(pod, dest)
        store.create("pods", _pod_json(pod.name, cpu="50m"))
        store.bind("default", pod.name, dest)
        algo.cache.confirm_assumed(pod.key, dest)
    algo.schedule_batch([_o(make_pod("flush", cpu="50m"), side)])
    v = m["Verifier"](algo.cache, **kw)
    if name == "aggregates":
        with algo.cache.lock:
            algo.cache._agg.requested[0, 0] += 13
    elif name == "device_row":
        with algo.cache.lock:
            assert algo.resident.in_sync(algo.cache._nt, algo.cache.space,
                                         algo.cache.tensor_epoch)
            row = min(set(range(6)) - algo.cache._dirty_rows)
        _corrupt_device_row(side, algo, row)
    elif name == "ghost":
        algo.cache.add_pod(_o(make_pod("ghost", node_name="vn0"), side))
    elif name == "missing":
        store.create("pods", _pod_json("abound"))
        store.bind("default", "abound", "vn2")
    elif name == "wrong_node":
        store.create("pods", _pod_json("moved"))
        store.bind("default", "moved", "vn1")
        algo.cache.add_pod(_o(make_pod("moved", node_name="vn0"), side))
    elif name == "inflight":
        store.create("pods", _pod_json("inflight"))
        algo.cache.assume_pod(_o(make_pod("inflight"), side), "vn3")
    elif name == "defrag":
        store.create("pods", _pod_json("m0"))
        store.bind("default", "m0", "vn1")
        algo.cache.add_pod(_o(make_pod("m0", cpu="100m",
                                       node_name="vn4"), side))
        v.heal = False
        v.note_defrag(["default/m0"])
    elif name == "out_of_sync":
        algo.cache.add_node(_o(make_node("joiner"), side))
    viol = [(x.kind, x.detail) for x in v.verify_once()]
    mirror_dropped = algo.resident.dc is None
    algo.schedule_batch([_o(make_pod("post", cpu="50m"), side)])
    second = [(x.kind, x.detail) for x in v.verify_once()]
    placements = {k: n for k, n, _ in algo.cache.tracked_pods()}
    return {"first": viol, "mirror_dropped": mirror_dropped,
            "second": second, "passes": v.passes,
            "total": v.violations_total, "placements": placements}


CASES = ["clean", "aggregates", "device_row", "ghost", "missing",
         "wrong_node", "inflight", "defrag", "out_of_sync"]


@pytest.mark.parametrize("name", CASES)
def test_verify_once_equals_the_reference(name):
    ref, port = _scenario("ref", name), _scenario("port", name)
    assert port == ref
    kinds = {k for k, _ in ref["first"]}
    want = {"clean": set(), "inflight": set(), "out_of_sync": set(),
            "aggregates": {"aggregates"}, "device_row": {"device_row"},
            "ghost": {"apiserver"}, "missing": {"apiserver"},
            "wrong_node": {"apiserver"}, "defrag": {"defrag",
                                                    "apiserver"}}[name]
    assert want <= kinds
    if name not in ("defrag",):
        assert ref["second"] == []


def _synth_rigs(n_nodes: int = 96, n_pods: int = 300):
    from kubernetes_tpu.perf import synth as r_synth
    from kubernetes_tpu_torch.perf import synth as t_synth
    r_eng, r_pods = r_synth.make_rig(n_nodes, n_pods, profile="mixed")
    t_eng, t_pods = t_synth.make_rig(n_nodes, n_pods, profile="mixed",
                                     device="cpu")
    for eng, pods in ((r_eng, r_pods), (t_eng, t_pods)):
        for pod, dest in zip(pods, eng.schedule_batch(pods)):
            if dest is not None:
                eng.cache.assume_pod(pod, dest)
        eng.schedule_batch(pods[:8])  # scatter the assumes' rows
    return r_eng, t_eng


def test_readback_rows_equals_the_reference_and_the_host():
    from kubernetes_tpu_torch.engine import devicestats
    r_eng, t_eng = _synth_rigs()
    idx = np.random.RandomState(3).choice(96, size=40, replace=False)
    for eng in (r_eng, t_eng):
        c = eng.cache
        assert eng.resident.in_sync(c._nt, c.space, c.tensor_epoch)
    before = devicestats.transfer_snapshot().get("readback", 0)
    port = t_eng.resident.readback_rows(idx)
    ref = r_eng.resident.readback_rows(idx)
    assert sorted(port) == sorted(ref) == \
        ["alloc", "nonzero", "requested", "schedulable"]
    host = {"schedulable": t_eng.cache._nt.schedulable,
            "alloc": t_eng.cache._nt.alloc,
            "requested": t_eng.cache._agg.requested,
            "nonzero": t_eng.cache._agg.nonzero}
    for f in port:
        assert isinstance(port[f], np.ndarray)
        assert port[f].shape == np.asarray(ref[f]).shape
        assert np.array_equal(port[f], np.asarray(ref[f])), f
        assert np.array_equal(port[f], np.asarray(host[f])[idx]), f
    assert devicestats.transfer_snapshot()["readback"] - before == \
        devicestats.nbytes(port)


def test_in_sync_follows_epoch_and_signature():
    from kubernetes_tpu_torch.engine.solver import ResidentCluster
    _, t_eng = _synth_rigs(n_nodes=16, n_pods=20)
    c = t_eng.cache
    assert t_eng.resident.in_sync(c._nt, c.space, c.tensor_epoch)
    assert not t_eng.resident.in_sync(c._nt, c.space, c.tensor_epoch + 1)
    assert not ResidentCluster("cpu").in_sync(c._nt, c.space,
                                              c.tensor_epoch)
    t_eng.resident.invalidate()
    assert not t_eng.resident.in_sync(c._nt, c.space, c.tensor_epoch)


def test_corrupted_resident_row_is_found_healed_and_places_as_before():
    from kubernetes_tpu_torch.cache.verifier import Verifier
    from kubernetes_tpu_torch.perf import synth as t_synth
    _, eng = _synth_rigs()
    _, twin = _synth_rigs()
    c = eng.cache
    with c.lock:
        row = min(set(range(96)) - c._dirty_rows)
    node = c._node_order[row]
    req = eng.resident.dc.requested.clone()
    req[row, 0] += 7
    eng.resident.dc = eng.resident.dc._replace(requested=req)
    v = Verifier(c, resident=eng.resident, sample=96)
    viol = v.verify_once()
    assert [x.kind for x in viol] == ["device_row"]
    assert node in viol[0].detail and "requested" in viol[0].detail
    assert eng.resident.dc is None  # healed: full re-upload next sync
    follow = t_synth.make_pods(64, seed=9, profile="mixed", n_services=4,
                               name_prefix="after")
    follow_twin = t_synth.make_pods(64, seed=9, profile="mixed",
                                    n_services=4, name_prefix="after")
    eng.last_node_index = twin.last_node_index
    assert eng.schedule_batch(follow) == twin.schedule_batch(follow_twin)
    assert torch.equal(eng.resident.dc.requested,
                       twin.resident.dc.requested)
    assert v.verify_once() == []


def test_verifier_runs_in_the_daemon(monkeypatch):
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    monkeypatch.setenv("KT_VERIFY_PERIOD", "0.1")
    store = MemStore()
    for i in range(4):
        store.create("nodes", _node_json(f"dn{i}"))
    for i in range(20):
        store.create("pods", _pod_json(f"dp{i}"))
    f = ConfigFactory(store, device="cpu")
    try:
        f.run()
        assert f.verifier is not None
        deadline = time.monotonic() + 30
        while f.verifier.passes < 3 or not all(
                store.get("pods", f"default/dp{i}")["spec"]
                .get("nodeName") for i in range(20)):
            assert time.monotonic() < deadline, "verifier never ran"
            time.sleep(0.05)
        assert f.verifier.violations_total == 0
    finally:
        f.stop()


@pytest.mark.parametrize("streams,counted", [
    (lambda: (1, 1), True),      # the same live streams: drift counts
    (lambda: None, False),       # a pod stream is down: lag
])
def test_a_ghost_counts_only_while_the_pod_streams_held(streams, counted):
    """The port's ``streams`` guard: the ghost of the reference's
    ``ghost`` case counts when the same pod watch streams were open over
    the whole window, and is left inconclusive while one is down."""
    m = _mods("port")
    store = m["MemStore"]()
    algo = m["engine"]()
    for i in range(2):
        algo.cache.add_node(_o(make_node(f"vn{i}"), "port"))
        store.create("nodes", _node_json(f"vn{i}"))
    algo.cache.add_pod(_o(make_pod("ghost", node_name="vn0"), "port"))
    v = m["Verifier"](algo.cache, truth=lambda: store.list("pods")[0],
                      grace_s=0.05, streams=streams)
    viol = [x.kind for x in v.verify_once()]
    assert viol == (["apiserver"] if counted else [])
    assert v.relisting_skips == (0 if counted else 1)


def test_a_stream_restart_inside_the_window_is_inconclusive():
    m = _mods("port")
    store = m["MemStore"]()
    algo = m["engine"]()
    algo.cache.add_node(_o(make_node("vn0"), "port"))
    store.create("nodes", _node_json("vn0"))
    algo.cache.add_pod(_o(make_pod("ghost", node_name="vn0"), "port"))
    tokens = iter([(1,), (2,)])
    v = m["Verifier"](algo.cache, truth=lambda: store.list("pods")[0],
                      grace_s=0.05, streams=lambda: next(tokens))
    assert v.verify_once() == [] and v.relisting_skips == 1


def test_reflector_stream_token_follows_its_streams():
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.client.reflector import Reflector
    store = MemStore()
    r = Reflector(store, "pods", lambda *_: None)
    assert r.stream_token() is None
    r.run()
    deadline = time.monotonic() + 10
    while r.stream_token() != 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    r.stop()
    while r.stream_token() is not None:
        assert time.monotonic() < deadline
        time.sleep(0.01)

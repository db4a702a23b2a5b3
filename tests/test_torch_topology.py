"""The PyTorch port's topology spread (``engine/workloads/topology.py``
and its sites in ``GenericScheduler``) on the CPU against the JAX
package: the [P, N] planes against the jitted ``_planes_kernel`` on
numpy-seeded term tables; decisions and the round-robin counter of
``schedule``, one-shot ``schedule_batch`` and the chunked
``schedule_batch_stream`` for spread-annotated pods; the FitError map
(``"TopologySpread"`` after the sorted predicate masks);
``find_preemptions`` with a hard term; and the daemon's multi-drain case
of ``tests/test_workload_constraints.py``.  Tolerance: exact equality
(bool masks, f32 scores that are whole numbers, integer choices)."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_node, make_pod
from kubernetes_tpu.api import types as r_api
from kubernetes_tpu.engine import generic_scheduler as r_gs
from kubernetes_tpu.engine.workloads import topology as r_topo
from kubernetes_tpu_torch.engine import generic_scheduler as t_gs
from kubernetes_tpu_torch.engine.workloads import topology as t_topo
from torch_parity import (annotate, daemon, outcome, ref_rig, to_port,
                          torch_rig)


def _same(x):
    return x


def _terms(flavour: str, seed: int, p: int = 24, n: int = 40,
           t: int = 4, d: int = 16, k: int = 3) -> tuple:
    """(SpreadTerms, topo_dom [N, K]) seeded with numpy.  Terms 0..2 are
    real, term 3 is a pad term (max_skew 1e9, carried by no pod).
    ``hard`` / ``soft`` / ``both`` set the real terms' kinds; ``nokey``
    leaves a third of the nodes without any key; ``novalid`` gives term
    1 no valid domain; ``large`` uses counts past 2,048, which TF32
    would round."""
    rng = np.random.RandomState(seed)
    key_col = rng.randint(0, k, t).astype(np.int32)
    max_skew = rng.randint(1, 4, t).astype(np.float32)
    max_skew[3] = np.float32(1e9)
    hard = {"hard": np.array([1, 1, 1, 0]), "soft": np.array([0, 0, 0, 0]),
            }.get(flavour, np.array([1, 0, 1, 0])).astype(bool)
    top = 30000 if flavour == "large" else 6
    counts = rng.randint(0, top, (t, d)).astype(np.float32)
    valid = rng.rand(t, d) < 0.7
    if flavour == "novalid":
        valid[1] = False
    src = rng.rand(p, t) < 0.5
    src[:, 3] = False
    topo_dom = rng.randint(0, d, (n, k)).astype(np.int32)
    topo_dom[rng.rand(n, k) < (0.33 if flavour == "nokey" else 0.1)] = -1
    terms = t_topo.SpreadTerms(
        key_col, max_skew, hard, counts, valid, src,
        any_hard=bool(hard.any()), any_soft=bool((~hard[:3]).any()))
    return terms, topo_dom


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("flavour", ["hard", "soft", "both", "nokey",
                                     "novalid", "large"])
def test_planes_match_reference_kernel(flavour, precision):
    terms, topo_dom = _terms(flavour, seed=len(flavour))
    want_mask, want_score = r_topo._planes_kernel(
        *(jnp.asarray(a) for a in (terms.key_col, terms.max_skew,
                                   terms.hard, terms.counts, terms.valid,
                                   terms.src)), jnp.asarray(topo_dom))
    # The contractions run in float64: a TF32 setting cannot round them.
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        got = t_topo.TermPlanes(terms, torch.from_numpy(topo_dom))
        mask, score = t_topo.contract(got.src, got.hard_viol, got.soft_tn)
        planes = t_topo.spread_planes(terms, torch.from_numpy(topo_dom))
    finally:
        torch.set_float32_matmul_precision(old)
    assert mask.dtype == torch.bool and score.dtype == torch.float32
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    assert np.array_equal(score.numpy(), np.asarray(want_score))
    want_planes = r_topo.spread_planes(terms, jnp.asarray(topo_dom))
    for g, w in zip(planes, want_planes):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w))
    # The planes are row-separable: a row range is that slice of them.
    part_mask, part_score = got.rows(8, 20)
    if part_mask is not None:
        assert np.array_equal(part_mask.numpy(),
                              np.asarray(want_mask)[8:20])
    if part_score is not None:
        assert np.array_equal(part_score.numpy(),
                              np.asarray(want_score)[8:20])


def _rigs(profile: str, n: int, p: int):
    ref, rpods, placements = ref_rig(profile, n, p, n_existing=24)
    port, tpods = torch_rig(profile, n, p, placements)
    return ref, annotate(rpods), port, annotate(tpods)


@pytest.mark.parametrize("route", ["oneshot", "stream", "padded"])
@pytest.mark.parametrize("profile,n,p", [("mixed", 24, 160),
                                         ("rich", 20, 120),
                                         ("mixed", 6, 96)])
def test_batch_routes_match_reference(profile, n, p, route):
    ref, rpods, port, tpods = _rigs(profile, n, p)
    if route == "stream":
        want = [c for _, ch in ref.schedule_batch_stream(rpods, 48)
                for c in ch]
        got = [c for _, ch in port.schedule_batch_stream(tpods, 48)
               for c in ch]
    else:
        pad = p + 37 if route == "padded" else 0
        want = ref.schedule_batch(rpods, pad_to=pad)
        got = port.schedule_batch(tpods, pad_to=pad)
    assert got == want
    assert int(port.last_node_index) == int(ref.last_node_index)
    if n == 6:
        # Six nodes over four zones: the hard terms leave pods unplaced.
        assert None in got


def _zone_rig(cls, conv, **kw):
    alg = cls(**kw)
    for i in range(4):
        alg.cache.add_node(conv(make_node(
            f"n{i}", labels={r_api.ZONE_LABEL: f"z{i % 2}"})))
    for i, node in enumerate(["n0", "n2", "n1"]):
        alg.cache.add_pod(conv(make_pod(f"pre{i}", labels={"app": "x"},
                                        node_name=node)))
    return alg


def spread_pod(conv, name, key, labels, max_skew=1, hard=True, **kw):
    p = make_pod(name, labels=labels, **kw)
    p.annotations[r_api.TOPOLOGY_SPREAD_ANNOTATION_KEY] = json.dumps([{
        "maxSkew": max_skew, "topologyKey": key,
        "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
        "labelSelector": {"matchLabels": dict(labels)}}])
    return conv(p)


def test_schedule_decisions_match_reference():
    """One pod at a time (each assumed before the next): hard and soft
    zone terms, a custom key interned on demand, and plain pods."""
    out = {}
    for side, cls, conv, kw in (("ref", r_gs.GenericScheduler, _same, {}),
                                ("port", t_gs.GenericScheduler, to_port,
                                 {"device": "cpu"})):
        alg = _zone_rig(cls, conv, **kw)
        alg.cache.add_node(conv(make_node("r0", labels={"kt/rack": "a"})))
        got = []
        for i in range(12):
            if i % 4 == 3:
                pod = conv(make_pod(f"plain{i}", labels={"app": "x"}))
            elif i % 4 == 2:
                pod = spread_pod(conv, f"rack{i}", "kt/rack", {"app": "x"})
            else:
                pod = spread_pod(conv, f"s{i}", r_api.ZONE_LABEL,
                                 {"app": "x"}, hard=i % 4 == 0)
            dest = alg.schedule(pod)
            alg.cache.assume_pod(pod, dest)
            got.append(dest)
        out[side] = (got, int(alg.last_node_index))
    assert out["port"] == out["ref"]


def test_fit_error_map_matches_reference():
    """A pod that fits nowhere: one node lacks the zone key (it fails
    the hard term), the other has the key but too little CPU.  Both
    packages raise FitError with ``"TopologySpread"`` listed after the
    sorted predicate names."""
    maps = {}
    for side, cls, conv, err, kw in (
            ("ref", r_gs.GenericScheduler, _same, r_gs.FitError, {}),
            ("port", t_gs.GenericScheduler, to_port, t_gs.FitError,
             {"device": "cpu"})):
        alg = cls(**kw)
        alg.cache.add_node(conv(make_node("plain")))
        alg.cache.add_node(conv(make_node(
            "tiny", milli_cpu=10, labels={r_api.ZONE_LABEL: "z0"})))
        with pytest.raises(err) as e:
            alg.schedule(spread_pod(conv, "s", r_api.ZONE_LABEL,
                                    {"app": "y"}, cpu="500m"))
        maps[side] = e.value.failed_predicates
    assert maps["port"] == maps["ref"]
    assert maps["port"]["plain"][-1] == "TopologySpread"
    assert list(maps["port"]) == ["plain", "tiny"]


def test_find_preemptions_honours_the_hard_mask():
    """Four full nodes over two zones; the preemptors carry a zone
    DoNotSchedule term that only zone z1 admits: every nomination lands
    in z1, as the reference's."""
    decisions = {}
    for side, cls, conv, kw in (("ref", r_gs.GenericScheduler, _same, {}),
                                ("port", t_gs.GenericScheduler, to_port,
                                 {"device": "cpu"})):
        alg = cls(**kw)
        for i in range(4):
            alg.cache.add_node(conv(make_node(
                f"n{i}", milli_cpu=1000,
                labels={r_api.ZONE_LABEL: f"z{i % 2}"})))
        for i in range(8):
            p = make_pod(f"low{i}", cpu="500m", node_name=f"n{i % 4}",
                         labels={"app": "w"} if i in (0, 2) else {})
            p.annotations[r_api.PRIORITY_ANNOTATION_KEY] = str(i % 3)
            alg.cache.add_pod(conv(p))
        pods = []
        for i in range(3):
            p = spread_pod(_same, f"hi{i}", r_api.ZONE_LABEL, {"app": "w"},
                           cpu="600m")
            p.annotations[r_api.PRIORITY_ANNOTATION_KEY] = "10"
            pods.append(conv(p))
        decisions[side] = [vars(d) for d in alg.find_preemptions(pods)]
    assert decisions["port"] == decisions["ref"]
    assert decisions["port"]
    assert {d["node"] for d in decisions["port"]} <= {"n1", "n3"}


@pytest.mark.parametrize("attrs", [{}, {"STREAM_THRESHOLD": 8}])
def test_daemon_multi_drain_matches_reference(attrs):
    """One spread pod per drain (counts refresh between drains, so the
    hard skew bound holds across the sequence), then a burst of twelve
    in one drain; bindings, counter, events and conditions equal the
    JAX daemon's, and the per-drain zone counts stay within skew 1."""
    out = {}
    for side, cls, conv, kw in (("ref", r_gs.GenericScheduler, _same, {}),
                                ("port", t_gs.GenericScheduler, to_port,
                                 {"device": "cpu"})):
        alg = cls(**kw)
        for i in range(4):
            alg.cache.add_node(conv(make_node(
                f"n{i}", labels={r_api.ZONE_LABEL: f"z{i % 2}"})))
        d = daemon(side, eng=alg, **attrs)
        try:
            counts = {"z0": 0, "z1": 0}
            keys = []
            for i in range(6):
                pod = spread_pod(conv, f"s{i}", r_api.ZONE_LABEL,
                                 {"app": "m"})
                d.enqueue(pod)
                d.schedule_pending(wait_first=False)
                node = d.config.binder.bound_node(pod.key)
                assert node is not None
                counts[f"z{int(node[1:]) % 2}"] += 1
                assert abs(counts["z0"] - counts["z1"]) <= 1
                keys.append(pod.key)
            burst = [spread_pod(conv, f"b{i}", r_api.ZONE_LABEL,
                                {"app": "m"}, hard=i % 2 == 0)
                     for i in range(12)]
            for pod in burst:
                d.enqueue(pod)
            d.schedule_pending(wait_first=False)
            keys += [p.key for p in burst]
            out[side] = outcome(d, keys)
        finally:
            d.stop()
    assert out["port"] == out["ref"]
    assert len(out["port"]["bound"]) == 18

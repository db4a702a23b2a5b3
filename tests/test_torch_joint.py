"""The PyTorch port's joint solve (``Solver._price_iterate`` and
``Solver.solve_joint``, ``schedule_batch(joint=True)``) on the CPU
against the JAX package: the price iteration's score bias and repair key
on the same host inputs; choices, counter and final aggregates on the
rigs of ``tests/test_joint_solver.py`` and on ``joint_quality`` at
60 x 600; the daemon with the ``JointSolver`` gate on; the prewarm plan's
topology and joint keys; and the two pieces of float arithmetic the
parity rests on (the fused multiply-add XLA's CPU backend contracts, and
``jnp.argsort``'s order of floats).  Tolerance: exact equality (f32
compared bit for bit, integer choices and aggregates)."""

from __future__ import annotations

import contextlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_node, make_pod
from kubernetes_tpu.engine import generic_scheduler as r_gs
from kubernetes_tpu.perf import workloads as r_wl
from kubernetes_tpu.scheduler import scheduler as r_sched
from kubernetes_tpu.utils import featuregate as r_fg
from kubernetes_tpu_torch.engine import generic_scheduler as t_gs
from kubernetes_tpu_torch.engine import solver as t_sv
from kubernetes_tpu_torch.perf import workloads as t_wl
from kubernetes_tpu_torch.scheduler import scheduler as t_sched
from kubernetes_tpu_torch.utils import featuregate as t_fg
from torch_parity import (annotate, both, daemon, host_inputs, outcome,
                          ref_rig, same, to_port, torch_rig)


def _same(x):
    return x


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


RIGS = [("mixed", 30, 200, False), ("rich", 40, 300, False),
        ("mixed", 60, 600, True), ("rich", 24, 160, True)]


@pytest.mark.parametrize("profile,n,p,spread", RIGS)
def test_price_iterate_matches_reference(profile, n, p, spread):
    eng, pods, _ = ref_rig(profile, n, p, n_existing=20)
    if spread:
        annotate(pods)
    _, hb, hc, _ = host_inputs(eng, pods)
    jb, jc, tb, tc = both(hb, hc)
    extra = None
    if spread:
        # The topology hard mask as the joint solve receives it.
        from kubernetes_tpu.engine.workloads import topology as r_topo
        extra, _ = r_topo.spread_planes(eng._topo_terms, jc.topo_dom)
    want_bias, want_key = eng.solver._price_iterate(jb, jc, 24, extra)
    got_bias, got_key = t_sv.Solver.for_policy(eng.policy)._price_iterate(
        tb, tc, 24, None if extra is None else
        torch.from_numpy(np.array(extra)))
    assert np.array_equal(_bits(got_bias.numpy()), _bits(want_bias))
    assert np.array_equal(_bits(got_key.numpy()), _bits(want_key))


@pytest.mark.parametrize("profile,n,p,spread", RIGS)
def test_solve_joint_matches_reference(profile, n, p, spread):
    """Choices, counter and the final cluster aggregates of one
    ``solve_joint`` from the same inputs and counter."""
    from kubernetes_tpu.engine import solver as r_sv
    eng, pods, _ = ref_rig(profile, n, p, n_existing=20)
    if spread:
        annotate(pods)
    batch, hb, hc, _ = host_inputs(eng, pods)
    jb, jc, tb, tc = both(hb, hc)
    flags = r_sv.batch_flags(batch)
    mask = bias = None
    if spread:
        from kubernetes_tpu.engine.workloads import topology as r_topo
        mask, bias = r_topo.spread_planes(eng._topo_terms, jc.topo_dom)
    counter = 2 ** 32 - 3
    want = eng.solver.solve_joint(jb, jc, jnp.uint32(counter), flags=flags,
                                  extra_mask=mask, score_bias=bias)
    t = None if mask is None else torch.from_numpy(np.array(mask))
    s = None if bias is None else torch.from_numpy(np.array(bias))
    got = t_sv.Solver.for_policy(eng.policy).solve_joint(
        tb, tc, torch.tensor([counter]), flags=t_sv.BatchFlags(*flags),
        extra_mask=t, score_bias=s)
    assert same(got[0], want[0])
    assert int(got[1][0]) == int(want[1])
    for f in ("requested", "nonzero", "ports_used", "vol_any", "vol_rw"):
        assert same(getattr(got[2], f), getattr(want[2], f)), f


def _pair(build):
    """(reference result, port result) of ``build(cls, conv, kw)``."""
    return (build(r_gs.GenericScheduler, _same, {}),
            build(t_gs.GenericScheduler, to_port, {"device": "cpu"}))


def _joint(rig):
    def build(cls, conv, kw):
        s, pods = rig(cls, conv, kw)
        got = s.schedule_batch(pods, joint=True)
        return got, int(s.last_node_index)
    return build


def _capacity_rig(cls, conv, kw):
    s = cls(**kw)
    for i in range(4):
        s.cache.add_node(conv(make_node(f"n{i}", milli_cpu=1000)))
    return s, [conv(make_pod(f"jp{i}", cpu="300m")) for i in range(16)]


def _contended_rig(cls, conv, kw):
    s = cls(**kw)
    for i in range(6):
        s.cache.add_node(conv(make_node(f"n{i}", milli_cpu=1000,
                                        memory=4 * 1024 ** 3)))
    rng = np.random.RandomState(3)
    pods = [conv(make_pod(f"mix{i}", cpu=f"{int(rng.choice([100, 400, 700]))}m",
                          memory="128Mi")) for i in range(40)]
    return s, pods


def _predicates_rig(cls, conv, kw):
    s = cls(**kw)
    s.cache.add_node(conv(make_node("gpu", labels={"accel": "tpu"})))
    s.cache.add_node(conv(make_node("fenced", taints=[
        {"key": "k", "value": "v", "effect": "NoSchedule"}])))
    s.cache.add_node(conv(make_node("plain")))
    return s, [conv(make_pod("sel", node_selector={"accel": "tpu"})),
               conv(make_pod("free1")), conv(make_pod("free2"))]


def _synth_rig(cls, conv, kw):
    if cls is r_gs.GenericScheduler:
        eng, pods, _ = ref_rig("mixed", 30, 200)
        return eng, pods
    return torch_rig("mixed", 30, 200, [])


@pytest.mark.parametrize("rig", [_capacity_rig, _contended_rig,
                                 _predicates_rig, _synth_rig])
def test_schedule_batch_joint_matches_reference(rig):
    want, got = _pair(_joint(rig))
    assert got == want
    placed = [d for d in got[0] if d is not None]
    if rig is _capacity_rig:
        assert len(placed) == 12
    if rig is _predicates_rig:
        assert got[0][0] == "gpu" and "fenced" not in got[0]


def test_joint_quality_matches_reference():
    def strip(rec):
        return {k: v for k, v in rec.items() if not k.endswith("_s")}
    want = r_wl.joint_quality(60, 600)
    got = t_wl.joint_quality(60, 600, device="cpu")
    assert strip(got) == strip(want)
    assert got["joint_placed"] > got["greedy_placed"]


@contextlib.contextmanager
def _joint_gate():
    old = (r_fg.DEFAULT_FEATURE_GATE, t_fg.DEFAULT_FEATURE_GATE)
    r_fg.set_default(r_fg.FeatureGate.parse("JointSolver=true"))
    t_fg.set_default(t_fg.FeatureGate.parse("JointSolver=true"))
    try:
        yield
    finally:
        r_fg.set_default(old[0])
        t_fg.set_default(old[1])


@pytest.mark.parametrize("n_pods", [40, 300])
def test_daemon_with_joint_gate_matches_reference(n_pods):
    """The same queue through both daemons with ``JointSolver`` on: one
    joint drain padded to a bucket (40 pods) or unpadded above the pad
    limit (300 pods), spread annotations included; bindings, counter,
    events and conditions equal."""
    from kubernetes_tpu.perf import synth as r_synth
    from kubernetes_tpu_torch.perf import synth as t_synth
    out = {}
    with _joint_gate():
        for side, synth_mod in (("ref", r_synth), ("port", t_synth)):
            d = daemon(side, 24, floor=16, _PAD_LIMIT=128)
            try:
                pods = annotate(synth_mod.make_pods(
                    n_pods, profile="mixed", n_services=4))
                for p in pods:
                    d.enqueue(p)
                d.schedule_pending(wait_first=False)
                out[side] = outcome(d, [p.key for p in pods])
            finally:
                d.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["bound"]


def test_prewarm_plan_topology_and_joint_keys_match_reference():
    ladder = [16, 32, 64]
    for joint in (False, True):
        want = {k for k in r_sched.prewarm_plan(ladder, [1], joint=joint)
                if k.startswith(("topo_planes", "oneshot_topo", "joint"))}
        got = {k for k in t_sched.prewarm_plan(ladder, cuda=False,
                                               joint=joint)
               if k.startswith(("topo_planes", "oneshot_topo", "joint"))}
        assert got == want
    assert not {k for k in t_sched.prewarm_plan([], cuda=False)
                if k.startswith(("topo", "oneshot_topo", "joint"))}


def test_prewarm_runs_the_joint_and_topology_drains():
    with _joint_gate():
        d = daemon("port", 16, floor=16, _PAD_LIMIT=64)
        try:
            plan = d.prewarm_plan()
            assert {"topo_planes", "oneshot_topo@16", "joint@16"} <= \
                set(plan)
            d.prewarm()
            assert sorted(d.workloads_prewarm_s) == \
                ["joint", "preempt", "topology"]
            assert sorted(d.prewarm_cache_stats) == \
                [k for k in plan if k != "select_rows@1"]
            # The warm pods are never assumed.
            assert not [k for k, _, _ in
                        d.config.algorithm.cache.tracked_pods()]
        finally:
            d.stop()


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded to the nearest f32, ties to even (exact)."""
    r = np.float32(float(x))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_f32_rounds_once():
    """``fma_f32`` against exact rational arithmetic: random triples,
    and triples whose float64 sum lands exactly on an f32 midpoint while
    the exact value lies below or above it (where rounding the float64
    sum to f32 would pick the wrong neighbour)."""
    rng = np.random.RandomState(0)
    a = (rng.randn(4000) * 10.0 ** rng.randint(-6, 6, 4000)).astype(
        np.float32)
    b = (rng.randn(4000) * 10.0 ** rng.randint(-6, 6, 4000)).astype(
        np.float32)
    c = (rng.randn(4000) * 10.0 ** rng.randint(-6, 6, 4000)).astype(
        np.float32)
    e18 = np.float32(2.0 ** -18)
    ties = [  # (a, b, c): c + a*b = midpoint -/+ 2^-60
        (np.float32(2.0 ** -24) * (1 + e18), 1 - e18,
         np.float32(1 + 2.0 ** -23)),
        (np.float32(2.0 ** -24) * (1 + e18), 1 + e18,
         np.float32(1 + 2.0 ** -23)),
        (-np.float32(2.0 ** -24) * (1 + e18), 1 - e18,
         np.float32(-(1 + 2.0 ** -23))),
    ]
    a = np.concatenate([a, [t[0] for t in ties]]).astype(np.float32)
    b = np.concatenate([b, [t[1] for t in ties]]).astype(np.float32)
    c = np.concatenate([c, [t[2] for t in ties]]).astype(np.float32)
    got = t_sv.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(_bits(got), _bits(want))
    # The crafted cases do hit the midpoint: the naive rounding differs.
    naive = (a[-3:].astype(np.float64) * b[-3:] + c[-3:]).astype(np.float32)
    assert not np.array_equal(_bits(naive), _bits(got[-3:]))


def test_repair_order_is_jnp_argsort_order():
    """``argsort(-key)`` as ``jnp.argsort`` orders it: stable, -0.0 and
    subnormals equal to 0.0, every NaN (either sign) after +inf."""
    rng = np.random.RandomState(1)
    key = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf,
                               np.nan, -np.nan, 3.0, 2 ** -140],
                              np.float32), 257)
    want = np.asarray(jnp.argsort(-jnp.asarray(key)))
    got = torch.argsort(t_sv._sort_key(-torch.from_numpy(key)),
                        stable=True).numpy()
    assert np.array_equal(got, want)

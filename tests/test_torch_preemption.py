"""The PyTorch port's priority preemption on the CPU against the JAX
package: ``victim_solve`` (torch ops) against the jitted JAX function,
exactly, on numpy-seeded tables; ``SchedulerCache.victim_table`` and
``GenericScheduler.find_preemptions`` decisions on a filled rig; and a
daemon preemption (evict -> assume -> bind) end to end.  Tolerance:
exact equality (int32 and bool outputs)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_node, make_pod
from kubernetes_tpu.api import types as r_api
from kubernetes_tpu.engine.generic_scheduler import \
    GenericScheduler as RScheduler
from kubernetes_tpu.engine.workloads import preemption as r_pre
from kubernetes_tpu_torch.engine.generic_scheduler import \
    GenericScheduler as TScheduler
from kubernetes_tpu_torch.engine.workloads import preemption as t_pre
from torch_parity import daemon, outcome, to_port


def _tables(n: int, v: int, flavour: str, seed: int) -> dict:
    """Inputs of one victim solve.  ``random``: mixed eligibility and
    sizes; ``zero_request``: the pod requests nothing (only a pod slot);
    ``ties``: equal victim priorities and sizes, so many nodes cost the
    same; ``ineligible``: every row's victims are at or above the pod's
    priority or invalid."""
    rng = np.random.RandomState(seed)
    alloc = np.stack([rng.choice([2000, 4000, 8000], n),
                      rng.choice([4096, 8192, 16384], n),
                      rng.randint(0, 2, n),
                      np.full(n, 8)], axis=1).astype(np.int32)
    frac = rng.uniform(0.5, 1.05, (n, 1))
    requested = np.minimum((alloc * frac).astype(np.int32),
                           alloc + 1).astype(np.int32)
    requested[:, 3] = rng.randint(4, 9, n)
    vic_req = np.stack([rng.randint(0, 1500, (n, v)),
                        rng.randint(0, 3000, (n, v)),
                        rng.randint(0, 2, (n, v)),
                        np.ones((n, v), np.int64)], axis=2).astype(np.int32)
    vic_prio = rng.randint(0, 12, (n, v)).astype(np.int32)
    vic_prio.sort(axis=1)
    vic_valid = rng.rand(n, v) < 0.8
    base_ok = rng.rand(n) < 0.85
    pod_req = np.array([rng.randint(100, 3000), rng.randint(100, 6000),
                        0, 1], np.int32)
    pod_prio = 8
    if flavour == "zero_request":
        pod_req = np.array([0, 0, 0, 1], np.int32)
    elif flavour == "ties":
        vic_prio[:] = 3
        vic_req[:] = np.array([700, 1000, 0, 1], np.int32)
        requested = alloc.copy()
        requested[:, 3] = 8
        base_ok[:] = True
    elif flavour == "ineligible":
        vic_prio[:] = pod_prio + rng.randint(0, 3, (n, v))
        vic_valid[: n // 2] = False
    return dict(alloc=alloc, requested=requested, base_ok=base_ok,
                vic_req=vic_req, vic_prio=vic_prio, vic_valid=vic_valid,
                pod_req=pod_req,
                pod_zero=bool(pod_req[0] == pod_req[1] == pod_req[2] == 0),
                pod_prio=pod_prio)


@pytest.mark.parametrize("flavour",
                         ["random", "zero_request", "ties", "ineligible"])
@pytest.mark.parametrize("v", [1, 4, 16])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_victim_solve_matches_reference(n, v, flavour):
    t = _tables(n, v, flavour, seed=n * 100 + v)
    want = r_pre.victim_solve(
        *(jnp.asarray(t[k]) for k in ("alloc", "requested", "base_ok",
                                      "vic_req", "vic_prio", "vic_valid",
                                      "pod_req")),
        jnp.asarray(t["pod_zero"]), jnp.asarray(t["pod_prio"], jnp.int32))
    got = t_pre.victim_solve(
        *(torch.from_numpy(np.ascontiguousarray(t[k]))
          for k in ("alloc", "requested", "base_ok", "vic_req", "vic_prio",
                    "vic_valid", "pod_req")),
        torch.tensor(t["pod_zero"]),
        torch.tensor(t["pod_prio"], dtype=torch.int32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)
    k, c, f = (x.numpy() for x in got)
    assert t_pre.pick_node(k, c, f) == r_pre.pick_node(
        *(np.asarray(x) for x in want))
    if flavour == "ineligible":
        # No victim is eligible: only nodes where the pod already fits
        # can be feasible, at k = 0.
        assert (k[f] == 0).all()


def test_prewarm_launches_at_the_padded_width():
    assert t_pre.padded_width(16) == 16 and t_pre.padded_width(5) == 8
    t_pre.prewarm_shapes(5, "cpu")


def _filled(cls, api_conv, **kw):
    """8 nodes of 2 CPUs, each holding two low-priority pods of 900m
    (priorities 0..3); the preemptors are priority pods of 1500m that fit
    nowhere."""
    eng = cls(**kw)
    for i in range(8):
        eng.cache.add_node(api_conv(make_node(f"pn{i}", milli_cpu=2000)))
    for i in range(16):
        p = make_pod(f"low{i}", cpu="900m", node_name=f"pn{i % 8}")
        p.annotations[r_api.PRIORITY_ANNOTATION_KEY] = str((i * 5) % 4)
        eng.cache.add_pod(api_conv(p))
    return eng


def _preemptors(api_conv, n: int) -> list:
    out = []
    for i in range(n):
        p = make_pod(f"hi{i}", cpu="1500m")
        p.annotations[r_api.PRIORITY_ANNOTATION_KEY] = str(10 + i % 3)
        out.append(api_conv(p))
    return out


def _same(x):
    return x


def test_victim_table_and_decisions_match_reference():
    ref = _filled(RScheduler, _same)
    port = _filled(TScheduler, to_port, device="cpu")
    rt = ref.cache.victim_table(r_pre.MAX_VICTIMS,
                                exclude=frozenset({"default/low3"}))
    tt = port.cache.victim_table(t_pre.MAX_VICTIMS,
                                 exclude=frozenset({"default/low3"}))
    for f in ("req", "prio", "valid"):
        assert np.array_equal(getattr(tt, f), getattr(rt, f)), f
    assert tt.keys == rt.keys
    want = ref.find_preemptions(_preemptors(_same, 5))
    got = port.find_preemptions(_preemptors(to_port, 5))
    assert [vars(d) for d in got] == [vars(d) for d in want]
    assert len(got) == 5
    # A zero-priority pod never preempts; an empty cluster decides nothing.
    assert port.find_preemptions([to_port(make_pod("zero",
                                                   cpu="1500m"))]) == []
    assert TScheduler(device="cpu").find_preemptions(
        _preemptors(to_port, 1)) == []


def test_daemon_preemption_matches_reference():
    """Both daemons over the same filled cluster drain the same queue
    (three preemptors, one pod that fits as it is): the preemptors bind
    to the nominated nodes, the victims are evicted with a Preempted
    event, and every binding, event and condition write is equal."""
    results = {}
    for side, cls, conv, kw in (("ref", RScheduler, _same, {}),
                                ("port", TScheduler, to_port,
                                 {"device": "cpu"})):
        eng = _filled(cls, conv, **kw)
        d = daemon(side, eng=eng, flight=True)
        try:
            for i in range(16):
                d.config.binder.bind(conv(make_pod(f"low{i}")),
                                     f"pn{i % 8}")
            pods = _preemptors(conv, 3) + [conv(make_pod("small",
                                                         cpu="50m"))]
            for p in pods:
                d.enqueue(p)
            assert d.schedule_pending(wait_first=False) == 4
            keys = [p.key for p in pods] + [f"default/low{i}"
                                            for i in range(16)]
            out = outcome(d, keys)
            out["nominated"] = [p.nominated_node for p in pods]
            out["explain"] = [
                (d.config.flight_recorder.explain(k) or {}).get(
                    "preempted_victims") for k in keys[:3]]
            out["tracked"] = sorted(k for k, _, _ in
                                    eng.cache.tracked_pods())
            results[side] = out
        finally:
            d.stop()
    assert results["port"] == results["ref"]
    port = results["port"]
    assert all(port["nominated"][:3])
    assert sum(1 for k, evs in port["events"].items()
               if any(e[1] == "Preempted" for e in evs)) >= 3

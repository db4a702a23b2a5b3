"""The rich families of the scan (host ports, NoDiskConflict, the MaxEBS
and MaxGCE counts, inter-pod affinity and its priority, service
anti-affinity) through the port's step loop against the JAX package's
``_solve_scan``, one family at a time and all together.

Each rig is ``perf/scan_check.py:rig_spec`` at a small size: the rig the
card holds the scan kernel to the step loop on, handed to the reference
through the JSON codec both packages share.  Both sides scan the host
batch the reference compiles, in chunks with carried state.  Tolerance:
exact equality of the choices, the round-robin counter and every carried
state tensor after each chunk (floats bit for bit).  The priority
counts' and ImageLocality's sums, taken in float64 in the port, are
pinned against the reference at the inputs where TF32 would round."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import policy as r_pol
from kubernetes_tpu.api import types as r_api
from kubernetes_tpu.cache.scheduler_cache import SchedulerCache as RCache
from kubernetes_tpu.engine import generic_scheduler as r_gs
from kubernetes_tpu.engine import solver as ref_sv
from kubernetes_tpu.ops import interpod as r_interpod
from kubernetes_tpu.ops import priorities as r_prio
from kubernetes_tpu_torch.api import types as t_api
from kubernetes_tpu_torch.engine import convert
from kubernetes_tpu_torch.engine import solver as t_sv
from kubernetes_tpu_torch.ops import interpod as t_interpod
from kubernetes_tpu_torch.ops import priorities as t_prio
from kubernetes_tpu_torch.perf import scan_check

from torch_parity import both, host_inputs, same

N_NODES, N_PODS, CHUNK = 24, 64, 32


def _reference(spec: scan_check.RigSpec):
    """The reference engine and pending pods for a port RigSpec."""
    cache = RCache()
    for nd in spec.nodes:
        cache.add_node(r_api.node_from_json(t_api.node_to_json(nd)))
    for pod in spec.existing:
        cache.add_pod(r_api.pod_from_json(t_api.pod_to_json(pod)))
    policy = r_pol.Policy(
        predicates=[r_pol.PredicateSpec(**vars(s))
                    for s in spec.policy.predicates],
        priorities=[r_pol.PrioritySpec(**vars(s))
                    for s in spec.policy.priorities])
    listers = r_gs.Listers(
        services=[r_api.Service(name=s.name, namespace=s.namespace,
                                selector=dict(s.selector))
                  for s in spec.services],
        pvcs=[r_api.PersistentVolumeClaim(name=c.name,
                                          namespace=c.namespace,
                                          volume_name=c.volume_name)
              for c in spec.pvcs])
    eng = r_gs.GenericScheduler(policy=policy, cache=cache, listers=listers)
    pods = [r_api.pod_from_json(t_api.pod_to_json(p)) for p in spec.pods]
    return eng, pods


# The scan families each rig must turn on (beyond resources and spread).
EXPECT = {
    "host ports": {"use_ports"},
    "volumes": {"use_volumes"},
    "disk counts": {"use_max_ebs", "use_max_gce"},
    "anti-affinity by hostname": {"use_interpod", "track_affinity"},
    "affinity with the self-match escape": {"use_interpod",
                                            "track_affinity"},
    "soft affinity, symmetric": {"track_affinity"},
    "service anti-affinity": {"track_saa"},
    "all": {"use_ports", "use_volumes", "use_max_ebs", "use_max_gce",
            "use_interpod", "track_affinity", "track_saa"},
}
RICH = set().union(*EXPECT.values())


def _families(solver, tb, tc, flags, monkeypatch) -> set:
    seen = {}

    def capture(self, b, c, last, mask, score, carry, has_bias, fams,
                prios, route=None, cluster=None):
        seen["fams"] = fams
        raise StopIteration

    with monkeypatch.context() as m:
        m.setattr(t_sv.Solver, "_fused_scan", capture)
        with pytest.raises(StopIteration):
            solver._solve_scan(tb, tc, convert.counter_from_numpy(0, "cpu"),
                               None, flags, None, None, None)
    return {f for f in RICH if seen["fams"][f]}


@pytest.mark.parametrize("family", list(EXPECT))
def test_chunked_rich_drain_matches_reference(family, monkeypatch):
    """Chunk by chunk, the port's step loop against the reference's own
    chunked scan: choices, counter and the carried dict after each."""
    spec = scan_check.rig_spec(family, N_NODES, N_PODS)
    eng, pods = _reference(spec)
    batch, hb, hc, _ = host_inputs(eng, pods)
    flags = ref_sv.batch_flags(batch)
    jb, jc, tb, tc = both(hb, hc)
    solver = t_sv.Solver(spec.policy)
    t_flags = t_sv.BatchFlags(*flags)
    assert _families(solver, tb, tc, t_flags, monkeypatch) == EXPECT[family]
    start_counter = 2 ** 32 - 9
    cj = jnp.uint32(start_counter)
    ct = convert.counter_from_numpy(start_counter, "cpu")
    carry_j = carry_t = None
    placed = unplaced = 0
    for start in range(0, N_PODS, CHUNK):
        ch_j, cj, carry_j = eng.solver._solve_scan(
            jax.device_put(ref_sv.slice_pod_axis(hb, start, start + CHUNK)),
            jc, cj, None, flags, carry_j, None, None)
        ch_t, ct, carry_t = solver._solve_scan(
            t_sv.slice_pod_axis(tb, start, start + CHUNK), tc, ct, None,
            t_flags, carry_t, None, None)
        assert same(ch_t, ch_j), start
        assert int(ct[0]) == int(np.asarray(cj)), start
        assert set(carry_t) == set(carry_j)
        for k in carry_j:
            if k != "counter":
                assert same(carry_t[k], carry_j[k]), (start, k)
        placed += int((ch_t >= 0).sum())
        unplaced += int((ch_t < 0).sum())
    assert placed > 0
    if family in ("affinity with the self-match escape", "all"):
        assert unplaced > 0  # terms nobody can satisfy


def test_unplaced_steps_keep_the_affinity_state():
    """A hostname anti-affinity group larger than the cluster: the steps
    that find no node leave every carried tensor as it was."""
    spec = scan_check.rig_spec("anti-affinity by hostname", 6, 48,
                               n_existing=4)
    eng, pods = _reference(spec)
    batch, hb, hc, _ = host_inputs(eng, pods)
    flags = ref_sv.batch_flags(batch)
    jb, jc, tb, tc = both(hb, hc)
    ch_j, cnt_j, fin_j = eng.solver._solve_scan(
        jb, jc, jnp.uint32(3), None, flags, None, None, None)
    ch_t, cnt_t, fin_t = t_sv.Solver(spec.policy)._solve_scan(
        tb, tc, convert.counter_from_numpy(3, "cpu"), None,
        t_sv.BatchFlags(*flags), None, None, None)
    assert same(ch_t, ch_j)
    assert int(cnt_t[0]) == int(np.asarray(cnt_j))
    assert int((ch_t < 0).sum()) > 0
    for k in fin_j:
        if k != "counter":
            assert same(fin_t[k], fin_j[k]), k


def test_priority_counts_are_exact_past_tf32():
    """Counts past 2,048 (a zone with 3,001 matching pods) and weights
    whose products pass 2^24: the port's float64 sums, rounded once,
    equal the reference's f32 contraction below 2^24 and are the exactly
    rounded value above it."""
    rng = np.random.RandomState(3)
    p, sm, ss, n = 5, 4, 3, 9
    pref_w = rng.randint(-100, 101, (p, sm)).astype(np.float32)
    match_cnt = rng.randint(0, 4000, (sm, n)).astype(np.float32)
    match_cnt[1, :] = 3001.0
    sym_match = rng.rand(p, ss) < 0.6
    sym_w = rng.randint(-10, 11, ss).astype(np.float32)
    sym_cnt = rng.randint(0, 3000, (ss, n)).astype(np.float32)
    t = [torch.from_numpy(x) for x in
         (pref_w, match_cnt, sym_match, sym_w, sym_cnt)]
    got = t_interpod.priority_counts(*t)
    want = r_interpod.priority_counts(*map(jnp.asarray, (
        pref_w, match_cnt, sym_match, sym_w, sym_cnt)))
    assert same(got, want)
    exact = pref_w.astype(np.float64) @ match_cnt.astype(np.float64) + \
        (sym_match * sym_w).astype(np.float64) @ sym_cnt.astype(np.float64)
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    big = t_interpod.priority_counts(
        torch.full((1, 2), 16777.0), torch.full((2, 1), 1001.0),
        torch.zeros((1, 1), dtype=torch.bool), torch.zeros(1),
        torch.zeros((1, 1)))
    assert float(big[0, 0]) == np.float32(2 * 16777.0 * 1001.0)


def test_image_locality_is_exact_past_tf32():
    """A 123,597 KiB image on the node (bucket 2; TF32 would round it to
    123,584 KiB, bucket 1) and sums of several large images."""
    kib = np.array([[123597, 0, 0], [900000, 700000, 5],
                    [23551, 1, 0], [23552, 0, 0]], np.int32)
    pods = np.array([[True, False, False], [True, True, True],
                     [False, True, True]])
    got = t_prio.image_locality(torch.from_numpy(pods),
                                torch.from_numpy(kib))
    want = r_prio.image_locality(jnp.asarray(pods), jnp.asarray(kib))
    assert same(got, want)
    assert float(got[0, 0]) == 2.0

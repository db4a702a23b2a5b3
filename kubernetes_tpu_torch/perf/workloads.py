"""Workloads-subsystem bench + parity harness.

Counterpart of ``kubernetes_tpu/perf/workloads.py`` for this package:
every engine runs on ``device`` (the card by default), and the
preemption replay uses this package's copy of the oracle.  Three
measurements for the gang / preemption / topology subsystem
(engine/workloads/):

* ``joint_quality`` — the quality-vs-greedy row the check_bench ratchet
  pins: placements of the LP-joint solve vs greedy order on an
  overcommitted fleet (the 12% win ROADMAP item 4 productionizes), with
  cold and warm wall-clock (warm = second run against the already-traced
  executable; the one-jit joint pipeline makes warm ~solve-only).
* ``preemption_parity`` — engine victim-solve decisions replayed against
  the pure-Python oracle (kubernetes_tpu/oracle.preempt), the PARITY.json
  harness pattern: agreement is exact cost match (victim count, summed
  victim priority) with the chosen node in the oracle's argmin set.
* ``gang`` — all-or-nothing admission on a fleet of multi-slice gangs:
  solve wall-time (warm), admitted/rejected split, and the partial-gang
  invariant probe (must be zero).

Run: ``python -m kubernetes_tpu_torch.perf.workloads --out
build/WORKLOADS_cuda.json`` (on a card; ``--device cpu`` elsewhere).
The record names its backend and, on a card, the card's name and power
limit.  ``WORKLOADS_r06.json`` is the JAX package's record, and the CLI
refuses to write it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from kubernetes_tpu_torch import oracle
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.engine.generic_scheduler import GenericScheduler
from kubernetes_tpu_torch.perf.parity import (IndexedClusterState, backend,
                                              refuse_reference_artifact)
from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                      SchedulerConfig)


def _node(name: str, cpu: int, mem_gib: int = 8) -> api.Node:
    return api.Node(
        name=name, labels={api.HOSTNAME_LABEL: name},
        allocatable_milli_cpu=cpu, allocatable_memory=mem_gib * 1024 ** 3,
        allocatable_pods=110,
        conditions=[api.NodeCondition("Ready", "True")])


def _pod(name: str, cpu: int, mem_mib: int = 64, prio: int = 0,
         gang: str = "", gang_size: int = 0) -> api.Pod:
    ann: dict[str, str] = {}
    if prio:
        ann[api.PRIORITY_ANNOTATION_KEY] = str(prio)
    if gang:
        ann[api.GANG_ANNOTATION_KEY] = gang
        ann[api.GANG_SIZE_ANNOTATION_KEY] = str(gang_size)
    return api.Pod(
        name=name, namespace="default", annotations=ann,
        containers=[api.Container(
            name="c", requests={"cpu": f"{cpu}m",
                                "memory": f"{mem_mib}Mi"})])


# -- joint quality (the check_bench ratchet row) -------------------------

def joint_rig(n_nodes: int = 500, n_pods: int = 6000, seed: int = 7,
              device: str = "cuda") -> tuple:
    """(scheduler, pods) of ``joint_quality``: an overcommitted fleet of
    1- and 2-CPU nodes and pods of 100m, 400m or 700m."""
    s = GenericScheduler(device=device)
    rng = np.random.RandomState(seed)
    for i in range(n_nodes):
        s.cache.add_node(_node(f"jn-{i}", int(rng.choice([1000, 2000]))))
    rng2 = np.random.RandomState(seed + 1)
    pods = [_pod(f"jq-{i}", int(rng2.choice([100, 400, 700])))
            for i in range(n_pods)]
    return s, pods


def joint_quality(n_nodes: int = 500, n_pods: int = 6000,
                  seed: int = 7, device: str = "cuda") -> dict:
    """Greedy vs LP-joint placements on an overcommitted mixed fleet,
    plus cold/warm wall-clock of the joint solve."""
    s1, pods1 = joint_rig(n_nodes, n_pods, seed, device)
    t0 = time.perf_counter()
    greedy = sum(1 for d in s1.schedule_batch(pods1) if d is not None)
    greedy_s = time.perf_counter() - t0
    s2, pods2 = joint_rig(n_nodes, n_pods, seed, device)
    t0 = time.perf_counter()
    joint = sum(1 for d in s2.schedule_batch(pods2, joint=True)
                if d is not None)
    joint_cold_s = time.perf_counter() - t0
    s3, pods3 = joint_rig(n_nodes, n_pods, seed, device)
    t0 = time.perf_counter()
    joint2 = sum(1 for d in s3.schedule_batch(pods3, joint=True)
                 if d is not None)
    joint_warm_s = time.perf_counter() - t0
    return {
        "metric": f"joint vs greedy placements, {n_pods} pods onto an "
                  f"overcommitted {n_nodes}-node fleet",
        "greedy_placed": greedy,
        "joint_placed": max(joint, joint2),
        "joint_vs_greedy": round(max(joint, joint2) / max(greedy, 1), 4),
        "greedy_s": round(greedy_s, 3),
        "joint_cold_s": round(joint_cold_s, 3),
        "joint_warm_s": round(joint_warm_s, 3),
    }


# -- preemption parity (the PARITY.json harness pattern) -----------------

def run_preemption_parity(n_nodes: int = 40, n_low: int = 300,
                          n_high: int = 40, seed: int = 0,
                          device: str = "cuda") -> dict:
    """Engine preemption decisions vs the oracle, replayed step by step.

    A fleet is filled with low-priority pods to (over)commitment, then
    high-priority pods that need evictions arrive one at a time; each
    engine decision is judged against the oracle's argmin set ON THE SAME
    STATE, then the engine's decision is applied to both sides (so one
    divergence cannot cascade)."""
    rng = np.random.RandomState(seed)
    eng = GenericScheduler(device=device)
    nodes = [_node(f"pn-{i}", int(rng.choice([1000, 2000])))
             for i in range(n_nodes)]
    for nd in nodes:
        eng.cache.add_node(nd)
    low = [_pod(f"low-{i}", int(rng.choice([200, 400, 600])),
                prio=int(rng.choice([1, 2, 3])))
           for i in range(n_low)]
    placements = eng.schedule_batch(low)
    cluster = IndexedClusterState(nodes=nodes)
    bound = 0
    for pod, dest in zip(low, placements):
        if dest is None:
            continue
        pod.node_name = dest
        eng.cache.add_pod(pod)
        cluster.add_pod(pod)
        bound += 1

    agree = disagree = none_agree = none_disagree = 0
    examples: list[dict] = []
    t0 = time.perf_counter()
    for i in range(n_high):
        pod = _pod(f"high-{i}", int(rng.choice([400, 700, 900])),
                   prio=10)
        decisions = eng.find_preemptions([pod])
        ocands = oracle.preempt_candidates(pod, cluster)
        odec = oracle.preempt(pod, cluster)
        if not decisions:
            if odec is None or odec[1] == 0:
                # Engine only preempts pods the solver failed; a pod the
                # oracle would place victim-free is out of scope here.
                none_agree += 1
            else:
                none_disagree += 1
                if len(examples) < 5:
                    examples.append({"pod": pod.name,
                                     "kind": "engine-none",
                                     "oracle": odec})
            continue
        dec = decisions[0]
        k, cost = len(dec.victims), dec.prio_cost
        best = min(ocands.values()) if ocands else None
        if best is not None and (k, cost) == best and \
                ocands.get(dec.node) == best:
            agree += 1
        else:
            disagree += 1
            if len(examples) < 5:
                examples.append({"pod": pod.name, "kind": "cost-mismatch",
                                 "engine": [dec.node, k, cost],
                                 "oracle_best": best,
                                 "oracle_at_choice":
                                 ocands.get(dec.node)})
        # Replay the ENGINE decision into both states.
        for vkey in dec.victims:
            vpod = eng.cache.get_pod(vkey)
            if vpod is not None:
                eng.cache.remove_pod(vpod)
            cluster.pods = [p for p in cluster.pods if p.key != vkey]
            cluster._pods_by_node[dec.node] = [
                p for p in cluster._pods_by_node.get(dec.node, [])
                if p.key != vkey]
        pod.node_name = dec.node
        eng.cache.add_pod(pod)
        cluster.add_pod(pod)
    replay_s = time.perf_counter() - t0
    judged = agree + disagree + none_agree + none_disagree
    return {
        "n_nodes": n_nodes, "low_pods_bound": bound,
        "high_pods": n_high, "judged": judged,
        "parity_pct": round(100.0 * (agree + none_agree) /
                            max(judged, 1), 3),
        "agree": agree, "disagree": disagree,
        "none_agree": none_agree, "none_disagree": none_disagree,
        "replay_s": round(replay_s, 2),
        "examples": examples,
    }


# -- gang bench ----------------------------------------------------------

def gang_bench(n_nodes: int = 64, n_gangs: int = 24,
               gang_size: int = 8, seed: int = 3,
               device: str = "cuda") -> dict:
    """All-or-nothing admission over a fleet of multi-slice gangs sized
    past capacity: warm solve wall-time, admitted/rejected split, and the
    partial-gang probe (MUST be zero — the un-fakeable invariant)."""
    def build():
        alg = GenericScheduler(device=device)
        for i in range(n_nodes):
            alg.cache.add_node(_node(f"gn-{i}", 4000))
        daemon = Scheduler(SchedulerConfig(
            algorithm=alg, binder=InMemoryBinder(), async_bind=False))
        pods = []
        rng = np.random.RandomState(seed)
        for g in range(n_gangs):
            cpu = int(rng.choice([500, 1000, 2000]))
            for m in range(gang_size):
                pods.append(_pod(f"g{g}-m{m}", cpu, gang=f"gang-{g}",
                                 gang_size=gang_size))
        return daemon, pods

    daemon, pods = build()   # cold run: the first launches
    try:
        for p in pods:
            daemon.enqueue(p)
        daemon.schedule_pending(wait_first=False)
    finally:
        daemon.stop()
    daemon2, pods2 = build()
    try:
        for p in pods2:
            daemon2.enqueue(p)
        t0 = time.perf_counter()
        daemon2.schedule_pending(wait_first=False)
        daemon2.wait_for_binds()
        warm_s = time.perf_counter() - t0
    finally:
        daemon2.stop()
    binder = daemon2.config.binder
    by_gang: dict[str, int] = {}
    for pod in pods2:
        if binder.bound_node(pod.key):
            by_gang[pod.gang] = by_gang.get(pod.gang, 0) + 1
    partial = [g for g, n in by_gang.items() if 0 < n < gang_size]
    return {
        "metric": f"gang all-or-nothing admission, {n_gangs} gangs x "
                  f"{gang_size} members onto {n_nodes} nodes",
        "gangs_admitted": sum(1 for n in by_gang.values()
                              if n == gang_size),
        "gangs_total": n_gangs,
        "partial_gangs_bound": len(partial),
        "warm_solve_s": round(warm_s, 3),
    }


def collect(quick: bool = False, device: str = "cuda") -> dict:
    """The WORKLOADS record body."""
    shape = (100, 1200) if quick else (
        int(os.environ.get("BENCH_WL_NODES", "500")),
        int(os.environ.get("BENCH_WL_PODS", "6000")))
    out = {
        "harness": "kubernetes_tpu_torch/perf/workloads.py (gang "
                   "admission, preemption oracle parity, joint-vs-greedy "
                   "quality)",
        **backend(device),
        "joint_quality": joint_quality(*shape, device=device),
        "preemption_parity": run_preemption_parity(device=device),
        "gang": gang_bench(device=device),
    }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="build/WORKLOADS_cuda.json")
    ap.add_argument("--quick", action="store_true",
                    help="small joint-quality shape")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    refuse_reference_artifact(opts.out, "WORKLOADS_r06.json")
    out = collect(quick=opts.quick, device=opts.device)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "harness"},
                     indent=1), file=sys.stderr)
    print(f"wrote {opts.out}")


if __name__ == "__main__":
    main()

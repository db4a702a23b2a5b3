"""Decision-parity harness at scale: the batched device drain vs the
pure-Python oracle, replayed sequentially.

The engine's ``schedule_batch`` is a sequential-greedy solve in queue order
with full in-batch visibility (engine/solver.py scan carry), so its
decisions should match the reference's one-pod-at-a-time loop
(generic_scheduler.go:93-153) run over the same evolving cluster state.
This harness proves it at scale:

1. drain N pending pods through ``schedule_batch`` (the path both the
   daemon and the bench use);
2. replay the engine's placements through an oracle ClusterState one pod
   at a time; at sampled steps, run the full oracle
   (``find_nodes_that_fit`` + ``prioritize``) on the state induced by the
   engine's PRIOR placements and check the engine's choice is in the
   oracle's argmax set (the reference's tie order is nondeterministic, so
   parity is set membership — generic_scheduler.go:124-141);
3. separately bound the one documented in-batch staleness:
   ServiceAntiAffinityPriority peer counts are snapshotted at batch start
   (engine/solver.py:59-64), so the harness measures, at each sampled
   step, how far live peer counts have drifted the oracle's
   ServiceAntiAffinity score from its batch-start value.

Decisions are judged per-step against the engine's own induced state, so
one divergence doesn't cascade into every later step being "wrong".

Counterpart of ``kubernetes_tpu/perf/parity.py`` for this package: the
drain runs on ``device`` (the card by default), the replay against this
package's copy of the oracle.

Run: ``python -m kubernetes_tpu_torch.perf.parity --out
build/PARITY_cuda.json`` (on a card; ``--device cpu`` elsewhere).
The record names its backend and, on a card, the card's name and power
limit.  ``PARITY.json`` is the JAX package's record, and the CLI refuses
to write it.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import time

import numpy as np

from kubernetes_tpu_torch import oracle
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import (Policy, PrioritySpec,
                                             default_provider)
from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
from kubernetes_tpu_torch.engine.generic_scheduler import (GenericScheduler,
                                                          Listers)
from kubernetes_tpu_torch.perf import synth
from kubernetes_tpu_torch.utils import device as device_mod


class IndexedClusterState(oracle.ClusterState):
    """ClusterState with dict indexes so a 10k-pod replay is O(1) per
    lookup instead of O(pods)-per-node-per-predicate.  Pure container
    optimization — every oracle function still sees identical data."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._node_by_name = {n.name: n for n in self.nodes}
        self._pods_by_node: dict[str, list[api.Pod]] = {}
        self._affinity_pods: list[api.Pod] = []
        self._ready = [n for n in self.nodes if n.is_ready()]
        for p in self.pods:
            self._index_pod(p)

    def _index_pod(self, pod: api.Pod) -> None:
        self._pods_by_node.setdefault(pod.node_name, []).append(pod)
        if pod.affinity() is not None:
            self._affinity_pods.append(pod)

    def add_pod(self, pod: api.Pod) -> None:
        self.pods.append(pod)
        self._index_pod(pod)

    def node(self, name: str):
        return self._node_by_name.get(name)

    def node_pods(self, name: str):
        return self._pods_by_node.get(name, [])

    def ready_nodes(self):
        return self._ready

    def affinity_pods(self):
        return self._affinity_pods


def _saa_policy(label: str) -> Policy:
    """DefaultProvider plus a ServiceAntiAffinity priority on ``label`` —
    the policy shape a CreateFromConfig user gets (api/types.go:95-110)."""
    pol = default_provider()
    pol.priorities = list(pol.priorities) + [
        PrioritySpec("ServiceAntiAffinityPriority", weight=1,
                     anti_affinity_label=label)]
    return pol


def run_parity(n_nodes: int, n_pods: int, seed: int = 0,
               n_samples: int = 200, profile: str = "rich",
               n_services: int = 4, n_zones: int = 4,
               saa_label: str = "", device: str = "cuda") -> dict:
    """Drain (on ``device``) + replay one synthetic cluster; return the
    agreement record.

    ``saa_label``: when set, schedule with DefaultProvider +
    ServiceAntiAffinity(label) and additionally measure the batch-start
    vs live drift of the ServiceAntiAffinity score at each sampled step.
    """
    nodes = synth.make_nodes(n_nodes, seed=seed, profile=profile,
                             n_zones=n_zones)
    pods = synth.make_pods(n_pods, seed=seed + 1, profile=profile,
                           n_services=n_services)
    services = synth.make_services(n_services)

    cache = SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    policy = _saa_policy(saa_label) if saa_label else None
    eng = GenericScheduler(policy=policy, cache=cache,
                           listers=Listers(services=services), device=device)
    t0 = time.perf_counter()
    placements = eng.schedule_batch(pods)
    drain_s = time.perf_counter() - t0
    rec = judge(nodes, pods, services, placements, seed=seed,
                n_samples=n_samples, saa_label=saa_label)
    rec.update(n_nodes=n_nodes, profile=profile, drain_s=round(drain_s, 3))
    return rec


def judge(nodes: list, pods: list, services: list, placements: list,
          seed: int = 0, n_samples: int = 200, saa_label: str = "",
          workers: int = 1) -> dict:
    """Replay ``placements`` (one node name or None per pod, in order)
    through the oracle, judging about ``n_samples`` decisions drawn from
    ``seed``: each against the oracle's feasible set and best score on
    the cluster as the earlier placements left it.  The replay stops
    after the last sampled decision.  With ``workers`` = 1 it runs here
    and marks each pod it replays bound (``pod.node_name``); with more,
    each of that many worker processes (spawned, given the inputs as
    arguments) replays the placements up to its share of the sampled
    decisions and judges that share (the judgments do not depend on one
    another).  Returns the agreement record."""
    n_pods = len(pods)
    rng = np.random.RandomState(seed + 17)
    sampled = sorted(rng.choice(n_pods, size=min(n_samples, n_pods),
                                replace=False).tolist())
    args = (nodes, pods, services, placements, saa_label)
    t1 = time.perf_counter()
    if workers <= 1:
        parts = [_judge_part(args, set(sampled))]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            parts = pool.starmap(_judge_part, [
                (args, set(sampled[w::workers])) for w in range(workers)])
    replay_s = time.perf_counter() - t1
    tot = {k: sum(part[k] for part in parts)
           for k in ("agree", "disagree", "none_agree", "none_disagree",
                     "infeasible", "saa_flips")}
    score_gaps = [g for part in parts for g in part["score_gaps"]]
    saa_drifts = [d for part in parts for d in part["saa_drifts"]]
    examples = [ex for _, ex in sorted(
        (item for part in parts for item in part["examples"]),
        key=lambda item: item[0])][:10]

    judged = tot["agree"] + tot["disagree"] + tot["none_agree"] + \
        tot["none_disagree"]
    placed = sum(1 for d in placements if d is not None)
    rec = {
        "n_nodes": len(nodes), "n_pods": n_pods, "seed": seed,
        "placed": placed,
        "sampled_decisions": judged,
        "decision_agreement_pct": round(
            100.0 * (tot["agree"] + tot["none_agree"]) / max(judged, 1), 3),
        "agree": tot["agree"], "disagree": tot["disagree"],
        "unschedulable_agree": tot["none_agree"],
        "unschedulable_disagree": tot["none_disagree"],
        "infeasible_choices": tot["infeasible"],
        "max_score_gap": max(score_gaps) if score_gaps else 0,
        "replay_s": round(replay_s, 1),
        "examples": examples,
    }
    if saa_label:
        rec["service_anti_affinity"] = {
            "label": saa_label,
            "scoring": "live in-batch peer counts (scan-carried)",
            "max_score_drift_vs_batch_start": max(saa_drifts)
            if saa_drifts else 0,
            "mean_score_drift_vs_batch_start": round(
                float(np.mean(saa_drifts)), 3) if saa_drifts else 0.0,
            "stale_scoring_would_flip": tot["saa_flips"],
            "samples": len(saa_drifts),
        }
    return rec


def _judge_part(args: tuple, sampled: set) -> dict:
    """Replay the placements up to the last decision in ``sampled``,
    judging those decisions."""
    nodes, pods, services, placements, saa_label = args
    cluster = IndexedClusterState(nodes=nodes, services=services)
    last = max(sampled, default=-1)

    # Batch-start ServiceAntiAffinity scores per service signature (the
    # engine's static view) for the drift bound.
    saa_start: dict[tuple, dict[str, int]] = {}
    if saa_label:
        for pod in pods:
            sig = _first_service_sig(pod, services)
            if sig not in saa_start:
                saa_start[sig] = oracle.service_anti_affinity(
                    pod, cluster, saa_label)

    out = {"agree": 0, "disagree": 0, "none_agree": 0, "none_disagree": 0,
           "infeasible": 0, "saa_flips": 0, "score_gaps": [],
           "saa_drifts": [], "examples": []}
    examples = out["examples"]
    for i, (pod, dest) in enumerate(zip(pods, placements)):
        if i > last:
            break
        if i in sampled:
            fits, _ = oracle.find_nodes_that_fit(pod, cluster)
            onames = {n.name for n in fits}
            if dest is None:
                if onames:
                    out["none_disagree"] += 1
                    if len(examples) < 10:
                        examples.append((i, {
                            "pod": pod.name, "kind": "engine-none",
                            "oracle_feasible": len(onames)}))
                else:
                    out["none_agree"] += 1
            elif dest not in onames:
                out["infeasible"] += 1
                out["disagree"] += 1
                if len(examples) < 10:
                    examples.append((i, {"pod": pod.name,
                                         "kind": "infeasible",
                                         "choice": dest}))
            else:
                scores = oracle.prioritize(pod, cluster)
                if saa_label:
                    # oracle.prioritize is DefaultProvider-only: add the
                    # ServiceAntiAffinity term explicitly.  The engine
                    # carries LIVE per-domain peer counts through the scan
                    # (engine/solver.py saa_cnt/saa_num state), so it is
                    # judged against the live oracle view; the batch-start
                    # (stale) view is replayed alongside to record what the
                    # pre-r4 static scoring would have flipped.
                    live = oracle.service_anti_affinity(pod, cluster,
                                                        saa_label)
                    start = saa_start[_first_service_sig(pod, services)]
                    drift = max(abs(live[nm] - start[nm]) for nm in onames)
                    out["saa_drifts"].append(drift)
                    stale_view = {nm: scores[nm] + start[nm] for nm in onames}
                    live_view = {nm: scores[nm] + live[nm] for nm in onames}
                    live_best = {nm for nm in onames
                                 if live_view[nm] == max(live_view[nm2]
                                                         for nm2 in onames)}
                    stale_best = {nm for nm in onames
                                  if stale_view[nm] == max(stale_view[nm2]
                                                           for nm2 in onames)}
                    if not (stale_best & live_best):
                        out["saa_flips"] += 1
                    scores = live_view
                best = max(scores[nm] for nm in onames)
                if scores[dest] == best:
                    out["agree"] += 1
                else:
                    out["disagree"] += 1
                    out["score_gaps"].append(int(best - scores[dest]))
                    if len(examples) < 10:
                        examples.append((i, {
                            "pod": pod.name, "kind": "suboptimal",
                            "choice": dest,
                            "choice_score": int(scores[dest]),
                            "best_score": int(best)}))
        if dest is not None:
            pod.node_name = dest
            cluster.add_pod(pod)
    return out


def _first_service_sig(pod: api.Pod, services) -> tuple:
    s = oracle.first_matching_service(pod, services)
    return (s.namespace, tuple(sorted(s.selector.items()))) if s else ()


def backend(device: str) -> dict:
    """What a record ran on: ``{"backend": "cuda" | "cpu"}``, and on a
    card its name and power limit as ``nvidia-smi`` gives them."""
    dev = device_mod.resolve(device)
    out = {"backend": dev.type}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return out


def refuse_reference_artifact(path: str, name: str) -> None:
    """The JAX package's committed records are never overwritten."""
    if os.path.basename(path) == name:
        raise SystemExit(f"{name} is the JAX package's record; write this "
                         f"package's record elsewhere (--out)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="build/PARITY_cuda.json")
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()
    refuse_reference_artifact(opts.out, "PARITY.json")
    shapes = [(1000, 10000), (5000, 10000)]
    runs = []
    for n_nodes, n_pods in shapes:
        for seed in range(opts.seeds):
            rec = run_parity(n_nodes, n_pods, seed=seed,
                             n_samples=opts.samples, device=opts.device)
            print(json.dumps(rec))
            runs.append(rec)
    # ServiceAntiAffinity drift bound at the 5k shape, one seed.
    saa = run_parity(5000, 10000, seed=0, n_samples=opts.samples,
                     saa_label=api.ZONE_LABEL, device=opts.device)
    print(json.dumps(saa))
    runs.append(saa)
    total = sum(r["sampled_decisions"] for r in runs)
    agree = sum(r["agree"] + r["unschedulable_agree"] for r in runs)
    out = {
        "harness": "kubernetes_tpu_torch/perf/parity.py (oracle replay of "
                   "the batched drain; per-step argmax-set membership)",
        **backend(opts.device),
        "overall_decision_agreement_pct": round(100.0 * agree / total, 3),
        "total_sampled_decisions": total,
        "runs": runs,
    }
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {opts.out}: {out['overall_decision_agreement_pct']}% "
          f"over {total} sampled decisions")


if __name__ == "__main__":
    main()

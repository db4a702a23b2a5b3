"""The PyTorch port's oracle (``kubernetes_tpu_torch/oracle.py``) and its
two harnesses (``perf/parity.py``, ``perf/workloads.py``) on the CPU
against the JAX package's: the oracle's fit sets, failure reasons,
priority scores, argmax sets and preemption decisions on the same
cluster state; then ``run_parity``, ``run_preemption_parity`` and
``gang_bench`` at small sizes give the same records, timings aside.
Tolerance: exact equality (the oracle's scores are integers; the records
hold counts and percentages)."""

from __future__ import annotations

import json

import pytest

from kubernetes_tpu import oracle as r_oracle
from kubernetes_tpu.api import types as r_api
from kubernetes_tpu.perf import parity as r_parity
from kubernetes_tpu.perf import synth as r_synth
from kubernetes_tpu.perf import workloads as r_wl
from kubernetes_tpu_torch import oracle as t_oracle
from kubernetes_tpu_torch.perf import parity as t_parity
from kubernetes_tpu_torch.perf import workloads as t_wl
from torch_parity import to_port


def _state(mod, conv, profile: str, seed: int):
    nodes = r_synth.make_nodes(24, seed=seed, profile=profile, n_zones=3)
    pods = r_synth.make_pods(60, seed=seed + 1, profile=profile,
                             n_services=3)
    for i, p in enumerate(pods[:40]):
        p.node_name = nodes[(i * 5) % len(nodes)].name
        if i % 7 == 0:
            p.annotations[r_api.PRIORITY_ANNOTATION_KEY] = str(i % 4)
    state = mod.ClusterState(nodes=[conv(n) for n in nodes],
                             pods=[conv(p) for p in pods[:40]],
                             services=[conv_service(mod, s) for s in
                                       r_synth.make_services(3)])
    return state, [conv(p) for p in pods[40:]]


def conv_service(mod, svc):
    if mod is r_oracle:
        return svc
    from kubernetes_tpu_torch.api import types as t_api
    return t_api.Service(name=svc.name, namespace=svc.namespace,
                         selector=dict(svc.selector))


def _same(x):
    return x


def _answers(mod, state, pods) -> list:
    out = []
    for pod in pods:
        fits, failed = mod.find_nodes_that_fit(pod, state)
        out.append({
            "fits": [n.name for n in fits],
            "failed": {k: list(v) for k, v in failed.items()},
            "scores": mod.prioritize(pod, state),
            "argmax": sorted(mod.schedule(pod, state)),
            "saa": mod.service_anti_affinity(pod, state, r_api.ZONE_LABEL),
            "preempt": mod.preempt(pod, state),
        })
    return out


@pytest.mark.parametrize("profile,seed", [("mixed", 0), ("rich", 3)])
def test_oracle_matches_reference(profile, seed):
    ref_state, ref_pods = _state(r_oracle, _same, profile, seed)
    port_state, port_pods = _state(t_oracle, to_port, profile, seed)
    want = _answers(r_oracle, ref_state, ref_pods)
    got = _answers(t_oracle, port_state, port_pods)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def _strip(rec):
    """A record without its wall-clock fields."""
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items() if not k.endswith("_s")}
    return rec


@pytest.mark.parametrize("profile", ["rich", "mixed"])
def test_run_parity_matches_reference(profile):
    want = r_parity.run_parity(60, 300, seed=0, n_samples=60,
                               profile=profile)
    got = t_parity.run_parity(60, 300, seed=0, n_samples=60,
                              profile=profile, device="cpu")
    assert _strip(got) == _strip(want)
    assert got["decision_agreement_pct"] >= 99.0


def test_run_parity_service_anti_affinity_matches_reference():
    want = r_parity.run_parity(40, 200, seed=1, n_samples=40,
                               saa_label=r_api.ZONE_LABEL)
    got = t_parity.run_parity(40, 200, seed=1, n_samples=40,
                              saa_label=r_api.ZONE_LABEL, device="cpu")
    assert _strip(got) == _strip(want)


def test_preemption_parity_and_gang_bench_match_reference():
    want = r_wl.run_preemption_parity(n_nodes=16, n_low=120, n_high=12)
    got = t_wl.run_preemption_parity(n_nodes=16, n_low=120, n_high=12,
                                     device="cpu")
    assert _strip(got) == _strip(want)
    assert got["parity_pct"] == 100.0
    want = r_wl.gang_bench(n_nodes=12, n_gangs=8, gang_size=4)
    got = t_wl.gang_bench(n_nodes=12, n_gangs=8, gang_size=4, device="cpu")
    assert _strip(got) == _strip(want)
    assert got["partial_gangs_bound"] == 0


def test_cli_refuses_the_reference_records(tmp_path):
    with pytest.raises(SystemExit):
        t_parity.refuse_reference_artifact(str(tmp_path / "PARITY.json"),
                                           "PARITY.json")
    with pytest.raises(SystemExit):
        t_parity.refuse_reference_artifact("WORKLOADS_r06.json",
                                           "WORKLOADS_r06.json")
    t_parity.refuse_reference_artifact(str(tmp_path / "PARITY_cuda.json"),
                                       "PARITY.json")
    assert t_parity.backend("cpu") == {"backend": "cpu"}


def test_judge_in_worker_processes_matches_one_process():
    """The replay split over spawned workers, each judging its share of
    the sampled decisions, gives the record of one in-process replay."""
    from kubernetes_tpu_torch.perf import synth as t_synth
    nodes = t_synth.make_nodes(60, profile="rich", n_zones=4)
    pods = t_synth.make_pods(400, seed=1, profile="rich", n_services=4)
    services = t_synth.make_services(4)
    # A placement per pod that breaks some predicates, so the record
    # holds agreements, infeasible choices and examples.
    placements = [None if i % 13 == 0 else nodes[(i * 7) % 60].name
                  for i in range(400)]
    recs = [_strip(t_parity.judge(nodes, pods, services, placements,
                                  seed=3, n_samples=40, workers=w))
            for w in (2, 1)]
    assert recs[0] == recs[1]
    assert recs[1]["sampled_decisions"] == 40

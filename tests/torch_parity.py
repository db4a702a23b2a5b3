"""Shared rigs for the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages build the same synthetic cluster from the same seeds
(each with its own copy of perf/synth.py).  The reference compiles the
host (numpy) batch and cluster; the port receives them through
``kubernetes_tpu_torch.engine.convert`` and the JAX side through
``jnp.asarray``, so the two sides see identical inputs."""

from __future__ import annotations

import jax
import numpy as np
import torch

from kubernetes_tpu.api.types import REGION_LABEL, ZONE_LABEL
from kubernetes_tpu.perf import synth as ref_synth
from kubernetes_tpu_torch.engine import convert
from kubernetes_tpu_torch.perf import synth as t_synth

# The parity tests run many tiny ops; one intra-op thread per test worker
# keeps them from crowding the other workers' cores (the sums they
# compare are exact integers, so the thread count cannot move a result).
torch.set_num_threads(1)


def ref_policy(name: str):
    """``default`` (the DefaultProvider: its 10,000-weight avoid-pods term
    keeps the encoded plane f32), ``f16`` (without that term the weight
    bound is 60, so the plane is stored at half width) or ``wide``
    (MostRequested in place of LeastRequested, plus the policy-argument
    entries: ServiceAntiAffinity by zone, NodeLabel, ServiceAffinity by
    region, CheckNodeLabelPresence)."""
    from kubernetes_tpu.api import policy as mod
    return _policy(name, mod)


def torch_policy(name: str):
    from kubernetes_tpu_torch.api import policy as mod
    return _policy(name, mod)


def _policy(name: str, mod):
    p = mod.default_provider()
    if name == "f16":
        p.priorities = [s for s in p.priorities
                        if s.name != "NodePreferAvoidPodsPriority"]
    elif name == "wide":
        p.priorities = [mod.PrioritySpec("MostRequestedPriority", s.weight)
                        if s.name == "LeastRequestedPriority" else s
                        for s in p.priorities] + [
            mod.PrioritySpec("ServiceAntiAffinityPriority", 2,
                             anti_affinity_label=ZONE_LABEL),
            mod.PrioritySpec("NodeLabelPriority", 1, label="kt/pool",
                             presence=True)]
        p.predicates = p.predicates + [
            mod.PredicateSpec("ServiceAffinity",
                              affinity_labels=(REGION_LABEL,)),
            mod.PredicateSpec("NewNodeLabelPredicate",
                              labels=(REGION_LABEL,), presence=True)]
    return p


def _seed_existing(eng, synth_mod, profile: str, n_existing: int,
                   placements: list) -> None:
    """Bind ``n_existing`` pods (seed 7) at the given node names, so
    aggregates, spread counts and affinity tables start non-empty."""
    old = synth_mod.make_pods(n_existing, seed=7, profile=profile,
                              n_services=4, name_prefix="old")
    for pod, node in zip(old, placements):
        if node is not None:
            pod.node_name = node
            eng.cache.add_pod(pod)


def ref_rig(profile: str, n_nodes: int, n_pods: int, n_existing: int = 0,
            policy: str = "default"):
    """(reference engine, pending pods, existing placements)."""
    eng, _ = ref_synth.make_rig(n_nodes, 0, profile=profile)
    if policy != "default":
        eng = type(eng)(policy=ref_policy(policy), cache=eng.cache,
                        listers=eng.listers)
    # Existing pods bound round-robin by a fixed stride (no solve: the
    # cache ingests bound pods as they are).
    placements = [f"node-{(i * 7) % n_nodes}" for i in range(n_existing)]
    _seed_existing(eng, ref_synth, profile, n_existing, placements)
    pods = ref_synth.make_pods(n_pods, profile=profile, n_services=4)
    return eng, pods, placements


def torch_rig(profile: str, n_nodes: int, n_pods: int,
              placements: list, policy: str = "default", counter: int = 0):
    """The port's engine on the CPU over the same cluster, with the same
    existing pods bound where the reference bound them and the same
    round-robin counter."""
    eng, _ = t_synth.make_rig(n_nodes, 0, profile=profile, device="cpu")
    if policy != "default":
        eng = type(eng)(policy=torch_policy(policy), cache=eng.cache,
                        listers=eng.listers, device="cpu")
    if placements:
        _seed_existing(eng, t_synth, profile, len(placements), placements)
    eng.last_node_index = np.uint32(counter)
    return eng, t_synth.make_pods(n_pods, profile=profile, n_services=4)


def host_inputs(eng, pods):
    """(batch, host DeviceBatch, host DeviceCluster, node tensors) from
    the reference's host-only compile — numpy throughout."""
    return eng._compile(pods, host_only=True)


def both(hb, hc):
    """The same host batch/cluster for each side: (jax batch, jax
    cluster, torch batch, torch cluster)."""
    jb = jax.device_put(hb)
    jc = jax.device_put(hc)
    tb = convert.batch_from_numpy(
        {k: (v if hasattr(v, "_fields") else np.asarray(v))
         for k, v in hb._asdict().items()}, "cpu")
    tc = convert.cluster_from_numpy(
        {k: np.asarray(v) for k, v in hc._asdict().items()}, "cpu")
    return jb, jc, tb, tc


def same(t: torch.Tensor, j) -> bool:
    """Exact equality of a torch result and a JAX result (values and
    shape; bool stays bool, f32 stays f32)."""
    a = t.detach().cpu().numpy()
    b = np.asarray(j)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b)


# -- daemon rigs (tests/test_torch_{daemon,guard,preemption}.py) ---------

def to_port(obj):
    """A reference Pod or Node as the port's object, through the JSON
    codec both packages share, so both sides get identical inputs."""
    from kubernetes_tpu.api import types as r_api
    from kubernetes_tpu_torch.api import types as t_api
    if isinstance(obj, r_api.Node):
        return t_api.node_from_json(r_api.node_to_json(obj))
    return t_api.pod_from_json(r_api.pod_to_json(obj))


def daemon(side: str, n_nodes: int = 0, profile: str = "mixed",
           floor: int = 8, flight: bool = False, eng=None, **attrs):
    """A synchronous-bind ``Scheduler`` of ``side`` ("ref" or "port", the
    port on the CPU) over a ``synth.make_rig(n_nodes)`` engine (or
    ``eng``), with every PodScheduled condition write collected in
    ``daemon.conditions`` and the small-drain floor at ``floor``.
    ``attrs`` retune the daemon (STREAM_THRESHOLD, _PAD_LIMIT, ...)."""
    if side == "ref":
        from kubernetes_tpu.scheduler import binder, scheduler
        synth_mod = ref_synth
        kw = {}
    else:
        from kubernetes_tpu_torch.scheduler import binder, scheduler
        synth_mod = t_synth
        kw = {"device": "cpu"}
    if eng is None:
        eng, _ = synth_mod.make_rig(n_nodes, 0, profile=profile, **kw)
    conditions: list = []
    cfg = dict(algorithm=eng, binder=binder.InMemoryBinder(),
               async_bind=False,
               condition_updater=lambda pod, reason, msg:
                   conditions.append((pod.key, reason, msg)))
    if not flight:
        cfg["flight_recorder"] = None
    d = scheduler.Scheduler(scheduler.SchedulerConfig(**cfg))
    d.conditions = conditions
    d.stream_min_bucket = floor
    for k, v in attrs.items():
        setattr(d, k, v)
    return d


def outcome(d, keys) -> dict:
    """What a daemon decided, comparable across packages: bindings, the
    round-robin counter, each pod's events and the condition writes."""
    return {
        "bound": dict(d.config.binder._bound),
        "counter": int(d.config.algorithm.last_node_index),
        "events": {k: [(e.event_type, e.reason, e.message)
                       for e in d.config.recorder.events(k)]
                   for k in keys},
        "conditions": list(d.conditions),
    }

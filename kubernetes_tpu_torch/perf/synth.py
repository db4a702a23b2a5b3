"""Synthetic cluster generator — the kubemark analogue.

The reference scales itself with two rigs this module stands in for:

* the scheduler perf rig (``test/component/scheduler/perf/util.go:85-130``):
  N identical ready nodes (110 pods / 4 CPU / 32 Gi) plus pause pods
  requesting 100m / 500Mi, no kubelets — pods only ever *bind*;
* kubemark (``docs/proposals/kubemark.md``): ~1000 hollow nodes with
  realistic label/zone topology against a real master.

``make_nodes``/``make_pods`` produce those populations as host API objects;
a ``profile`` knob moves from the uniform perf-rig shape to a mixed kubemark
shape (zones/regions, heterogeneous capacities, label-selected services,
spreading controllers, tolerations, node selectors).

Deterministic for a given seed: the benchmarks and tests rely on reproducibility.
"""

from __future__ import annotations

import json

import numpy as np

from kubernetes_tpu_torch.api import types as api

_READY = [api.NodeCondition(api.NODE_READY, "True")]


def make_nodes(n: int, seed: int = 0, profile: str = "uniform",
               n_zones: int = 0, milli_cpu: int = 4000,
               memory: int = 32 * 1024 ** 3, pods: int = 110) -> list[api.Node]:
    """N ready nodes.  ``uniform`` mirrors the perf rig's identical nodes;
    ``mixed`` adds zone/region labels (3 regions x n_zones) and capacity
    jitter like a kubemark fleet; ``rich`` additionally taints ~8% of the
    fleet (NoSchedule/PreferNoSchedule), marks ~2% NotReady and ~2% under
    memory pressure — the full predicate surface for parity runs."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        labels = {api.HOSTNAME_LABEL: f"node-{i}"}
        cpu, mem, npods = milli_cpu, memory, pods
        taints = None
        conditions = list(_READY)
        if profile in ("mixed", "rich"):
            if n_zones > 0:
                z = int(rng.randint(n_zones))
                labels[api.ZONE_LABEL] = f"zone-{z}"
                labels[api.REGION_LABEL] = f"region-{z % 3}"
            labels["kt/pool"] = f"pool-{int(rng.randint(4))}"
            scale = float(rng.choice([0.5, 1.0, 1.0, 2.0]))
            cpu, mem = int(milli_cpu * scale), int(memory * scale)
        if profile == "rich":
            r = rng.rand()
            if r < 0.04:
                taints = [{"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"}]
            elif r < 0.08:
                taints = [{"key": "degraded", "value": "true",
                           "effect": "PreferNoSchedule"}]
            r = rng.rand()
            if r < 0.02:
                conditions = [api.NodeCondition(api.NODE_READY, "False")]
            elif r < 0.04:
                conditions = conditions + [
                    api.NodeCondition("MemoryPressure", "True")]
        node = api.Node(
            name=f"node-{i}", labels=labels,
            allocatable_milli_cpu=cpu, allocatable_memory=mem,
            allocatable_pods=npods, conditions=conditions)
        if taints is not None:
            node.annotations[api.TAINTS_ANNOTATION_KEY] = json.dumps(taints)
        out.append(node)
    return out


def _pause_pod(i, namespace: str = "default",
               labels: dict | None = None,
               milli_cpu: int = 100, memory: int = 500 * 1024 ** 2,
               **kw) -> api.Pod:
    """The perf rig's pause pod (util.go:113-130): 100m / 500Mi requests."""
    return api.Pod(
        name=str(i), namespace=namespace, labels=labels or {},
        containers=[api.Container(
            name="pause", image="kubernetes/pause:go",
            requests={"cpu": f"{milli_cpu}m", "memory": str(memory)},
            ports=[api.ContainerPort(container_port=80)])],
        **kw)


def make_pods(n: int, seed: int = 1, profile: str = "uniform",
              n_services: int = 0, namespace: str = "default",
              name_prefix: str = "pod") -> list[api.Pod]:
    """N pending pods.  ``uniform`` = identical pause pods; ``mixed`` adds
    service-labeled spreading groups, node selectors, and affinity
    annotations in kubemark-like proportions; ``rich`` additionally mixes
    in required pod anti-affinity replica groups (don't co-locate), soft
    pod affinity toward a service, EBS volumes, host ports, and
    tolerations — the full feature surface for parity runs."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if profile == "uniform":
            out.append(_pause_pod(f"{name_prefix}-{i}", namespace))
            continue
        r = rng.rand()
        labels: dict[str, str] = {}
        annotations: dict[str, str] = {}
        node_selector: dict[str, str] = {}
        kw: dict = {}
        cpu = int(rng.choice([50, 100, 200, 500]))
        mem = int(rng.choice([128, 256, 500, 1024])) * 1024 ** 2
        if n_services and r < 0.4:  # service-member pods spread
            labels["app"] = f"svc-{int(rng.randint(n_services))}"
        if 0.4 <= r < 0.5:
            node_selector["kt/pool"] = f"pool-{int(rng.randint(4))}"
        if 0.5 <= r < 0.55:  # preferred zone affinity via annotation
            annotations[api.AFFINITY_ANNOTATION_KEY] = json.dumps({
                "nodeAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": 10,
                        "preference": {"matchExpressions": [{
                            "key": api.ZONE_LABEL, "operator": "In",
                            "values": [f"zone-{int(rng.randint(4))}"]}]},
                    }]}})
        if profile == "rich":
            rr = rng.rand()
            if rr < 0.02:
                # Replica group spread across hosts: required anti-affinity
                # against the pod's own small group.
                g = f"g{i // 3}"
                labels["kt/aa"] = g
                annotations[api.AFFINITY_ANNOTATION_KEY] = json.dumps({
                    "podAntiAffinity": {
                        "requiredDuringSchedulingIgnoredDuringExecution": [{
                            "labelSelector": {"matchLabels": {"kt/aa": g}},
                            "topologyKey": api.HOSTNAME_LABEL}]}})
            elif rr < 0.04 and n_services:
                # Soft co-location with a service's pods by zone.
                annotations[api.AFFINITY_ANNOTATION_KEY] = json.dumps({
                    "podAffinity": {
                        "preferredDuringSchedulingIgnoredDuringExecution": [{
                            "weight": int(rng.randint(1, 10)),
                            "podAffinityTerm": {
                                "labelSelector": {"matchLabels": {
                                    "app": f"svc-{int(rng.randint(n_services))}"}},
                                "topologyKey": api.ZONE_LABEL}}]}})
            rr = rng.rand()
            if rr < 0.03:
                kw["volumes"] = [api.Volume(
                    name="data", aws_ebs_id=f"vol-{int(rng.randint(200))}",
                    aws_read_only=bool(rng.rand() < 0.5))]
            rr = rng.rand()
            if rr < 0.05:
                annotations[api.TOLERATIONS_ANNOTATION_KEY] = json.dumps([
                    {"key": "dedicated", "operator": "Equal",
                     "value": "infra", "effect": "NoSchedule"}])
        pod = _pause_pod(f"{name_prefix}-{i}", namespace, labels=labels,
                         milli_cpu=cpu, memory=mem,
                         node_selector=node_selector,
                         annotations=annotations, **kw)
        if profile == "rich" and rng.rand() < 0.02:
            pod.containers[0].ports = [api.ContainerPort(
                container_port=8080,
                host_port=int(rng.choice([30080, 30443, 31000])))]
        out.append(pod)
    return out


def add_spread_constraints(pods: list, seed: int = 5,
                           share: float = 0.4) -> list:
    """Give about ``share`` of ``pods`` (drawn from ``seed``) a zone
    DoNotSchedule topologySpreadConstraint (maxSkew 1) over their
    ``app`` label (``grp-<i mod 3>`` where they have none), and half of
    those also a hostname ScheduleAnyway term (maxSkew 2).  Returns
    ``pods``, annotated in place."""
    rng = np.random.RandomState(seed)
    for i, p in enumerate(pods):
        r = rng.rand()
        if r >= share:
            continue
        app = p.labels.get("app", f"grp-{i % 3}")
        p.labels["app"] = app
        sel = {"matchLabels": {"app": app}}
        terms = [{"maxSkew": 1, "topologyKey": api.ZONE_LABEL,
                  "whenUnsatisfiable": "DoNotSchedule",
                  "labelSelector": sel}]
        if r < share / 2:
            terms.append({"maxSkew": 2, "topologyKey": api.HOSTNAME_LABEL,
                          "whenUnsatisfiable": "ScheduleAnyway",
                          "labelSelector": sel})
        p.annotations[api.TOPOLOGY_SPREAD_ANNOTATION_KEY] = json.dumps(terms)
    return pods


def make_services(n: int, namespace: str = "default") -> list[api.Service]:
    return [api.Service(name=f"svc-{i}", namespace=namespace,
                        selector={"app": f"svc-{i}"}) for i in range(n)]


def make_rig(n_nodes: int, n_pods: int, profile: str = "mixed",
             n_zones: int = 4, n_services: int = 4, device: str = "cuda"):
    """Assembled scheduler + pending pods — the mustSetupScheduler analogue
    (util.go:46-74).  Returns (scheduler, pods); the scheduler runs on
    ``device``."""
    from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
    from kubernetes_tpu_torch.engine.generic_scheduler import (GenericScheduler,
                                                              Listers)

    cache = SchedulerCache()
    for nd in make_nodes(n_nodes, profile=profile, n_zones=n_zones):
        cache.add_node(nd)
    sched = GenericScheduler(
        cache=cache, listers=Listers(services=make_services(n_services)),
        device=device)
    return sched, make_pods(n_pods, profile=profile, n_services=n_services)

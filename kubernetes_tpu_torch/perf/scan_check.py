"""The scan kernel held against its plain version, the step loop.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run these cases on the
card: each compiles one batch, runs it through ``Solver._solve_scan``
from the same inputs — once with ``route="steps"`` (the step loop) and
once per kernel route (``engine/scan.py:scan_chunk``; ``"kernel"`` takes
the plan's cluster size, ``"kernel@C"`` forces C CTAs), in two chunks so
the second continues the first's carried state — and requires
exact equality of the choices, the counter and every carried state
tensor (floats compared bit for bit) after each chunk: ``packed``, ``D``
and the spread planes, and for the rich families ``ports_used``,
``vol_any``, ``vol_rw``, ``pd_ebs``, ``pd_gce``, ``match_cnt``,
``match_total``, ``decl_reach``, ``sym_cnt``, ``saa_cnt`` and
``saa_num``.

The ``mixed`` cases cover what the kernel must get right: node counts
around its thread and warp boundaries (1, 31, 1,023, 1,025, 5,000,
16,384), an all-infeasible chunk, round-robin counters at 0, 2^31,
2^32 - 1 (wraps on the first placement) and 2^32, an f16 encoded plane,
MostRequested and non-unit weights, templates over their cap (in-step
resource scores), a policy with neither spread nor PodFitsResources,
node 0 unschedulable under unplaceable pods (the spread maxima must not
fold column 0), identical nodes whose ties straddle lanes, rounds and
warps, and the f32 route the joint repair and topology spread take: a
non-integral score bias (which keeps even the f16 policy's plane at
f32), and an extra mask that leaves whole rows infeasible.

The ``rich`` cases (``rig_spec``: a ``mixed`` cluster whose existing and
pending pods carry one family's features, under the default policy cut
so that only that family is on) cover each family alone: host ports
drawn from three ports; GCE disks mounted read-write and read-only
(NoDiskConflict); EBS and GCE disks, missing and unbound claims under
maxima of 3 and 4; required anti-affinity by hostname (and by the
default keys, an empty topologyKey); required affinity by zone with the
self-match escape, and to pods nobody runs; preferred affinity and
anti-affinity with their symmetric terms; two service anti-affinity
priorities (zone, pool).  Then every family at once at N = 1, 1,025,
5,000 and 16,384, with the counter at 2^32 - 1, with an f16 plane and
with a non-integral bias; disks at their maxima; an anti-affinity group
larger than the cluster (unplaced steps that carry affinity state); and
the first 512 pods of the ``rich`` north-star rig.

The ``seams`` cases aim at the cluster's slice boundaries, in ``mixed``
and ``rich``: identical nodes whose ties straddle two CTAs with the
counter at N - 1 (the ix-th tie is the last node, in the last CTA); the
counter at 515 on identical nodes, so the picks walk across the slice
edges of every cluster size (a placed node at a slice's first and last
node); N = 1,027 (f32) and N = 1,030 (f16), which no 4 x C divides, so
rows of enc start off the 16-byte grid (and, in f16, off the 4-byte
grid: the ring's first and last words); T = 64 templates at N = 16,384,
where ``D`` is too large for shared memory at any cluster size and stays
in device memory; and 250 pods in two chunks, so the second chunk's
bool tables (``zero_request``, ``spread_incr``) start off the 4-byte
grid, with every third pod requesting nothing.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetes_tpu_torch.api import policy as pol
from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
from kubernetes_tpu_torch.engine import scan as scan_mod
from kubernetes_tpu_torch.engine import solver as sv
from kubernetes_tpu_torch.engine.generic_scheduler import (GenericScheduler,
                                                          Listers)
from kubernetes_tpu_torch.perf import synth


class ScanMismatch(AssertionError):
    """The kernel and the step loop disagree."""


def policy(name: str) -> pol.Policy:
    """``default`` (f32 plane: the 10,000-weight avoid-pods term),
    ``f16`` (without that term: weight bound 60, half-width plane),
    ``weighted`` (f16, MostRequested at weight 2 and spread at weight 3)
    or ``bare`` (LeastRequested and balanced only, and no
    PodFitsResources)."""
    p = pol.default_provider()
    if name == "default":
        return p
    p.priorities = [s for s in p.priorities
                    if s.name != "NodePreferAvoidPodsPriority"]
    if name == "weighted":
        p.priorities = [
            pol.PrioritySpec("MostRequestedPriority", 2)
            if s.name == "LeastRequestedPriority" else
            pol.PrioritySpec("SelectorSpreadPriority", 3)
            if s.name == "SelectorSpreadPriority" else s
            for s in p.priorities]
    elif name == "bare":
        p.predicates = [pol.PredicateSpec("PodFitsHost"),
                        pol.PredicateSpec("MatchNodeSelector")]
        p.priorities = [pol.PrioritySpec("LeastRequestedPriority", 1),
                        pol.PrioritySpec("BalancedResourceAllocation", 1)]
    elif name != "f16":
        raise KeyError(name)
    return p


@dataclass
class Case:
    name: str
    sched: GenericScheduler
    pods: list
    counter: int = 0
    infeasible: bool = False
    template_cap: int | None = None
    bias: bool = False
    masked_rows: bool = False


def _many_templates(device) -> tuple:
    """N = 16,384 with 40 distinct pod requests: T = 64 templates."""
    sched, pods = _rig(device, 16384, 64)
    for k, pod in enumerate(pods):
        pod.containers[0].requests["cpu"] = f"{50 + 10 * (k % 40)}m"
    return sched, pods


def _rig(device, n_nodes: int, n_pods: int, profile: str = "mixed",
         policy_name: str = "default", n_services: int = 4) -> tuple:
    sched, pods = synth.make_rig(n_nodes, n_pods, profile=profile,
                                 n_services=n_services, device=device)
    if policy_name != "default":
        sched = GenericScheduler(policy=policy(policy_name),
                                 cache=sched.cache, listers=sched.listers,
                                 device=device)
    return sched, pods


def _node0_unschedulable(device) -> tuple:
    """Node 0 cordoned and holding the most ``svc-0`` pods; a third of the
    pending ``svc-0`` pods ask for more CPU than any node has."""
    nodes = synth.make_nodes(64, profile="mixed", n_zones=4)
    nodes[0].unschedulable = True
    cache = SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    for k, pod in enumerate(synth.make_pods(12, seed=7, profile="uniform",
                                            name_prefix="old")):
        pod.labels = {"app": "svc-0"}
        pod.node_name = "node-0" if k < 10 else f"node-{k}"
        cache.add_pod(pod)
    sched = GenericScheduler(
        cache=cache, listers=Listers(services=synth.make_services(4)),
        device=device)
    pods = synth.make_pods(256, profile="mixed", n_services=4)
    for k, pod in enumerate(pods):
        pod.labels = {"app": "svc-0"}
        if k % 3 == 0:
            pod.containers[0].requests["cpu"] = "100000"
    return sched, pods


# -- the rich families -------------------------------------------------------

HOST_PORTS = (30080, 30443, 31000)


@dataclass
class RigSpec:
    """A cluster and its pending pods, as API objects (so a test can hand
    the same rig to another scheduler through the JSON codec)."""

    nodes: list
    existing: list
    pods: list
    services: list
    policy: pol.Policy
    pvcs: list = field(default_factory=list)


def _with_pod_affinity(pod, kind: str, section: str, terms: list) -> None:
    """Add ``terms`` to the pod's affinity annotation under ``kind``
    (podAffinity / podAntiAffinity) and ``section`` (required / preferred),
    keeping what the annotation holds."""
    raw = pod.annotations.get(api.AFFINITY_ANNOTATION_KEY)
    aff = json.loads(raw) if raw else {}
    key = ("requiredDuringSchedulingIgnoredDuringExecution"
           if section == "required" else
           "preferredDuringSchedulingIgnoredDuringExecution")
    aff.setdefault(kind, {}).setdefault(key, []).extend(terms)
    pod.annotations[api.AFFINITY_ANNOTATION_KEY] = json.dumps(aff)


def _term(labels: dict, key: str) -> dict:
    return {"labelSelector": {"matchLabels": labels}, "topologyKey": key}


def _policy_for(family: str) -> pol.Policy:
    """The default policy, cut so that only ``family``'s scan families
    are on; ``all`` keeps every predicate, with small disk maxima and two
    service anti-affinity priorities; ``all, f16`` drops the avoid-pods
    term besides (a half-width encoded plane)."""
    p = pol.default_provider()
    preds = list(p.predicates)

    def drop(*names):
        return [s for s in preds if s.name not in names]

    def disk_maxima(specs):
        return [pol.PredicateSpec(s.name, max_volumes=3)
                if s.name == "MaxEBSVolumeCount" else
                pol.PredicateSpec(s.name, max_volumes=4)
                if s.name == "MaxGCEPDVolumeCount" else s for s in specs]

    if family == "volumes":
        preds = drop("MaxEBSVolumeCount", "MaxGCEPDVolumeCount")
    elif family == "disk counts":
        preds = disk_maxima(drop("NoDiskConflict", "NoVolumeZoneConflict"))
    elif family == "service anti-affinity" or family.startswith("all"):
        p.priorities = list(p.priorities) + [
            pol.PrioritySpec("ServiceAntiAffinityPriority", 2,
                             anti_affinity_label=api.ZONE_LABEL),
            pol.PrioritySpec("ServiceAntiAffinityPriority", 1,
                             anti_affinity_label="kt/pool")]
        if family.startswith("all"):
            preds = disk_maxima(preds)
        if family == "all, f16":
            p.priorities = [s for s in p.priorities
                            if s.name != "NodePreferAvoidPodsPriority"]
    p.predicates = preds
    return p


def _add_family(family: str, pods: list, rng, prefix: str) -> None:
    """Give ``pods`` (existing or pending) the features of ``family``."""
    zone, host = api.ZONE_LABEL, api.HOSTNAME_LABEL
    for i, pod in enumerate(pods):
        r = rng.rand()
        if family == "host ports" and r < 0.5:
            pod.containers[0].ports = [api.ContainerPort(
                container_port=8080,
                host_port=int(HOST_PORTS[rng.randint(3)]))]
        elif family == "volumes" and r < 0.5:
            pod.volumes = [api.Volume(
                name=f"v{k}", gce_pd_name=f"pd-{rng.randint(8)}",
                gce_read_only=bool(rng.rand() < 0.6))
                for k in range(1 + rng.randint(2))]
        elif family == "disk counts" and r < 0.6:
            vols = [api.Volume(name=f"e{k}",
                               aws_ebs_id=f"vol-{rng.randint(12)}",
                               aws_read_only=bool(rng.rand() < 0.5))
                    for k in range(rng.randint(3))]
            vols += [api.Volume(name=f"g{k}",
                                gce_pd_name=f"pd-{rng.randint(10)}")
                     for k in range(rng.randint(3))]
            if rng.rand() < 0.1:
                # A claim no lister knows: one un-dedupable volume.
                vols.append(api.Volume(name="c", pvc_claim_name="missing"))
            if prefix == "old" and rng.rand() < 0.05:
                vols.append(api.Volume(name="u", pvc_claim_name="unbound"))
            pod.volumes = vols
        elif family == "anti-affinity by hostname" and r < 0.4:
            g = f"{prefix}-g{i // 4}"
            pod.labels["kt/aa"] = g
            _with_pod_affinity(pod, "podAntiAffinity", "required", [_term(
                {"kt/aa": g}, host if rng.rand() < 0.8 else "")])
        elif family == "affinity with the self-match escape" and r < 0.4:
            # Co-locate by zone with pods like itself; the first of a
            # group goes anywhere (it matches its own term).
            g = f"{prefix}-a{rng.randint(6)}"
            pod.labels["kt/af"] = g
            _with_pod_affinity(pod, "podAffinity", "required",
                               [_term({"kt/af": g}, zone)])
        elif family == "affinity with the self-match escape" and r < 0.45:
            # Affinity to pods nobody runs: unplaceable.
            _with_pod_affinity(pod, "podAffinity", "required",
                               [_term({"kt/af": "nobody"}, zone)])
        elif family == "soft affinity, symmetric" and r < 0.5:
            svc = f"svc-{rng.randint(4)}"
            _with_pod_affinity(pod, "podAffinity", "preferred", [{
                "weight": int(rng.randint(1, 10)),
                "podAffinityTerm": _term({"app": svc}, zone)}])
            if rng.rand() < 0.5:
                _with_pod_affinity(pod, "podAntiAffinity", "preferred", [{
                    "weight": int(rng.randint(1, 10)),
                    "podAffinityTerm": _term(
                        {"app": f"svc-{rng.randint(4)}"},
                        host if rng.rand() < 0.7 else "")}])


FAMILIES = ("host ports", "volumes", "disk counts",
            "anti-affinity by hostname",
            "affinity with the self-match escape",
            "soft affinity, symmetric", "service anti-affinity")


def rig_spec(family: str, n_nodes: int, n_pods: int,
             n_existing: int | None = None, seed: int = 0,
             node_profile: str = "mixed") -> RigSpec:
    """``family`` (one of :data:`FAMILIES`, or ``all`` / ``all, f16`` for
    every family at once) on a ``node_profile`` cluster of ``n_nodes``
    (``mixed``: in 4 zones; ``uniform``: identical nodes), with
    ``n_existing`` pods (default: one per node) bound round robin by a
    stride and ``n_pods`` pending ones."""
    families = FAMILIES if family.startswith("all") else (family,)
    nodes = synth.make_nodes(n_nodes, seed=seed, profile=node_profile,
                             n_zones=4)
    n_old = n_nodes if n_existing is None else n_existing
    existing = synth.make_pods(n_old, seed=seed + 7, profile="mixed",
                               n_services=4, name_prefix="old")
    pods = synth.make_pods(n_pods, seed=seed + 1, profile="mixed",
                           n_services=4)
    rng = np.random.RandomState(seed + 11)
    for fam in families:
        _add_family(fam, existing, rng, "old")
        _add_family(fam, pods, rng, "pod")
    for k, pod in enumerate(existing):
        pod.node_name = nodes[(k * 7) % n_nodes].name
    return RigSpec(nodes, existing, pods, synth.make_services(4),
                   _policy_for(family),
                   [api.PersistentVolumeClaim(name="unbound")])


def build(spec: RigSpec, device) -> tuple:
    """(scheduler on ``device``, pending pods) of a :class:`RigSpec`."""
    cache = SchedulerCache()
    for nd in spec.nodes:
        cache.add_node(nd)
    for pod in spec.existing:
        cache.add_pod(pod)
    sched = GenericScheduler(
        policy=spec.policy, cache=cache,
        listers=Listers(services=spec.services, pvcs=list(spec.pvcs)),
        device=device)
    return sched, spec.pods


def _family_rig(family: str, n_nodes: int, n_pods: int, **kw):
    return lambda d: build(rig_spec(family, n_nodes, n_pods, **kw), d)


def _cases() -> dict:
    """Case name -> factory(device)."""
    out = {}
    for n, p in ((1, 64), (31, 256), (1023, 256), (1025, 256),
                 (5000, 1024), (16384, 64)):
        out[f"N={n}"] = lambda d, n=n, p=p: _rig(d, n, p)
    out["all infeasible"] = lambda d: _rig(d, 1025, 128)
    for c in (0, 2 ** 31, 2 ** 32 - 1, 2 ** 32):
        out[f"counter {c}"] = lambda d: _rig(d, 1023, 128)
    out["f16 plane"] = lambda d: _rig(d, 1025, 256, policy_name="f16")
    out["MostRequested, weights 2 and 3"] = \
        lambda d: _rig(d, 1025, 256, policy_name="weighted")
    out["templates over the cap"] = lambda d: _rig(d, 1025, 256)
    out["templates over the cap, MostRequested weighted"] = \
        lambda d: _rig(d, 1025, 256, policy_name="weighted")
    out["no spread, no PodFitsResources"] = \
        lambda d: _rig(d, 1025, 256, policy_name="bare")
    out["node 0 unschedulable, unplaced steps"] = _node0_unschedulable
    out["ties across threads"] = \
        lambda d: _rig(d, 5000, 512, profile="uniform")
    out["non-integral bias, f16 policy"] = \
        lambda d: _rig(d, 1025, 256, policy_name="f16")
    out["non-integral bias, N=5000"] = lambda d: _rig(d, 5000, 512)
    out["extra mask with all-false rows, bias"] = \
        lambda d: _rig(d, 1025, 256)
    for fam in FAMILIES:
        out[f"rich: {fam}"] = _family_rig(fam, 1025, 256)
    for n, p in ((1, 64), (1025, 256), (5000, 512), (16384, 64)):
        out[f"rich: all, N={n}"] = _family_rig("all", n, p)
    out["rich: all, counter 4294967295"] = _family_rig("all", 1023, 128)
    out["rich: all, f16 plane"] = _family_rig("all, f16", 1025, 256)
    out["rich: disk counts at their maxima"] = \
        _family_rig("disk counts", 64, 512, n_existing=128)
    out["rich: anti-affinity leaves pods no node"] = \
        _family_rig("anti-affinity by hostname", 16, 256, n_existing=8)
    out["rich: all, non-integral bias"] = _family_rig("all", 1025, 256)
    out["rich: all, the rich north-star rig"] = \
        lambda d: _rig(d, 5000, 512, profile="rich")
    # The cluster's slice seams.
    out["seams: ties straddle CTAs, counter 1024"] = \
        lambda d: _rig(d, 1025, 256, profile="uniform")
    out["seams: picks walk the slice edges, counter 515"] = \
        lambda d: _rig(d, 1025, 256, profile="uniform")
    out["seams: N=1027"] = lambda d: _rig(d, 1027, 256)
    out["seams: N=1030, f16 plane"] = \
        lambda d: _rig(d, 1030, 256, policy_name="f16")
    out["seams: T=64 at N=16384, D in device memory"] = _many_templates
    out["rich: seams, ties straddle CTAs, counter 1024"] = \
        _family_rig("all", 1025, 256, node_profile="uniform")
    out["rich: seams, picks walk the slice edges, counter 515"] = \
        _family_rig("all", 1025, 256, node_profile="uniform")
    out["rich: seams, all, N=1027"] = _family_rig("all", 1027, 256)
    out["rich: seams, all, f16 plane, N=1030"] = \
        _family_rig("all, f16", 1030, 256)
    # 250 pods in two chunks: the second chunk's bool tables (zero_request,
    # and spread_incr with one service's S <= 2 groups) start at pod 125,
    # off the 4-byte grid.
    out["seams: 250 pods, the second chunk off the 4-byte grid"] = \
        _zero_requests(lambda d: _rig(d, 1025, 250, n_services=1))
    out["rich: seams, 250 pods, the second chunk off the 4-byte grid"] = \
        _zero_requests(_family_rig("all", 1025, 250))
    return out


def _zero_requests(factory):
    """``factory`` with every third pod requesting nothing (zero_request
    set), so neighbouring bytes of zero_request differ."""
    def build_rig(device):
        sched, pods = factory(device)
        for pod in pods[::3]:
            for ctr in pod.containers:
                ctr.requests = {}
        return sched, pods
    return build_rig


_FACTORIES = _cases()
CASE_NAMES = tuple(_FACTORIES)


def case(name: str, device) -> Case:
    """The case called ``name``, built on ``device``."""
    extra = {}
    if name == "all infeasible":
        extra["infeasible"] = True
    elif "counter " in name:
        extra["counter"] = int(name.split("counter ")[1])
    elif name.startswith("templates over the cap"):
        extra["template_cap"] = 2
    if "bias" in name:
        extra["bias"] = True
    if "all-false rows" in name:
        extra["masked_rows"] = True
    return Case(name, *_FACTORIES[name](device), **extra)


def cases(device) -> list[Case]:
    """Every case, on ``device``."""
    return [case(name, device) for name in CASE_NAMES]


def _compile(case: Case):
    cap = sv.DYN_TEMPLATE_CAP
    if case.template_cap is not None:
        sv.DYN_TEMPLATE_CAP = case.template_cap
    try:
        batch, db, dc, _nt = case.sched._compile(case.pods)
    finally:
        sv.DYN_TEMPLATE_CAP = cap
    return db, dc, sv.batch_flags(batch)


def constraint_planes(case: Case, n_nodes: int, device
                      ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(extra_mask, score_bias) [P, N] for the case, seeded by its size:
    the bias in steps of 1/64 plus a third (non-integral, as a joint
    price cost is), the mask about 1 in 8 entries false and every fifth
    row all false."""
    p = len(case.pods)
    rng = np.random.RandomState(p * 131 + n_nodes)
    bias = mask = None
    if case.bias:
        b = rng.randint(-640, 640, (p, n_nodes)) / 64.0 + 1.0 / 3.0
        bias = torch.from_numpy(b.astype(np.float32)).to(device)
    if case.masked_rows:
        m = rng.rand(p, n_nodes) >= 0.125
        m[::5] = False
        mask = torch.from_numpy(m).to(device)
    if case.infeasible:
        mask = torch.zeros((p, n_nodes), dtype=torch.bool, device=device)
    return mask, bias


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float16:
        return t.view(torch.int16)
    return t


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def run_routes(case: Case, routes: tuple = ("steps", "kernel"),
               chunks: int = 2) -> dict:
    """Run the case once per route, chunk by chunk from the same inputs;
    raise :class:`ScanMismatch` unless every route agrees with the first
    exactly after every chunk.  Routes: ``steps``, ``kernel`` (the plan's
    cluster size), ``kernel@C`` (C CTAs forced) or ``kernel@*`` (one
    route per cluster size the case's N allows).  Returns {"steps":
    scan steps per route, "max_abs_err": largest difference seen (0.0
    when they agree), "placed": placements, "axes": the batch's term
    axes, "routes": the routes run}."""
    db, dc, flags = _compile(case)
    n = dc.alloc.shape[0]
    routes = tuple(x for r in routes for x in (
        [f"kernel@{c}" for c in scan_mod.allowed_clusters(n)]
        if r == "kernel@*" else [r]))
    forced = {r: _cluster_of(r) for r in routes}
    p = len(case.pods)
    size = -(-p // chunks)
    dev = dc.alloc.device
    state = {r: (torch.tensor([case.counter], dtype=torch.int64,
                              device=dev), None) for r in routes}
    mask, bias = constraint_planes(case, dc.alloc.shape[0], dev)
    placed = 0
    worst = 0.0
    for start in range(0, p, size):
        bk = sv.slice_pod_axis(db, start, start + size)
        extra = None if mask is None else mask[start:start + size]
        sb = None if bias is None else bias[start:start + size]
        got = {}
        for r in routes:
            counter, carry = state[r]
            ch, counter, carry = case.sched.solver._solve_scan(
                bk, dc, counter, sb, flags, carry, None, extra,
                route=r.partition("@")[0], cluster=forced[r])
            state[r] = (counter, carry)
            got[r] = (ch, counter, carry)
        for r in routes[1:]:
            worst = max(worst, compare(
                f"{case.name}, chunk at {start}, {r} vs {routes[0]}",
                got[r], got[routes[0]]))
        placed += int((got[routes[0]][0] >= 0).sum())
    return {"steps": p, "max_abs_err": worst, "placed": placed,
            "axes": axis_sizes(db), "routes": routes}


def _cluster_of(route: str) -> int | None:
    """The cluster size a ``kernel@C`` route forces (None otherwise)."""
    name, at, c = route.partition("@")
    if name not in ("steps", "kernel") or (at and (
            name != "kernel" or not c.isdigit())):
        raise ValueError(f"scan_check: route {route!r} is not steps, "
                         f"kernel, kernel@C or kernel@*")
    return int(c) if at else None


def compare(where: str, got: tuple, ref: tuple) -> float:
    """Raise :class:`ScanMismatch` unless ``got`` and ``ref``, each the
    (choices, counter, carried state) of one chunk, are equal exactly
    (floats bit for bit).  Returns the largest difference (0.0)."""
    ch, cnt, carry = got
    ref_ch, ref_cnt, ref_carry = ref
    worst = max(_max_abs(ch, ref_ch), _max_abs(cnt, ref_cnt))
    if not torch.equal(ch, ref_ch):
        bad = (ch != ref_ch).nonzero()[:5].flatten().tolist()
        raise ScanMismatch(
            f"{where}: choices differ at rows {bad}: "
            f"{ch[bad].tolist()} vs {ref_ch[bad].tolist()}")
    if not torch.equal(cnt, ref_cnt):
        raise ScanMismatch(f"{where}: counter {cnt.tolist()} vs "
                           f"{ref_cnt.tolist()}")
    if set(carry) != set(ref_carry):
        raise ScanMismatch(f"{where}: state keys {sorted(carry)} "
                           f"vs {sorted(ref_carry)}")
    for k in ref_carry:
        a, b = carry[k], ref_carry[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise ScanMismatch(f"{where}: state {k} is {a.dtype} "
                               f"{tuple(a.shape)} vs {b.dtype} "
                               f"{tuple(b.shape)}")
        worst = max(worst, _max_abs(a, b))
        if not torch.equal(_bits(a), _bits(b)):
            diff = (_bits(a) != _bits(b)).nonzero()[:3].tolist()
            raise ScanMismatch(f"{where}: state {k} differs at {diff}")
    return worst


# The kernel's carried state, updated in place by each launch (with the
# disk counts, which the wrapper's caller derives from pd_* per chunk).
STATE = ("packed", "counter", "d_plane", "sp_node", "sp_maxn", "sp_zone",
         "sp_maxz")
RICH_STATE = ("ports_used", "vol_any", "vol_rw", "pd_ebs", "pd_gce",
              "ebs_count", "gce_count", "match_cnt", "match_total",
              "decl_reach", "sym_cnt", "saa_cnt", "saa_num")


def axis_sizes(db) -> dict:
    """The term axes of a compiled batch: host ports, volumes, EBS and
    GCE disks, match / decl / sym signatures, service anti-affinity rows,
    groups and domains."""
    a, vs = db.aff, db.volsvc
    return {"Cp": int(db.ports.shape[1]), "W": int(db.vol_rw.shape[1]),
            "We": int(vs.pd_pod_ebs.shape[1]),
            "Wg": int(vs.pd_pod_gce.shape[1]),
            "Sm": int(a.match_cnt.shape[0]), "Sd": int(a.decl_reach.shape[0]),
            "Ss": int(a.sym_cnt.shape[0]), "L": int(vs.saa_cnt.shape[0]),
            "Gy": int(vs.saa_cnt.shape[1]), "D": int(vs.saa_cnt.shape[2])}


def north_star_chunk(nodes: int = 5000, pods: int = 2048,
                     device="cuda", profile: str = "mixed",
                     batch_pods: int | None = None,
                     rig: tuple | None = None) -> dict:
    """The first chunk of a ``profile`` rig as the solver hands it to the
    kernel, for timing it alone: one launch through ``_solve_scan`` with
    the kernel's arguments captured.  With ``batch_pods`` the rig has
    that many pods, compiled as one batch (as a stream compiles its
    queue), and the chunk is its first ``pods``.  Returns {"sched",
    "db", "dc", "flags"} (the compiled chunk), {"enc", "kw"} (the
    arguments, the rich families' term lists included) and "init" (the
    carried state as it was before the launch, to restore between timed
    launches).  ``rig`` (an engine and its pod list) takes the synthetic
    rig's place; ``nodes``, ``profile`` and ``batch_pods`` then go
    unused."""
    sched, plist = rig if rig is not None else synth.make_rig(
        nodes, batch_pods or pods, profile=profile, device=device)
    batch, db, dc, _ = sched._compile(plist)
    flags = sv.batch_flags(batch)
    db = sv.slice_pod_axis(db, 0, pods)
    real = scan_mod.scan_chunk
    seen = {}

    # functools.wraps carries the launch count over, so the wrapper's own
    # count has an attribute to land on while the capture is installed.
    @functools.wraps(real)
    def capture(enc, **kw):
        seen["enc"], seen["kw"] = enc, kw
        seen["init"] = {k: kw[k].clone() for k in STATE + RICH_STATE
                        if kw.get(k) is not None}
        return real(enc, **kw)

    scan_mod.scan_chunk = capture
    try:
        sched.solver._solve_scan(
            db, dc, torch.zeros(1, dtype=torch.int64, device=dc.alloc.device),
            None, flags, None, None, None, route="kernel")
    finally:
        scan_mod.scan_chunk = real
    return {"sched": sched, "db": db, "dc": dc, "flags": flags, **seen}

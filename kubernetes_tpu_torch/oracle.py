"""Decision-parity oracle: the reference scheduler's semantics as slow,
obvious Python.

This module re-derives every default-provider predicate and priority
directly from the Go sources (cited per function) with per-pod-per-node
loops and NO shared code with the tensor path — so differential tests
comparing it against the device solver surface real bugs in either side.

A copy of ``kubernetes_tpu/oracle.py`` with its import pointed at this
package's ``api``.  Used by ``perf/parity.py`` (the oracle replay of the
batched drain) and ``perf/workloads.py`` (preemption parity), and
available as a debugging tool (``oracle.explain``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from kubernetes_tpu_torch.api import types as api

MAX_PRIORITY = 10


@dataclass
class ClusterState:
    """Everything the reference scheduler reads through its listers."""

    nodes: list[api.Node] = field(default_factory=list)
    pods: list[api.Pod] = field(default_factory=list)  # assigned, alive
    services: list[api.Service] = field(default_factory=list)
    controllers: list[api.ReplicationController] = field(default_factory=list)
    replica_sets: list[api.ReplicaSet] = field(default_factory=list)
    pvs: list[api.PersistentVolume] = field(default_factory=list)
    pvcs: list[api.PersistentVolumeClaim] = field(default_factory=list)
    hard_pod_affinity_weight: int = 1

    def node(self, name: str) -> Optional[api.Node]:
        for n in self.nodes:
            if n.name == name:
                return n
        return None

    def node_pods(self, name: str) -> list[api.Pod]:
        return [p for p in self.pods if p.node_name == name]

    def ready_nodes(self) -> list[api.Node]:
        """getNodeConditionPredicate (factory.go:436-462)."""
        return [n for n in self.nodes if n.is_ready()]

    def affinity_pods(self) -> list[api.Pod]:
        """Pods carrying any affinity annotation — the reference's
        PodsWithAffinity precompute (node_info.go:32-54, maintained by
        addPod/removePod) that bounds the anti-affinity scans to pods that
        can actually contribute terms.  Pods without affinity contribute
        nothing to those loops, so restricting them is semantics-neutral."""
        return [p for p in self.pods if p.affinity() is not None]


# ---------------------------------------------------------------------------
# Label / selector matching (pkg/labels)
# ---------------------------------------------------------------------------

def _node_selector_term_matches(term: api.NodeSelectorTerm,
                                node: api.Node) -> bool:
    """NodeSelectorRequirementsAsSelector semantics (predicates.go:504-554):
    empty term matches nothing; unknown operator or bad value poisons the
    term."""
    if not term.match_expressions:
        return False
    for e in term.match_expressions:
        val = node.labels.get(e.key)
        if e.operator == api.NS_OP_IN:
            if val is None or val not in e.values:
                return False
        elif e.operator == api.NS_OP_NOT_IN:
            if val is not None and val in e.values:
                return False
        elif e.operator == api.NS_OP_EXISTS:
            if val is None:
                return False
        elif e.operator == api.NS_OP_DOES_NOT_EXIST:
            if val is not None:
                return False
        elif e.operator in (api.NS_OP_GT, api.NS_OP_LT):
            if len(e.values) != 1 or val is None:
                return False
            try:
                lhs, rhs = int(val), int(e.values[0])
            except ValueError:
                return False
            if e.operator == api.NS_OP_GT and not lhs > rhs:
                return False
            if e.operator == api.NS_OP_LT and not lhs < rhs:
                return False
        else:
            return False
    return True


def pod_matches_node_labels(pod: api.Pod, node: api.Node) -> bool:
    """podMatchesNodeLabels (predicates.go:504-554): nodeSelector AND
    required node affinity (terms OR'd; empty terms list matches nothing)."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    aff = pod.affinity()
    if aff is not None and aff.node_affinity is not None \
            and aff.node_affinity.required is not None:
        terms = aff.node_affinity.required.node_selector_terms
        if not any(_node_selector_term_matches(t, node) for t in terms):
            return False
    return True


def _term_selector_matches(term: api.PodAffinityTerm,
                           labels: dict[str, str]) -> bool:
    """LabelSelectorAsSelector: nil selector matches nothing."""
    if term.label_selector is None:
        return False
    return term.label_selector.matches(labels)


def pod_matches_term(pod: api.Pod, affinity_pod: api.Pod,
                     term: api.PodAffinityTerm) -> bool:
    """PodMatchesTermsNamespaceAndSelector (topologies.go:42-54)."""
    if term.namespaces is None:
        namespaces = {affinity_pod.namespace}
    else:
        namespaces = set(term.namespaces)
    if namespaces and pod.namespace not in namespaces:
        return False
    return _term_selector_matches(term, pod.labels)


def nodes_same_topology(node_a: api.Node, node_b: api.Node,
                        key: str) -> bool:
    """NodesHaveSameTopologyKey (topologies.go:57-76)."""
    def same(k):
        va, vb = node_a.labels.get(k), node_b.labels.get(k)
        return bool(va) and va == vb
    if not key:
        return any(same(k) for k in api.DEFAULT_FAILURE_DOMAINS)
    return same(key)


def _affinity_terms(pod: api.Pod):
    aff = pod.affinity()
    req_a = req_aa = pref_a = pref_aa = ()
    if aff is not None:
        if aff.pod_affinity is not None:
            req_a = aff.pod_affinity.required
            pref_a = aff.pod_affinity.preferred
        if aff.pod_anti_affinity is not None:
            req_aa = aff.pod_anti_affinity.required
            pref_aa = aff.pod_anti_affinity.preferred
    return req_a, req_aa, pref_a, pref_aa


# ---------------------------------------------------------------------------
# Predicates (algorithm/predicates/predicates.go)
# ---------------------------------------------------------------------------

def pod_fits_resources(pod: api.Pod, node: api.Node,
                       node_pods: list[api.Pod]) -> bool:
    """predicates.go:444-485."""
    if len(node_pods) + 1 > node.allocatable_pods:
        return False
    req = pod.resource_request()
    if req.milli_cpu == 0 and req.memory == 0 and req.nvidia_gpu == 0:
        return True
    used = api.Resource()
    for p in node_pods:
        used = used.add(p.resource_request())
    return (used.milli_cpu + req.milli_cpu <= node.allocatable_milli_cpu and
            used.memory + req.memory <= node.allocatable_memory and
            used.nvidia_gpu + req.nvidia_gpu <= node.allocatable_gpu)


def pod_fits_host(pod: api.Pod, node: api.Node) -> bool:
    """predicates.go:567-581."""
    return not pod.node_name or pod.node_name == node.name


def pod_fits_host_ports(pod: api.Pod, node_pods: list[api.Pod]) -> bool:
    """predicates.go:721-761."""
    wanted = pod.used_host_ports()
    if not wanted:
        return True
    existing = set()
    for p in node_pods:
        existing |= p.used_host_ports()
    return not (wanted & existing)


def no_disk_conflict(pod: api.Pod, node_pods: list[api.Pod]) -> bool:
    """predicates.go:100-153: GCE PD (read-only-only sharing OK), EBS
    (never shared), RBD (never shared when any monitor matches)."""
    for v in pod.volumes:
        for ev in (e for p in node_pods for e in p.volumes):
            if v.gce_pd_name and v.gce_pd_name == ev.gce_pd_name:
                if not (v.gce_read_only and ev.gce_read_only):
                    return False
            if v.aws_ebs_id and v.aws_ebs_id == ev.aws_ebs_id:
                return False
            if v.rbd_key and ev.rbd_key:
                mons_a, pool_a, img_a = (v.rbd_key.split("#") + ["", ""])[:3]
                mons_b, pool_b, img_b = (ev.rbd_key.split("#") + ["", ""])[:3]
                if pool_a == pool_b and img_a == img_b and \
                        set(mons_a.split(",")) & set(mons_b.split(",")):
                    if not (v.rbd_read_only and ev.rbd_read_only):
                        return False
    return True


def pod_tolerates_node_taints(pod: api.Pod, node: api.Node) -> bool:
    """predicates.go:1070-1117."""
    taints = [t for t in node.taints()
              if t.effect != api.TAINT_EFFECT_PREFER_NO_SCHEDULE]
    all_taints = node.taints()
    if not all_taints:
        return True
    tols = pod.tolerations()
    if not tols:
        return False
    return all(t.tolerated_by(tols) for t in taints)


def check_node_memory_pressure(pod: api.Pod, node: api.Node) -> bool:
    """predicates.go:1125-1153."""
    if not pod.is_best_effort():
        return True
    return node.condition(api.NODE_MEMORY_PRESSURE) != "True"


def check_node_disk_pressure(pod: api.Pod, node: api.Node) -> bool:
    """predicates.go:1156-1172."""
    return node.condition(api.NODE_DISK_PRESSURE) != "True"


def _pd_filter_ids(pod: api.Pod, family: str,
                   cluster: ClusterState) -> tuple[set, int, bool]:
    """filterVolumes (predicates.go:188-241): (ids, extras, hard_error)."""
    ids: set[str] = set()
    extra = 0
    counter = [0]
    for v in pod.volumes:
        if family == "ebs" and v.aws_ebs_id:
            ids.add(v.aws_ebs_id)
        elif family == "gce" and v.gce_pd_name:
            ids.add(v.gce_pd_name)
        elif v.pvc_claim_name:
            pvc = next((c for c in cluster.pvcs
                        if c.namespace == pod.namespace
                        and c.name == v.pvc_claim_name), None)
            if pvc is None:
                extra += 1
                continue
            if not pvc.volume_name:
                return ids, extra, True
            pv = next((x for x in cluster.pvs
                       if x.name == pvc.volume_name), None)
            if pv is None:
                extra += 1
                continue
            if family == "ebs" and pv.aws_ebs_id:
                ids.add(pv.aws_ebs_id)
            elif family == "gce" and pv.gce_pd_name:
                ids.add(pv.gce_pd_name)
    del counter
    return ids, extra, False


def max_pd_volume_count(pod: api.Pod, node_pods: list[api.Pod],
                        family: str, max_volumes: int,
                        cluster: ClusterState) -> bool:
    """predicates.go:243-282."""
    if not pod.volumes:
        return True
    new_ids, new_extra, hard = _pd_filter_ids(pod, family, cluster)
    if hard:
        return False
    if not new_ids and not new_extra:
        return True
    existing: set[str] = set()
    existing_extra = 0
    for p in node_pods:
        ids, extra, hard = _pd_filter_ids(p, family, cluster)
        if hard:
            return False
        existing |= ids
        existing_extra += extra
    num_new = len(new_ids - existing) + new_extra
    return len(existing) + existing_extra + num_new <= max_volumes


def volume_zone(pod: api.Pod, node: api.Node,
                cluster: ClusterState) -> bool:
    """predicates.go:348-418."""
    if not pod.volumes:
        return True
    constraints = {k: v for k, v in node.labels.items()
                   if k in (api.ZONE_LABEL, api.REGION_LABEL)}
    if not constraints:
        return True
    for v in pod.volumes:
        if not v.pvc_claim_name:
            continue
        pvc = next((c for c in cluster.pvcs
                    if c.namespace == pod.namespace
                    and c.name == v.pvc_claim_name), None)
        if pvc is None or not pvc.volume_name:
            return False  # hard error
        pv = next((x for x in cluster.pvs if x.name == pvc.volume_name), None)
        if pv is None:
            return False
        for k, val in pv.labels.items():
            if k not in (api.ZONE_LABEL, api.REGION_LABEL):
                continue
            if val != constraints.get(k, ""):
                return False
    return True


def matching_anti_affinity_terms(pod: api.Pod, cluster: ClusterState
                                 ) -> list[tuple[api.Node,
                                                 api.PodAffinityTerm]]:
    """getMatchingAntiAffinityTerms (predicates.go:881-906): the per-pod
    precompute of predicateMetadata — (existing pod's node, term) for every
    existing anti-affinity term that matches the pending pod.  Only
    affinity-carrying pods can contribute (PodsWithAffinity,
    node_info.go:32-54)."""
    out = []
    for epod in cluster.affinity_pods():
        enode = cluster.node(epod.node_name)
        if enode is None:
            continue
        _, req_aa, _, _ = _affinity_terms(epod)
        for term in req_aa:
            if pod_matches_term(pod, epod, term):
                out.append((enode, term))
    return out


def inter_pod_affinity(pod: api.Pod, node: api.Node,
                       cluster: ClusterState, meta=None) -> bool:
    """InterPodAffinityMatches (predicates.go:825-1068).  ``meta``: the
    matching_anti_affinity_terms precompute (predicateMetadata,
    predicates.go:71-98); derived on the fly when absent."""
    # 1. Existing pods' anti-affinity (satisfiesExistingPodsAntiAffinity).
    if meta is None:
        meta = matching_anti_affinity_terms(pod, cluster)
    for enode, term in meta:
        if nodes_same_topology(node, enode, term.topology_key):
            return False
    # 2. The pod's own required terms.
    req_a, req_aa, _, _ = _affinity_terms(pod)
    for term in req_a:
        term_matches = False
        matching_exists = False
        for epod in cluster.pods:
            if pod_matches_term(epod, pod, term):
                matching_exists = True
                enode = cluster.node(epod.node_name)
                if enode is not None and \
                        nodes_same_topology(node, enode, term.topology_key):
                    term_matches = True
                    break
        if not term_matches:
            # Self-match escape hatch (predicates.go:1038-1048).
            if not (pod_matches_term(pod, pod, term) and not matching_exists):
                return False
    for term in req_aa:
        for epod in cluster.pods:
            if pod_matches_term(epod, pod, term):
                enode = cluster.node(epod.node_name)
                if enode is not None and \
                        nodes_same_topology(node, enode, term.topology_key):
                    return False
    return True


DEFAULT_MAX_EBS = 39
DEFAULT_MAX_GCE = 16


def find_nodes_that_fit(pod: api.Pod, cluster: ClusterState
                        ) -> tuple[list[api.Node], dict[str, list[str]]]:
    """findNodesThatFit with the DefaultProvider predicate set
    (defaults.go:113-163), over ready nodes."""
    fits = []
    failures: dict[str, list[str]] = {}
    meta = matching_anti_affinity_terms(pod, cluster)
    for node in cluster.ready_nodes():
        node_pods = cluster.node_pods(node.name)
        checks = [
            ("NoVolumeZoneConflict", volume_zone(pod, node, cluster)),
            ("MaxEBSVolumeCount", max_pd_volume_count(
                pod, node_pods, "ebs", DEFAULT_MAX_EBS, cluster)),
            ("MaxGCEPDVolumeCount", max_pd_volume_count(
                pod, node_pods, "gce", DEFAULT_MAX_GCE, cluster)),
            ("MatchInterPodAffinity", inter_pod_affinity(pod, node, cluster,
                                                         meta)),
            ("NoDiskConflict", no_disk_conflict(pod, node_pods)),
            ("PodFitsResources", pod_fits_resources(pod, node, node_pods)),
            ("PodFitsHost", pod_fits_host(pod, node)),
            ("PodFitsHostPorts", pod_fits_host_ports(pod, node_pods)),
            ("MatchNodeSelector", pod_matches_node_labels(pod, node)),
            ("PodToleratesNodeTaints", pod_tolerates_node_taints(pod, node)),
            ("CheckNodeMemoryPressure",
             check_node_memory_pressure(pod, node)),
            ("CheckNodeDiskPressure", check_node_disk_pressure(pod, node)),
        ]
        failed = [name for name, ok in checks if not ok]
        if failed:
            failures[node.name] = failed
        else:
            fits.append(node)
    return fits, failures


# ---------------------------------------------------------------------------
# Priorities (algorithm/priorities/)
# ---------------------------------------------------------------------------

def _nonzero_sum(pods: Sequence[api.Pod]) -> tuple[int, int]:
    cpu = mem = 0
    for p in pods:
        c, m = p.non_zero_request()
        cpu += c
        mem += m
    return cpu, mem


def least_requested(pod: api.Pod, node: api.Node,
                    node_pods: list[api.Pod]) -> int:
    """priorities.go:81-149 (int64 arithmetic; memory in bytes)."""
    def unused(requested, capacity):
        if capacity == 0 or requested > capacity:
            return 0
        return ((capacity - requested) * 10) // capacity
    ec, em = _nonzero_sum(node_pods)
    pc, pm = pod.non_zero_request()
    cpu = unused(ec + pc, node.allocatable_milli_cpu)
    mem = unused(em + pm, node.allocatable_memory)
    return (cpu + mem) // 2


def balanced_resource_allocation(pod: api.Pod, node: api.Node,
                                 node_pods: list[api.Pod]) -> int:
    """priorities.go:271-317."""
    def frac(req, cap):
        return 1.0 if cap == 0 else req / cap
    ec, em = _nonzero_sum(node_pods)
    pc, pm = pod.non_zero_request()
    cf = frac(ec + pc, node.allocatable_milli_cpu)
    mf = frac(em + pm, node.allocatable_memory)
    if cf >= 1 or mf >= 1:
        return 0
    return int(10 - abs(cf - mf) * 10)


def _spread_selectors(pod: api.Pod, cluster: ClusterState) -> list:
    sels: list = []
    for s in cluster.services:
        if s.namespace == pod.namespace and s.selector and \
                all(pod.labels.get(k) == v for k, v in s.selector.items()):
            sels.append(dict(s.selector))
    if pod.labels:
        for rc in cluster.controllers:
            if rc.namespace == pod.namespace and rc.selector and \
                    all(pod.labels.get(k) == v for k, v in rc.selector.items()):
                sels.append(dict(rc.selector))
        for rs in cluster.replica_sets:
            if rs.namespace == pod.namespace and rs.selector is not None and \
                    (rs.selector.match_labels or rs.selector.match_expressions) \
                    and rs.selector.matches(pod.labels):
                sels.append(rs.selector)
    return sels


def _sel_matches(sel, labels: dict[str, str]) -> bool:
    if isinstance(sel, dict):
        return bool(sel) and all(labels.get(k) == v for k, v in sel.items())
    return sel.matches(labels)


def first_matching_service(pod: api.Pod, services) -> Optional[api.Service]:
    """GetPodServices[0] — ServiceAffinity/ServiceAntiAffinity read only
    the FIRST matching service (predicates.go:676-678)."""
    for s in services:
        if s.namespace == pod.namespace and _sel_matches(s.selector,
                                                         pod.labels):
            return s
    return None


def selector_spread(pod: api.Pod, cluster: ClusterState) -> dict[str, int]:
    """CalculateSpreadPriority (selector_spreading.go:63-175), over ready
    nodes."""
    nodes = cluster.ready_nodes()
    selectors = _spread_selectors(pod, cluster)
    counts: dict[str, float] = {}
    counts_by_zone: dict[str, float] = {}
    max_count = 0.0
    if selectors:
        for node in nodes:
            count = 0.0
            for npod in cluster.node_pods(node.name):
                if npod.namespace != pod.namespace or \
                        npod.deletion_timestamp is not None:
                    continue
                if any(_sel_matches(s, npod.labels) for s in selectors):
                    count += 1
            counts[node.name] = count
            max_count = max(max_count, count)
            zone = node.zone_key()
            if zone:
                counts_by_zone[zone] = counts_by_zone.get(zone, 0) + count
    have_zones = len(counts_by_zone) != 0
    max_zone = max(counts_by_zone.values()) if have_zones else 0.0
    # The reference's fScore is a Go float32 (selector_spreading.go:139);
    # the blend must round through float32 or edge values truncate
    # differently than both the reference and the tensor engine (observed:
    # a blend that is exactly 6.0 in f32 lands at 5.9999996 in f64 and
    # int-truncates to 5).
    f32 = np.float32
    result = {}
    for node in nodes:
        f = f32(MAX_PRIORITY)
        if max_count > 0:
            f = f32(MAX_PRIORITY) * ((f32(max_count)
                                      - f32(counts.get(node.name, 0)))
                                     / f32(max_count))
        if have_zones and max_zone > 0:
            # The reference divides unguarded (selector_spreading.go:160);
            # with zero matches everywhere that's 0/0 -> NaN whose int
            # conversion is Go/amd64-implementation-defined.  Both this
            # oracle and the tensor engine take the only sane reading: no
            # zone signal, keep the node score.
            zone = node.zone_key()
            if zone:
                zscore = f32(MAX_PRIORITY) * (
                    (f32(max_zone) - f32(counts_by_zone.get(zone, 0)))
                    / f32(max_zone))
                f = f * f32(1 - 2 / 3) + f32(2 / 3) * zscore
        result[node.name] = int(f)
    return result


def service_anti_affinity(pod: api.Pod, cluster: ClusterState,
                          label: str) -> dict[str, int]:
    """CalculateAntiAffinityPriority (selector_spreading.go:193-253): spread
    the pods of the pod's FIRST matching service across values of a node
    label.  Ready nodes carrying the label score
    int(10 * (numServicePods - countsOnValue) / numServicePods); nodes
    without the label score 0; every labeled node scores 10 when the
    service has no pods."""
    nodes = cluster.ready_nodes()
    svc = first_matching_service(pod, cluster.services)
    peers: list[api.Pod] = []
    if svc is not None:
        peers = [p for p in cluster.pods
                 if p.namespace == svc.namespace and p.node_name and
                 _sel_matches(svc.selector, p.labels)]
    num = len(peers)
    counts: dict[str, int] = {}
    for peer in peers:
        pn = cluster.node(peer.node_name)
        if pn is not None and pn.is_ready() and label in pn.labels:
            counts[pn.labels[label]] = counts.get(pn.labels[label], 0) + 1
    out = {}
    for node in nodes:
        if label not in node.labels:
            out[node.name] = 0
        elif num == 0:
            out[node.name] = MAX_PRIORITY
        else:
            v = node.labels[label]
            out[node.name] = int(10.0 * (num - counts.get(v, 0)) / num)
    return out


def node_prefer_avoid(pod: api.Pod, cluster: ClusterState) -> dict[str, int]:
    """priorities.go:326-398: 0 when the node's preferAvoidPods annotation
    names one of the pod's controllers, else 10."""
    import json as _json
    refs = []
    if pod.labels:
        for rc in cluster.controllers:
            if rc.namespace == pod.namespace and rc.selector and \
                    all(pod.labels.get(k) == v for k, v in rc.selector.items()):
                refs.append(("ReplicationController", f"{rc.namespace}/{rc.name}"))
        for rs in cluster.replica_sets:
            if rs.namespace == pod.namespace and rs.selector is not None and \
                    (rs.selector.match_labels or rs.selector.match_expressions) \
                    and rs.selector.matches(pod.labels):
                refs.append(("ReplicaSet", f"{rs.namespace}/{rs.name}"))
    result = {}
    for node in cluster.ready_nodes():
        score = MAX_PRIORITY
        raw = node.annotations.get(api.PREFER_AVOID_PODS_ANNOTATION_KEY, "")
        if raw and refs:
            try:
                d = _json.loads(raw)
                for e in d.get("preferAvoidPods") or ():
                    pc = (e.get("podSignature") or {}).get("podController") or {}
                    if (pc.get("kind", ""), pc.get("uid", "")) in refs:
                        score = 0
            except ValueError:
                pass
        result[node.name] = score
    return result


def node_affinity_priority(pod: api.Pod,
                           cluster: ClusterState) -> dict[str, int]:
    """node_affinity.go:32-86."""
    nodes = cluster.ready_nodes()
    counts = {}
    max_count = 0
    aff = pod.affinity()
    for node in nodes:
        count = 0
        if aff is not None and aff.node_affinity is not None:
            for term in aff.node_affinity.preferred:
                if term.weight == 0:
                    continue
                if _node_selector_term_matches(term.preference, node):
                    count += term.weight
        counts[node.name] = count
        max_count = max(max_count, count)
    return {n.name: (int(counts[n.name] * MAX_PRIORITY / max_count)
                     if max_count > 0 else 0) for n in nodes}


def taint_toleration_priority(pod: api.Pod,
                              cluster: ClusterState) -> dict[str, int]:
    """taint_toleration.go:54-105."""
    nodes = cluster.ready_nodes()
    tols = [t for t in pod.tolerations()
            if not t.effect or t.effect == api.TAINT_EFFECT_PREFER_NO_SCHEDULE]
    counts = {}
    max_count = 0
    for node in nodes:
        count = 0
        for taint in node.taints():
            if taint.effect != api.TAINT_EFFECT_PREFER_NO_SCHEDULE:
                continue
            if not taint.tolerated_by(tols):
                count += 1
        counts[node.name] = count
        max_count = max(max_count, count)
    out = {}
    for node in nodes:
        if max_count > 0:
            out[node.name] = int((1.0 - counts[node.name] / max_count) * 10)
        else:
            out[node.name] = MAX_PRIORITY
    return out


def inter_pod_affinity_priority(pod: api.Pod,
                                cluster: ClusterState) -> dict[str, int]:
    """interpod_affinity.go:117-260."""
    nodes = cluster.ready_nodes()
    counts: dict[str, float] = {}

    def process_term(term, affinity_pod, check_pod, fixed_node, weight):
        if weight == 0 or fixed_node is None:
            return
        if pod_matches_term(check_pod, affinity_pod, term):
            for node in nodes:
                if nodes_same_topology(node, fixed_node, term.topology_key):
                    counts[node.name] = counts.get(node.name, 0) + weight

    req_a, req_aa, pref_a, pref_aa = _affinity_terms(pod)
    # The pending pod's own preferred terms are checked against EVERY
    # existing pod (their labels matter, not their affinity)...
    if pref_a or pref_aa:
        for epod in cluster.pods:
            enode = cluster.node(epod.node_name)
            if enode is None:
                continue
            for wt in pref_a:
                process_term(wt.pod_affinity_term, pod, epod, enode,
                             wt.weight)
            for wt in pref_aa:
                process_term(wt.pod_affinity_term, pod, epod, enode,
                             -wt.weight)
    # ...while existing pods' terms can only come from affinity-carrying
    # pods (PodsWithAffinity, node_info.go:32-54).
    for epod in cluster.affinity_pods():
        enode = cluster.node(epod.node_name)
        if enode is None:
            continue
        ereq_a, _, epref_a, epref_aa = _affinity_terms(epod)
        if cluster.hard_pod_affinity_weight > 0:
            for term in ereq_a:
                process_term(term, epod, pod, enode,
                             cluster.hard_pod_affinity_weight)
        for wt in epref_a:
            process_term(wt.pod_affinity_term, epod, pod, enode, wt.weight)
        for wt in epref_aa:
            process_term(wt.pod_affinity_term, epod, pod, enode, -wt.weight)

    max_c = max([counts.get(n.name, 0) for n in nodes] + [0])
    min_c = min([counts.get(n.name, 0) for n in nodes] + [0])
    out = {}
    for node in nodes:
        if max_c - min_c > 0:
            out[node.name] = int(
                10 * ((counts.get(node.name, 0) - min_c) / (max_c - min_c)))
        else:
            out[node.name] = 0
    return out


def prioritize(pod: api.Pod, cluster: ClusterState) -> dict[str, int]:
    """PrioritizeNodes with DefaultProvider weights (defaults.go:165-206):
    SelectorSpread x1, InterPodAffinity x1, LeastRequested x1,
    BalancedResourceAllocation x1, NodePreferAvoidPods x10000,
    NodeAffinity x1, TaintToleration x1."""
    nodes = cluster.ready_nodes()
    spread = selector_spread(pod, cluster)
    interpod = inter_pod_affinity_priority(pod, cluster)
    avoid = node_prefer_avoid(pod, cluster)
    naff = node_affinity_priority(pod, cluster)
    taint = taint_toleration_priority(pod, cluster)
    out = {}
    for node in nodes:
        node_pods = cluster.node_pods(node.name)
        out[node.name] = (
            spread[node.name]
            + interpod[node.name]
            + least_requested(pod, node, node_pods)
            + balanced_resource_allocation(pod, node, node_pods)
            + 10000 * avoid[node.name]
            + naff[node.name]
            + taint[node.name])
    return out


def preempt_candidates(pod: api.Pod, cluster: ClusterState,
                       max_victims: int = 16) -> dict[str, tuple[int, int]]:
    """Per-node minimal-cost victim prefix for an unschedulable priority
    pod — the pure-Python mirror of the tensor victim solve
    (engine/workloads/preemption.py), for differential parity testing.

    For each ready node whose NON-resource predicates pass with the
    victims still present, victims (pods of strictly lower priority) are
    sorted ascending by (priority, key) and the smallest prefix k whose
    eviction lets the pod fit is found.  Returns node name ->
    (k, summed victim priority) for feasible nodes."""
    out: dict[str, tuple[int, int]] = {}
    prio = pod.effective_priority
    meta = matching_anti_affinity_terms(pod, cluster)
    for node in cluster.ready_nodes():
        node_pods = cluster.node_pods(node.name)
        checks = [
            volume_zone(pod, node, cluster),
            max_pd_volume_count(pod, node_pods, "ebs", DEFAULT_MAX_EBS,
                                cluster),
            max_pd_volume_count(pod, node_pods, "gce", DEFAULT_MAX_GCE,
                                cluster),
            inter_pod_affinity(pod, node, cluster, meta),
            no_disk_conflict(pod, node_pods),
            pod_fits_host(pod, node),
            pod_fits_host_ports(pod, node_pods),
            pod_matches_node_labels(pod, node),
            pod_tolerates_node_taints(pod, node),
            check_node_memory_pressure(pod, node),
            check_node_disk_pressure(pod, node),
        ]
        if not all(checks):
            continue
        victims = sorted(node_pods,
                         key=lambda p: (p.effective_priority, p.key))
        victims = victims[:max_victims]
        eligible = [v for v in victims if v.effective_priority < prio]
        for k in range(len(eligible) + 1):
            remaining = [p for p in node_pods
                         if p.key not in {v.key for v in eligible[:k]}]
            if pod_fits_resources(pod, node, remaining):
                out[node.name] = (
                    k, sum(v.effective_priority for v in eligible[:k]))
                break
    return out


def preempt(pod: api.Pod, cluster: ClusterState,
            max_victims: int = 16) -> Optional[tuple[str, int, int]]:
    """The argmin preemption decision: (node, victim count, priority
    cost), minimizing (victim count, summed victim priority, node index
    in cluster order) — the engine's deterministic cost order.  None when
    no node works even after evictions."""
    cands = preempt_candidates(pod, cluster, max_victims)
    if not cands:
        return None
    node_order = {n.name: i for i, n in enumerate(cluster.nodes)}
    name = min(cands, key=lambda nm: (*cands[nm], node_order[nm]))
    return (name, *cands[name])


def schedule(pod: api.Pod, cluster: ClusterState) -> set[str]:
    """The reference Schedule's argmax set: all hosts selectHost could pick
    (its tie order is nondeterministic Go map iteration, so parity is
    membership in this set)."""
    fits, _ = find_nodes_that_fit(pod, cluster)
    if not fits:
        return set()
    scores = prioritize(pod, cluster)
    best = max(scores[n.name] for n in fits)
    return {n.name for n in fits if scores[n.name] == best}

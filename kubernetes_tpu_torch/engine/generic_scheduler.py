"""Host orchestration: the batched counterpart of genericScheduler.Schedule
(generic_scheduler.go:78-122), on PyTorch.

Counterpart of ``kubernetes_tpu/engine/generic_scheduler.py``:
``schedule_batch`` (sequential greedy) places a pending queue in one
device solve, ``schedule_batch_stream`` in equal chunks with
device-carried state, ``schedule`` places one pod (the reference's
Schedule, with policy extenders called over HTTP) and
``explain_failures`` reports why pods fit nowhere, and
``find_preemptions`` picks minimal-cost victim sets for unschedulable
priority pods.  All are decision-identical to the JAX package.

``schedule_batch(joint=True)`` runs the joint solve (price iteration,
then the regret-ordered repair scan), and pods carrying
topologySpreadConstraints get the spread planes
(``engine/workloads/topology.py``) on every route: a hard mask and a
soft score bias for the scan, ``"TopologySpread"`` in the FitError map,
and the hard mask in the preemption base.

Every device solve site runs inside the device guard
(``engine/guard.py``: ``watch`` classifies CUDA faults, every assignment
readback passes ``checked_readback``), under ``devicestats.live_path``,
``utils/profiling.device_trace`` (a ``torch.profiler`` trace per solve
with ``--profile-dir``) and a ``stage`` span.  There is no host engine to fall back to: a
classified fault surfaces as ``DeviceFault`` (the daemon's pipeline
retries, bisects or requeues), and a non-finite score plane on the
single-pod path raises :class:`ScoreGateError`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import (Policy, default_provider,
                                             node_label_args,
                                             node_label_prio_args,
                                             service_affinity_labels,
                                             service_anti_affinity_labels)
from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
from kubernetes_tpu_torch.engine import devicestats
from kubernetes_tpu_torch.engine import guard as guard_mod
from kubernetes_tpu_torch.engine import solver as sv
from kubernetes_tpu_torch.engine.extender_client import (ExtenderUnavailable,
                                                         HTTPExtender)
from kubernetes_tpu_torch.engine.workloads import topology
from kubernetes_tpu_torch.features import batch as fb
from kubernetes_tpu_torch.features import compiler as fc
from kubernetes_tpu_torch.features import padcap
from kubernetes_tpu_torch.features.volumes import compile_volsvc
from kubernetes_tpu_torch.ops import combine
from kubernetes_tpu_torch.utils import device as device_mod
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.logging import get_logger
from kubernetes_tpu_torch.utils.profiling import device_trace
from kubernetes_tpu_torch.utils.trace import Trace, stage

log = get_logger("engine")

_MASK32 = 0xFFFFFFFF


class FitError(Exception):
    """No node fits (generic_scheduler.go:39-61). failed_predicates maps
    node name -> list of failing predicate names."""

    def __init__(self, pod: api.Pod, failed_predicates: dict[str, list[str]]):
        self.pod = pod
        self.failed_predicates = failed_predicates
        super().__init__(f"pod ({pod.name}) failed to fit in any node")


# The single-pod sanity gate's error (a ``corrupt`` DeviceFault).
ScoreGateError = guard_mod.ScoreGateError


@dataclass
class Listers:
    """In-memory cluster-object stores standing in for the reference's
    reflector-backed caches (factory.go:387-416)."""

    services: list[api.Service] = field(default_factory=list)
    controllers: list[api.ReplicationController] = field(default_factory=list)
    replica_sets: list[api.ReplicaSet] = field(default_factory=list)
    pvs: list[api.PersistentVolume] = field(default_factory=list)
    pvcs: list[api.PersistentVolumeClaim] = field(default_factory=list)

    def get_pv(self, name: str) -> api.PersistentVolume | None:
        for pv in self.pvs:
            if pv.name == name:
                return pv
        return None

    def get_pvc(self, namespace: str, name: str) -> api.PersistentVolumeClaim | None:
        for pvc in self.pvcs:
            if pvc.namespace == namespace and pvc.name == name:
                return pvc
        return None

    def first_service(self, pod: api.Pod) -> api.Service | None:
        """GetPodServices[0] (the reference's ServiceAffinity/ServiceAnti
        Affinity use only the first matching service,
        predicates.go:676-678)."""
        for s in self.services:
            if s.namespace == pod.namespace and s.selector and \
                    all(pod.labels.get(k) == v for k, v in s.selector.items()):
                return s
        return None

    def spread_selectors(self, pod: api.Pod) -> list:
        """GetPodServices/GetPodControllers/GetPodReplicaSets
        (pkg/client/cache/listers.go): same namespace, empty selectors match
        nothing, unlabeled pods match no RC/RS."""
        out: list = []
        for s in self.services:
            if s.namespace == pod.namespace and s.selector and \
                    all(pod.labels.get(k) == v for k, v in s.selector.items()):
                out.append(s.selector)
        if pod.labels:
            for rc in self.controllers:
                if rc.namespace == pod.namespace and rc.selector and \
                        all(pod.labels.get(k) == v for k, v in rc.selector.items()):
                    out.append(rc.selector)
            for rs in self.replica_sets:
                if rs.namespace == pod.namespace and rs.selector is not None:
                    if (rs.selector.match_labels or rs.selector.match_expressions) \
                            and rs.selector.matches(pod.labels):
                        out.append(rs.selector)
        return out

    def controller_refs(self, pod: api.Pod) -> list:
        """Controller signatures for NodePreferAvoidPods (priorities.go:340-342).
        UIDs are modeled as 'namespace/name'."""
        out = []
        if pod.labels:
            for rc in self.controllers:
                if rc.namespace == pod.namespace and rc.selector and \
                        all(pod.labels.get(k) == v for k, v in rc.selector.items()):
                    out.append(("ReplicationController", f"{rc.namespace}/{rc.name}"))
            for rs in self.replica_sets:
                if rs.namespace == pod.namespace and rs.selector is not None:
                    if (rs.selector.match_labels or rs.selector.match_expressions) \
                            and rs.selector.matches(pod.labels):
                        out.append(("ReplicaSet", f"{rs.namespace}/{rs.name}"))
        return out


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to kubernetes_tpu_torch yet ({slice_name} "
        f"slice); use kubernetes_tpu for it")


class GenericScheduler:
    def __init__(self, policy: Policy | None = None,
                 cache: SchedulerCache | None = None,
                 listers: Listers | None = None,
                 device: "str | torch.device | None" = "cuda"):
        self.device = device_mod.resolve(device)
        self.policy = policy or default_provider()
        self.cache = cache or SchedulerCache()
        self.listers = listers or Listers()
        # Shared per policy signature (see Solver.for_policy).
        self.solver = sv.Solver.for_policy(self.policy)
        # Device-resident cluster mirror: per drain only the cache's
        # dirty rows are scattered into the resident arrays.
        self.resident = sv.ResidentCluster(self.device)
        devicestats.track_device(self.device)
        # Guarded device execution (engine/guard.py): every solve site
        # runs inside the guard so CUDA faults classify, count and
        # recover (OOM -> evict + bisect; repeated or lost -> the fault
        # surfaces and the daemon requeues the batch).
        self.guard = guard_mod.DeviceGuard(evict_fn=self.resident.invalidate)
        self.extenders = [HTTPExtender(cfg) for cfg in self.policy.extenders]
        self.last_node_index = np.uint32(0)
        # Monotonic compile state (features.padcap): table-axis capacities
        # and the OR of all content flags seen, so the drains of a
        # long-running scheduler keep one state layout.
        self._axis_caps: dict[str, int] = {}
        self._flags_seen: sv.BatchFlags | None = None
        self._agg_handoff: Optional[tuple] = None
        # Spread-constraint term tables of the batch ``_compile`` last saw
        # (None = no pod carried topologySpreadConstraints).
        self._topo_terms: Optional[topology.SpreadTerms] = None

    def _pinned_flags(self, batch) -> sv.BatchFlags:
        """Content flags OR-ed monotonically: once a family has appeared,
        later batches keep carrying its (numerically no-op when empty)
        state."""
        flags = sv.batch_flags(batch)
        if self._flags_seen is not None:
            flags = sv.BatchFlags(*(a or b for a, b in
                                    zip(flags, self._flags_seen)))
        self._flags_seen = flags
        return flags

    def _counter(self) -> torch.Tensor:
        """The round-robin counter as a [1] int64 device tensor."""
        return torch.tensor([int(self.last_node_index)], dtype=torch.int64,
                            device=self.device)

    # -- compilation helpers --------------------------------------------

    def _compile(self, pods: list[api.Pod]
                 ) -> tuple[fb.PodBatch, sv.DeviceBatch,
                            sv.DeviceCluster, object]:
        """Host snapshot + NumPy feature compile + the device transfer of
        the batch and the resident-cluster sync, all under the cache lock
        so every read sees one generation.  Sets ``_topo_terms`` to the
        batch's spread-constraint tables (None without constraints)."""
        # Topology keys named by spread constraints are interned BEFORE
        # the snapshot, so topo_dom has their columns (a new key marks
        # the node tensors dirty: once per workload type).
        has_spread = topology.batch_has_spread(pods)
        if has_spread:
            for key in topology.spread_topology_keys(pods):
                self.cache.ensure_topo_key(key)
        with self.cache.lock:
            with stage("snapshot", pods=len(pods)):
                nt, agg, ep, nodes = self.cache.snapshot()
                # Tag for the device-aggregate handoff: the snapshot the
                # solve starts from (assume_pods validates nothing
                # changed since).
                self._snapshot_generation = self.cache.generation
            with stage("compile", pods=len(pods)):
                batch = self._compile_batch(pods, nt, ep, nodes)
                # Term tables: counts snapshotted under the same lock as
                # everything else this solve reads.
                self._topo_terms = topology.compile_terms(
                    pods, nt, self.cache.space,
                    self.cache.topo_domain_counts_bulk) \
                    if has_spread else None
            with stage("transfer"):
                db = sv.device_batch(batch, self.device)
                dc = self.resident.sync(nt, agg, self.cache.space,
                                        self.cache.take_dirty_rows(),
                                        self.cache.tensor_epoch)
        return batch, db, dc, nt

    def _compile_batch(self, pods: list[api.Pod], nt, ep,
                       nodes) -> fb.PodBatch:
        """The NumPy feature compile of one batch (caller holds the cache
        lock)."""
        volsvc = compile_volsvc(
            pods, nodes, nt.schedulable,
            volume_pods=self.cache.volume_pods(),
            listers=self.listers,
            service_affinity_labels=service_affinity_labels(self.policy),
            service_anti_affinity_labels=(
                service_anti_affinity_labels(self.policy)),
            node_label_args=node_label_args(self.policy),
            node_label_prio_args=node_label_prio_args(self.policy),
            service_peers=self.cache.service_peer_nodes,
            first_peer=self.cache.first_peer_node)
        batch = fb.compile_batch(
            pods, nt, self.cache.space, ep=ep, nodes=nodes,
            spread_selectors=self.listers.spread_selectors,
            controller_refs=self.listers.controller_refs,
            affinity_pods=self.cache.affinity_pods(),
            hard_pod_affinity_weight=(
                self.policy.hard_pod_affinity_symmetric_weight),
            volsvc=volsvc)
        return padcap.apply_caps(batch, self._axis_caps)

    def _topo_planes(self, dc: sv.DeviceCluster
                     ) -> Optional[topology.TermPlanes]:
        """The last compiled batch's spread term planes on the device
        (None when no pod carries a constraint)."""
        if self._topo_terms is None:
            return None
        with stage("topo_planes"):
            return topology.TermPlanes(self._topo_terms, dc.topo_dom)

    # -- single-pod path (Schedule, generic_scheduler.go:78) -------------

    def schedule(self, pod: api.Pod) -> str:
        """One decision: the pod's feasibility and score planes against
        the current cache, then selectHost (the CUDA kernel of
        ``ops/combine.py`` on the card), or the extenders' filter and
        prioritize when the policy names any.  Raises FitError when no
        node fits, ScoreGateError on a non-finite score plane, and
        DeviceFault on any other classified device fault (the guard has
        counted it; the caller requeues the pod)."""
        try:
            with devicestats.live_path("single_pod"), \
                    self.guard.watch("single_pod"):
                return self._schedule_device(pod)
        except guard_mod.DeviceFault as fault:
            self.guard.recover(fault, can_bisect=False)
            raise

    def _schedule_device(self, pod: api.Pod) -> str:
        trace = Trace(f"Scheduling {pod.namespace}/{pod.name}")
        if not self.cache.nodes():
            raise FitError(pod, {})
        batch, db, dc, nt = self._compile([pod])
        trace.step("Computing predicates & priorities")
        feasible, scores = self.solver.evaluate(
            db, dc, self._pinned_flags(batch))
        topo = self._topo_planes(dc)
        tmask = None
        if topo is not None:
            tmask, tscore = topo.rows()
            if tmask is not None:
                feasible = feasible & tmask
            if tscore is not None:
                scores = scores + tscore
        trace.step("Selecting host")
        if self.extenders:
            feasible_np = feasible[0].cpu().numpy()
            scores_np = scores[0].cpu().numpy()
            self.guard.checked_scores("single_pod",
                                      bool(np.isfinite(scores_np).all()))
            if not feasible_np.any():
                raise self._fit_error(pod, db, dc, nt, tmask)
            host = self._schedule_with_extenders(pod, nt, feasible_np,
                                                 scores_np)
            trace.log_if_long()
            return host
        choice, new_last = combine.select_hosts(scores, feasible,
                                                self._counter())
        # One device->host copy: (choice, new counter, finite flag).
        picked, new_last, finite = torch.cat(
            [choice.long(), new_last,
             torch.isfinite(scores).all().long()[None]]).cpu().tolist()
        self.guard.checked_scores("single_pod", bool(finite))
        if picked < 0:
            raise self._fit_error(pod, db, dc, nt, tmask)
        self.last_node_index = np.uint32(new_last & _MASK32)
        trace.log_if_long()
        return nt.names[picked]

    def _fit_error(self, pod: api.Pod, db: sv.DeviceBatch,
                   dc: sv.DeviceCluster, nt,
                   tmask: Optional[torch.Tensor] = None) -> FitError:
        """FitError with, per schedulable node, the names of the
        predicates that fail it (in ``Solver.masks`` order, then
        ``"TopologySpread"`` when the pod carries a hard spread term)."""
        masks = {k: v[0].cpu().numpy()
                 for k, v in self.solver.masks(db, dc).items()}
        if tmask is not None:
            masks["TopologySpread"] = tmask[0].cpu().numpy()
        failed: dict[str, list[str]] = {}
        for i, name in enumerate(nt.names):
            if nt.schedulable[i]:
                failed[name] = [p for p, m in masks.items() if not m[i]]
        return FitError(pod, failed)

    def _schedule_with_extenders(self, pod: api.Pod, nt,
                                 feasible_np: np.ndarray,
                                 scores_np: np.ndarray) -> str:
        """Extender filter after built-in predicates
        (generic_scheduler.go:189-207) and prioritize summed at weight
        (:287-305), then selectHost (:124-141) host-side."""
        nodes = self.cache.nodes()
        candidates = [nodes[i] for i in range(len(nodes)) if feasible_np[i]]
        failed_ext: dict[str, list[str]] = {}
        degraded = False
        for ext in self.extenders:
            try:
                candidates, failed = ext.filter(pod, candidates)
            except ExtenderUnavailable:
                # Breaker open: the endpoint is known-dead.  Graceful
                # degradation — schedule on built-in predicates alone
                # rather than failing every pod until it recovers.  (A
                # closed-breaker timeout still raises ExtenderError and
                # fails THIS pod, the reference's filter-timeout
                # semantics, api/types.go:128-130.)
                if not degraded:
                    degraded = True
                    metrics.EXTENDER_DEGRADED_DECISIONS.labels(
                        extender=ext.config.url_prefix).inc()
                    log.debug("extender %s unavailable (breaker open); "
                              "scheduling %s with built-in predicates "
                              "only", ext.config.url_prefix, pod.key)
                continue
            for name, msg in failed.items():
                failed_ext.setdefault(name, []).append(msg or "extender")
            if not candidates:
                raise FitError(pod, failed_ext)
        name_to_idx = nt.name_to_idx
        combined = {n.name: float(scores_np[name_to_idx[n.name]])
                    for n in candidates}
        for ext in self.extenders:
            for host, score in ext.prioritize(pod, candidates).items():
                if host in combined:
                    combined[host] += score
        best = max(combined.values())
        ties = [n.name for n in candidates if combined[n.name] == best]
        choice = ties[int(self.last_node_index) % len(ties)]
        self.last_node_index = np.uint32(
            (int(self.last_node_index) + 1) & _MASK32)
        return choice

    def _schedule_batch_via_extenders(self, pods: list[api.Pod]
                                      ) -> list[str | None]:
        """Extenders are a per-pod HTTP protocol: the one-pod path with
        temporary assumes for in-batch visibility, then restored (callers
        re-assume)."""
        out: list[str | None] = []
        assumed: list[api.Pod] = []
        try:
            for pod in pods:
                try:
                    dest = self.schedule(pod)
                except FitError:
                    out.append(None)
                    continue
                self.cache.assume_pod(pod, dest)
                assumed.append(pod)
                out.append(dest)
        finally:
            for pod in assumed:
                self.cache.forget_pod(pod)
                pod.node_name = ""
        return out

    # Cap on pods explained per call: one compile + masks + evaluate over
    # a batch padded to this many pods.
    EXPLAIN_CAP = 64

    def explain_failures(self, pods: list[api.Pod]) -> dict:
        """Per-predicate failure counts (and top-scoring nodes) for pods
        that failed to place, against the CURRENT cache snapshot: a pod
        that only failed because of in-batch contention may show zero
        failing predicates.  At most ``EXPLAIN_CAP`` pods, padded to that
        many with inert pods, as the JAX package pads them."""
        pods = pods[:self.EXPLAIN_CAP]
        if not pods:
            return {}
        nodes = self.cache.nodes()
        if not nodes:
            return {pod.key: {"message": "no nodes in cluster",
                              "failed_predicates": {}}
                    for pod in pods}
        padded = list(pods) + [
            api.Pod(name=f"__explain-pad-{i}", namespace="__pad__")
            for i in range(self.EXPLAIN_CAP - len(pods))]
        batch, db, dc, nt = self._compile(padded)
        masks = {name: m.cpu().numpy() for name, m in
                 self.solver.masks(db, dc).items()}
        _, scores = self.solver.evaluate(db, dc, sv.batch_flags(batch))
        scores = scores.cpu().numpy()
        sched = np.asarray(nt.schedulable, dtype=bool)
        n_sched = int(sched.sum())
        out: dict = {}
        for i, pod in enumerate(pods):
            counts = {}
            for name, m in masks.items():
                failing = int(np.count_nonzero(sched & ~m[i]))
                if failing:
                    counts[name] = failing
            top_idx = np.argsort(-scores[i])[:5]
            out[pod.key] = {
                "message": f"pod ({pod.name}) failed to fit in any node"
                if counts else
                f"pod ({pod.name}) fit no node in this batch (in-batch "
                f"contention; predicates pass against the current "
                f"snapshot)",
                "nodes_considered": n_sched,
                "failed_predicates": counts,
                "top_scores": [{"node": nt.names[int(j)],
                                "score": float(scores[i][int(j)])}
                               for j in top_idx]}
        return out

    # Preemption decisions computed per call: the masks pass pads to
    # this many pods (the EXPLAIN_CAP discipline) and the per-decision
    # eviction blast radius is bounded separately
    # (workloads.preemption.MAX_VICTIMS).
    PREEMPT_CAP = 16

    def find_preemptions(self, pods: list[api.Pod],
                         protected: frozenset = frozenset()) -> list:
        """Minimal-cost victim sets for unschedulable priority pods — the
        second batched solve (engine/workloads/preemption.py).

        Per pod, in priority order: one ``victim_solve`` over the (nodes
        x victims) table picks the cheapest feasible eviction prefix per
        node; the host takes the (victim count, victim priority sum, node
        index) argmin.  Decisions within one call see each other through
        host-side overlays (victims already claimed are consumed, the
        preemptor's own request charged), so two pods never nominate the
        same victim.  ``protected`` keys are never victims.  The caller
        executes the decisions (evict -> assume -> bind); it must have
        ASSUMED the batch's placements first so the aggregates this solve
        reads include them."""
        from kubernetes_tpu_torch.engine.workloads import preemption as pre
        pods = [p for p in pods if p.effective_priority > 0]
        pods.sort(key=lambda p: (-p.effective_priority, p.key))
        pods = pods[:self.PREEMPT_CAP]
        if not pods or not self.cache.nodes():
            return []
        padded = list(pods) + [
            api.Pod(name=f"__preempt-pad-{i}", namespace="__pad__")
            for i in range(self.PREEMPT_CAP - len(pods))]
        batch, db, dc, nt = self._compile(padded)
        # Non-resource predicate rows: victims free resources, nothing
        # else — a node that only becomes selector/taint-feasible after
        # eviction is never nominated (conservative).
        masks = {name: m.cpu().numpy() for name, m in
                 self.solver.masks(db, dc).items()}
        base = np.broadcast_to(np.asarray(nt.schedulable, bool),
                               (len(padded), nt.alloc.shape[0])).copy()
        for name, m in masks.items():
            if name not in ("PodFitsResources",):
                base &= m
        topo = self._topo_planes(dc)
        if topo is not None:
            tmask, _ = topo.rows()
            if tmask is not None:
                base &= tmask.cpu().numpy()
        with self.cache.lock:
            _, agg, _, _ = self.cache.snapshot()
            vt = self.cache.victim_table(pre.MAX_VICTIMS,
                                         exclude=protected)
            requested = agg.requested.copy()
        alloc = nt.alloc
        vic_req, vic_prio, vic_valid = (vt.req.copy(), vt.prio.copy(),
                                        vt.valid.copy())
        vic_keys = [list(k) for k in vt.keys]
        decisions = []
        with devicestats.live_path("victim"), self.guard.watch("victim"):
            self._find_preemptions_inner(
                pods, alloc, requested, base, vic_req, vic_prio,
                vic_valid, vic_keys, nt, decisions)
        return decisions

    def _find_preemptions_inner(self, pods, alloc, requested, base,
                                vic_req, vic_prio, vic_valid, vic_keys,
                                nt, decisions) -> None:
        from kubernetes_tpu_torch.engine.workloads import preemption as pre
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        alloc_d = put(np.asarray(alloc, np.int32))
        for i, pod in enumerate(pods):
            pod_req = fc.pod_resource_row(pod)
            with stage("solve", pods=1, mode="victim"):
                k_min, cost, feas = pre.victim_solve(
                    alloc_d, put(requested.astype(np.int32)),
                    put(base[i]), put(vic_req), put(vic_prio),
                    put(vic_valid), put(np.asarray(pod_req, np.int32)),
                    torch.tensor(bool(pod_req[0] == pod_req[1]
                                      == pod_req[2] == 0), device=dev),
                    torch.tensor(pod.effective_priority,
                                 dtype=torch.int32, device=dev))
            with stage("readback", pods=1):
                # One device->host copy of the three [N] results.
                host = torch.stack([k_min, cost, feas.to(torch.int32)]
                                   ).cpu().numpy()
                devicestats.record_transfer("readback", host.nbytes)
            k_min, cost, feas = host[0], host[1], host[2].astype(bool)
            n_idx = pre.pick_node(k_min, cost, feas)
            if n_idx is None:
                continue
            k = int(k_min[n_idx])
            victims = vic_keys[n_idx][:k]
            decisions.append(pre.PreemptionDecision(
                pod_key=pod.key, node=nt.names[n_idx], node_idx=n_idx,
                victims=victims, prio_cost=int(cost[n_idx])))
            # Overlay for later pods in this call: free the claimed
            # victims' rows, charge the preemptor, shift the table.
            freed = vic_req[n_idx, :k].sum(axis=0)
            requested[n_idx] = requested[n_idx] - freed + pod_req
            if k:
                vic_req[n_idx] = np.concatenate(
                    [vic_req[n_idx, k:], np.zeros((k, 4), np.int32)])
                vic_prio[n_idx] = np.concatenate(
                    [vic_prio[n_idx, k:], np.zeros(k, np.int32)])
                vic_valid[n_idx] = np.concatenate(
                    [vic_valid[n_idx, k:], np.zeros(k, bool)])
                vic_keys[n_idx] = vic_keys[n_idx][k:]

    # -- batched path ----------------------------------------------------

    def schedule_batch(self, pods: list[api.Pod],
                       joint: bool = False,
                       pad_to: int = 0) -> list[str | None]:
        """Place a pending queue in one device solve.  Returns node names,
        None where unschedulable.  The default is sequential greedy in
        queue order with full in-batch visibility; ``joint=True`` runs the
        joint solve (price iteration, then the regret-ordered repair
        scan): better aggregate placement, no per-pod order parity.
        ``pad_to`` pads the batch with live-masked inert rows.  With
        policy extenders every pod goes through the single-pod path
        (``schedule``)."""
        if not pods:
            return []
        if not self.cache.nodes():
            # Empty cluster: findNodesThatFit over zero nodes fails every
            # pod.
            return [None] * len(pods)
        if self.extenders:
            return self._schedule_batch_via_extenders(pods)
        real_p = len(pods)
        live = None
        if pad_to > real_p:
            pods = list(pods) + [
                api.Pod(name=f"__pad-{i}", namespace="__pad__")
                for i in range(pad_to - real_p)]
        with self.guard.watch("joint" if joint else "oneshot",
                              inject=False):
            batch, db, dc, nt = self._compile(pods)
        flags = self._pinned_flags(batch)
        live_np = None
        if pad_to > real_p:
            live_np = np.zeros(len(pods), bool)
            live_np[:real_p] = True
            live = torch.from_numpy(live_np).to(self.device)
        extra_mask = score_bias = None
        topo = self._topo_planes(dc)
        if topo is not None:
            extra_mask, score_bias = topo.rows()
        self._agg_handoff = None
        if joint:
            return self._schedule_batch_joint(
                pods, real_p, batch, db, dc, nt, flags, live, live_np,
                extra_mask, score_bias)
        # One packed device->host copy for the whole drain: choices + tie
        # counter + final aggregates.
        p, n = len(pods), sv.cluster_nodes(dc)
        with devicestats.live_path("oneshot"), \
                device_trace("solve_sequential"), \
                self.guard.watch("oneshot"), \
                stage("solve", pods=p, mode="sequential"):
            packed = self.solver.solve_sequential_packed(
                db, dc, self._counter(), flags, extra_mask=extra_mask,
                score_bias=score_bias, live=live)
        with stage("readback", pods=p):
            with self.guard.watch("oneshot", inject=False):
                host = packed.cpu().numpy()
            devicestats.record_transfer("readback", host.nbytes)
        choices = self.guard.checked_readback(
            "oneshot", host[:p], n, live=live_np, alloc=nt.alloc,
            requests=np.asarray(batch.request),
            keys_fn=lambda: [pd.key for pd in pods[:real_p]])
        rows = choices[:real_p].tolist()
        self.last_node_index = np.uint32(int(host[p]) & _MASK32)
        # Device-aggregate handoff: the scan's final requested/nonzero
        # equal the snapshot plus every in-batch placement, so
        # assume_pods can ingest them instead of re-aggregating — valid
        # only when the batch carries no port/volume state, the cache
        # hasn't moved since the snapshot, and the assumed set is EXACTLY
        # this solve's placements (stamped with their signature).
        if not (flags.any_ports or flags.any_volumes or flags.any_ebs
                or flags.any_gce):
            placed_sig = hash(frozenset(
                (pod.key, rows[i])
                for i, pod in enumerate(pods[:real_p])
                if rows[i] >= 0))
            self._agg_handoff = (
                self._snapshot_generation, placed_sig, nt,
                host[p + 1:p + 1 + 4 * n].reshape(n, 4).astype(np.int32),
                host[p + 1 + 4 * n:].reshape(n, 2).astype(np.int32))
        names = nt.names
        return [names[c] if c >= 0 else None for c in rows]

    def _schedule_batch_joint(self, pods, real_p, batch, db, dc, nt, flags,
                              live, live_np, extra_mask, score_bias
                              ) -> list[str | None]:
        """The joint branch of ``schedule_batch``: one ``solve_joint``,
        then one device->host copy of the choices and the counter."""
        p, n = len(pods), sv.cluster_nodes(dc)
        with devicestats.live_path("joint"), \
                device_trace("solve_joint"), self.guard.watch("joint"), \
                stage("solve", pods=p, mode="joint"):
            choices, counter, _ = self.solver.solve_joint(
                db, dc, self._counter(), flags=flags,
                extra_mask=extra_mask, score_bias=score_bias, live=live)
        with stage("readback", pods=p):
            with self.guard.watch("joint", inject=False):
                host = torch.cat([choices.long(), counter.long()]
                                 ).cpu().numpy()
            devicestats.record_transfer("readback", host.nbytes)
        choices_np = self.guard.checked_readback(
            "joint", host[:p], n, live=live_np, alloc=nt.alloc,
            requests=np.asarray(batch.request),
            keys_fn=lambda: [pd.key for pd in pods[:real_p]])
        self.last_node_index = np.uint32(int(host[p]) & _MASK32)
        names = nt.names
        return [names[c] if c >= 0 else None
                for c in choices_np[:real_p].tolist()]

    def take_agg_handoff(self) -> Optional[tuple]:
        """One-shot: the (generation, signature, node tensors, requested,
        nonzero) handoff from the last schedule_batch, if any (see
        SchedulerCache.assume_pods)."""
        h = self._agg_handoff
        self._agg_handoff = None
        return h

    def schedule_batch_stream(self, pods: list[api.Pod],
                              chunk_size: int = 2048,
                              defer_readback: bool = False) -> Iterator:
        """Pipelined batched drain: one host compile and one batch
        transfer, then the scan runs in equal chunks with device-carried
        state (identical choices to ``schedule_batch`` — each chunk
        continues the previous chunk's aggregates).  Yields ``(chunk_pods,
        chunk_placements)`` as each chunk's results are read back, while
        the device is already scanning the next chunk.

        With ``defer_readback=True`` each yield is ``(chunk_pods,
        resolve)`` instead, where ``resolve()`` performs the blocking
        device->host readback and returns ``(chunk_pods, placements)``.

        The last chunk is padded with inert pods (live=False rows are
        infeasible everywhere and bump no tie counter), so every chunk has
        the same shape."""
        p = len(pods)
        if p == 0:
            return
        if not self.cache.nodes():
            for start in range(0, p, chunk_size):
                chunk = pods[start:start + chunk_size]
                empty = [None] * len(chunk)
                yield (chunk, (lambda c=chunk, e=empty: (c, e))) \
                    if defer_readback else (chunk, empty)
            return
        n_chunks = (p + chunk_size - 1) // chunk_size
        padded = n_chunks * chunk_size
        all_pods = list(pods)
        if padded > p:
            all_pods += [api.Pod(name=f"__pad-{i}", namespace="__pad__")
                         for i in range(padded - p)]
        with self.guard.watch("stream", inject=False):
            batch, db, dc, nt = self._compile(all_pods)
        flags = self._pinned_flags(batch)
        # Spread-constraint planes: the [T, N] term planes once, then each
        # chunk's rows on the device (row-separable; pad rows carry no
        # constraint), so the whole [P, N] planes never exist.
        topo = self._topo_planes(dc)
        counter = self._counter()
        carry = None
        n = sv.cluster_nodes(dc)
        live_np = np.zeros(padded, bool)
        live_np[:p] = True
        live_all = torch.from_numpy(live_np).to(self.device)
        requests = np.asarray(batch.request)
        # The readback of a deferred chunk runs on the commit worker
        # thread: it is ordered on the stream that ran the chunk.
        launch_stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        pending: list[tuple[int, torch.Tensor]] = []

        def emit(start: int, choices: torch.Tensor) -> tuple[list, list]:
            with stage("readback", chunk_at=start):
                with self.guard.watch("stream", inject=False):
                    if launch_stream is not None:
                        with torch.cuda.stream(launch_stream):
                            rows = choices.cpu().numpy()  # blocks
                    else:
                        rows = choices.cpu().numpy()
                devicestats.record_transfer("readback", rows.nbytes)
            stop = min(start + chunk_size, p)
            chunk_pods = pods[start:stop]
            # Post-solve sanity gate: a corrupt chunk readback requeues
            # the chunk (DeviceFault through the commit worker) instead
            # of binding garbage.
            rows = self.guard.checked_readback(
                "stream", rows, n, live=live_np[start:start + chunk_size],
                alloc=nt.alloc,
                requests=requests[start:start + chunk_size],
                keys_fn=lambda: [pd.key for pd in chunk_pods])
            placements = [nt.names[int(c)] if c >= 0 else None
                          for c in rows[: stop - start]]
            return chunk_pods, placements

        for start in range(0, padded, chunk_size):
            # Pod-axis views of the device-resident batch: slicing on the
            # device costs no transfer.
            db_k = sv.slice_pod_axis(db, start, start + chunk_size)
            live = live_all[start:start + chunk_size]
            # The launch is async: device time surfaces in the chunk's
            # readback, which is what keeps the pipeline overlapped.
            with devicestats.live_path("stream"), \
                    device_trace("solve_stream_chunk"), \
                    self.guard.watch("stream"), \
                    stage("solve", chunk_at=start, mode="stream"):
                em_k = sb_k = None
                if topo is not None:
                    em_k, sb_k = topo.rows(start, start + chunk_size)
                choices_k, counter, carry = self.solver._solve_scan(
                    db_k, dc, counter, sb_k, flags, carry, live, em_k)
            pending.append((start, choices_k))
            if len(pending) > 1:
                s_k, c_k = pending.pop(0)
                yield (pods[s_k:min(s_k + chunk_size, p)],
                       functools.partial(emit, s_k, c_k)) \
                    if defer_readback else emit(s_k, c_k)
        for start, choices_k in pending:
            yield (pods[start:min(start + chunk_size, p)],
                   functools.partial(emit, start, choices_k)) \
                if defer_readback else emit(start, choices_k)
        self.last_node_index = np.uint32(int(counter[0]) & _MASK32)

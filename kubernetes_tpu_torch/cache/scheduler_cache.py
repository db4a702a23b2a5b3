"""Tensor-backed scheduler cache.

The reference's ``schedulerCache`` (plugin/pkg/scheduler/schedulercache/
cache.go) keeps authoritative in-memory cluster state including *assumed*
(optimistically bound, not yet confirmed) pods, with a TTL state machine:

    AssumePod (cache.go:107) -> [confirm] AddPod (:160) -> UpdatePod -> RemovePod
            \\-> ForgetPod (:135)        \\-> expire after TTL (:309-330)

This class keeps the same state machine host-side, but the per-node
aggregates live as the dense arrays the device kernels consume
(``NodeAggregates``/``ExistingPodTensors``) and are updated incrementally —
the tensor analogue of NodeInfo.addPod/removePod plus the generation-counter
snapshotting of UpdateNodeNameToInfoMap (cache.go:77-91).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.features import compiler as fc
from kubernetes_tpu_torch.utils import locktrace

if TYPE_CHECKING:  # torch-free at import: the cache stays host-only
    from kubernetes_tpu_torch.engine.workloads.preemption import VictimTable


def _locked(fn):
    """Serialize public cache methods on self.lock (cache.go mutex)."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)
    return wrapper


DEFAULT_ASSUMED_POD_TTL = 30.0  # factory.go:102
CLEANUP_PERIOD = 1.0            # cache.go:31


@dataclass
class _PodState:
    pod: api.Pod
    assumed: bool
    deadline: Optional[float]  # expiry for assumed pods


class SchedulerCache:
    """Cache interface parity (schedulercache/interface.go:38-93)."""

    def __init__(self, space: Optional[fc.FeatureSpace] = None,
                 ttl: float = DEFAULT_ASSUMED_POD_TTL,
                 now: Callable[[], float] = time.monotonic):
        self.space = space or fc.FeatureSpace()
        self.ttl = ttl
        self._now = now
        # schedulerCache.mu (cache.go:60): the daemon's async bind threads
        # forget failed binds while the scheduling loop assumes new batches.
        # The drain holds this lock across the whole batch
        # snapshot/compile by design (the snapshot must be consistent
        # against concurrent assumes), so its hold time is the compile
        # stage span, not a long-hold bug; order tracking stays on.
        self.lock = locktrace.make_rlock("cache.SchedulerCache",
                                         hold_ms=0)
        self._nodes: dict[str, api.Node] = {}
        self._node_order: list[str] = []
        self._pod_states: dict[str, _PodState] = {}
        self._node_pods: dict[str, dict[str, api.Pod]] = {}
        # PodsWithAffinity analogue (node_info.go podsWithAffinity): attached
        # pods carrying any affinity annotation, for the sig compiler.
        self._affinity_pods: dict[str, api.Pod] = {}
        # Attached pods with volumes, for the MaxPD volume-count compiler
        # (resolved against PV/PVC listers at batch compile time, matching
        # the reference's per-evaluation resolution, predicates.go:260-266).
        self._volume_pods: dict[str, api.Pod] = {}
        self._nt: Optional[fc.NodeTensors] = None
        self._agg: Optional[fc.NodeAggregates] = None
        self._ep: Optional[fc.ExistingPodTensors] = None
        self._dirty_nodes = True
        self.generation = 0
        # Device-residency protocol: ``tensor_epoch`` bumps whenever row
        # identity changes (full rebuild, node append — the [N, ...]
        # shapes or the row->node mapping moved), telling the device
        # mirror (engine/solver.ResidentCluster) to re-upload everything.
        # ``_dirty_rows`` collects the row indices whose CONTENT changed
        # in place (node updates, pod attach/detach aggregates) since the
        # mirror last synced; the engine consumes it under self.lock via
        # take_dirty_rows().  One device mirror per cache, by design —
        # the same 1:1 engine/cache pairing _compile already assumes.
        self.tensor_epoch = 0
        self._dirty_rows: set[int] = set()
        # Churn observability: full rebuilds vs incremental row updates.
        self.stats = {"rebuilds": 0, "rebuild_s": 0.0,
                      "incremental_node_updates": 0}

    # ---- node lifecycle (cache.go:263-307) ----------------------------

    @_locked
    def add_node(self, node: api.Node) -> None:
        known = node.name in self._nodes
        self._nodes[node.name] = node
        if node.name not in self._node_pods:
            self._node_pods[node.name] = {}
        if self._dirty_nodes or self._nt is None:
            self._mark_nodes_dirty()
        elif known:
            # Duplicate ADDED (relist Replace): treat as update in place.
            idx = self._nt.name_to_idx[node.name]
            fc.update_node_row(self._nt, idx, node, self.space)
            self._dirty_rows.add(idx)
            self.stats["incremental_node_updates"] += 1
            self.generation += 1
        else:
            # Incremental append: one new row across the node tensors +
            # zero aggregates; no 5k-row recompile per joining node.
            # Capacity growth: the device mirror re-uploads (epoch bump).
            fc.append_node_row(self._nt, node, self.space)
            fc.append_aggregate_row(self._agg)
            self._node_order.append(node.name)
            self.tensor_epoch += 1
            self.stats["incremental_node_updates"] += 1
            self.generation += 1

    @_locked
    def update_node(self, node: api.Node) -> None:
        self._nodes[node.name] = node
        if node.name not in self._node_pods:
            self._node_pods[node.name] = {}
        idx = None if (self._dirty_nodes or self._nt is None) else \
            self._nt.name_to_idx.get(node.name)
        if idx is None:
            self._mark_nodes_dirty()
        else:
            # Incremental UPDATE (Ready flip, capacity change): rewrite the
            # one row — the node controller's churn must not cost a full
            # rebuild (nodecontroller.go:70-160 at 5k nodes).  In-place
            # writes are safe against concurrent solves because every
            # reader (GenericScheduler._compile) holds self.lock across
            # snapshot + feature compile + the device transfer; after the
            # transfer the solver reads device copies, not these arrays.
            fc.update_node_row(self._nt, idx, node, self.space)
            self._dirty_rows.add(idx)
            self.stats["incremental_node_updates"] += 1
            self.generation += 1

    @_locked
    def remove_node(self, name: str) -> None:
        self._nodes.pop(name, None)
        # Pods on the node stay tracked (the reference keeps them until their
        # own delete events arrive); their rows rebuild against the new order.
        # Removal reshapes every [N, ...] tensor: full rebuild (bulk path).
        self._mark_nodes_dirty()

    def _mark_nodes_dirty(self) -> None:
        self._dirty_nodes = True
        self.generation += 1

    # ---- pod state machine --------------------------------------------

    @_locked
    def assume_pod(self, pod: api.Pod, node_name: str) -> None:
        """AssumePod (cache.go:107-133): optimistic placement with TTL."""
        key = pod.key
        if key in self._pod_states:
            raise ValueError(f"pod {key} already in cache")
        pod.node_name = node_name
        self._pod_states[key] = _PodState(
            pod=pod, assumed=True, deadline=self._now() + self.ttl)
        self._attach(pod, node_name)

    @_locked
    def assume_pods(self, assignments: list[tuple[api.Pod, str]],
                    strict: bool = True,
                    agg_handoff: Optional[tuple] = None) -> list[str]:
        """Bulk AssumePod for a solved batch: same state machine as
        assume_pod, with the tensor updates vectorized (the per-pod path is
        O(pods x numpy-call overhead) at 30k-pod batches).

        With ``strict=False`` already-cached pods are skipped and their keys
        returned (the daemon logs and proceeds, scheduler.go:116-120).

        ``agg_handoff``: optional (generation, placement_signature,
        node_tensors, requested, nonzero) from the device solve
        (GenericScheduler.take_agg_handoff).  When the generation still
        matches, every assignment attached cleanly, AND the assignments
        hash to the stamped placement signature, the device-final
        aggregates are ingested directly instead of re-aggregating the
        rows host-side."""
        self._ensure_tensors()
        gen_at_entry = self.generation
        deadline = self._now() + self.ttl
        pods, idxs = [], []
        skipped: list[str] = []
        for pod, node_name in assignments:
            key = pod.key
            if key in self._pod_states:
                if strict:
                    raise ValueError(f"pod {key} already in cache")
                skipped.append(key)
                continue
            pod.node_name = node_name
            self._pod_states[key] = _PodState(pod=pod, assumed=True,
                                              deadline=deadline)
            self._node_pods.setdefault(node_name, {})[key] = pod
            if pod.affinity() is not None:
                self._affinity_pods[key] = pod
            if pod.volumes:
                self._volume_pods[key] = pod
            idx = self._nt.name_to_idx.get(node_name)
            if idx is None:
                self._mark_nodes_dirty()
            else:
                pods.append(pod)
                idxs.append(idx)
        if not self._dirty_nodes and pods:
            import numpy as np
            use_handoff = (agg_handoff is not None
                           and agg_handoff[0] == gen_at_entry
                           and not skipped
                           and len(pods) == len(assignments))
            if use_handoff:
                # The handoff is stamped with the solve's placement
                # signature: ingest only if this assume is EXACTLY that
                # set (a different set at an unchanged generation would
                # corrupt requested/nonzero).
                name_to_idx = agg_handoff[2].name_to_idx
                sig = hash(frozenset(
                    (pod.key, name_to_idx.get(node, -1))
                    for pod, node in assignments))
                use_handoff = sig == agg_handoff[1]
            if use_handoff:
                # copy(): jax->numpy views are read-only, later incremental
                # updates write in place.
                self._agg.requested = np.asarray(agg_handoff[3]).copy()
                self._agg.nonzero = np.asarray(agg_handoff[4]).copy()
            else:
                self._agg = fc.add_pods_to_aggregates_bulk(
                    self._agg, idxs, pods, self.space)
            self._ep = fc.existing_pods_add_bulk(
                self._ep, pods, idxs, self.space)
            self._dirty_rows.update(idxs)
        self.generation += len(assignments)
        return skipped

    @_locked
    def forget_pod(self, pod: api.Pod) -> None:
        """ForgetPod (cache.go:135-158): only assumed pods may be forgotten."""
        key = pod.key
        st = self._pod_states.get(key)
        if st is None or not st.assumed:
            raise ValueError(f"pod {key} not assumed")
        self._detach(st.pod)
        del self._pod_states[key]

    @_locked
    def forget_pods_matching(self, pred: Callable[[api.Pod], bool]
                             ) -> list[str]:
        """Forget every ASSUMED pod whose object matches ``pred`` — the
        shard-handoff release (scheduler/shards.py): an incarnation that
        lost a shard's lease drops its optimistic assumes there in one
        locked pass, so the shard's new owner can re-solve those pods
        without racing phantom capacity.  Confirmed (bound) pods are
        untouched — they are apiserver truth, not our speculation, and
        every incarnation's cache must keep charging their capacity.
        Returns the forgotten keys."""
        victims = [key for key, st in self._pod_states.items()
                   if st.assumed and pred(st.pod)]
        for key in victims:
            self._detach(self._pod_states[key].pod)
            del self._pod_states[key]
        return victims

    @_locked
    def add_pod(self, pod: api.Pod) -> None:
        """AddPod (cache.go:160-186): confirm an assumed pod (clearing its
        TTL) or ingest an already-bound pod seen via watch."""
        key = pod.key
        st = self._pod_states.get(key)
        if st is not None:
            # Confirm an assumed pod (possibly bound to a different node than
            # assumed) or refresh a duplicate add: replace the old attachment.
            self._detach(st.pod)
        self._attach(pod, pod.node_name)
        self._pod_states[key] = _PodState(pod=pod, assumed=False, deadline=None)

    @_locked
    def confirm_assumed(self, key: str, node_name: str) -> bool:
        """Fast-path bind confirmation: an assumed pod whose watch event
        agrees with the assumed node just flips to confirmed (TTL
        cleared) — the attachment and aggregates are already correct, so
        the full detach/attach of add_pod (and the pod JSON parse feeding
        it) is skipped.  Returns False when the caller must fall back to
        the full path (unknown pod, not assumed, or a different node)."""
        st = self._pod_states.get(key)
        if st is None or not st.assumed or st.pod.node_name != node_name:
            return False
        self._pod_states[key] = _PodState(pod=st.pod, assumed=False,
                                          deadline=None)
        return True

    @_locked
    def update_pod(self, old: api.Pod, new: api.Pod) -> None:
        """UpdatePod (cache.go:188-206)."""
        st = self._pod_states.get(old.key)
        if st is not None:
            self._detach(st.pod)
        self._attach(new, new.node_name)
        self._pod_states[new.key] = _PodState(pod=new, assumed=False, deadline=None)

    @_locked
    def remove_pod(self, pod: api.Pod) -> None:
        """RemovePod (cache.go:208-230)."""
        st = self._pod_states.pop(pod.key, None)
        if st is not None:
            self._detach(st.pod)

    @_locked
    def cleanup_expired(self, now: Optional[float] = None) -> list[str]:
        """cleanupAssumedPods (cache.go:309-330): expire stale assumed pods."""
        now = self._now() if now is None else now
        expired = [k for k, st in self._pod_states.items()
                   if st.assumed and st.deadline is not None and st.deadline <= now]
        for k in expired:
            self._detach(self._pod_states[k].pod)
            del self._pod_states[k]
        return expired

    @_locked
    def assumed_age(self, key: str) -> Optional[float]:
        """Seconds since ``key`` was assumed (None when not tracked or
        not assumed) — derived from the TTL deadline stamped at assume
        time.  The shard ownership sweep uses this to tell a LIVE
        in-flight bind (young assume: leave it alone) from a leaked one
        (old assume whose bind result was lost: forget + requeue)."""
        st = self._pod_states.get(key)
        if st is None or not st.assumed or st.deadline is None:
            return None
        return self.ttl - (st.deadline - self._now())

    @_locked
    def is_assumed(self, key: str) -> bool:
        st = self._pod_states.get(key)
        return st is not None and st.assumed

    @_locked
    def contains(self, key: str) -> bool:
        """Pod is tracked at all (assumed OR confirmed)."""
        return key in self._pod_states

    @_locked
    def pod_count(self) -> int:
        return len(self._pod_states)

    @_locked
    def nodes(self) -> list[api.Node]:
        self._ensure_tensors()
        return [self._nodes[n] for n in self._node_order]

    @_locked
    def node_pods(self, node_name: str) -> list[api.Pod]:
        return list(self._node_pods.get(node_name, {}).values())

    @_locked
    def service_peer_nodes(self, namespace: str,
                           selector: dict[str, str]) -> list[str]:
        """Node names hosting assigned pods matching a service selector in
        a namespace (podLister.List(selector) + namespace filter, the
        ServiceAffinity/ServiceAntiAffinity peer lookup,
        predicates.go:678-690)."""
        if not selector:
            return []
        out = []
        for st in self._pod_states.values():
            pod = st.pod
            if pod.node_name and pod.namespace == namespace and \
                    all(pod.labels.get(k) == v for k, v in selector.items()):
                out.append(pod.node_name)
        return out

    def first_peer_node(self, namespace: str,
                        selector: dict[str, str]) -> Optional[str]:
        peers = self.service_peer_nodes(namespace, selector)
        return peers[0] if peers else None

    @_locked
    def volume_pods(self) -> list[tuple[api.Pod, int]]:
        """(pod, node index) for attached pods with volumes (incl. assumed)."""
        self._ensure_tensors()
        return [(p, self._nt.name_to_idx.get(p.node_name, -1))
                for p in self._volume_pods.values()]

    @_locked
    def affinity_pods(self) -> list[tuple[api.Pod, int]]:
        """(pod, node index) for every attached pod with affinity annotations
        (incl. assumed pods — matching the reference's assumed-pod
        visibility).  Node index -1 if the pod's node is unknown."""
        self._ensure_tensors()
        return [(p, self._nt.name_to_idx.get(p.node_name, -1))
                for p in self._affinity_pods.values()]

    # ---- tensor maintenance -------------------------------------------

    def _attach(self, pod: api.Pod, node_name: str) -> None:
        if not node_name:
            return
        self._node_pods.setdefault(node_name, {})[pod.key] = pod
        if pod.affinity() is not None:
            self._affinity_pods[pod.key] = pod
        if pod.volumes:
            self._volume_pods[pod.key] = pod
        if not self._dirty_nodes and self._nt is not None:
            idx = self._nt.name_to_idx.get(node_name)
            if idx is None:
                # Pod bound to a node we haven't seen; full rebuild on demand.
                self._mark_nodes_dirty()
                return
            self._agg = fc.add_pod_to_aggregates(self._agg, idx, pod, self.space)
            self._ep = fc.existing_pods_add(self._ep, pod, idx, self.space)
            self._dirty_rows.add(idx)
        self.generation += 1

    def _detach(self, pod: api.Pod) -> None:
        node_name = pod.node_name
        if not node_name:
            return
        pods = self._node_pods.get(node_name, {})
        pods.pop(pod.key, None)
        self._affinity_pods.pop(pod.key, None)
        self._volume_pods.pop(pod.key, None)
        if not self._dirty_nodes and self._nt is not None:
            idx = self._nt.name_to_idx.get(node_name)
            if idx is not None:
                self._agg = fc.remove_pod_from_aggregates(
                    self._agg, idx, pod, self.space, list(pods.values()))
                self._ep = fc.existing_pods_remove(self._ep, pod.key)
                self._dirty_rows.add(idx)
        self.generation += 1

    def _ensure_tensors(self) -> None:
        if not self._dirty_nodes and self._nt is not None:
            return
        t0 = time.perf_counter()
        self._node_order = list(self._nodes.keys())
        self._nt = fc.compile_nodes(
            [self._nodes[n] for n in self._node_order], self.space)
        self._agg = fc.empty_aggregates(len(self._node_order), self.space)
        self._ep = fc.empty_existing_pods(self.space)
        # Re-attach every tracked pod through the BULK paths: the per-pod
        # loop is O(pods x numpy-call overhead) — tens of seconds at 30k
        # attached pods, per node event, before this.
        idxs: list[int] = []
        pods: list[api.Pod] = []
        for name, podmap in self._node_pods.items():
            idx = self._nt.name_to_idx.get(name)
            if idx is None:
                continue
            for pod in podmap.values():
                idxs.append(idx)
                pods.append(pod)
        if pods:
            self._agg = fc.add_pods_to_aggregates_bulk(
                self._agg, idxs, pods, self.space)
            self._ep = fc.existing_pods_add_bulk(
                self._ep, pods, idxs, self.space)
        self._dirty_nodes = False
        # Relist/rebuild: row identity moved — the device mirror must
        # re-upload; any pending per-row deltas are subsumed.
        self.tensor_epoch += 1
        self._dirty_rows.clear()
        self.stats["rebuilds"] += 1
        self.stats["rebuild_s"] += time.perf_counter() - t0

    # ---- workload-constraint bookkeeping (engine/workloads/) ----------

    @_locked
    def get_pod(self, key: str) -> Optional[api.Pod]:
        """The tracked pod object (assumed or confirmed), or None."""
        st = self._pod_states.get(key)
        return st.pod if st is not None else None

    @_locked
    def ensure_topo_key(self, key: str) -> None:
        """Intern a topology label key (topologySpreadConstraints name
        arbitrary node labels, not just the default failure domains).  A
        NEW key means the node tensors lack its topo_val column contents:
        full rebuild on next snapshot (rare — once per workload type)."""
        if self.space.topo_keys.get(key) < 0:
            self.space.topo_keys.id(key)
            self._mark_nodes_dirty()

    @_locked
    def topo_domain_counts_bulk(self, specs: list) -> list[dict[int, int]]:
        """Matching tracked-pod count per topology domain id, for EVERY
        term of a batch in ONE pod walk — the domain bookkeeping behind
        the spread planes (workloads/topology.compile_terms).  ``specs``
        is [(namespace, api.LabelSelector, key_col)]; assumed pods count
        (the reference's assumed-pod visibility).  One walk for all
        terms matters because this runs under the cache lock inside the
        drain's compile stage — per-term walks would be O(terms x pods)
        of interpreter time blocking every reflector handler."""
        self._ensure_tensors()
        out: list[dict[int, int]] = [{} for _ in specs]
        if not specs:
            return out
        for st in self._pod_states.values():
            pod = st.pod
            if not pod.node_name:
                continue
            idx = self._nt.name_to_idx.get(pod.node_name)
            if idx is None:
                continue
            for i, (ns, selector, key_col) in enumerate(specs):
                if pod.namespace != ns or \
                        not selector.matches(pod.labels):
                    continue
                dom = int(self._nt.topo_val[idx, key_col])
                if dom >= 0:
                    out[i][dom] = out[i].get(dom, 0) + 1
        return out

    def topo_domain_counts(self, namespace: str, selector: object,
                           key_col: int) -> dict[int, int]:
        """Single-term convenience over the bulk walk."""
        return self.topo_domain_counts_bulk(
            [(namespace, selector, key_col)])[0]

    @_locked
    def victim_table(self, max_victims: int,
                     exclude: frozenset = frozenset()) -> "VictimTable":
        """Per-node victim candidates for the preemption solve: every
        tracked pod (assumed or confirmed — both hold capacity), sorted
        ascending by (priority, key) so the solve's prefix-k IS the k
        cheapest victims, padded to a pow2 victim axis.  At most
        ``max_victims`` candidates per node are FILLED (the pow2 padding
        is rows, not extra victims).  ``exclude``: pod keys never
        eligible (the daemon protects the current drain's own
        placements).  Returns a workloads.preemption.VictimTable."""
        import numpy as np

        from kubernetes_tpu_torch.engine.workloads.preemption import \
            VictimTable
        self._ensure_tensors()
        n = len(self._node_order)
        v = 1 << max(max_victims - 1, 0).bit_length()
        req = np.zeros((n, v, 4), np.int32)
        prio = np.zeros((n, v), np.int32)
        valid = np.zeros((n, v), bool)
        keys: list[list[str]] = [[] for _ in range(n)]
        for name, podmap in self._node_pods.items():
            idx = self._nt.name_to_idx.get(name)
            if idx is None or not podmap:
                continue
            cands = sorted(
                (p for p in podmap.values() if p.key not in exclude),
                key=lambda p: (p.effective_priority, p.key))
            for j, pod in enumerate(cands[:max_victims]):
                # The canonical (cpu, mem_mib ceil, gpu, 1) row, the same
                # encoding the tensor solve uses.
                req[idx, j] = fc.pod_resource_row(pod)
                prio[idx, j] = pod.effective_priority
                valid[idx, j] = True
                keys[idx].append(pod.key)
        return VictimTable(req=req, prio=prio, valid=valid, keys=keys)

    # ---- churn & recovery hooks (recovery.py, verifier.py) -------------

    @_locked
    def force_resnapshot(self) -> None:
        """Self-heal / restart re-seed: invalidate the incremental state
        so the next snapshot rebuilds every tensor from the tracked
        objects and bumps ``tensor_epoch`` (the device mirror re-uploads
        everything).  The verifier calls this on any invariant mismatch —
        one full rebuild instead of a wrong placement."""
        self._mark_nodes_dirty()

    @_locked
    def tracked_pods(self) -> list[tuple[str, str, bool]]:
        """(key, node_name, assumed) for every tracked pod — the restart
        reconciler's and invariant checker's consistent view of what the
        cache believes, taken under one lock acquisition."""
        return [(key, st.pod.node_name or "", st.assumed)
                for key, st in self._pod_states.items()]

    @_locked
    def recompute_aggregates(self) -> tuple:
        """Rebuild (requested, nonzero) from scratch out of the tracked
        pod set — the ground truth the incremental assume/forget deltas
        must equal.  Returns (requested, nonzero) numpy arrays aligned
        with the current row order, WITHOUT touching cache state; the
        verifier diffs them against the live ``_agg`` rows."""
        self._ensure_tensors()
        agg = fc.empty_aggregates(len(self._node_order), self.space)
        idxs: list[int] = []
        pods: list[api.Pod] = []
        for name, podmap in self._node_pods.items():
            idx = self._nt.name_to_idx.get(name)
            if idx is None:
                continue
            for pod in podmap.values():
                idxs.append(idx)
                pods.append(pod)
        if pods:
            agg = fc.add_pods_to_aggregates_bulk(agg, idxs, pods,
                                                 self.space)
        return agg.requested, agg.nonzero

    @_locked
    def take_dirty_rows(self) -> set[int]:
        """Row indices mutated in place since the last take, cleared on
        read — the device mirror's incremental-update feed.  Call in the
        same locked section as ``snapshot()`` (the engine's _compile
        holds ``self.lock`` across both) so the row set and the row
        contents are one consistent generation."""
        dirty = self._dirty_rows
        self._dirty_rows = set()
        return dirty

    @_locked
    def snapshot(self) -> tuple[fc.NodeTensors, fc.NodeAggregates,
                                fc.ExistingPodTensors, list[api.Node]]:
        """Current tensor view (UpdateNodeNameToInfoMap analogue).  The
        returned aggregates are referenced, not copied — callers must not
        mutate them."""
        self._ensure_tensors()
        # Existing-pod label matrix may lag vocab growth from newly seen pods.
        self._ep.labels = fc._grow_cols(self._ep.labels, self.space.pod_labels.capacity)
        return self._nt, self._agg, self._ep, \
            [self._nodes[n] for n in self._node_order]

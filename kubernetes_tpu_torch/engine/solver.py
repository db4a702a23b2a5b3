"""The device solver: policy -> mask/score/assign computation in PyTorch.

Counterpart of ``kubernetes_tpu/engine/solver.py`` for the main path, the
streamed sequential-greedy drain:

``_solve_scan``
    Greedy in-order placement: pods are placed in queue order and every
    placement updates device-resident aggregates (requested resources,
    host ports, volume mounts, spreading counts) before the next pod is
    scored — the visibility the reference's scheduler gets through its
    assumed-pod cache (scheduler.go:116-120, cache.go:107).  The
    placement-invariant [P, N] mask and score planes are hoisted out of
    the step loop; each step does O(N) work on one row.

On the card every chunk runs as ONE launch of the scan kernel
(``engine/scan.py``, ``csrc/scan.cu``): the ``mixed`` families
(resources, the resource priorities, spread with or without zones) and
the ``rich`` ones (host ports, volumes, the disk counts, inter-pod
affinity, service anti-affinity).  Every chunk on the CPU runs the step
loop: a Python loop over torch ops with all state on the device, which
is also the kernel's plain version.  No step reads a device value on
the host (no ``.item()``, ``int()`` or ``bool()`` of a device tensor),
so a chunk of steps is enqueued without a host round trip and read back
once.  On CUDA tensors (``route="steps"``) the step loop's select is the
CUDA kernel of ``engine/fused.py``.

``evaluate`` / ``masks``
    The one-shot [P, N] feasibility and weighted-score planes (and the
    per-predicate masks behind them) of the single-pod path, the
    extender verbs and ``explain_failures``.

``solve_joint``
    The joint batched assignment: ``_price_iterate`` (24 dual-price
    steps and the regret-ordered repair key, torch ops), then the
    repair scan, which is ``_solve_scan`` over the permuted batch with
    the price cost as its f32 score bias.

Not in this package yet: the legacy full-plane scan body and the narrow
int16 wire planes.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.policy import (DEFAULT_MAX_EBS_VOLUMES,
                                             DEFAULT_MAX_GCE_PD_VOLUMES,
                                             Policy,
                                             canonical_predicate_name,
                                             canonical_priority_name,
                                             expand_predicates)
from kubernetes_tpu_torch.engine import devicestats
from kubernetes_tpu_torch.engine import fused as fused_mod
from kubernetes_tpu_torch.engine import scan as scan_mod
from kubernetes_tpu_torch.features.batch import PodBatch
from kubernetes_tpu_torch.features.compiler import (FeatureSpace,
                                                    NodeAggregates,
                                                    NodeTensors, RES_PODS)
from kubernetes_tpu_torch.ops import (interpod, predicates as pr,
                                      priorities as prio)
from kubernetes_tpu_torch.utils import device as device_mod
from kubernetes_tpu_torch.utils import knobs

PASSTHROUGH_PREDICATES = ()

# Priorities whose planes read in-batch placement state.
DYNAMIC_PRIORITIES = ("LeastRequestedPriority", "MostRequestedPriority",
                      "BalancedResourceAllocation", "SelectorSpreadPriority",
                      "ServiceSpreadingPriority", "InterPodAffinityPriority",
                      "ServiceAntiAffinityPriority")

# Cap on distinct nonzero-request templates factored out of the scan.
DYN_TEMPLATE_CAP = knobs.get_int("KT_DYN_TEMPLATES")

_MASK32 = 0xFFFFFFFF


class DeviceAffinity(NamedTuple):
    """AffinityTensors' array fields as tensors (features/affinity.py
    documents each)."""

    node_dom: torch.Tensor
    match_key: torch.Tensor
    match_cnt: torch.Tensor
    match_total: torch.Tensor
    match_src: torch.Tensor
    aff_need: torch.Tensor
    aff_self: torch.Tensor
    anti_need: torch.Tensor
    pref_w: torch.Tensor
    decl_key: torch.Tensor
    decl_reach: torch.Tensor
    decl_match: torch.Tensor
    decl_src: torch.Tensor
    sym_key: torch.Tensor
    sym_w: torch.Tensor
    sym_cnt: torch.Tensor
    sym_match: torch.Tensor
    sym_src: torch.Tensor


class DeviceVolSvc(NamedTuple):
    """VolSvcTensors as tensors (features/volumes.py documents each)."""

    pd_pod_ebs: torch.Tensor
    pd_node_ebs: torch.Tensor
    pd_extra_ebs: torch.Tensor
    pd_node_extra_ebs: torch.Tensor
    pd_node_err_ebs: torch.Tensor
    pd_pod_gce: torch.Tensor
    pd_node_gce: torch.Tensor
    pd_extra_gce: torch.Tensor
    pd_node_extra_gce: torch.Tensor
    pd_node_err_gce: torch.Tensor
    vz_group: torch.Tensor
    vz_mask: torch.Tensor
    sa_group: torch.Tensor
    sa_mask: torch.Tensor
    saa_group: torch.Tensor
    saa_src: torch.Tensor
    saa_dom: torch.Tensor
    saa_labeled: torch.Tensor
    saa_cnt: torch.Tensor
    saa_num: torch.Tensor
    nl_pred_row: torch.Tensor
    nl_prio_rows: torch.Tensor


class DeviceBatch(NamedTuple):
    """PodBatch as tensors (order mirrors features.batch.PodBatch)."""

    request: torch.Tensor
    zero_request: torch.Tensor
    nonzero: torch.Tensor
    best_effort: torch.Tensor
    host_idx: torch.Tensor
    ports: torch.Tensor
    vol_ro: torch.Tensor
    vol_rw: torch.Tensor
    tol_nosched: torch.Tensor
    tol_prefer: torch.Tensor
    has_tolerations: torch.Tensor
    images: torch.Tensor
    sel_group: torch.Tensor
    sel_required: torch.Tensor
    sel_pref_counts: torch.Tensor
    spread_group: torch.Tensor
    spread_node_counts: torch.Tensor
    spread_zone_counts: torch.Tensor
    spread_has_zones: torch.Tensor
    spread_incr: torch.Tensor
    node_zone_id: torch.Tensor
    avoid_group: torch.Tensor
    avoid_rows: torch.Tensor
    nz_tmpl_idx: torch.Tensor
    nz_templates: torch.Tensor
    aff: DeviceAffinity
    volsvc: DeviceVolSvc


class BatchFlags(NamedTuple):
    """Content-derived specialization for the sequential scan: dynamic
    state families the batch provably cannot touch are left out of the
    step loop (a no-port batch keeps ``ports_used`` constant and
    conflict-free, so neither the check nor the update belongs there)."""

    any_ports: bool
    any_volumes: bool
    any_ebs: bool
    any_gce: bool
    any_affinity_pred: bool   # aff_need/anti_need/decl_match content
    any_affinity_prio: bool   # pref_w/sym content
    any_spread: bool          # spread_incr content (placements move counts)
    any_spread_zones: bool    # some spread group blends zone counts
    any_saa: bool             # saa_src content (placements move peer counts)


def batch_flags(b: "PodBatch | DeviceBatch") -> BatchFlags:
    """Derive BatchFlags from a PodBatch or a host (numpy) DeviceBatch —
    call before the device transfer."""
    a, vs = b.aff, b.volsvc
    return BatchFlags(
        any_ports=bool(np.asarray(b.ports).any()),
        any_volumes=bool(np.asarray(b.vol_ro).any()
                         or np.asarray(b.vol_rw).any()),
        any_ebs=bool(np.asarray(vs.pd_pod_ebs).any()
                     or np.asarray(vs.pd_extra_ebs).any()),
        any_gce=bool(np.asarray(vs.pd_pod_gce).any()
                     or np.asarray(vs.pd_extra_gce).any()),
        any_affinity_pred=bool(np.asarray(a.aff_need).any()
                               or np.asarray(a.anti_need).any()
                               or np.asarray(a.decl_match).any()),
        any_affinity_prio=bool(np.asarray(a.pref_w).any()
                               or (np.asarray(a.sym_match).any()
                                   and np.asarray(a.sym_w).any())),
        # Force-on, as in the JAX package: the spread counts stay carried
        # (numerically a no-op when spread_incr is all-false), so both
        # packages run the same families on the same batch.
        any_spread=True,
        any_spread_zones=bool(np.asarray(b.spread_has_zones).any()
                              or np.asarray(b.spread_zone_counts).any()),
        any_saa=bool(np.asarray(vs.saa_src).any()))


ALL_ON_FLAGS = BatchFlags(*([True] * 9))


class DeviceCluster(NamedTuple):
    schedulable: torch.Tensor    # [N] bool — getNodeConditionPredicate
    alloc: torch.Tensor          # [N,4] int32
    requested: torch.Tensor      # [N,4] int32
    nonzero: torch.Tensor        # [N,2] int32
    ports_used: torch.Tensor     # [N,C] bool
    vol_any: torch.Tensor        # [N,W] bool
    vol_rw: torch.Tensor         # [N,W] bool
    taints_nosched: torch.Tensor  # [N,T] bool
    taints_prefer: torch.Tensor  # [N,T] bool
    has_taints: torch.Tensor     # [N] bool — any taint incl. PreferNoSchedule
    mem_pressure: torch.Tensor   # [N] bool
    disk_pressure: torch.Tensor  # [N] bool
    image_kib: torch.Tensor      # [N,I] int32
    topo_dom: torch.Tensor       # [N,K] int32 — domain id per topology key


def cluster_nodes(c: DeviceCluster) -> int:
    return int(c.schedulable.shape[0])


def _pad_cols(a: np.ndarray, width: int, fill=0) -> np.ndarray:
    if a.shape[1] == width:
        return a
    out = np.full((a.shape[0], width), fill, a.dtype)
    out[:, : a.shape[1]] = a
    return out


def to_device(tree, device: "torch.device | str"):
    """A NamedTuple of numpy arrays (nested NamedTuples allowed) as the
    same NamedTuple of tensors on ``device``.  Always copies: the host
    arrays belong to the scheduler cache, which mutates them in place."""
    if hasattr(tree, "_fields"):
        return type(tree)(*[to_device(v, device) for v in tree])
    arr = np.ascontiguousarray(np.asarray(tree))
    return torch.from_numpy(arr).to(device, copy=True)


def host_batch(b: PodBatch) -> DeviceBatch:
    """The DeviceBatch still holding the host numpy arrays."""
    parts = [getattr(b, f) for f in DeviceBatch._fields
             if f not in ("aff", "volsvc")]
    aff = DeviceAffinity(*[getattr(b.aff, f)
                           for f in DeviceAffinity._fields])
    volsvc = DeviceVolSvc(*[getattr(b.volsvc, f)
                            for f in DeviceVolSvc._fields])
    return DeviceBatch(*parts, aff=aff, volsvc=volsvc)


def device_batch(b: PodBatch, device: "torch.device | str") -> DeviceBatch:
    return to_device(host_batch(b), device)


def _host_cluster(nt: NodeTensors, agg: NodeAggregates,
                  space: FeatureSpace) -> DeviceCluster:
    """The DeviceCluster as host numpy, aggregate columns padded to the
    current vocabulary capacities (pods may have interned new ports or
    volumes).  The full upload and the dirty-row gather share this
    field encoding."""
    return DeviceCluster(
        schedulable=nt.schedulable,
        alloc=nt.alloc,
        requested=agg.requested,
        nonzero=agg.nonzero,
        ports_used=_pad_cols(agg.ports_used, space.ports.capacity),
        vol_any=_pad_cols(agg.vol_any, space.volumes.capacity),
        vol_rw=_pad_cols(agg.vol_rw, space.volumes.capacity),
        taints_nosched=nt.taints_nosched,
        taints_prefer=nt.taints_prefer,
        has_taints=nt.taints_nosched.any(1) | nt.taints_prefer.any(1),
        mem_pressure=nt.mem_pressure,
        disk_pressure=nt.disk_pressure,
        image_kib=_pad_cols(nt.image_kib, space.images.capacity),
        topo_dom=_pad_cols(nt.topo_val, space.topo_keys.capacity, fill=-1))


def device_cluster(nt: NodeTensors, agg: NodeAggregates,
                   space: FeatureSpace,
                   device: "torch.device | str") -> DeviceCluster:
    return to_device(_host_cluster(nt, agg, space), device)


class ResidentCluster:
    """Device-resident mirror of the cache's node tensors.

    One DeviceCluster stays on the device across drains; per drain only
    the cache's dirty rows (assume/bind aggregate deltas, heartbeat Ready
    flips) are copied over and scattered in with ``index_copy``.

    * A FULL re-upload happens when row identity moved (cache
      ``tensor_epoch`` bump) or a column capacity grew (the shape
      signature changed), or when a drain dirtied at least 1/4 of the
      rows (the gather would move most of the bytes anyway).
    * Otherwise the mirror equals ``device_cluster`` of the current host
      arrays after the scatter.
    * ``sync`` must run under the cache lock, so the gathered rows and the
      dirty set are one generation.
    * The scatter is out of place: a streamed drain still holds the
      previous DeviceCluster across its chunks, and must keep reading the
      state it started from.
    """

    FULL_FRACTION = 4  # dirty rows * 4 >= N -> full upload wins

    def __init__(self, device: "torch.device | str | None" = "cuda"):
        self.device = device_mod.resolve(device)
        self.dc: DeviceCluster | None = None
        self._sig = None
        self._epoch = None
        self.stats = {"full_syncs": 0, "row_syncs": 0, "rows_scattered": 0}

    def invalidate(self) -> None:
        """Drop the resident tensors (the guard's OOM eviction).  A
        queued chunk that still reads them keeps its own references, and
        the caching allocator reuses a freed block only for work ordered
        after it on the same stream, so no in-flight read is clobbered."""
        self.dc = None

    @staticmethod
    def signature(nt: NodeTensors, space: FeatureSpace) -> tuple:
        """The shape signature a resident copy was uploaded at; any
        component moving means the arrays cannot be patched in place."""
        return (nt.alloc.shape[0], space.ports.capacity,
                space.volumes.capacity, nt.taints_nosched.shape[1],
                space.images.capacity, space.topo_keys.capacity)

    def in_sync(self, nt: NodeTensors, space: FeatureSpace,
                epoch: int) -> bool:
        """True when the resident copy mirrors THIS host state's row
        identity (same epoch, same shape signature) — the precondition
        for the invariant checker's row readback to be meaningful (a
        mirror awaiting a full re-upload legitimately differs)."""
        return self.dc is not None and self._epoch == epoch and \
            self._sig == self.signature(nt, space)

    # The resource-truth planes the dirty-row protocol must keep equal
    # to the host arrays (cache/verifier.py reads them back).
    READBACK_FIELDS = ("schedulable", "alloc", "requested", "nonzero")

    def readback_rows(self, idx: "np.ndarray | list[int]") -> dict:
        """Device->host readback of the verifier's sampled rows: the four
        resource-truth fields, one gather of k rows each, as host numpy
        arrays.  The resident planes are wide, so no decode step."""
        i = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        out = {f: getattr(self.dc, f).index_select(0, i).cpu().numpy()
               for f in self.READBACK_FIELDS}
        devicestats.record_transfer("readback", devicestats.nbytes(out))
        return out

    def sync(self, nt: NodeTensors, agg: NodeAggregates,
             space: FeatureSpace, dirty: set[int],
             epoch: int) -> DeviceCluster:
        """The current cluster state on the device: scatter ``dirty`` rows
        into the resident arrays, or re-upload everything when the
        resident copy cannot be patched (see class docstring)."""
        n = nt.alloc.shape[0]
        sig = self.signature(nt, space)
        if self.dc is None or self._sig != sig or self._epoch != epoch \
                or len(dirty) * self.FULL_FRACTION >= max(n, 1):
            self.dc = device_cluster(nt, agg, space, self.device)
            self._sig = sig
            self._epoch = epoch
            self.stats["full_syncs"] += 1
            devicestats.record_transfer("full_upload",
                                       devicestats.nbytes(self.dc))
            return self.dc
        if not dirty:
            return self.dc
        idx = np.fromiter(dirty, np.int64, len(dirty))
        # Gather only the dirty rows host-side (same field encoding as
        # _host_cluster), then one copy of idx + rows to the device.
        tn, tp = nt.taints_nosched[idx], nt.taints_prefer[idx]
        rows = DeviceCluster(
            schedulable=nt.schedulable[idx],
            alloc=nt.alloc[idx],
            requested=agg.requested[idx],
            nonzero=agg.nonzero[idx],
            ports_used=_pad_cols(agg.ports_used[idx],
                                 space.ports.capacity),
            vol_any=_pad_cols(agg.vol_any[idx], space.volumes.capacity),
            vol_rw=_pad_cols(agg.vol_rw[idx], space.volumes.capacity),
            taints_nosched=tn,
            taints_prefer=tp,
            has_taints=tn.any(1) | tp.any(1),
            mem_pressure=nt.mem_pressure[idx],
            disk_pressure=nt.disk_pressure[idx],
            image_kib=_pad_cols(nt.image_kib[idx], space.images.capacity),
            topo_dom=_pad_cols(nt.topo_val[idx],
                               space.topo_keys.capacity, fill=-1))
        idx_d = torch.from_numpy(idx).to(self.device)
        rows_d = to_device(rows, self.device)
        # kt-xray: no-alias(a streamed drain still reads the planes it
        # started from: each scatter makes new planes, never writes them)
        self.dc = DeviceCluster(*[arr.index_copy(0, idx_d, new)
                                  for arr, new in zip(self.dc, rows_d)])
        self.stats["row_syncs"] += 1
        self.stats["rows_scattered"] += len(dirty)
        devicestats.record_transfer("scatter", idx.nbytes +
                                    devicestats.nbytes(rows))
        return self.dc


def _predicate_mask(name: str, b: DeviceBatch, c: DeviceCluster,
                    n_nodes: int, extra: dict) -> torch.Tensor:
    p = b.request.shape[0]
    if name in ("PodFitsHost", "HostName"):
        return pr.pod_fits_host(b.host_idx, n_nodes)
    if name == "MatchNodeSelector":
        return pr.pod_selector_matches(b.sel_group, b.sel_required)
    if name == "PodToleratesNodeTaints":
        return pr.pod_tolerates_node_taints(b.tol_nosched, b.has_tolerations,
                                            c.taints_nosched, c.has_taints)
    if name == "CheckNodeMemoryPressure":
        return pr.check_node_memory_pressure(b.best_effort, c.mem_pressure)
    if name == "CheckNodeDiskPressure":
        return pr.check_node_disk_pressure(p, c.disk_pressure)
    if name == "NewNodeLabelPredicate":
        return pr.node_label_presence(p, b.volsvc.nl_pred_row)
    if name == "NoVolumeZoneConflict":
        return b.volsvc.vz_mask[b.volsvc.vz_group.long()]
    if name == "ServiceAffinity":
        return b.volsvc.sa_mask[b.volsvc.sa_group.long()]
    if name == "MaxEBSVolumeCount":
        return pr.max_pd_volume_count(b.volsvc.pd_pod_ebs,
                                      b.volsvc.pd_extra_ebs,
                                      b.volsvc.pd_node_ebs,
                                      b.volsvc.pd_node_extra_ebs,
                                      b.volsvc.pd_node_err_ebs,
                                      extra["max_ebs"])
    if name == "MaxGCEPDVolumeCount":
        return pr.max_pd_volume_count(b.volsvc.pd_pod_gce,
                                      b.volsvc.pd_extra_gce,
                                      b.volsvc.pd_node_gce,
                                      b.volsvc.pd_node_extra_gce,
                                      b.volsvc.pd_node_err_gce,
                                      extra["max_gce"])
    if name == "PodFitsResources":
        return pr.pod_fits_resources(b.request, b.zero_request, c.alloc,
                                     c.requested)
    if name in ("PodFitsHostPorts", "PodFitsPorts"):
        return pr.pod_fits_host_ports(b.ports, c.ports_used)
    if name == "NoDiskConflict":
        return pr.no_disk_conflict(b.vol_rw, b.vol_ro, c.vol_any, c.vol_rw)
    if name == "MatchInterPodAffinity":
        a = b.aff
        return interpod.predicate_mask(a.aff_need, a.aff_self, a.anti_need,
                                       a.decl_match, a.match_cnt,
                                       a.match_total, a.decl_reach)
    if name in PASSTHROUGH_PREDICATES:
        return torch.ones((p, n_nodes), dtype=torch.bool,
                          device=b.request.device)
    raise KeyError(f"unknown predicate {name!r}")


def saa_plane(cnt: torch.Tensor, num: torch.Tensor, dom: torch.Tensor,
              labeled: torch.Tensor) -> torch.Tensor:
    """CalculateAntiAffinityPriority score (selector_spreading.go:236-250):
    int(10*(num-count)/num) on ready labeled nodes, 10 when the service
    has no pods, 0 on unlabeled nodes.  ``cnt`` [P,D] per-domain peer
    counts of each pod's service group, ``num`` [P,1] peer totals,
    ``dom`` [N] node domain ids, ``labeled`` [N]."""
    per = cnt[:, dom.long()]                                     # [P, N]
    score = torch.where(
        num > 0.0,
        prio._trunc(10.0 * (num - per) / torch.clamp(num, min=1.0)),
        10.0)
    return torch.where(labeled[None, :], score, 0.0)


def _priority_plane(name: str, b: DeviceBatch, c: DeviceCluster,
                    n_nodes: int, extra: dict) -> torch.Tensor:
    p = b.request.shape[0]
    if name == "LeastRequestedPriority":
        return prio.least_requested(b.nonzero, c.nonzero, c.alloc)
    if name == "MostRequestedPriority":
        return prio.most_requested(b.nonzero, c.nonzero, c.alloc)
    if name == "BalancedResourceAllocation":
        return prio.balanced_resource_allocation(b.nonzero, c.nonzero,
                                                 c.alloc)
    if name == "NodeAffinityPriority":
        return prio.node_affinity(b.sel_group, b.sel_pref_counts,
                                  c.schedulable)
    if name == "TaintTolerationPriority":
        return prio.taint_toleration(b.tol_prefer, c.taints_prefer,
                                     c.schedulable)
    if name == "ImageLocalityPriority":
        return prio.image_locality(b.images, c.image_kib)
    if name == "NodePreferAvoidPodsPriority":
        return prio.node_prefer_avoid(b.avoid_group, b.avoid_rows)
    if name in ("SelectorSpreadPriority", "ServiceSpreadingPriority"):
        return prio.selector_spread(b.spread_group, b.spread_node_counts,
                                    b.spread_zone_counts, b.spread_has_zones,
                                    b.node_zone_id, c.schedulable)
    if name == "InterPodAffinityPriority":
        a = b.aff
        counts = interpod.priority_counts(a.pref_w, a.match_cnt, a.sym_match,
                                          a.sym_w, a.sym_cnt)
        return interpod.priority_score(counts, c.schedulable, prio._trunc)
    if name == "NodeLabelPriority":
        return prio.node_label(p, b.volsvc.nl_prio_rows[extra.get("aux", 0)])
    if name == "ServiceAntiAffinityPriority":
        vs = b.volsvc
        aux = extra.get("aux", 0)
        g = vs.saa_group.long()
        return saa_plane(vs.saa_cnt[aux][g], vs.saa_num[g][:, None],
                         vs.saa_dom[aux], vs.saa_labeled[aux])
    if name == "EqualPriority":
        return prio.equal_priority(p, n_nodes, device=c.alloc.device)
    raise KeyError(f"unknown priority {name!r}")


def scan_route(device: torch.device) -> str:
    """Which body runs a chunk: ``"kernel"`` (one launch of the scan
    kernel, which carries every family) for CUDA tensors, else
    ``"steps"`` (the step loop)."""
    return "kernel" if device.type == "cuda" else "steps"


def _add_weighted(acc: torch.Tensor, weight: float,
                  plane: torch.Tensor) -> torch.Tensor:
    """``acc + f32(weight) * plane``; a weight of 1 skips the (exact,
    identity) multiply and its launch."""
    return acc + plane if weight == 1 else acc + float(weight) * plane


class Solver:
    """Compiles a Policy into the sequential-solve computation.

    Solvers hold only policy-derived constants, so ``Solver.for_policy``
    shares one instance per distinct derived signature."""

    _registry: dict = {}
    _registry_lock = threading.Lock()

    @classmethod
    def for_policy(cls, policy: Policy) -> "Solver":
        candidate = cls(policy)
        key = (candidate.predicate_names, candidate.priority_specs,
               tuple(sorted(candidate.extra.items())))
        with cls._registry_lock:
            existing = cls._registry.get(key)
            if existing is not None:
                return existing
            cls._registry[key] = candidate
            return candidate

    def __init__(self, policy: Policy):
        self.policy = policy
        # Half-width encoded-score dtype: f16 (the JAX package's non-TPU
        # choice; wider mantissa than bf16, so a larger exact-integer
        # range).
        self._half_dtype = torch.float16
        # Canonical names: argument-carrying entries resolve to their
        # builtin regardless of the user-chosen policy name (plugins.go).
        self.predicate_names = tuple(canonical_predicate_name(p)
                                     for p in expand_predicates(policy))
        # (name, weight, aux) — aux indexes per-instance policy-arg tables
        # (ServiceAntiAffinityPriority / NodeLabelPriority rows).
        specs = []
        saa_i = nl_i = 0
        for s in policy.priorities:
            if s.weight == 0:
                continue
            name = canonical_priority_name(s)
            if name == "ServiceAntiAffinityPriority":
                specs.append((name, s.weight, saa_i))
                saa_i += 1
            elif name == "NodeLabelPriority":
                specs.append((name, s.weight, nl_i))
                nl_i += 1
            else:
                specs.append((name, s.weight, 0))
        self.priority_specs = tuple(specs)
        # MaxPD caps: policy value, else KUBE_MAX_PD_VOLS env, else provider
        # default (defaults.go:42-54).
        env_max = os.environ.get("KUBE_MAX_PD_VOLS", "")
        env_val = int(env_max) if env_max.isdigit() else 0
        self.extra = {"max_ebs": env_val or DEFAULT_MAX_EBS_VOLUMES,
                      "max_gce": env_val or DEFAULT_MAX_GCE_PD_VOLUMES}
        for spec in expand_predicates(policy):
            if spec.name == "MaxEBSVolumeCount" and spec.max_volumes:
                self.extra["max_ebs"] = spec.max_volumes
            elif spec.name == "MaxGCEPDVolumeCount" and spec.max_volumes:
                self.extra["max_gce"] = spec.max_volumes

    # -- one-shot batched evaluation ------------------------------------

    def masks(self, b: DeviceBatch, c: DeviceCluster
              ) -> dict[str, torch.Tensor]:
        """Per-predicate [P,N] masks (for Filter verbs / failure
        reporting), keyed in sorted name order: the order in which the
        JAX package's jitted ``masks`` returns them, which the FitError
        map and the extender's failure reasons list."""
        n = c.alloc.shape[0]
        return {name: _predicate_mask(name, b, c, n, self.extra)
                for name in sorted(set(self.predicate_names))}

    def evaluate(self, b: DeviceBatch, c: DeviceCluster,
                 flags: BatchFlags = ALL_ON_FLAGS
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """(feasible [P,N] bool, scores [P,N] f32) against current state,
        both contiguous.

        ``flags`` (content-derived, see batch_flags) skips planes the batch
        provably cannot trigger — an all-pass mask or all-zero plane."""
        n = c.alloc.shape[0]
        p = b.request.shape[0]
        skip_preds = self.evaluate_skips(flags)
        # Unready nodes are filtered before scheduling (factory.go:436-462).
        feasible = c.schedulable[None, :].expand(p, n).contiguous()
        for name in self.predicate_names:
            if name not in skip_preds:
                feasible = feasible & \
                    _predicate_mask(name, b, c, n, self.extra)
        scores = torch.zeros((p, n), dtype=torch.float32,
                             device=c.alloc.device)
        for name, weight, aux in self.evaluate_priorities(flags):
            scores = scores + float(weight) * \
                _priority_plane(name, b, c, n, {"aux": aux})
        return feasible, scores

    @staticmethod
    def evaluate_skips(flags: BatchFlags) -> set[str]:
        """The predicates ``evaluate`` leaves out: all-pass masks for a
        batch whose content cannot trigger them."""
        skip_preds = set()
        if not flags.any_ports:
            skip_preds |= {"PodFitsHostPorts", "PodFitsPorts"}
        if not flags.any_volumes:
            skip_preds.add("NoDiskConflict")
        if not flags.any_ebs:
            skip_preds.add("MaxEBSVolumeCount")
        if not flags.any_gce:
            skip_preds.add("MaxGCEPDVolumeCount")
        if not flags.any_affinity_pred:
            skip_preds.add("MatchInterPodAffinity")
        return skip_preds

    def evaluate_priorities(self, flags: BatchFlags) -> tuple:
        """The (name, weight, aux) priorities ``evaluate`` sums, in order:
        all but an inter-pod plane whose counts are provably zero."""
        return tuple(sp for sp in self.priority_specs
                     if sp[0] != "InterPodAffinityPriority" or
                     flags.any_affinity_prio)

    # -- sequential greedy solve ----------------------------------------

    def solve_sequential_packed(self, b: DeviceBatch, c: DeviceCluster,
                                last_node_index: torch.Tensor,
                                flags: BatchFlags,
                                extra_mask: torch.Tensor | None = None,
                                score_bias: torch.Tensor | None = None,
                                live: torch.Tensor | None = None
                                ) -> torch.Tensor:
        """Greedy in-order placement of the whole batch, with every
        host-bound result packed into ONE int64 vector: [choices (P),
        counter (1), requested (4N), nonzero (2N)], so the host reads the
        drain back in one copy.  ``last_node_index`` is a [1] int64
        tensor (low 32 bits used); ``extra_mask``/``score_bias`` are the
        workload-constraint planes (topology spread)."""
        choices, counter, final = self._solve_scan(
            b, c, last_node_index, score_bias, flags, None, live,
            extra_mask)
        requested, nonzero = self._final_aggregates(final)
        return torch.cat([choices.long(), counter.long(),
                          requested.reshape(-1).long(),
                          nonzero.reshape(-1).long()])

    @staticmethod
    def _final_aggregates(final: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(requested [N,4], nonzero [N,2]) from the scan's packed [N,6]."""
        return final["packed"][:, :4], final["packed"][:, 4:6]

    @staticmethod
    def _carry_cluster(c: DeviceCluster, final: dict) -> DeviceCluster:
        """Fold a scan's final dynamic state back into a DeviceCluster."""
        requested, nonzero = Solver._final_aggregates(final)
        return c._replace(
            requested=requested, nonzero=nonzero,
            ports_used=final.get("ports_used", c.ports_used),
            vol_any=final.get("vol_any", c.vol_any),
            vol_rw=final.get("vol_rw", c.vol_rw))

    # -- joint batched assignment (the LP-relaxed global solve) ----------

    def _price_iterate(self, b: DeviceBatch, c: DeviceCluster,
                       n_iters: int,
                       extra_mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dual-price iteration for the joint assignment objective.

        The batched placement is a generalized assignment problem:
        maximize the summed combined score subject to per-node
        multi-resource capacity.  Its LP relaxation decomposes by pricing
        each node resource (dual variables lam [N, 3]): pods bid for
        their utility-argmax node, prices rise on oversubscribed
        resources (projected subgradient on the dual), and the final
        prices shape a regret-ordered greedy repair pass
        (``solve_joint``).  Returns (score_bias [P, N] = -price cost,
        repair-order key [P]).

        Torch ops throughout, decision-identical to the JAX package's
        jitted ``_price_iterate``:

        * the cost ``einsum("pnr,nr->pn", dnorm, lam)`` and the price
          step ``lam + lr * over`` round as XLA's CPU backend rounds
          them, with fused multiply-adds (``_price_cost``,
          ``fma_f32``), and the [P, N, 3] ``dnorm`` never exists;
        * the bid load ``einsum("pn,pr->nr", one_hot(choice) * placed,
          demand)`` is an int64 ``index_add_`` of the placed pods'
          integer requests at their choices, cast to f32 once: exact and
          order-free (the JAX sum is exact too while a node's bid total
          stays below 2^24);
        * the size bucket's ``max(demand / free)`` over all nodes is
          ``demand / min(free)`` (division is monotonic in the divisor,
          so the quotient of the least divisor is the maximum)."""
        f32 = torch.float32
        feasible, scores = self.evaluate(b, c)
        if extra_mask is not None:
            feasible = feasible & extra_mask
        neg = float("-inf")
        free = torch.clamp((c.alloc[:, :3] - c.requested[:, :3]).to(f32),
                           min=1.0)                                # [N, 3]
        demand = b.request[:, :3].to(f32)                          # [P, 3]
        span = torch.clamp(torch.where(feasible, scores, 0.0).amax(),
                           min=1.0)
        lr = span  # one full-node oversubscription ~ top score
        placed = feasible.any(dim=1)
        bids = b.request[:, :3].to(torch.int64) * placed[:, None]
        lam = torch.zeros((c.alloc.shape[0], 3), dtype=f32,
                          device=c.alloc.device)
        for _ in range(n_iters):
            util = torch.where(feasible,
                               scores - _price_cost(demand, free, lam), neg)
            choice = util.argmax(dim=1)
            # kt-xray: in-place(into a fresh zero tensor of this step)
            load = torch.zeros_like(lam, dtype=torch.int64).index_add_(
                0, choice, bids).to(f32)
            over = torch.clamp(load - free, min=0.0) / free
            lam = torch.clamp(fma_f32(lr, over, lam)
                              - 0.02 * lr * (over == 0).to(f32), min=0.0)
        cost = _price_cost(demand, free, lam)
        util = torch.where(feasible, scores - cost, neg)
        if util.shape[1] > 1:
            top2 = torch.topk(util, 2, dim=1).values
        else:
            top2 = torch.cat([util, torch.full_like(util, neg)], dim=1)
        t0, t1 = top2[:, 0], top2[:, 1]
        regret = torch.where(
            torch.isfinite(t0),
            t0 - torch.where(torch.isfinite(t1), t1, t0 - 1e3), neg)
        # Repair-order key: smallest dominant-resource fraction first
        # (for a sum-of-scores objective with commensurate per-pod scores
        # this maximizes admitted count), regret-tiebroken within a size
        # bucket.
        dfrac = (demand / free.amin(dim=0)[None, :]).amax(dim=1)
        key = -torch.floor(torch.clamp(dfrac, max=1.0) * 16.0) \
            * (20.0 * span) \
            + torch.where(torch.isfinite(regret), regret, 0.0)
        return -cost, key

    def solve_joint(self, b: DeviceBatch, c: DeviceCluster,
                    last_node_index: torch.Tensor, n_iters: int = 24, *,
                    flags: BatchFlags,
                    extra_mask: torch.Tensor | None = None,
                    score_bias: torch.Tensor | None = None,
                    live: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, DeviceCluster]:
        """Joint batched assignment: price iteration, then the greedy
        repair in regret order.  Returns (choices [P] int32 in the
        batch's own order, counter [1] int64, the cluster after the
        placements).  Placements honor EVERY predicate: the repair pass
        is the exact sequential scan (``_solve_scan``, on the card one
        scan-kernel launch), price-shaped through
        its f32 score bias and reordered, plus the workload-constraint
        ``extra_mask``/``score_bias`` planes.  ``live`` marks real rows
        when the caller padded the batch.  ``flags`` come from the host
        batch (``batch_flags``)."""
        bias, key = self._price_iterate(b, c, n_iters, extra_mask)
        if score_bias is not None:
            bias = bias + score_bias
        # Biggest, then highest-regret, first: a stable sort of -key in
        # the float order of the JAX package's jnp.argsort.
        order = torch.argsort(_sort_key(-key), stable=True)
        pb = permute_pod_axis(b, order)
        pbias = bias.index_select(0, order)
        pmask = None if extra_mask is None else \
            extra_mask.index_select(0, order)
        plive = None if live is None else live.index_select(0, order)
        choices_p, counter, final = self._solve_scan(
            pb, c, last_node_index, pbias, flags, None, plive, pmask)
        choices = torch.empty_like(choices_p)
        choices[order] = choices_p
        return choices, counter, self._carry_cluster(c, final)

    def _solve_scan(self, b: DeviceBatch, c: DeviceCluster,
                    last_node_index: torch.Tensor,
                    score_bias: torch.Tensor | None,
                    flags: BatchFlags = ALL_ON_FLAGS,
                    carry: dict | None = None,
                    live: torch.Tensor | None = None,
                    extra_mask: torch.Tensor | None = None,
                    route: str | None = None, cluster: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """The sequential scan, with an additive per-(pod,node) score bias.

        ``flags`` leaves out dynamic-state families the batch cannot
        touch; ``carry`` continues a previous chunk's final state (chunked
        drain) — flags MUST come from the full batch, not the chunk, so
        every chunk carries the same state.  ``live`` [P] bool marks real
        rows (pad rows are infeasible everywhere, place nothing and bump
        no counter); ``extra_mask`` [P,N] is an extra hard feasibility
        plane.  ``route`` forces the body (``scan_route`` chooses by
        default) and ``cluster`` the kernel's cluster size, as the checks
        do.  Returns (choices [P] int32, counter [1] int64, final
        state dict).  The carry's tensors are updated in place: a
        chunk's final state is consumed by the next chunk only."""
        n = c.alloc.shape[0]
        p = b.request.shape[0]
        in_scan_preds, static_prios, dynamic_prios, fams = \
            self.scan_layout(flags)
        static_mask = c.schedulable[None, :].expand(p, n)
        for name in self.predicate_names:
            if name not in in_scan_preds:
                static_mask = static_mask & \
                    _predicate_mask(name, b, c, n, self.extra)
        if live is not None:
            static_mask = static_mask & live[:, None]
        if extra_mask is not None:
            static_mask = static_mask & extra_mask
        static_score = score_bias if score_bias is not None else \
            torch.zeros((p, n), dtype=torch.float32, device=c.alloc.device)
        for name, weight, aux in static_prios:
            static_score = static_score + float(weight) * \
                _priority_plane(name, b, c, n, {"aux": aux})
        return self._fused_scan(b, c, last_node_index, static_mask,
                                static_score, carry, score_bias is not None,
                                fams, dynamic_prios, route, cluster)

    def scan_layout(self, flags: BatchFlags
                    ) -> tuple[set, tuple, tuple, dict]:
        """How the scan splits the policy for a batch with ``flags``:
        (the predicates checked in the scan, the static priorities
        hoisted into the encoded plane, the dynamic priorities scored per
        step, the state families the scan carries).  Placement-invariant
        work is hoisted; a policy-dynamic predicate whose inputs are
        absent from this batch (flags) is hoisted too."""
        use_resources = "PodFitsResources" in self.predicate_names
        use_ports = flags.any_ports and any(
            nm in self.predicate_names
            for nm in ("PodFitsHostPorts", "PodFitsPorts"))
        use_volumes = flags.any_volumes and \
            "NoDiskConflict" in self.predicate_names
        use_interpod = flags.any_affinity_pred and \
            "MatchInterPodAffinity" in self.predicate_names
        use_max_ebs = flags.any_ebs and \
            "MaxEBSVolumeCount" in self.predicate_names
        use_max_gce = flags.any_gce and \
            "MaxGCEPDVolumeCount" in self.predicate_names
        in_scan_preds = {"PodFitsResources"} if use_resources else set()
        if use_ports:
            in_scan_preds |= {"PodFitsHostPorts", "PodFitsPorts"}
        if use_volumes:
            in_scan_preds.add("NoDiskConflict")
        if use_interpod:
            in_scan_preds.add("MatchInterPodAffinity")
        if use_max_ebs:
            in_scan_preds.add("MaxEBSVolumeCount")
        if use_max_gce:
            in_scan_preds.add("MaxGCEPDVolumeCount")
        static_prios = []
        dynamic_prios = []
        for name, weight, aux in self.priority_specs:
            in_scan = name in DYNAMIC_PRIORITIES
            if name in ("SelectorSpreadPriority", "ServiceSpreadingPriority"):
                in_scan = flags.any_spread
            elif name == "InterPodAffinityPriority":
                in_scan = flags.any_affinity_prio
            elif name == "ServiceAntiAffinityPriority":
                # No batch pod joins any scored service group: counts are
                # provably constant, the batch-start plane is exact.
                in_scan = flags.any_saa
            if in_scan:
                dynamic_prios.append((name, weight, aux))
            else:
                static_prios.append((name, weight, aux))
        dynamic_prios = tuple(dynamic_prios)
        use_interpod_prio = any(nm == "InterPodAffinityPriority"
                                for nm, _, _ in dynamic_prios)
        track_spread = any(nm in ("SelectorSpreadPriority",
                                  "ServiceSpreadingPriority")
                           for nm, _, _ in dynamic_prios)
        fams = dict(
            use_resources=use_resources, use_ports=use_ports,
            use_volumes=use_volumes, use_interpod=use_interpod,
            use_max_ebs=use_max_ebs, use_max_gce=use_max_gce,
            track_affinity=use_interpod or use_interpod_prio,
            track_spread=track_spread,
            track_spread_zones=track_spread and flags.any_spread_zones,
            track_saa=any(nm == "ServiceAntiAffinityPriority"
                          for nm, _, _ in dynamic_prios))
        return in_scan_preds, tuple(static_prios), dynamic_prios, fams

    # Dynamic priorities whose pod-dependence is ONLY the nonzero-request
    # row: their per-step [N] score plane is a function of (template,
    # carried aggregates), so the scan carries one [templates, N] plane
    # and recomputes a single column per placement.
    _TEMPLATE_PRIOS = ("LeastRequestedPriority", "MostRequestedPriority",
                       "BalancedResourceAllocation")

    def _template_col(self, tmpl_prios: tuple, templates: torch.Tensor,
                      nz_j: torch.Tensor, alloc_j: torch.Tensor
                      ) -> torch.Tensor:
        """[T, 1] — the template-factored score column for one node, from
        its (new) nonzero aggregates ``nz_j`` [1,2] and ``alloc_j``
        [1,4]: the per-step formulas evaluated at a single node."""
        col = torch.zeros((templates.shape[0], 1), dtype=torch.float32,
                          device=templates.device)
        for name, weight, _aux in tmpl_prios:
            if name == "LeastRequestedPriority":
                col = _add_weighted(col, weight, prio.least_requested(
                    templates, nz_j, alloc_j))
            elif name == "MostRequestedPriority":
                col = _add_weighted(col, weight, prio.most_requested(
                    templates, nz_j, alloc_j))
            elif name == "BalancedResourceAllocation":
                col = _add_weighted(col, weight,
                                    prio.balanced_resource_allocation(
                                        templates, nz_j, alloc_j))
        return col

    def _rich_kernel_args(self, b: DeviceBatch, c: DeviceCluster,
                          state: dict, fams: dict, other_prios: tuple
                          ) -> dict:
        """The rich families' arguments of ``scan_chunk``: the chunk's
        per-pod term lists (built here, on the device, as part of the
        hoist), the batch's tables and the carried state."""
        lists = scan_mod.term_lists
        a, vs = b.aff, b.volsvc
        kw = {}
        if fams["use_ports"]:
            kw.update(ports_list=lists(b.ports),
                      ports_used=state["ports_used"])
        if fams["use_volumes"]:
            kw.update(vol_rw_list=lists(b.vol_rw),
                      vol_ro_list=lists(b.vol_ro), vol_any=state["vol_any"],
                      vol_rw=state["vol_rw"])
        for fam in ("ebs", "gce"):
            if fams[f"use_max_{fam}"]:
                pd = state[f"pd_{fam}"]
                kw.update({
                    f"{fam}_list": lists(getattr(vs, f"pd_pod_{fam}")),
                    f"{fam}_extra": getattr(vs, f"pd_extra_{fam}"),
                    f"{fam}_node_extra": getattr(vs, f"pd_node_extra_{fam}"),
                    f"{fam}_node_err": getattr(vs, f"pd_node_err_{fam}"),
                    f"pd_{fam}": pd,
                    f"{fam}_count": pd.sum(dim=1, dtype=torch.int32),
                    f"max_{fam}": self.extra[f"max_{fam}"]})
        if fams["track_affinity"]:
            kw.update(node_dom=a.node_dom, match_key=a.match_key,
                      decl_key=a.decl_key, sym_key=a.sym_key,
                      match_cnt=state["match_cnt"],
                      match_total=state["match_total"],
                      decl_reach=state["decl_reach"],
                      sym_cnt=state["sym_cnt"],
                      match_src_list=lists(a.match_src),
                      decl_src_list=lists(a.decl_src),
                      sym_src_list=lists(a.sym_src))
        if fams["use_interpod"]:
            kw.update(aff_need_list=lists(a.aff_need), aff_self=a.aff_self,
                      anti_need_list=lists(a.anti_need),
                      decl_match_list=lists(a.decl_match))
        if any(nm == "InterPodAffinityPriority" for nm, _, _ in other_prios):
            kw.update(pref_list=lists(a.pref_w != 0), pref_w=a.pref_w,
                      sym_match_list=lists(a.sym_match), sym_w=a.sym_w,
                      schedulable=c.schedulable)
        if fams["track_saa"]:
            kw.update(saa_group=vs.saa_group, saa_src_list=lists(vs.saa_src),
                      saa_dom=vs.saa_dom, saa_labeled=vs.saa_labeled,
                      saa_cnt=state["saa_cnt"], saa_num=state["saa_num"])
        return kw

    def _fused_scan(self, b: DeviceBatch, c: DeviceCluster,
                    last_node_index: torch.Tensor,
                    static_mask: torch.Tensor, static_score: torch.Tensor,
                    carry: dict | None, has_bias: bool, fams: dict,
                    dynamic_prios: tuple, route: str | None = None,
                    cluster: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """The fused scan body, decision-identical to the JAX package's
        ``_fused_scan`` (solver.py:1319-1665):

        * the hoisted mask/score planes merge into ONE encoded plane
          (``-inf`` = statically infeasible), so each step reads one row
          and folds dynamic feasibility with a single ``where``;
        * ``requested``+``nonzero`` carry as one packed [N,6] matrix
          committed by a one-row ``index_add_``;
        * spread/zone counts commit one column; port/volume/PD planes
          one row;
        * least/most-requested and balanced are template-factored: a
          carried [T,N] plane is row-gathered per pod and one column is
          recomputed per placement (``_template_col``);
        * mask -> score -> tie-break -> select is the fused select kernel
          (engine/fused.py).

        Every per-step index is a device tensor (``index_select`` /
        ``index_add_`` / ``index_copy_``), never a host value.  With
        ``route == "kernel"`` the whole chunk of steps is one launch of
        ``engine/scan.py:scan_chunk`` on the same encoded plane and the
        same state (``cluster`` forces its cluster size)."""
        dev = c.alloc.device
        route = route or scan_route(dev)
        n = c.alloc.shape[0]
        p = b.request.shape[0]
        a = b.aff
        vs = b.volsvc
        neg = float("-inf")
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        zone_ids = b.node_zone_id
        fits_pods_alloc = c.alloc[:, RES_PODS]
        alloc3 = c.alloc[:, :3]
        use_resources = fams["use_resources"]
        use_ports = fams["use_ports"]
        use_volumes = fams["use_volumes"]
        use_interpod = fams["use_interpod"]
        use_max_ebs = fams["use_max_ebs"]
        use_max_gce = fams["use_max_gce"]
        track_affinity = fams["track_affinity"]
        track_spread = fams["track_spread"]
        track_spread_zones = fams["track_spread_zones"]
        track_saa = fams["track_saa"]

        tmpl_prios = tuple(sp for sp in dynamic_prios
                           if sp[0] in self._TEMPLATE_PRIOS)
        other_prios = tuple(sp for sp in dynamic_prios
                            if sp[0] not in self._TEMPLATE_PRIOS)
        use_templates = bool(tmpl_prios) and b.nz_templates.shape[0] > 0
        if not use_templates:
            other_prios = dynamic_prios
            tmpl_prios = ()

        # The encoded static plane: score where statically feasible, -inf
        # elsewhere.  When the greedy score is provably small-integral (no
        # bias; the policy's summed weight x MAX_PRIORITY fits f16's exact
        # integer range), it is stored at half width and each step widens
        # its one row back to f32; -inf encodes exactly in f16.
        enc = torch.where(static_mask, static_score, neg)
        weight_bound = sum(abs(w) for _n, w, _a in self.priority_specs) \
            * prio.MAX_PRIORITY
        if not has_bias and weight_bound < 2048:
            enc = enc.to(self._half_dtype)
        half = enc.dtype != f32

        carry = carry or {}

        def init(key: str, make):
            return carry[key] if key in carry else make()

        state = {
            "packed": init("packed", lambda: torch.cat(
                [c.requested, c.nonzero], dim=1)),
            "counter": init("counter", lambda: last_node_index.to(
                device=dev, dtype=i64).reshape(1).clone()),
        }
        req6 = torch.cat([b.request, b.nonzero], dim=1)          # [P,6]
        req3 = b.request[:, :3]
        if use_templates:
            def d0():
                D0 = torch.zeros((b.nz_templates.shape[0], n), dtype=f32,
                                 device=dev)
                for name, weight, _aux in tmpl_prios:
                    if name == "LeastRequestedPriority":
                        D0 = _add_weighted(D0, weight, prio.least_requested(
                            b.nz_templates, c.nonzero, c.alloc))
                    elif name == "MostRequestedPriority":
                        D0 = _add_weighted(D0, weight, prio.most_requested(
                            b.nz_templates, c.nonzero, c.alloc))
                    elif name == "BalancedResourceAllocation":
                        D0 = _add_weighted(
                            D0, weight, prio.balanced_resource_allocation(
                                b.nz_templates, c.nonzero, c.alloc))
                return D0
            state["D"] = init("D", d0)
            tmpl = b.nz_tmpl_idx.to(i64)
        if use_ports:
            state["ports_used"] = init("ports_used", c.ports_used.clone)
        if use_volumes:
            state["vol_any"] = init("vol_any", c.vol_any.clone)
            state["vol_rw"] = init("vol_rw", c.vol_rw.clone)
        if track_spread:
            state["sp_node"] = init("sp_node", b.spread_node_counts.clone)
            state["sp_zone"] = init("sp_zone", b.spread_zone_counts.clone)
            # Carried maxima, seeded like the per-step reductions they
            # replace (the node max spans the ready nodes; the zone max
            # spans all zones).
            state["sp_maxn"] = init("sp_maxn", lambda: torch.where(
                c.schedulable[None, :], b.spread_node_counts, 0.0)
                .amax(dim=1))
            state["sp_maxz"] = init("sp_maxz", lambda: b.spread_zone_counts
                                    .amax(dim=1))
            sgroup = b.spread_group.to(i64)
            incr_f = b.spread_incr.to(f32)
            node_has_zone = zone_ids >= 0
            zone_clip = torch.clamp(zone_ids, min=0).to(i64)
        # Copies: the kernel updates its state in place, and the batch's
        # tables must stay as compiled.
        if track_affinity:
            state["match_cnt"] = init("match_cnt", a.match_cnt.clone)
            state["match_total"] = init("match_total", a.match_total.clone)
            state["decl_reach"] = init("decl_reach", a.decl_reach.clone)
            state["sym_cnt"] = init("sym_cnt", a.sym_cnt.clone)
        if track_saa:
            state["saa_cnt"] = init("saa_cnt", vs.saa_cnt.clone)
            state["saa_num"] = init("saa_num", vs.saa_num.clone)
            saa_g = vs.saa_group.to(i64)
            n_dom = state["saa_cnt"].shape[2]
            dom_ids = torch.arange(n_dom, dtype=i32, device=dev)
        if use_max_ebs:
            state["pd_ebs"] = init("pd_ebs", vs.pd_node_ebs.clone)
        if use_max_gce:
            state["pd_gce"] = init("pd_gce", vs.pd_node_gce.clone)

        packed = state["packed"]
        if route == "kernel":
            kw = {}
            if use_templates:
                kw.update(templates=b.nz_templates, tmpl_idx=b.nz_tmpl_idx,
                          d_plane=state["D"], tmpl_terms=tmpl_prios)
            if track_spread:
                kw.update(spread_group=b.spread_group,
                          spread_incr=b.spread_incr, sp_node=state["sp_node"],
                          sp_maxn=state["sp_maxn"])
            if track_spread_zones:
                kw.update(node_zone=zone_ids, has_zones=b.spread_has_zones,
                          sp_zone=state["sp_zone"], sp_maxz=state["sp_maxz"])
            kw.update(self._rich_kernel_args(b, c, state, fams, other_prios))
            # kt-xray: in-place(the kernel updates the chunk's carried
            # state: copies of the cluster's planes made above, or the
            # previous chunk's state, which only this chunk consumes)
            choices = scan_mod.scan_chunk(
                enc, request=b.request, nonzero=b.nonzero,
                zero_request=b.zero_request, alloc=c.alloc, packed=packed,
                counter=state["counter"], terms=other_prios,
                use_resources=use_resources, cluster=cluster, **kw)
            return choices, state["counter"], state

        counter = state["counter"]
        outs = []
        for i in range(p):
            row = enc[i]
            masked = row.to(f32) if half else row

            # Dynamic score families (template-factored ones come from the
            # carried plane).
            if use_templates:
                masked = masked + state["D"].index_select(
                    0, tmpl[i:i + 1])[0]
            for name, weight, aux in other_prios:
                if name == "LeastRequestedPriority":
                    plane = prio.least_requested(
                        b.nonzero[i:i + 1], packed[:, 4:6], c.alloc)[0]
                elif name == "MostRequestedPriority":
                    plane = prio.most_requested(
                        b.nonzero[i:i + 1], packed[:, 4:6], c.alloc)[0]
                elif name == "BalancedResourceAllocation":
                    plane = prio.balanced_resource_allocation(
                        b.nonzero[i:i + 1], packed[:, 4:6], c.alloc)[0]
                elif name in ("SelectorSpreadPriority",
                              "ServiceSpreadingPriority"):
                    # Selector spread from CARRIED per-group maxima (counts
                    # only grow, and only at the placed column), term for
                    # term the same f32 expressions as prio.selector_spread.
                    g = sgroup[i:i + 1]
                    counts_g = state["sp_node"].index_select(0, g)[0]
                    maxn_g = state["sp_maxn"].index_select(0, g)
                    fsc = torch.where(
                        maxn_g > 0,
                        10.0 * ((maxn_g - counts_g)
                                / torch.clamp(maxn_g, min=1e-9)), 10.0)
                    if track_spread_zones:
                        zc_g = state["sp_zone"].index_select(0, g)[0]
                        maxz_g = state["sp_maxz"].index_select(0, g)
                        zs_z = 10.0 * ((maxz_g - zc_g)
                                       / torch.clamp(maxz_g, min=1e-9))
                        zs_n = torch.where(
                            node_has_zone, zs_z.index_select(0, zone_clip),
                            10.0 * (maxz_g / torch.clamp(maxz_g, min=1e-9)))
                        blended = fsc * (1.0 - 2.0 / 3.0) + \
                            (2.0 / 3.0) * zs_n
                        fsc = torch.where(
                            b.spread_has_zones.index_select(0, g)
                            & node_has_zone & (maxz_g > 0), blended, fsc)
                    plane = prio._trunc(fsc)
                elif name == "InterPodAffinityPriority":
                    counts = interpod.priority_counts(
                        a.pref_w[i:i + 1], state["match_cnt"],
                        a.sym_match[i:i + 1], a.sym_w, state["sym_cnt"])
                    plane = interpod.priority_score(
                        counts, c.schedulable, prio._trunc)[0]
                elif name == "ServiceAntiAffinityPriority":
                    gy = saa_g[i:i + 1]
                    plane = saa_plane(
                        state["saa_cnt"][aux].index_select(0, gy),
                        state["saa_num"].index_select(0, gy)[:, None],
                        vs.saa_dom[aux], vs.saa_labeled[aux])[0]
                else:
                    raise KeyError(f"unknown dynamic priority {name!r}")
                masked = _add_weighted(masked, weight, plane)

            # Dynamic predicates folded into the encoded row by one where.
            dyn_ok = None

            def also(cond):
                return cond if dyn_ok is None else (dyn_ok & cond)

            if use_resources:
                fits_pods = (packed[:, RES_PODS] + 1) <= fits_pods_alloc
                free = alloc3 - packed[:, :3]
                fits_res = torch.all(req3[i][None, :] <= free, dim=-1)
                dyn_ok = also(fits_pods & (b.zero_request[i] | fits_res))
            if use_ports:
                dyn_ok = also(~(state["ports_used"]
                                & b.ports[i][None, :]).any(dim=1))
            if use_volumes:
                vol_conflict = (state["vol_any"]
                                & b.vol_rw[i][None, :]).any(dim=1) | \
                    (state["vol_rw"] & b.vol_ro[i][None, :]).any(dim=1)
                dyn_ok = also(~vol_conflict)
            for fam, on in (("ebs", use_max_ebs), ("gce", use_max_gce)):
                if not on:
                    continue
                pd_node = state[f"pd_{fam}"].to(f32)
                pod_row = getattr(vs, f"pd_pod_{fam}")[i].to(f32)
                overlap = pd_node @ pod_row
                new = pod_row.sum() + \
                    getattr(vs, f"pd_extra_{fam}")[i].to(f32)
                total = pd_node.sum(dim=1) + \
                    getattr(vs, f"pd_node_extra_{fam}").to(f32) + \
                    new - overlap
                ok = (total <= float(self.extra[f"max_{fam}"])) & \
                    ~getattr(vs, f"pd_node_err_{fam}")
                dyn_ok = also((new == 0) | ok)
            if use_interpod:
                reach = state["match_cnt"] > 0.0                # [Sm, N]
                live_need = a.aff_need[i] & ~(
                    a.aff_self[i] & (state["match_total"] == 0.0))
                viol = (live_need.to(f32) @ (~reach).to(f32)
                        + a.anti_need[i].to(f32) @ reach.to(f32)
                        + a.decl_match[i].to(f32)
                        @ state["decl_reach"].to(f32)) > 0
                dyn_ok = also(~viol)
            if dyn_ok is not None:
                masked = torch.where(dyn_ok, masked, neg)

            # Fused selectHost (generic_scheduler.go:124-141).
            choice, n_ties = fused_mod.select(masked, counter)
            outs.append(choice)

            # Commit (the batched AssumePod, cache.go:107): one-row /
            # one-column updates in place on the carried state.
            placed = choice >= 0                                   # [1]
            j = torch.clamp(choice, min=0).to(i64)                 # [1]
            pf = placed.to(f32)
            # kt-xray: in-place(the chunk's carried state, as the kernel)
            packed.index_add_(0, j, req6[i:i + 1] * placed.to(i32))
            if use_templates:
                # kt-xray: in-place(the carried template plane)
                state["D"].index_copy_(1, j, self._template_col(
                    tmpl_prios, b.nz_templates,
                    packed.index_select(0, j)[:, 4:6],
                    c.alloc.index_select(0, j)))
            if use_ports:
                pu = state["ports_used"]
                # kt-xray: in-place(the carried port rows)
                pu.index_copy_(0, j, pu.index_select(0, j)
                               | (b.ports[i] & placed)[None, :])
            if use_volumes:
                va, vr = state["vol_any"], state["vol_rw"]
                # kt-xray: in-place(the carried volume rows)
                va.index_copy_(0, j, va.index_select(0, j)
                               | ((b.vol_rw[i] | b.vol_ro[i])
                                  & placed)[None, :])
                # kt-xray: in-place(the carried volume rows)
                vr.index_copy_(0, j, vr.index_select(0, j)
                               | (b.vol_rw[i] & placed)[None, :])
            if track_spread:
                incr = incr_f[i] * pf                              # [S]
                new_col = state["sp_node"].index_select(1, j)[:, 0] + incr
                # kt-xray: in-place(the carried spread counts)
                state["sp_node"].index_copy_(1, j, new_col[:, None])
                # The placed node is feasible hence schedulable, so the
                # max-over-schedulable moves only through its column; an
                # unplaced step must NOT fold column 0 (the clamp target,
                # possibly an unschedulable node) into the maximum.
                state["sp_maxn"] = torch.where(
                    placed, torch.maximum(state["sp_maxn"], new_col),
                    state["sp_maxn"])
                if track_spread_zones:
                    zid = zone_ids.index_select(0, j)              # [1]
                    zc = torch.clamp(zid, min=0).to(i64)
                    zval = incr * (zid >= 0).to(f32)
                    new_zcol = state["sp_zone"].index_select(1, zc)[:, 0] \
                        + zval
                    # kt-xray: in-place(the carried zone counts)
                    state["sp_zone"].index_copy_(1, zc, new_zcol[:, None])
                    state["sp_maxz"] = torch.where(
                        placed & (zid >= 0),
                        torch.maximum(state["sp_maxz"], new_zcol),
                        state["sp_maxz"])
            for fam, on in (("ebs", use_max_ebs), ("gce", use_max_gce)):
                if on:
                    pd = state[f"pd_{fam}"]
                    # kt-xray: in-place(the carried disk rows)
                    pd.index_copy_(0, j, pd.index_select(0, j) | (
                        getattr(vs, f"pd_pod_{fam}")[i] & placed)[None, :])
            if track_saa:
                src = vs.saa_src[i].to(f32) * pf                   # [Gy]
                state["saa_num"] = state["saa_num"] + src
                dom_j = vs.saa_dom.index_select(1, j)[:, 0]        # [L]
                lab_j = vs.saa_labeled.index_select(1, j)[:, 0] & placed
                domoh = ((dom_ids[None, :] == dom_j[:, None])
                         & lab_j[:, None]).to(f32)                 # [L, D]
                state["saa_cnt"] = state["saa_cnt"] + \
                    domoh[:, None, :] * src[None, :, None]
            if track_affinity:
                (state["match_cnt"], state["match_total"],
                 state["decl_reach"], state["sym_cnt"]) = \
                    interpod.place_update(
                        a.node_dom, a.match_key, state["match_cnt"],
                        state["match_total"], a.match_src[i],
                        a.decl_key, state["decl_reach"], a.decl_src[i],
                        a.sym_key, state["sym_cnt"], a.sym_src[i],
                        choice, placed)
            counter = counter + (n_ties > 0).to(i64)

        state["counter"] = counter & _MASK32
        choices = torch.cat(outs) if outs else \
            torch.empty(0, dtype=i32, device=dev)
        return choices, state["counter"], state


# Pod-axis fields of DeviceBatch (dim 0 = P) for chunking.
_POD_AXIS_FIELDS = ("request", "zero_request", "nonzero", "best_effort",
                    "host_idx", "ports", "vol_ro", "vol_rw", "tol_nosched",
                    "tol_prefer", "has_tolerations", "images", "sel_group",
                    "spread_group", "spread_incr", "avoid_group",
                    "nz_tmpl_idx")
_AFF_POD_AXIS_FIELDS = ("match_src", "aff_need", "aff_self", "anti_need",
                        "pref_w", "decl_match", "decl_src", "sym_match",
                        "sym_src")
_VS_POD_AXIS_FIELDS = ("pd_pod_ebs", "pd_extra_ebs", "pd_pod_gce",
                       "pd_extra_gce", "vz_group", "sa_group", "saa_group",
                       "saa_src")


def slice_pod_axis(b: DeviceBatch, start: int, stop: int) -> DeviceBatch:
    """A [start:stop) view of every pod-axis tensor (chunked drain)."""
    updates = {f: getattr(b, f)[start:stop] for f in _POD_AXIS_FIELDS}
    aff = b.aff._replace(**{f: getattr(b.aff, f)[start:stop]
                            for f in _AFF_POD_AXIS_FIELDS})
    volsvc = b.volsvc._replace(**{f: getattr(b.volsvc, f)[start:stop]
                                  for f in _VS_POD_AXIS_FIELDS})
    return b._replace(aff=aff, volsvc=volsvc, **updates)


def permute_pod_axis(b: DeviceBatch, order: torch.Tensor) -> DeviceBatch:
    """Reorder every pod-axis tensor of a DeviceBatch by ``order``."""
    updates = {f: getattr(b, f).index_select(0, order)
               for f in _POD_AXIS_FIELDS}
    aff = b.aff._replace(**{f: getattr(b.aff, f).index_select(0, order)
                            for f in _AFF_POD_AXIS_FIELDS})
    volsvc = b.volsvc._replace(
        **{f: getattr(b.volsvc, f).index_select(0, order)
           for f in _VS_POD_AXIS_FIELDS})
    return b._replace(aff=aff, volsvc=volsvc, **updates)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors (broadcast to ``c``'s shape) with ONE
    rounding (a fused multiply-add), from elementwise float64 ops, so the card and the CPU
    give the same bits whatever their own contraction rules.

    XLA's CPU backend contracts a multiply feeding an add into an FMA, so
    the JAX package's f32 ``lam + lr * over`` and its three-term price
    dot round once per multiply-add; this reproduces those bits.  The
    product is exact in float64 (24 + 24 bits); Knuth's TwoSum gives the
    sum's rounding error exactly; rounding the float64 sum to f32 is
    correct except when it lands exactly on an f32 midpoint (the low 29
    of its 52 mantissa bits are 1 followed by zeros) while the error is
    not zero, where the result moves one f32 step toward the error.  The
    midpoint test holds for results in the f32 normal range, which the
    price iteration's values are (integer requests, prices of at least
    the 1/node-capacity order)."""
    f64 = torch.float64
    p = a.to(f64) * b.to(f64)
    cd = c.to(f64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.to(torch.float32)
    low = s.view(torch.int64) & ((1 << 29) - 1)
    tie = low == (1 << 28)
    inf = torch.full_like(r, float("inf"))
    return torch.where(tie & (err > 0), torch.nextafter(r, inf),
                       torch.where(tie & (err < 0),
                                   torch.nextafter(r, -inf), r))


def _price_cost(demand: torch.Tensor, free: torch.Tensor,
                lam: torch.Tensor) -> torch.Tensor:
    """[P, N] ``sum_r (demand[p, r] / free[n, r]) * lam[n, r]``: the JAX
    package's ``einsum("pnr,nr->pn", dnorm, lam)`` as XLA's CPU backend
    computes it, a multiply-add chain in r order
    (``fma(d2, l2, fma(d1, l1, d0 * l0))``), each ``demand[:, r] /
    free[:, r]`` formed per use (the [P, N, 3] ``dnorm`` never exists),
    with no BLAS call to reorder the sum."""
    cost = None
    for r in range(demand.shape[1]):
        d = demand[:, r, None] / free[None, :, r]
        cost = d * lam[None, :, r] if cost is None else \
            fma_f32(d, lam[None, :, r], cost)
    return cost


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order f32 ``x`` as ``jnp.argsort`` orders it on
    the CPU: -0.0 and subnormals equal to 0.0 (XLA flushes subnormals),
    every NaN after +inf.  A float's bits as int32 with the magnitude
    bits of negative values flipped, after those become 0.0; NaN maps to
    the largest int32.  Integer keys sort alike on every device."""
    x = torch.where(x.abs() < 2.0 ** -126, 0.0, x)
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(x), 0x7FFFFFFF, key)

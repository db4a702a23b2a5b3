"""Soft-scoring functions (torch counterpart of
``kubernetes_tpu/ops/priorities.py``).

Each priority is a score plane ``[P, N]`` (float32 holding exact small
integers 0-10).  Integer formulas are exact int32 arithmetic with floor
division (all operands are non-negative where it matters, so it equals
Go's truncating division); float formulas keep the JAX twin's f32
expression order term for term, so both packages land on the same bits.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.features.compiler import RES_CPU, RES_MEM

# priorities.go:45 — scores live on a 0-10 scale.
MAX_PRIORITY = 10


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """Go's int(float) truncation with an epsilon guard: an f32 division
    can land an exact boundary (3000/4000*10 == 7.5) an ulp off, and the
    reference's quotients of small integers sit >= 1e-4 from any integer,
    so +1e-5 absorbs the error without crossing a true boundary."""
    return torch.trunc(x + 1e-5)


def _unused_score(requested: torch.Tensor,
                  capacity: torch.Tensor) -> torch.Tensor:
    """calculateUnusedScore (priorities.go:45-55): ((cap-req)*10)/cap, 0
    when cap==0 or req>cap.  Exact int32."""
    safe_cap = torch.clamp(capacity, min=1)
    score = ((capacity - requested) * 10) // safe_cap
    return torch.where((capacity == 0) | (requested > capacity),
                       torch.zeros_like(score), score)


def _used_score(requested: torch.Tensor,
                capacity: torch.Tensor) -> torch.Tensor:
    """calculateUsedScore (priorities.go:64-74): (req*10)/cap."""
    safe_cap = torch.clamp(capacity, min=1)
    score = (requested * 10) // safe_cap
    return torch.where((capacity == 0) | (requested > capacity),
                       torch.zeros_like(score), score)


def _total_nonzero(pod_nonzero: torch.Tensor,
                   node_nonzero: torch.Tensor) -> torch.Tensor:
    """[P,N,2] — pod's non-zero request + node's accumulated non-zero
    requests (calculateUnusedPriority, priorities.go:81-86)."""
    return pod_nonzero[:, None, :] + node_nonzero[None, :, :]


def least_requested(pod_nonzero: torch.Tensor, node_nonzero: torch.Tensor,
                    node_alloc: torch.Tensor) -> torch.Tensor:
    """LeastRequestedPriority (priorities.go:139-149)."""
    total = _total_nonzero(pod_nonzero, node_nonzero)
    cpu = _unused_score(total[..., 0], node_alloc[None, :, RES_CPU])
    mem = _unused_score(total[..., 1], node_alloc[None, :, RES_MEM])
    return ((cpu + mem) // 2).float()


def most_requested(pod_nonzero: torch.Tensor, node_nonzero: torch.Tensor,
                   node_alloc: torch.Tensor) -> torch.Tensor:
    """MostRequestedPriority (priorities.go:152-161)."""
    total = _total_nonzero(pod_nonzero, node_nonzero)
    cpu = _used_score(total[..., 0], node_alloc[None, :, RES_CPU])
    mem = _used_score(total[..., 1], node_alloc[None, :, RES_MEM])
    return ((cpu + mem) // 2).float()


def balanced_resource_allocation(pod_nonzero: torch.Tensor,
                                 node_nonzero: torch.Tensor,
                                 node_alloc: torch.Tensor) -> torch.Tensor:
    """BalancedResourceAllocation (priorities.go:271-317):
    int(10 - |cpuFrac - memFrac| * 10), 0 if either fraction >= 1."""
    total = _total_nonzero(pod_nonzero, node_nonzero).float()
    cap_cpu = node_alloc[None, :, RES_CPU].float()
    cap_mem = node_alloc[None, :, RES_MEM].float()
    cpu_frac = torch.where(cap_cpu == 0, 1.0,
                           total[..., 0] / torch.clamp(cap_cpu, min=1))
    mem_frac = torch.where(cap_mem == 0, 1.0,
                           total[..., 1] / torch.clamp(cap_mem, min=1))
    diff = torch.abs(cpu_frac - mem_frac)
    score = _trunc(10.0 - diff * 10.0)
    return torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0.0, score)


def node_affinity(sel_group: torch.Tensor, sel_pref_counts: torch.Tensor,
                  schedulable: torch.Tensor,
                  max_count: "torch.Tensor | None" = None) -> torch.Tensor:
    """CalculateNodeAffinityPriority (node_affinity.go:32-86): weighted
    preferred-term match counts normalized per pod to int(10*count/max)
    over the ready nodes; all-zero when no term matches anywhere.
    ``max_count`` [P,1], when given, is that maximum taken over a wider
    node axis than these columns (a node shard of parallel/mesh.py)."""
    counts = sel_pref_counts[sel_group.long()].float()            # [P,N]
    if max_count is None:
        max_count = torch.where(schedulable[None, :], counts, 0.0) \
            .amax(dim=1, keepdim=True)
    score = _trunc(10.0 * counts / torch.clamp(max_count, min=1e-9))
    return torch.where(max_count > 0, score, 0.0)


def taint_toleration(pod_tol_prefer: torch.Tensor,
                     node_taints_prefer: torch.Tensor,
                     schedulable: torch.Tensor,
                     max_count: "torch.Tensor | None" = None
                     ) -> torch.Tensor:
    """ComputeTaintTolerationPriority (taint_toleration.go:54-105):
    int((1 - count/max)*10) over intolerable PreferNoSchedule taints, 10
    everywhere when max==0 (``max_count`` as in :func:`node_affinity`)."""
    counts = (~pod_tol_prefer).float() @ node_taints_prefer.float().T
    if max_count is None:
        max_count = torch.where(schedulable[None, :], counts, 0.0) \
            .amax(dim=1, keepdim=True)
    score = _trunc((1.0 - counts / torch.clamp(max_count, min=1e-9)) * 10.0)
    return torch.where(max_count > 0, score, 10.0)


def selector_spread(spread_group: torch.Tensor,
                    spread_node_counts: torch.Tensor,
                    spread_zone_counts: torch.Tensor,
                    spread_has_zones: torch.Tensor,
                    node_zone_id: torch.Tensor,
                    schedulable: torch.Tensor,
                    max_count: "torch.Tensor | None" = None
                    ) -> torch.Tensor:
    """SelectorSpreadPriority (selector_spreading.go:63-175): fewer
    same-selector pods is better; with zones, blend the node score 1/3
    with the zone score 2/3.  f32 throughout, as the reference
    (``max_count`` as in :func:`node_affinity`)."""
    g = spread_group.long()
    counts = spread_node_counts[g]                                # [P,N]
    zc = spread_zone_counts[g]                                    # [P,Z]
    node_has_zone = node_zone_id >= 0                             # [N]
    zcounts = zc[:, torch.clamp(node_zone_id, min=0).long()]      # [P,N]
    zcounts = torch.where(node_has_zone[None, :], zcounts, 0.0)
    has_zones = spread_has_zones[g][:, None]                      # [P,1]
    if max_count is None:
        max_count = torch.where(schedulable[None, :], counts, 0.0) \
            .amax(dim=1, keepdim=True)
    f = torch.where(max_count > 0,
                    10.0 * ((max_count - counts)
                            / torch.clamp(max_count, min=1e-9)),
                    10.0)
    max_zone = zc.amax(dim=1, keepdim=True)
    zscore = 10.0 * ((max_zone - zcounts) / torch.clamp(max_zone, min=1e-9))
    blended = f * (1.0 - 2.0 / 3.0) + (2.0 / 3.0) * zscore
    f = torch.where(has_zones & node_has_zone[None, :] & (max_zone > 0),
                    blended, f)
    return _trunc(f)


def selector_spread_node_only(spread_group: torch.Tensor,
                              spread_node_counts: torch.Tensor,
                              schedulable: torch.Tensor) -> torch.Tensor:
    """selector_spread when no group is zone-aware: only the node-count
    term remains (selector_spreading.go:137-156)."""
    counts = spread_node_counts[spread_group.long()]
    max_count = torch.where(schedulable[None, :], counts, 0.0) \
        .amax(dim=1, keepdim=True)
    f = torch.where(max_count > 0,
                    10.0 * ((max_count - counts)
                            / torch.clamp(max_count, min=1e-9)),
                    10.0)
    return _trunc(f)


# image_locality.go constants in KiB (priorities.go:199-203).
_MIN_IMG_KIB = 23 * 1024
_MAX_IMG_KIB = 1000 * 1024


def image_locality(pod_images: torch.Tensor,
                   node_image_kib: torch.Tensor) -> torch.Tensor:
    """ImageLocalityPriority (priorities.go:205-263): sum the sizes of
    the pod's images already on the node, bucketed into 0-10.  The KiB
    sums are taken in float64, exact at any matmul precision (TF32 would
    round a 123,597 KiB image to 123,584, a bucket lower)."""
    sums = (pod_images.double() @ node_image_kib.double().T) \
        .to(torch.int32)
    clamped = torch.clamp(sums, max=_MAX_IMG_KIB)
    mid = (10 * (clamped - _MIN_IMG_KIB)) // \
        (_MAX_IMG_KIB - _MIN_IMG_KIB) + 1
    score = torch.where(sums < _MIN_IMG_KIB, 0,
                        torch.where(sums >= _MAX_IMG_KIB, 10, mid))
    return score.float()


def node_label(n_pods: int, node_row: torch.Tensor) -> torch.Tensor:
    """CalculateNodeLabelPriority (priorities.go:160-197): 10 or 0 per
    node, pod-independent."""
    row = torch.where(node_row, 10.0, 0.0)
    return row[None, :].expand(n_pods, node_row.shape[0])


def node_prefer_avoid(avoid_group: torch.Tensor,
                      avoid_rows: torch.Tensor) -> torch.Tensor:
    """CalculateNodePreferAvoidPodsPriority (priorities.go:326-398): 0
    where the node's preferAvoidPods annotation names the pod's
    controller, else 10."""
    return torch.where(avoid_rows[avoid_group.long()], 0.0, 10.0)


def equal_priority(n_pods: int, n_nodes: int,
                   device: "torch.device | str" = "cpu") -> torch.Tensor:
    """EqualPriority (generic_scheduler.go:317-326): constant 1."""
    return torch.ones((n_pods, n_nodes), dtype=torch.float32, device=device)

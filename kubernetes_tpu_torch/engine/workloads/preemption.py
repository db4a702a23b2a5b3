"""Priority preemption: the second batched solve over the victim set.

Counterpart of ``kubernetes_tpu/engine/workloads/preemption.py``.  When
a priority-carrying pod fits nowhere, the scheduler asks which node
could host it after evicting some strictly-lower-priority pods, and what
the cheapest such eviction is:

* the cache reconstructs the VICTIM TABLE from its tracked (assumed +
  confirmed) pods: per node, victims sorted ascending by (priority, key)
  and padded to a power-of-two V (``SchedulerCache.victim_table``);
* ``victim_solve`` computes, for every node at once, the minimal victim
  count k whose eviction lets the pod fit — the "cluster minus victims"
  row update is the prefix sum ``requested - cumsum(victim_requests)``,
  so prefix k is exactly the k cheapest victims;
* the host picks the node minimizing (victim count, summed victim
  priority, node index).

Victims are strictly lower priority (the eligibility mask), and the
non-resource predicates must pass with the victims still present.

``victim_solve`` is a chain of torch ops on the scheduler's device with
the JAX program's int32 arithmetic (the cumulative sums keep int32, where
torch would widen to int64 by default).  It is not a Pallas kernel in the
reference, so it has no hand-written kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.features.compiler import RES_PODS
from kubernetes_tpu_torch.utils import knobs

# Victim-table width: victims per node considered, padded pow2.  Bounds
# both the solve's shape and the blast radius of one decision.
MAX_VICTIMS = knobs.get_int("KT_PREEMPT_MAX_VICTIMS")


class VictimTable(NamedTuple):
    """Per-node victim candidates (host side; see SchedulerCache
    .victim_table).  Rows sorted ascending by (priority, pod key)."""

    req: np.ndarray       # [N, V, 4] int32 (cpu, mem_mib, gpu, 1)
    prio: np.ndarray      # [N, V] int32
    valid: np.ndarray     # [N, V] bool
    keys: list            # [N] lists of pod keys, aligned with rows


@dataclass
class PreemptionDecision:
    pod_key: str
    node: str
    node_idx: int
    victims: list[str] = field(default_factory=list)
    prio_cost: int = 0


def victim_solve(alloc: torch.Tensor, requested: torch.Tensor,
                 base_ok: torch.Tensor, vic_req: torch.Tensor,
                 vic_prio: torch.Tensor, vic_valid: torch.Tensor,
                 pod_req: torch.Tensor, pod_zero: torch.Tensor,
                 pod_prio: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimal victim prefix per node: (k_min [N] int32, prio_cost [N]
    int32, feasible [N] bool).  ``alloc``/``requested`` [N,4] int32,
    ``base_ok`` [N] bool (the pod's non-resource predicate row, victims
    present), ``vic_req`` [N,V,4] int32, ``vic_prio`` [N,V] int32,
    ``vic_valid`` [N,V] bool, ``pod_req`` [4] int32, ``pod_zero`` a bool
    scalar (the zero-request escape hatch: such a pod only needs a pod
    slot) and ``pod_prio`` an int32 scalar."""
    i32 = torch.int32
    eligible = vic_valid & (vic_prio < pod_prio)                 # [N, V]
    k_elig = eligible.sum(dim=1, dtype=i32)                      # [N]
    vreq = vic_req * eligible[..., None].to(vic_req.dtype)
    cum = torch.cumsum(vreq, dim=1, dtype=i32)                   # [N, V, 4]
    cumz = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    free = alloc[:, None, :] - requested[:, None, :] + cumz      # [N, V+1, 4]
    fits_res = (pod_req[None, None, :3] <= free[..., :3]).all(dim=-1) \
        | pod_zero
    fits_pods = free[..., RES_PODS] >= 1
    ks = torch.arange(cumz.shape[1], dtype=i32, device=alloc.device)
    feasible_k = fits_res & fits_pods & \
        (ks[None, :] <= k_elig[:, None]) & base_ok[:, None]
    # First feasible k (0 where none is, as argmax of an all-false row).
    k_min = torch.argmax(feasible_k.to(torch.uint8), dim=1).to(i32)
    any_k = feasible_k.any(dim=1)
    prio_cum = torch.cat(
        [torch.zeros_like(vic_prio[:, :1]),
         torch.cumsum(vic_prio * eligible, dim=1, dtype=i32)], dim=1)
    prio_cost = torch.gather(prio_cum, 1, k_min[:, None].long())[:, 0]
    return k_min, prio_cost.to(i32), any_k


def pick_node(k_min: np.ndarray, prio_cost: np.ndarray,
              feasible: np.ndarray) -> Optional[int]:
    """argmin over (victim count, summed victim priority, node index) —
    the deterministic cost order.  None when no node is feasible even
    after evictions."""
    idx = np.flatnonzero(np.asarray(feasible, bool))
    if idx.size == 0:
        return None
    k = np.asarray(k_min)[idx]
    c = np.asarray(prio_cost)[idx]
    order = np.lexsort((idx, c, k))
    return int(idx[order[0]])


def padded_width(v: int = 0) -> int:
    """The victim axis as ``SchedulerCache.victim_table`` pads it."""
    v = v or MAX_VICTIMS
    return 1 << max(v - 1, 0).bit_length()


def prewarm_shapes(n_nodes: int, device: "torch.device | str",
                   v: int = 0) -> None:
    """Launch ``victim_solve`` once at the cluster's (N, V) shape, so the
    first live preemption pays no first-launch cost (kernel loading,
    allocator growth)."""
    v = padded_width(v)
    n = max(n_nodes, 1)
    z = lambda *shape, dt=torch.int32: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=device)
    out = victim_solve(z(n, 4), z(n, 4), z(n, dt=torch.bool), z(n, v, 4),
                       z(n, v), z(n, v, dt=torch.bool), z(4),
                       torch.tensor(False, device=device),
                       torch.tensor(0, dtype=torch.int32, device=device))
    out[0].cpu()

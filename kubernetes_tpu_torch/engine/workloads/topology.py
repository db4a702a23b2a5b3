"""Topology-aware spread: ``topologySpreadConstraints`` as mask/score
planes over the cluster topology tensor.

Counterpart of ``kubernetes_tpu/engine/workloads/topology.py``.  Every
node row of ``DeviceCluster.topo_dom`` holds the compact domain id of
each interned topology label key (-1 = the node lacks the label): the
compressed encoding of the (nodes x topology_domains) one-hot, which the
planes expand per constraint term by gather (the full one-hot would be
O(N x D), and hostname-keyed domains make D ~ N).

A batch's constraints compile to per-TERM tables (one term per distinct
(namespace, selector, topologyKey, maxSkew, whenUnsatisfiable)
signature, shared by every pod carrying it):

    key_col [T]    column of topo_dom the term reads
    max_skew [T]   admissible count spread above the least-loaded domain
    hard [T]       DoNotSchedule (mask plane) vs ScheduleAnyway (score)
    counts [T, D]  matching-pod count per domain at batch start
    valid [T, D]   domain exists among schedulable nodes (min runs here)
    src [P, T]     pod p carries term t

``spread_planes`` contracts these against ``topo_dom`` into a [P, N]
hard mask (placing must not push the domain more than max_skew above the
global minimum; nodes lacking the key fail hard terms) and a [P, N] soft
score (negative skew delta).  Counts are snapshotted at batch START:
in-batch placements of the same spread group do not move them mid-scan.

The planes are row-separable (row p reads only ``src[p]``), so
:class:`TermPlanes` computes the [T, N] term planes once per batch and
contracts any row range of ``src`` on demand: the streamed drain builds
each chunk's rows on the device and never holds the whole [P, N] planes.
The two ``[P, T] @ [T, N]`` contractions sum whole numbers; they run in
float64 so TF32 (``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision``), which keeps integers exact only
up to 2,048, can never round them.  Every value they produce is exact
while a domain's count stays below 2^24, where the JAX package's f32
contraction is exact too.

The JAX package's ``spread_planes_host`` belongs to its host fallback
engine (``engine/hostsolver.py``), which this package does not have
(the guard surfaces faults instead), so it is not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api import types as api


class SpreadTerms(NamedTuple):
    """Host-side term tables (uploaded by :class:`TermPlanes`)."""

    key_col: np.ndarray    # [T] int32
    max_skew: np.ndarray   # [T] float32
    hard: np.ndarray       # [T] bool
    counts: np.ndarray     # [T, D] float32
    valid: np.ndarray      # [T, D] bool
    src: np.ndarray        # [P, T] bool
    any_hard: bool
    any_soft: bool


def _pow2(n: int, floor: int = 1) -> int:
    return max(1 << max(n - 1, 0).bit_length(), floor)


def batch_has_spread(pods: Sequence) -> bool:
    return any(api.TOPOLOGY_SPREAD_ANNOTATION_KEY in pod.annotations
               for pod in pods)


def spread_topology_keys(pods: Sequence) -> set[str]:
    """Topology keys named by any constraint in the batch — the engine
    interns these (cache.ensure_topo_key) BEFORE the snapshot so the
    topo_dom columns exist."""
    keys: set[str] = set()
    for pod in pods:
        if api.TOPOLOGY_SPREAD_ANNOTATION_KEY in pod.annotations:
            for tsc in pod.topology_spread_constraints():
                if tsc.topology_key:
                    keys.add(tsc.topology_key)
    return keys


def compile_terms(pods: Sequence, nt: object, space: object,
                  domain_counts_bulk: Callable[[list],
                                               list[dict[int, int]]]
                  ) -> Optional[SpreadTerms]:
    """Build the per-term tables for a batch (None when no pod carries a
    constraint).  ``domain_counts_bulk([(namespace, selector,
    key_col)])`` is the cache's domain bookkeeping
    (SchedulerCache.topo_domain_counts_bulk): matching tracked-pod count
    per domain id for every term in ONE pod walk, assumed pods included.

    T and D are padded to powers of two, as the JAX package pads them."""
    p = len(pods)
    term_of: dict[tuple, int] = {}
    rows: list[tuple] = []   # (key_col, max_skew, hard, ns, selector)
    src_pairs: list[tuple[int, int]] = []
    for i, pod in enumerate(pods):
        if api.TOPOLOGY_SPREAD_ANNOTATION_KEY not in pod.annotations:
            continue
        for tsc in pod.topology_spread_constraints():
            col = space.topo_keys.get(tsc.topology_key)
            if col < 0:
                continue  # key never interned: no node can carry it yet
            sel = tsc.label_selector
            sig = (pod.namespace, col, tsc.max_skew, tsc.hard,
                   sel if sel is not None else ("__self__",
                                                tuple(sorted(
                                                    pod.labels.items()))))
            ti = term_of.get(sig)
            if ti is None:
                ti = len(rows)
                term_of[sig] = ti
                # A nil selector spreads the pod's own label set (the
                # common "spread my replicas" shorthand).
                eff_sel = sel if sel is not None else api.LabelSelector(
                    match_labels=tuple(sorted(pod.labels.items())))
                rows.append((col, tsc.max_skew, tsc.hard, pod.namespace,
                             eff_sel))
            src_pairs.append((i, ti))
    if not rows:
        return None
    t_cap = _pow2(len(rows))
    d_cap = _pow2(max(len(space.topo_vals), 1), floor=8)
    key_col = np.zeros(t_cap, np.int32)
    max_skew = np.full(t_cap, np.float32(1e9))  # pad terms constrain nothing
    hard = np.zeros(t_cap, bool)
    counts = np.zeros((t_cap, d_cap), np.float32)
    valid = np.zeros((t_cap, d_cap), bool)
    src = np.zeros((p, t_cap), bool)
    sched = np.asarray(nt.schedulable, bool)
    all_counts = domain_counts_bulk(
        [(ns, sel, col) for col, _, _, ns, sel in rows])
    for ti, (col, skew, is_hard, ns, sel) in enumerate(rows):
        key_col[ti] = col
        max_skew[ti] = skew
        hard[ti] = is_hard
        doms = nt.topo_val[sched, col]
        for d in np.unique(doms[doms >= 0]):
            valid[ti, int(d)] = True
        for dom, cnt in all_counts[ti].items():
            if 0 <= dom < d_cap:
                counts[ti, dom] = cnt
    for i, ti in enumerate(src_pairs):
        src[ti[0], ti[1]] = True
    return SpreadTerms(key_col, max_skew, hard, counts, valid, src,
                       any_hard=bool(hard.any()),
                       any_soft=bool((~hard[: len(rows)]).any()))


def term_planes(key_col: torch.Tensor, max_skew: torch.Tensor,
                hard: torch.Tensor, counts: torch.Tensor,
                valid: torch.Tensor, topo_dom: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The [T, N] term planes of ``_planes_kernel``: (hard violation,
    soft score), both f32.  The per-term one-hot expansion is a gather
    (``counts[t, dom[n, key_col[t]]]``), never O(N x D)."""
    dom_tn = topo_dom.index_select(1, key_col.long()).T      # [T, N]
    cnt_tn = torch.gather(counts, 1, torch.clamp(dom_tn, min=0).long())
    big = 1e9
    min_t = torch.where(valid, counts, big).amin(dim=1)
    min_t = torch.where(min_t >= big, 0.0, min_t)            # no valid domain
    has = dom_tn >= 0
    ok = (cnt_tn + 1.0 - min_t[:, None]) <= max_skew[:, None]
    viol_tn = ((~has) | ~ok).to(torch.float32)
    hard_viol = viol_tn * hard.to(torch.float32)[:, None]
    soft_tn = torch.where((~hard)[:, None] & has,
                          -(cnt_tn - min_t[:, None]), 0.0)
    return hard_viol, soft_tn


def contract(src: torch.Tensor, hard_viol: torch.Tensor,
             soft_tn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, N] (mask, score) of the ``src`` rows [R, T]: the two
    ``[R, T] @ [T, N]`` contractions, in float64 (whole numbers, so the
    f32 result is the exactly rounded sum; no TF32)."""
    srcd = src.to(torch.float64)
    mask = (srcd @ hard_viol.to(torch.float64)) < 0.5
    score = (srcd @ soft_tn.to(torch.float64)).to(torch.float32)
    return mask, score


class TermPlanes:
    """A batch's term planes on the device, contracted per row range.

    ``rows(start, stop)`` gives the (extra_mask, score_bias) planes of
    pods ``[start, stop)``, None for a plane no term populates (the scan
    then leaves it out).  The stream's pad pods are part of the batch
    and carry no constraint."""

    def __init__(self, terms: SpreadTerms, topo_dom: torch.Tensor):
        dev = topo_dom.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.terms = terms
        self.src = put(terms.src)
        self.hard_viol, self.soft_tn = term_planes(
            put(terms.key_col), put(terms.max_skew), put(terms.hard),
            put(terms.counts), put(terms.valid), topo_dom)

    def rows(self, start: int = 0, stop: Optional[int] = None
             ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        mask, score = contract(self.src[start:stop], self.hard_viol,
                               self.soft_tn)
        return (mask if self.terms.any_hard else None,
                score if self.terms.any_soft else None)


def spread_planes(terms: SpreadTerms, topo_dom: torch.Tensor
                  ) -> tuple[Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """(extra_mask, score_bias) [P, N] planes for the solver — None for a
    plane no term populates."""
    return TermPlanes(terms, topo_dom).rows()

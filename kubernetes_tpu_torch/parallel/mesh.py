"""Node-axis sharding of the scheduling planes, the combines written by
hand.

Counterpart of the JAX package's ``parallel/mesh.py``.  There every
``[*, N]`` tensor is ``device_put`` with a ``NamedSharding`` over a
``nodes`` mesh axis (the ``[P, *]`` pod tensors optionally over a
``batch`` axis) and XLA inserts the collectives.  Here a mesh is a grid
of torch devices, every computation runs per shard, and each combine is
written out:

* per-node work (every predicate, every per-node priority, the carried
  aggregates and their one-row commits) runs on the shard that holds the
  node: per-node sums stay per shard;
* a per-pod maximum or minimum over the nodes (the normalizing
  priorities, the carried spread maxima, the price iteration's span and
  least free capacity) is the max or min of the shards' partials;
* selectHost is the max across the shards, the shards' tie counts
  summed in node order, and the round-robin pick made by the shard that
  holds the ``counter % ties``-th tie;
* an argmax over the nodes (the price iteration's bids) is the first
  shard holding the maximum; a top-2 is the top-2 of the shards' top-2s;
* what a placement changes beyond its node's row (the zone and service
  anti-affinity counts, the inter-pod topology rows) needs the placed
  node's columns, which the shard holding the node hands to the others.

On one card every shard lies on ``cuda:0``; with more cards shard i lies
on ``cuda:i``.  The results equal the unsharded solver's bit for bit
(tests/test_torch_mesh.py holds them to the JAX package's unsharded
results; ``dryrun_multichip`` checks them on a device).  The scan runs
as torch ops (the step loop's families), never the scan kernel: the
kernel is one thread-block cluster over the whole node axis.
"""

from __future__ import annotations

import functools
import json
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.engine import solver as sv
from kubernetes_tpu_torch.engine.solver import (DeviceBatch, DeviceCluster,
                                                Solver)
from kubernetes_tpu_torch.features.compiler import RES_PODS
from kubernetes_tpu_torch.ops import interpod
from kubernetes_tpu_torch.ops import priorities as prio
from kubernetes_tpu_torch.utils import device as device_mod

BATCH_AXIS = "batch"
NODE_AXIS = "nodes"
_MASK32 = 0xFFFFFFFF
_NEG = float("-inf")


@dataclass(frozen=True)
class Mesh:
    """A (batch, nodes) grid of devices, row-major as the JAX mesh's
    device array: ``devices[i * nodes + j]`` holds pod shard i's node
    shard j."""

    devices: tuple
    batch: int = 1

    @property
    def nodes(self) -> int:
        return len(self.devices) // self.batch

    def row(self, i: int = 0) -> tuple:
        """The devices of pod shard ``i``, one per node shard."""
        return self.devices[i * self.nodes:(i + 1) * self.nodes]

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: self.batch, NODE_AXIS: self.nodes}


def make_mesh(n_devices: int = 0, batch: int = 1,
              device: "torch.device | str" = "cuda") -> Mesh:
    """A 1D node-sharded mesh of ``n_devices`` shards (default: one per
    card), or a (batch, nodes) one for the one-shot evaluate.  Shard i
    lies on ``cuda:(i mod the card count)``: all on ``cuda:0`` on one
    card.  ``device="cpu"`` puts every shard on the CPU."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        k = n_devices or cards
        devs = tuple(torch.device("cuda", i % cards) for i in range(k))
    else:
        k = n_devices or 1
        devs = (dev,) * k
    if k < 1 or k % batch:
        raise ValueError(f"mesh: {k} devices do not split into a batch "
                         f"axis of {batch}")
    return Mesh(devs, batch)


def node_bounds(n: int, shards: int) -> list[tuple[int, int]]:
    """[lo, hi) of each shard: the first ``n % shards`` shards hold one
    node more (N need not divide by the shard count)."""
    if not 1 <= shards <= max(n, 1):
        raise ValueError(f"mesh: {shards} shards over {n} rows")
    base, extra = divmod(n, shards)
    out, lo = [], 0
    for i in range(shards):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


# -- placing the planes -------------------------------------------------

# Which fields carry the node axis, and on which dim (every DeviceCluster
# field on dim 0).  The rest are pod-axis or replicated.
_BATCH_NODE_DIM0 = ("node_zone_id",)
_BATCH_NODE_DIM1 = ("sel_required", "sel_pref_counts", "spread_node_counts",
                    "avoid_rows")
_AFF_NODE_DIM1 = ("node_dom", "match_cnt", "decl_reach", "sym_cnt")
_VS_NODE_DIM0 = ("pd_node_ebs", "pd_node_extra_ebs", "pd_node_err_ebs",
                 "pd_node_gce", "pd_node_extra_gce", "pd_node_err_gce",
                 "nl_pred_row")
_VS_NODE_DIM1 = ("vz_mask", "sa_mask", "saa_dom", "saa_labeled",
                 "nl_prio_rows")


def _move(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(*[_move(v, dev) for v in tree])


def _cut(tup, dim0: Sequence[str], dim1: Sequence[str], lo: int, hi: int,
         n: int):
    upd = {}
    for dim, names in ((0, dim0), (1, dim1)):
        for f in names:
            t = getattr(tup, f)
            if t.shape[dim] != n:
                raise ValueError(f"mesh: {f} {tuple(t.shape)} has no "
                                 f"{n}-node axis on dim {dim}")
            upd[f] = t.narrow(dim, lo, hi - lo)
    return tup._replace(**upd)


def shard_cluster(c: DeviceCluster, bounds: list, devices: Sequence
                  ) -> list[DeviceCluster]:
    """Every cluster plane cut along its node axis, shard j on
    ``devices[j]``."""
    return [DeviceCluster(*[a[lo:hi].to(d) for a in c])
            for (lo, hi), d in zip(bounds, devices)]


def shard_batch(b: DeviceBatch, bounds: list, devices: Sequence
                ) -> list[DeviceBatch]:
    """The batch's node-axis tables cut like the cluster (its pod-axis
    and replicated tensors whole), shard j on ``devices[j]``.  A pod
    pinned by ``spec.nodeName`` keeps its node's index within the shard
    that holds it, and names no node (-2) in the others."""
    n = bounds[-1][1]
    out = []
    for (lo, hi), dev in zip(bounds, devices):
        h = b.host_idx
        host = torch.where(h < 0, h, torch.where((h >= lo) & (h < hi),
                                                 h - lo, -2))
        bs = _cut(b, _BATCH_NODE_DIM0, _BATCH_NODE_DIM1, lo, hi, n)._replace(
            host_idx=host,
            aff=_cut(b.aff, (), _AFF_NODE_DIM1, lo, hi, n),
            volsvc=_cut(b.volsvc, _VS_NODE_DIM0, _VS_NODE_DIM1, lo, hi, n))
        out.append(_move(bs, dev))
    return out


# -- the combines -------------------------------------------------------

def _reduce(parts: list, op, dev) -> torch.Tensor:
    return functools.reduce(op, [t.to(dev) for t in parts])


def _pick(vals: list, touch: list, dev) -> torch.Tensor:
    """The value of the one shard whose ``touch`` is set (shard 0's when
    it is): a placed node's column, handed to every shard."""
    out = vals[0].to(dev)
    for v, t in zip(vals[1:], touch[1:]):
        out = torch.where(t.to(dev), v.to(dev), out)
    return out


_NORMALIZED = ("NodeAffinityPriority", "TaintTolerationPriority",
               "SelectorSpreadPriority", "ServiceSpreadingPriority",
               "InterPodAffinityPriority")


def _stats(name: str, bs: list, cs: list, dev) -> Optional[tuple]:
    """The per-pod statistics over ALL nodes that a normalizing priority
    needs, from the shards' partials; None for a per-node priority."""
    if name not in _NORMALIZED:
        return None
    parts = []
    for b, c in zip(bs, cs):
        sched = c.schedulable[None, :]
        if name == "InterPodAffinityPriority":
            a = b.aff
            counts = interpod.priority_counts(a.pref_w, a.match_cnt,
                                              a.sym_match, a.sym_w,
                                              a.sym_cnt)
            parts.append((torch.where(sched, counts, _NEG).amax(dim=1),
                          torch.where(sched, counts, -_NEG).amin(dim=1)))
            continue
        if name == "NodeAffinityPriority":
            counts = b.sel_pref_counts[b.sel_group.long()].float()
        elif name == "TaintTolerationPriority":
            counts = (~b.tol_prefer).float() @ c.taints_prefer.float().T
        else:
            counts = b.spread_node_counts[b.spread_group.long()]
        parts.append((torch.where(sched, counts, 0.0)
                      .amax(dim=1, keepdim=True),))
    out = (_reduce([p[0] for p in parts], torch.maximum, dev),)
    if name == "InterPodAffinityPriority":
        out += (_reduce([p[1] for p in parts], torch.minimum, dev),)
    return out


def _plane(name: str, b: DeviceBatch, c: DeviceCluster, aux: int,
           stats: Optional[tuple]) -> torch.Tensor:
    """One shard's [P, N_shard] plane of priority ``name``."""
    n = c.alloc.shape[0]
    if stats is None:
        return sv._priority_plane(name, b, c, n, {"aux": aux})
    stats = tuple(s.to(c.alloc.device) for s in stats)
    if name == "NodeAffinityPriority":
        return prio.node_affinity(b.sel_group, b.sel_pref_counts,
                                  c.schedulable, max_count=stats[0])
    if name == "TaintTolerationPriority":
        return prio.taint_toleration(b.tol_prefer, c.taints_prefer,
                                     c.schedulable, max_count=stats[0])
    if name == "InterPodAffinityPriority":
        a = b.aff
        counts = interpod.priority_counts(a.pref_w, a.match_cnt,
                                          a.sym_match, a.sym_w, a.sym_cnt)
        return interpod.priority_score(counts, c.schedulable, prio._trunc,
                                       bounds=stats)
    return prio.selector_spread(b.spread_group, b.spread_node_counts,
                                b.spread_zone_counts, b.spread_has_zones,
                                b.node_zone_id, c.schedulable,
                                max_count=stats[0])


# -- the one-shot evaluate ----------------------------------------------

def evaluate(solver: Solver, b: DeviceBatch, c: DeviceCluster, mesh: Mesh,
             flags: sv.BatchFlags = sv.ALL_ON_FLAGS
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``Solver.evaluate`` with pods over the batch axis and nodes over
    the node axis: (feasible [P, N], scores [P, N]) gathered on the
    mesh's first device."""
    n, p = c.alloc.shape[0], b.request.shape[0]
    nb = node_bounds(n, mesh.nodes)
    d0 = mesh.devices[0]
    feas_rows, score_rows = [], []
    for i, (plo, phi) in enumerate(node_bounds(p, mesh.batch)):
        devs = mesh.row(i)
        feas, scores = _evaluate_shards(
            solver, shard_batch(sv.slice_pod_axis(b, plo, phi), nb, devs),
            shard_cluster(c, nb, devs), flags, d0)
        feas_rows.append(torch.cat([f.to(d0) for f in feas], dim=1))
        score_rows.append(torch.cat([s.to(d0) for s in scores], dim=1))
    return torch.cat(feas_rows), torch.cat(score_rows)


def _evaluate_shards(solver: Solver, bs: list, cs: list,
                     flags: sv.BatchFlags, dev) -> tuple[list, list]:
    """Each node shard's (feasible, scores) of one pod range, the
    normalizing priorities' statistics combined on ``dev``."""
    skips = solver.evaluate_skips(flags)
    feas, scores = [], []
    for bj, cj in zip(bs, cs):
        p, nj = bj.request.shape[0], cj.alloc.shape[0]
        f = cj.schedulable[None, :].expand(p, nj).contiguous()
        for name in solver.predicate_names:
            if name not in skips:
                f = f & sv._predicate_mask(name, bj, cj, nj, solver.extra)
        feas.append(f)
        scores.append(torch.zeros((p, nj), dtype=torch.float32,
                                  device=cj.alloc.device))
    for name, weight, aux in solver.evaluate_priorities(flags):
        st = _stats(name, bs, cs, dev)
        for j, (bj, cj) in enumerate(zip(bs, cs)):
            scores[j] = scores[j] + float(weight) * \
                _plane(name, bj, cj, aux, st)
    return feas, scores


# -- the sequential-greedy scan -----------------------------------------

def _select(rows: list, counter: torch.Tensor, bounds: list, dev
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """selectHost over the shards' rows: (choice [1] int32 global, ties
    [1] int32), as ``engine/fused.py:select_plain`` over the whole row."""
    i32 = torch.int32
    mx = _reduce([r.amax() for r in rows], torch.maximum, dev)
    finite = torch.isfinite(mx)
    ties = [(r == mx.to(r.device)) & finite.to(r.device) for r in rows]
    counts = [t.sum(dtype=i32).to(dev) for t in ties]
    n_raw = functools.reduce(torch.add, counts).reshape(1)
    ix = (counter & _MASK32) % torch.clamp(n_raw, min=1).to(torch.int64)
    choice = torch.full((1,), -1, dtype=i32, device=dev)
    before = torch.zeros((), dtype=i32, device=dev)
    for t, cnt, (lo, hi) in zip(ties, counts, bounds):
        d = t.device
        rank = torch.cumsum(t.to(i32), 0, dtype=i32) + before.to(d)
        pick = t & (rank == (ix.to(d) + 1))
        col = torch.arange(lo, hi, dtype=i32, device=d)
        choice = torch.maximum(choice, torch.where(pick, col, -1).amax()
                               .to(dev))
        before = before + cnt
    return torch.where(n_raw > 0, choice, -1), n_raw


class _Shards:
    """The shards of one scan: their planes and carried state, and the
    replicated state on the mesh's first device."""

    def __init__(self, solver: Solver, b: DeviceBatch, c: DeviceCluster,
                 mesh: Mesh, flags: sv.BatchFlags):
        self.solver, self.b, self.flags = solver, b, flags
        self.n = c.alloc.shape[0]
        self.bounds = node_bounds(self.n, mesh.nodes)
        self.devs = mesh.row(0)
        self.d0 = self.devs[0]
        self.bs = shard_batch(b, self.bounds, self.devs)
        self.cs = shard_cluster(c, self.bounds, self.devs)

    def stats(self, name: str) -> Optional[tuple]:
        return _stats(name, self.bs, self.cs, self.d0)


def solve_sequential(solver: Solver, b: DeviceBatch, c: DeviceCluster,
                     last_node_index: torch.Tensor, mesh: Mesh,
                     flags: sv.BatchFlags = sv.ALL_ON_FLAGS,
                     score_bias: Optional[torch.Tensor] = None,
                     live: Optional[torch.Tensor] = None,
                     extra_mask: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``Solver._solve_scan`` with the node axis sharded (the pod axis is
    the scan's and stays whole): (choices [P] int32, counter [1] int64,
    final state with ``packed`` [N, 6] gathered).  The same families as
    the step loop, step for step."""
    sh = _Shards(solver, b, c, mesh, flags)
    in_scan_preds, static_prios, dynamic_prios, fams = \
        solver.scan_layout(flags)
    p = b.request.shape[0]
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    d0 = sh.d0

    # The hoist: each shard's encoded static plane.
    masks, scores = [], []
    for (lo, hi), bj, cj in zip(sh.bounds, sh.bs, sh.cs):
        dev, nj = cj.alloc.device, hi - lo
        m = cj.schedulable[None, :].expand(p, nj)
        for name in solver.predicate_names:
            if name not in in_scan_preds:
                m = m & sv._predicate_mask(name, bj, cj, nj, solver.extra)
        if live is not None:
            m = m & live.to(dev)[:, None]
        if extra_mask is not None:
            m = m & extra_mask[:, lo:hi].to(dev)
        masks.append(m)
        scores.append(score_bias[:, lo:hi].to(dev)
                      if score_bias is not None else
                      torch.zeros((p, nj), dtype=f32, device=dev))
    for name, weight, aux in static_prios:
        st = sh.stats(name)
        for j, (bj, cj) in enumerate(zip(sh.bs, sh.cs)):
            scores[j] = scores[j] + float(weight) * \
                _plane(name, bj, cj, aux, st)
    weight_bound = sum(abs(w) for _n, w, _a in solver.priority_specs) \
        * prio.MAX_PRIORITY
    encs = []
    for m, s in zip(masks, scores):
        enc = torch.where(m, s, _NEG)
        if score_bias is None and weight_bound < 2048:
            enc = enc.to(solver._half_dtype)
        encs.append(enc)
    half = encs[0].dtype != f32

    tmpl_prios = tuple(sp for sp in dynamic_prios
                       if sp[0] in Solver._TEMPLATE_PRIOS)
    other_prios = tuple(sp for sp in dynamic_prios
                        if sp[0] not in Solver._TEMPLATE_PRIOS)
    use_templates = bool(tmpl_prios) and b.nz_templates.shape[0] > 0
    if not use_templates:
        other_prios, tmpl_prios = dynamic_prios, ()
    st = _init_state(solver, sh, fams, tmpl_prios, use_templates,
                     last_node_index)
    counter = st["counter"]
    req6 = torch.cat([b.request, b.nonzero], dim=1)
    outs = []
    for i in range(p):
        rows = []
        for j, enc in enumerate(encs):
            row = enc[i].to(f32) if half else enc[i]
            if use_templates:
                row = row + st["D"][j].index_select(
                    0, st["tmpl"][j][i:i + 1])[0]
            rows.append(row)
        for name, weight, aux in other_prios:
            planes = _step_planes(name, aux, i, sh, st, fams)
            rows = [sv._add_weighted(r, weight, pl)
                    for r, pl in zip(rows, planes)]
        rows = _step_feasible(i, rows, sh, st, fams)
        choice, n_ties = _select(rows, counter, sh.bounds, d0)
        outs.append(choice)
        _commit(i, choice, sh, st, fams, tmpl_prios, use_templates, req6)
        counter = counter + (n_ties > 0).to(i64)

    st["counter"] = counter & _MASK32
    choices = torch.cat(outs) if outs else \
        torch.empty(0, dtype=i32, device=d0)
    final = {"packed": torch.cat([t.to(d0) for t in st["packed"]])}
    for key in ("ports_used", "vol_any", "vol_rw"):
        if key in st:
            final[key] = torch.cat([t.to(d0) for t in st[key]])
    return choices, st["counter"], final


def _init_state(solver: Solver, sh: _Shards, fams: dict, tmpl_prios: tuple,
                use_templates: bool, last_node_index: torch.Tensor) -> dict:
    """The scan's carried state: per shard (lists) where the step loop's
    is per node, once (on the first device) where it is replicated."""
    b, d0 = sh.b, sh.d0
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    st: dict = {
        "packed": [torch.cat([cj.requested, cj.nonzero], dim=1)
                   for cj in sh.cs],
        "counter": last_node_index.to(device=d0, dtype=i64).reshape(1)
        .clone(),
    }
    if use_templates:
        st["D"] = []
        for bj, cj in zip(sh.bs, sh.cs):
            D0 = torch.zeros((bj.nz_templates.shape[0], cj.alloc.shape[0]),
                             dtype=f32, device=cj.alloc.device)
            for name, weight, _aux in tmpl_prios:
                fn = {"LeastRequestedPriority": prio.least_requested,
                      "MostRequestedPriority": prio.most_requested,
                      "BalancedResourceAllocation":
                          prio.balanced_resource_allocation}[name]
                D0 = sv._add_weighted(D0, weight, fn(
                    bj.nz_templates, cj.nonzero, cj.alloc))
            st["D"].append(D0)
        st["tmpl"] = [bj.nz_tmpl_idx.to(i64) for bj in sh.bs]
    if fams["use_ports"]:
        st["ports_used"] = [cj.ports_used.clone() for cj in sh.cs]
    if fams["use_volumes"]:
        st["vol_any"] = [cj.vol_any.clone() for cj in sh.cs]
        st["vol_rw"] = [cj.vol_rw.clone() for cj in sh.cs]
    if fams["track_spread"]:
        st["sp_node"] = [bj.spread_node_counts.clone() for bj in sh.bs]
        st["sp_zone"] = b.spread_zone_counts.to(d0).clone()
        st["sp_maxn"] = _reduce(
            [torch.where(cj.schedulable[None, :], bj.spread_node_counts,
                         0.0).amax(dim=1) for bj, cj in zip(sh.bs, sh.cs)],
            torch.maximum, d0)
        st["sp_maxz"] = b.spread_zone_counts.to(d0).amax(dim=1)
    if fams["track_affinity"]:
        a = b.aff
        st["match_cnt"] = [bj.aff.match_cnt.clone() for bj in sh.bs]
        st["match_total"] = a.match_total.to(d0).clone()
        st["decl_reach"] = [bj.aff.decl_reach.clone() for bj in sh.bs]
        st["sym_cnt"] = [bj.aff.sym_cnt.clone() for bj in sh.bs]
    if fams["track_saa"]:
        st["saa_cnt"] = b.volsvc.saa_cnt.to(d0).clone()
        st["saa_num"] = b.volsvc.saa_num.to(d0).clone()
        st["dom_ids"] = torch.arange(st["saa_cnt"].shape[2], dtype=i32,
                                     device=d0)
    for fam in ("ebs", "gce"):
        if fams[f"use_max_{fam}"]:
            st[f"pd_{fam}"] = [getattr(bj.volsvc, f"pd_node_{fam}").clone()
                               for bj in sh.bs]
    return st


def _step_planes(name: str, aux: int, i: int, sh: _Shards, st: dict,
                 fams: dict) -> list:
    """Each shard's [N_shard] plane of dynamic priority ``name`` for pod
    ``i`` (the step loop's expressions, per shard)."""
    b = sh.b
    out = []
    if name == "InterPodAffinityPriority":
        a = b.aff
        counts = [interpod.priority_counts(
            a.pref_w[i:i + 1].to(cj.alloc.device), mc,
            a.sym_match[i:i + 1].to(cj.alloc.device),
            a.sym_w.to(cj.alloc.device), sc)
            for cj, mc, sc in zip(sh.cs, st["match_cnt"], st["sym_cnt"])]
        bounds = (
            _reduce([torch.where(cj.schedulable[None, :], k, _NEG)
                     .amax(dim=1) for cj, k in zip(sh.cs, counts)],
                    torch.maximum, sh.d0),
            _reduce([torch.where(cj.schedulable[None, :], k, -_NEG)
                     .amin(dim=1) for cj, k in zip(sh.cs, counts)],
                    torch.minimum, sh.d0))
        return [interpod.priority_score(
            k, cj.schedulable, prio._trunc,
            bounds=tuple(x.to(cj.alloc.device) for x in bounds))[0]
            for cj, k in zip(sh.cs, counts)]
    for j, (bj, cj) in enumerate(zip(sh.bs, sh.cs)):
        dev = cj.alloc.device
        packed = st["packed"][j]
        if name == "LeastRequestedPriority":
            plane = prio.least_requested(bj.nonzero[i:i + 1],
                                         packed[:, 4:6], cj.alloc)[0]
        elif name == "MostRequestedPriority":
            plane = prio.most_requested(bj.nonzero[i:i + 1],
                                        packed[:, 4:6], cj.alloc)[0]
        elif name == "BalancedResourceAllocation":
            plane = prio.balanced_resource_allocation(
                bj.nonzero[i:i + 1], packed[:, 4:6], cj.alloc)[0]
        elif name in ("SelectorSpreadPriority", "ServiceSpreadingPriority"):
            g = bj.spread_group[i:i + 1].to(torch.int64)
            counts_g = st["sp_node"][j].index_select(0, g)[0]
            maxn_g = st["sp_maxn"].to(dev).index_select(0, g)
            fsc = torch.where(
                maxn_g > 0,
                10.0 * ((maxn_g - counts_g)
                        / torch.clamp(maxn_g, min=1e-9)), 10.0)
            if fams["track_spread_zones"]:
                zone_ids = bj.node_zone_id
                node_has_zone = zone_ids >= 0
                zone_clip = torch.clamp(zone_ids, min=0).to(torch.int64)
                zc_g = st["sp_zone"].to(dev).index_select(0, g)[0]
                maxz_g = st["sp_maxz"].to(dev).index_select(0, g)
                zs_z = 10.0 * ((maxz_g - zc_g)
                               / torch.clamp(maxz_g, min=1e-9))
                zs_n = torch.where(
                    node_has_zone, zs_z.index_select(0, zone_clip),
                    10.0 * (maxz_g / torch.clamp(maxz_g, min=1e-9)))
                blended = fsc * (1.0 - 2.0 / 3.0) + (2.0 / 3.0) * zs_n
                fsc = torch.where(
                    bj.spread_has_zones.index_select(0, g)
                    & node_has_zone & (maxz_g > 0), blended, fsc)
            plane = prio._trunc(fsc)
        elif name == "ServiceAntiAffinityPriority":
            vs = bj.volsvc
            gy = vs.saa_group[i:i + 1].to(torch.int64)
            plane = sv.saa_plane(
                st["saa_cnt"].to(dev)[aux].index_select(0, gy),
                st["saa_num"].to(dev).index_select(0, gy)[:, None],
                vs.saa_dom[aux], vs.saa_labeled[aux])[0]
        else:
            raise KeyError(f"unknown dynamic priority {name!r}")
        out.append(plane)
    return out


def _also(cond: torch.Tensor, ok: Optional[torch.Tensor]) -> torch.Tensor:
    return cond if ok is None else (ok & cond)


def _step_feasible(i: int, rows: list, sh: _Shards, st: dict,
                   fams: dict) -> list:
    """The dynamic predicates folded into each shard's row."""
    f32 = torch.float32
    out = []
    for j, (row, bj, cj) in enumerate(zip(rows, sh.bs, sh.cs)):
        dev = cj.alloc.device
        ok = None

        if fams["use_resources"]:
            packed = st["packed"][j]
            fits_pods = (packed[:, RES_PODS] + 1) <= cj.alloc[:, RES_PODS]
            free = cj.alloc[:, :3] - packed[:, :3]
            fits_res = torch.all(bj.request[i, :3][None, :] <= free, dim=-1)
            ok = _also(fits_pods & (bj.zero_request[i] | fits_res), ok)
        if fams["use_ports"]:
            ok = _also(~(st["ports_used"][j] & bj.ports[i][None, :])
                      .any(dim=1), ok)
        if fams["use_volumes"]:
            conflict = (st["vol_any"][j] & bj.vol_rw[i][None, :]).any(dim=1) \
                | (st["vol_rw"][j] & bj.vol_ro[i][None, :]).any(dim=1)
            ok = _also(~conflict, ok)
        vs = bj.volsvc
        for fam in ("ebs", "gce"):
            if not fams[f"use_max_{fam}"]:
                continue
            pd_node = st[f"pd_{fam}"][j].to(f32)
            pod_row = getattr(vs, f"pd_pod_{fam}")[i].to(f32)
            overlap = pd_node @ pod_row
            new = pod_row.sum() + getattr(vs, f"pd_extra_{fam}")[i].to(f32)
            total = pd_node.sum(dim=1) + \
                getattr(vs, f"pd_node_extra_{fam}").to(f32) + new - overlap
            fits = (total <= float(sh.solver.extra[f"max_{fam}"])) & \
                ~getattr(vs, f"pd_node_err_{fam}")
            ok = _also((new == 0) | fits, ok)
        if fams["use_interpod"]:
            a = bj.aff
            reach = st["match_cnt"][j] > 0.0
            live_need = a.aff_need[i] & ~(
                a.aff_self[i] & (st["match_total"].to(dev) == 0.0))
            viol = (live_need.to(f32) @ (~reach).to(f32)
                    + a.anti_need[i].to(f32) @ reach.to(f32)
                    + a.decl_match[i].to(f32)
                    @ st["decl_reach"][j].to(f32)) > 0
            ok = _also(~viol, ok)
        out.append(row if ok is None else torch.where(ok, row, _NEG))
    return out


def _commit(i: int, choice: torch.Tensor, sh: _Shards, st: dict,
            fams: dict, tmpl_prios: tuple, use_templates: bool,
            req6: torch.Tensor) -> None:
    """The step loop's commit, per shard: the shard holding the node the
    step writes (the placed node; node 0 on an unplaced step, as the step
    loop's clamp) writes it, the others write their own rows back; the
    replicated state moves once, from the placed node's columns."""
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    b, d0 = sh.b, sh.d0
    placed = choice >= 0
    jg = torch.clamp(choice, min=0).to(i64)
    pf = placed.to(f32)
    touch, local = [], []
    for lo, hi in sh.bounds:
        touch.append((jg >= lo) & (jg < hi))
        local.append(torch.clamp(jg - lo, 0, hi - lo - 1))
    for j, (bj, cj) in enumerate(zip(sh.bs, sh.cs)):
        dev = cj.alloc.device
        t, js = touch[j].to(dev), local[j].to(dev)
        here = placed.to(dev) & t
        packed = st["packed"][j]
        # kt-xray: in-place(a shard's carried state, as the step loop's)
        packed.index_add_(0, js, req6[i:i + 1].to(dev) * here.to(i32))
        if use_templates:
            D = st["D"][j]
            col = sh.solver._template_col(
                tmpl_prios, bj.nz_templates, packed.index_select(0, js)
                [:, 4:6], cj.alloc.index_select(0, js))
            # kt-xray: in-place(a shard's carried template plane)
            D.index_copy_(1, js, torch.where(t, col, D.index_select(1, js)))
        for key, src in (("ports_used", (bj.ports[i],)),
                         ("vol_any", (bj.vol_rw[i], bj.vol_ro[i])),
                         ("vol_rw", (bj.vol_rw[i],))):
            if key in st:
                rows = st[key][j]
                bits = functools.reduce(torch.logical_or, src)
                # kt-xray: in-place(a shard's carried rows)
                rows.index_copy_(0, js, rows.index_select(0, js)
                                 | (bits & here)[None, :])
        for fam in ("ebs", "gce"):
            if fams[f"use_max_{fam}"]:
                pd = st[f"pd_{fam}"][j]
                # kt-xray: in-place(a shard's carried disk rows)
                pd.index_copy_(0, js, pd.index_select(0, js) | (
                    getattr(bj.volsvc, f"pd_pod_{fam}")[i] & here)[None, :])
    if fams["track_spread"]:
        incr = b.spread_incr[i].to(d0).to(f32) * pf
        cols = []
        for j, bj in enumerate(sh.bs):
            dev = bj.request.device
            sp = st["sp_node"][j]
            js = local[j].to(dev)
            new = sp.index_select(1, js)[:, 0] + \
                incr.to(dev) * touch[j].to(dev).to(f32)
            # kt-xray: in-place(a shard's carried spread counts)
            sp.index_copy_(1, js, new[:, None])
            cols.append(new)
        new_col = _pick(cols, touch, d0)
        st["sp_maxn"] = torch.where(
            placed, torch.maximum(st["sp_maxn"], new_col), st["sp_maxn"])
        if fams["track_spread_zones"]:
            zid = _pick([bj.node_zone_id.index_select(0, local[j].to(
                bj.request.device)) for j, bj in enumerate(sh.bs)],
                touch, d0)
            zc = torch.clamp(zid, min=0).to(i64)
            zval = incr * (zid >= 0).to(f32)
            new_zcol = st["sp_zone"].index_select(1, zc)[:, 0] + zval
            # kt-xray: in-place(the replicated zone counts)
            st["sp_zone"].index_copy_(1, zc, new_zcol[:, None])
            st["sp_maxz"] = torch.where(
                placed & (zid >= 0),
                torch.maximum(st["sp_maxz"], new_zcol), st["sp_maxz"])
    if fams["track_saa"]:
        vs = b.volsvc
        src = vs.saa_src[i].to(d0).to(f32) * pf
        st["saa_num"] = st["saa_num"] + src
        dom_j = _pick([bj.volsvc.saa_dom.index_select(
            1, local[j].to(bj.request.device))[:, 0]
            for j, bj in enumerate(sh.bs)], touch, d0)
        lab_j = _pick([bj.volsvc.saa_labeled.index_select(
            1, local[j].to(bj.request.device))[:, 0]
            for j, bj in enumerate(sh.bs)], touch, d0) & placed
        domoh = ((st["dom_ids"][None, :] == dom_j[:, None])
                 & lab_j[:, None]).to(f32)
        st["saa_cnt"] = st["saa_cnt"] + domoh[:, None, :] * src[None, :, None]
    if fams["track_affinity"]:
        a = b.aff
        col = _pick([bj.aff.node_dom.index_select(
            1, local[j].to(bj.request.device))[:, 0]
            for j, bj in enumerate(sh.bs)], touch, d0)
        ok = placed.to(f32)
        st["match_total"] = st["match_total"] + \
            ok * a.match_src[i].to(d0).float()
        for j, bj in enumerate(sh.bs):
            dev = bj.request.device
            aj, c_j, okj, pl = bj.aff, col.to(dev), ok.to(dev), \
                placed.to(dev)
            m_rows = interpod.topo_rows_col(aj.node_dom, aj.match_key,
                                            c_j).float()
            st["match_cnt"][j] = st["match_cnt"][j] + \
                okj * aj.match_src[i].float()[:, None] * m_rows
            d_rows = interpod.topo_rows_col(aj.node_dom, aj.decl_key, c_j)
            st["decl_reach"][j] = st["decl_reach"][j] | (
                pl & aj.decl_src[i][:, None] & d_rows)
            y_rows = interpod.topo_rows_col(aj.node_dom, aj.sym_key,
                                            c_j).float()
            st["sym_cnt"][j] = st["sym_cnt"][j] + \
                okj * aj.sym_src[i].float()[:, None] * y_rows


# -- the joint solve ----------------------------------------------------

def price_iterate(solver: Solver, b: DeviceBatch, c: DeviceCluster,
                  mesh: Mesh, n_iters: int,
                  extra_mask: Optional[torch.Tensor] = None
                  ) -> tuple[list, torch.Tensor]:
    """``Solver._price_iterate`` with the node axis sharded: (each
    shard's score bias [P, N_shard], the repair-order key [P])."""
    f32, i64 = torch.float32, torch.int64
    sh = _Shards(solver, b, c, mesh, sv.ALL_ON_FLAGS)
    d0 = sh.d0
    feas, scores = _evaluate_shards(solver, sh.bs, sh.cs, sv.ALL_ON_FLAGS,
                                    d0)
    if extra_mask is not None:
        feas = [f & extra_mask[:, lo:hi].to(f.device)
                for f, (lo, hi) in zip(feas, sh.bounds)]
    demand = b.request[:, :3].to(f32)
    free = [torch.clamp((cj.alloc[:, :3] - cj.requested[:, :3]).to(f32),
                        min=1.0) for cj in sh.cs]
    span = torch.clamp(_reduce([torch.where(f, s, 0.0).amax()
                                for f, s in zip(feas, scores)],
                               torch.maximum, d0), min=1.0)
    lr = span
    placed = _reduce([f.any(dim=1) for f in feas], torch.logical_or, d0)
    bids = b.request[:, :3].to(i64) * placed[:, None]
    lams = [torch.zeros((cj.alloc.shape[0], 3), dtype=f32,
                        device=cj.alloc.device) for cj in sh.cs]
    for _ in range(n_iters):
        utils = [torch.where(f, s - sv._price_cost(demand.to(f.device), fr,
                                                   lam), _NEG)
                 for f, s, fr, lam in zip(feas, scores, free, lams)]
        choice = _argmax(utils, sh.bounds, d0)
        new = []
        for (lo, hi), u, fr, lam in zip(sh.bounds, utils, free, lams):
            dev = u.device
            ch = choice.to(dev)
            here = (ch >= lo) & (ch < hi)
            # kt-xray: in-place(into a fresh zero tensor of this step)
            load = torch.zeros_like(lam, dtype=i64).index_add_(
                0, torch.clamp(ch - lo, 0, hi - lo - 1),
                bids.to(dev) * here[:, None]).to(f32)
            over = torch.clamp(load - fr, min=0.0) / fr
            lr_d = lr.to(dev)
            new.append(torch.clamp(
                sv.fma_f32(lr_d, over, lam)
                - 0.02 * lr_d * (over == 0).to(f32), min=0.0))
        lams = new
    costs = [sv._price_cost(demand.to(fr.device), fr, lam)
             for fr, lam in zip(free, lams)]
    utils = [torch.where(f, s - cost, _NEG)
             for f, s, cost in zip(feas, scores, costs)]
    if sh.n > 1:
        cand = torch.cat([torch.topk(u, min(2, u.shape[1]), dim=1).values
                          .to(d0) for u in utils], dim=1)
        top2 = torch.topk(cand, 2, dim=1).values
    else:
        u = utils[0].to(d0)
        top2 = torch.cat([u, torch.full_like(u, _NEG)], dim=1)
    t0, t1 = top2[:, 0], top2[:, 1]
    regret = torch.where(
        torch.isfinite(t0),
        t0 - torch.where(torch.isfinite(t1), t1, t0 - 1e3), _NEG)
    min_free = _reduce([fr.amin(dim=0) for fr in free], torch.minimum, d0)
    dfrac = (demand / min_free[None, :]).amax(dim=1)
    key = -torch.floor(torch.clamp(dfrac, max=1.0) * 16.0) \
        * (20.0 * span) \
        + torch.where(torch.isfinite(regret), regret, 0.0)
    return [-cost for cost in costs], key


def _argmax(utils: list, bounds: list, dev) -> torch.Tensor:
    """The first node holding each row's maximum (``argmax(dim=1)`` over
    the whole row) from the shards' argmaxes."""
    best = vals = None
    for u, (lo, _hi) in zip(utils, bounds):
        idx = u.argmax(dim=1)
        v = u.gather(1, idx[:, None])[:, 0].to(dev)
        g = (idx + lo).to(dev)
        if best is None:
            best, vals = g, v
        else:
            take = v > vals
            best = torch.where(take, g, best)
            vals = torch.where(take, v, vals)
    return best


def solve_joint(solver: Solver, b: DeviceBatch, c: DeviceCluster,
                last_node_index: torch.Tensor, mesh: Mesh,
                n_iters: int = 24, *, flags: sv.BatchFlags,
                live: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``Solver.solve_joint`` with the node axis sharded: the price
    iteration, the regret order, then the repair scan."""
    biases, key = price_iterate(solver, b, c, mesh, n_iters)
    d0 = mesh.devices[0]
    bias = torch.cat([x.to(d0) for x in biases], dim=1)
    order = torch.argsort(sv._sort_key(-key), stable=True)
    pb = sv.permute_pod_axis(b, order)
    plive = None if live is None else live.index_select(0, order)
    choices_p, counter, final = solve_sequential(
        solver, pb, c, last_node_index, mesh, flags,
        score_bias=bias.index_select(0, order), live=plive)
    choices = torch.empty_like(choices_p)
    choices[order] = choices_p
    return choices, counter, final


# -- the multi-chip dry run ---------------------------------------------

def dryrun_multichip(n_devices: int, device: "torch.device | str" = "cuda",
                     n_nodes: int = 2048, n_pods: int = 256,
                     profile: str = "rich", seed: int = 0,
                     quiet: bool = False) -> dict:
    """The JAX package's ``__graft_entry__.dryrun_multichip`` on this
    package: a (batch, nodes) mesh over ``n_devices`` shards (batch 2
    when ``n_devices`` is even), then the one-shot evaluate (pods over
    the batch axis, nodes over the node axis), the sequential-greedy
    solve and the joint solve (nodes sharded), each equal to the
    unsharded solver's result (feasible, scores, choices and counters
    exactly).  Raises AssertionError on a difference; returns the
    record it prints."""
    from kubernetes_tpu_torch.perf import synth
    dev = device_mod.resolve(device)
    batch_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    times: dict[str, float] = {}
    t0 = time.perf_counter()
    np.random.seed(seed)
    sched, pods = synth.make_rig(n_nodes, n_pods, profile=profile,
                                 device=str(dev))
    batch, db, dc, _nt = sched._compile(pods)
    flags = sv.batch_flags(batch)
    s = sched.solver
    times["build_s"] = time.perf_counter() - t0

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[key] = time.perf_counter() - t
        return out

    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ref_f, ref_s = timed("single_evaluate_s", lambda: s.evaluate(db, dc,
                                                                 flags))
    ref_c, ref_k, _ = timed("single_sequential_s", lambda: s._solve_scan(
        db, dc, zero, None, flags))
    ref_jc, ref_jk, _ = timed("single_joint_s", lambda: s.solve_joint(
        db, dc, zero, flags=flags))
    mesh = make_mesh(n_devices, batch=batch_axis, device=dev)
    f, sc = timed("sharded_evaluate_s",
                  lambda: evaluate(s, db, dc, mesh, flags))
    assert torch.equal(f.cpu(), ref_f.cpu()), \
        "sharded evaluate: feasible mask diverges"
    assert torch.equal(sc.cpu(), ref_s.cpu()), "sharded evaluate: scores diverge"
    node_mesh = Mesh(mesh.devices, 1)
    ch, k, _ = timed("sharded_sequential_s", lambda: solve_sequential(
        s, db, dc, zero, node_mesh, flags))
    assert torch.equal(ch.cpu(), ref_c.cpu()) and \
        torch.equal(k.cpu(), ref_k.cpu()), \
        "sharded sequential solve diverges"
    jc, jk, _ = timed("sharded_joint_s", lambda: solve_joint(
        s, db, dc, zero, node_mesh, flags=flags))
    assert torch.equal(jc.cpu(), ref_jc.cpu()) and \
        torch.equal(jk.cpu(), ref_jk.cpu()), "sharded joint solve diverges"
    rec = {"n_devices": n_devices, "device": str(dev),
           "mesh": mesh.shape, "n_nodes": n_nodes, "n_pods": n_pods,
           "profile": profile,
           "placed": int((ref_c >= 0).sum().item()),
           "value_asserts": ["evaluate", "solve_sequential", "solve_joint"],
           **{key: round(v, 3) for key, v in times.items()}}
    if not quiet:
        print("dryrun_multichip " + json.dumps(rec))
    return rec

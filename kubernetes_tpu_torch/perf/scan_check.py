"""The scan kernel held against its plain version, the step loop.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` run these cases on the
card: each compiles one batch, runs it through ``Solver._solve_scan``
twice from the same inputs — once with ``route="steps"`` (the step loop)
and once with ``route="kernel"`` (``engine/scan.py:scan_chunk``), in two
chunks so the second continues the first's carried state — and requires
exact equality of the choices, the counter and every carried state
tensor (floats compared bit for bit) after each chunk.

The cases cover what the kernel must get right: node counts around its
thread and warp boundaries (1, 31, 1,023, 1,025, 5,000, 16,384), an
all-infeasible chunk, round-robin counters at 0, 2^31, 2^32 - 1 (wraps on
the first placement) and 2^32, an f16 encoded plane, MostRequested and
non-unit weights, templates over their cap (in-step resource scores),
a policy with neither spread nor PodFitsResources, node 0 unschedulable
under unplaceable pods (the spread maxima must not fold column 0),
identical nodes whose ties straddle lanes, rounds and warps, and the
f32 route the joint repair and topology spread take: a non-integral
score bias (which keeps even the f16 policy's plane at f32), and an
extra mask that leaves whole rows infeasible.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_tpu_torch.api import policy as pol
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


def _rig(device, n_nodes: int, n_pods: int, profile: str = "mixed",
         policy_name: str = "default") -> tuple:
    sched, pods = synth.make_rig(n_nodes, n_pods, profile=profile,
                                 device=device)
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
    return out


_FACTORIES = _cases()
CASE_NAMES = tuple(_FACTORIES)


def case(name: str, device) -> Case:
    """The case called ``name``, built on ``device``."""
    extra = {}
    if name == "all infeasible":
        extra["infeasible"] = True
    elif name.startswith("counter "):
        extra["counter"] = int(name.split()[1])
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
    exactly after every chunk.  Returns {"steps": scan steps per route,
    "max_abs_err": largest difference seen (0.0 when they agree),
    "placed": placements}."""
    db, dc, flags = _compile(case)
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
                bk, dc, counter, sb, flags, carry, None, extra, route=r)
            state[r] = (counter, carry)
            got[r] = (ch, counter, carry)
        ref_ch, ref_cnt, ref_carry = got[routes[0]]
        for r in routes[1:]:
            ch, cnt, carry = got[r]
            where = f"{case.name}, chunk at {start}, {r} vs {routes[0]}"
            worst = max(worst, _max_abs(ch, ref_ch), _max_abs(cnt, ref_cnt))
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
                    raise ScanMismatch(f"{where}: state {k} differs at "
                                       f"{diff}")
        placed += int((ref_ch >= 0).sum())
    return {"steps": p, "max_abs_err": worst, "placed": placed}


# The kernel's carried state, updated in place by each launch.
STATE = ("packed", "counter", "d_plane", "sp_node", "sp_maxn", "sp_zone",
         "sp_maxz")


def north_star_chunk(nodes: int = 5000, pods: int = 2048,
                     device="cuda") -> dict:
    """The first chunk of a ``mixed`` rig as the solver hands it to the
    kernel, for timing it alone: one launch through ``_solve_scan`` with
    the kernel's arguments captured.  Returns {"sched", "db", "dc",
    "flags"} (the compiled inputs), {"enc", "kw"} (the arguments) and
    "init" (the carried state as it was before the launch, to restore
    between timed launches)."""
    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device=device)
    batch, db, dc, _ = sched._compile(plist)
    flags = sv.batch_flags(batch)
    real = scan_mod.scan_chunk
    seen = {}

    # functools.wraps carries the launch count over, so the wrapper's own
    # count has an attribute to land on while the capture is installed.
    @functools.wraps(real)
    def capture(enc, **kw):
        seen["enc"], seen["kw"] = enc, kw
        seen["init"] = {k: kw[k].clone() for k in STATE
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

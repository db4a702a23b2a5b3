"""The sequential-greedy scan of a whole chunk in one CUDA launch.

:func:`scan_chunk` wraps the kernel of ``csrc/scan.cu``, which runs the P
dependent steps of ``Solver._fused_scan``'s step loop in ONE thread-block
cluster whose CTAs split the node axis, for every family the loop
carries: dynamic PodFitsResources, the
template-factored or in-step resource priorities, selector/service
spread with or without zones, and selectHost inlined (the ``mixed``
set); host ports, NoDiskConflict, the MaxEBS/MaxGCE volume counts, the
inter-pod affinity predicate and priority with their carried topology
state, and service anti-affinity (the ``rich`` set, compiled as a
separate instantiation of the kernel).  It replaces, on the card, the
per-pod launches of the select kernel and of the ~120 small PyTorch
kernels around it.

The rich families' per-pod operands are [P, S] tables whose rows hold
0-2 set entries while S is in the hundreds; :func:`term_lists` turns
each into per-pod lists (offsets and set columns, in order) with torch
ops and no host sync, so a step walks only its pod's own terms.  Every
rich sum is a sum of whole numbers, so the kernel equals the step loop
bit for bit (``csrc/scan.cu`` sets out the argument).

Its plain version is the step loop itself (``engine/solver.py``), which
``tests/test_torch_solver.py`` and ``tests/test_torch_scan_rich.py`` pin
to the JAX package; the kernel is held against it bit for bit on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  The kernel carries
every family of the step, so ``_fused_scan`` sends every chunk on CUDA
tensors here.

The launch is planned by :func:`cluster_plan`: the cluster size C (by
the rule below, or forced by ``scan_chunk(cluster=...)``, which only the
checks do), each CTA's node slice, threads and nodes per thread, and
each CTA's shared memory: the fixed records, the pod slots, the
replicated spread state, the enc ring, then the node planes' slices
(``packed``, ``alloc``, ``node_zone``, ``sp_node``, ``D``, in that order)
as far as the 232,448-byte budget allows; a plane that does not fit
stays in device memory.

:func:`scan_chunk` takes CUDA tensors only, launches on the current
stream, never synchronises, raises on a failed launch, and counts its
launches in ``scan_chunk.launches`` (and per plan, keyed by (N, C, K),
in ``scan_chunk.plans``).  Before the first launch of each
configuration it checks that one such cluster can be resident
(``cudaOccupancyMaxActiveClusters``) and raises, naming C, the threads
and the shared-memory bytes, if not; it never shrinks C.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from kubernetes_tpu_torch.engine.kernels import library
from kubernetes_tpu_torch.ops.interpod import N_DEFAULT_KEYS

# Dynamic priority -> term kind of csrc/scan.cu.
TERM_KINDS = {"LeastRequestedPriority": 0, "MostRequestedPriority": 1,
              "BalancedResourceAllocation": 2, "SelectorSpreadPriority": 3,
              "ServiceSpreadingPriority": 3, "InterPodAffinityPriority": 4,
              "ServiceAntiAffinityPriority": 5}
SPREAD_KIND = 3
INTERPOD_KIND = 4
SERVICE_ANTI_KIND = 5
MAX_TERMS = 8
MAX_NODES = 16384

# The launch plan (csrc/scan.cu SmemPlan).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# The rule: the cluster size of the first (largest N, C) pair that N
# fits.  Chosen from perf/scan_sweep.py's sweep of both profiles at 64 to
# 16,384 nodes (PERF.md): one CTA is fastest up to ~640 nodes, where the
# cluster's exchanges cost more than the per-node work they split; 8
# CTAs up to ~2,000 nodes; 16 beyond.  2 and 4 CTAs never won.
RULE = ((640, 1), (2048, 8), (MAX_NODES, 16))
KS = (1, 2, 4, 8, 16)  # KT_SCAN_KS
MAX_THREADS = 1024
SMEM_LIMIT = 232448       # bytes of shared memory a block may use
FIXED_SMEM = 5456         # sizeof(Records)
SLOT_HEAD = 40            # kSlotIncr: the pod slot's words before incr
MAX_STAGES = 4
# The node planes a CTA may hold, in the order the budget takes them.
PLANES = ("packed", "alloc", "node_zone", "sp_node", "d_plane")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ScanPlan:
    """One launch of the scan kernel: ``cluster`` CTAs, CTA r owning the
    nodes ``slices[r]``; each CTA ``threads`` threads of ``k`` nodes and
    ``smem`` bytes of dynamic shared memory, laid out at the offsets
    (-1: the plane stays in device memory)."""

    n: int
    cluster: int
    slice: int
    threads: int
    k: int
    stages: int
    smem: int
    slot_words: int
    off_slots: int
    off_repl: int
    off_ring: int
    stage_bytes: int
    offsets: dict

    @property
    def slices(self) -> list[tuple[int, int]]:
        return [(r * self.slice, min(self.n, (r + 1) * self.slice))
                for r in range(self.cluster)]

    @property
    def resident(self) -> tuple[str, ...]:
        return tuple(k for k in PLANES if self.offsets[k] >= 0)

    def describe(self) -> str:
        return (f"C={self.cluster} x {self.threads} threads, K={self.k}, "
                f"slice {self.slice}, {self.stages} stages, {self.smem} B "
                f"shared memory per CTA, resident "
                f"{', '.join(self.resident) or 'none'}")


def allowed_clusters(n: int) -> tuple[int, ...]:
    """The cluster sizes that leave no CTA without nodes at N = n."""
    return tuple(c for c in CLUSTER_SIZES
                 if c == 1 or (c - 1) * _up(-(-n // c), 8) < n)


def cluster_plan(n: int, *, t: int = 0, s: int = 0, z: int = 0,
                 half: bool = False, cluster: int | None = None
                 ) -> ScanPlan:
    """The plan for N = ``n`` nodes, T = ``t`` templates (0: no ``D``),
    S = ``s`` spread groups (0: no spread), Z = ``z`` zones (0: no
    zones) and an f16 (``half``) or f32 enc row.

    C: forced by ``cluster``, else by :data:`RULE` (K is then 1: at most
    1,024 nodes per CTA).  Slices: n at C = 1, else ceil(n / C) rounded
    up to 8 nodes (so each CTA's slice of an f32 row starts on a 32-byte
    sector), in rank order, the last taking the rest.  K: the smallest instantiation that covers a slice with at
    most 1,024 threads.  Shared memory, in order: the records, one pod
    slot per ring stage and one more, the spread replicas (S maxima, S
    zone maxima, S flags, the [S, Z] zone counts and zone-blend table)
    and the [T, 2] templates, the enc ring (4 stages, fewer while the
    ring would take more than half the budget, at least 2), then each of
    :data:`PLANES` that the CTA's slice needs and that still fits, in
    that order."""
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"scan_chunk: takes 1 <= N <= {MAX_NODES} nodes, "
                         f"got {n}")
    ok = allowed_clusters(n)
    if cluster is None:
        c = next(c for bound, c in RULE if n <= bound)
    else:
        if cluster not in CLUSTER_SIZES or isinstance(cluster, bool):
            raise ValueError(f"scan_chunk: cluster must be one of "
                             f"{CLUSTER_SIZES} or None, got {cluster!r}")
        c = cluster
    if c not in ok:
        raise ValueError(f"scan_chunk: a cluster of {c} CTAs leaves a CTA "
                         f"without nodes at N = {n} (allowed: {ok})")
    slice_ = n if c == 1 else _up(-(-n // c), 8)
    k = next(k for k in KS if -(-slice_ // (32 * k)) <= MAX_THREADS // 32)
    threads = 32 * -(-slice_ // (32 * k))
    es = 2 if half else 4
    # The spread_incr row's words, from the aligned one down.
    slot_words = SLOT_HEAD + (-(-s // 4) + 1 if s else 0)
    stage_bytes = _up((slice_ + 2) * es, 16)
    stages = MAX_STAGES
    while stages > 2 and stages * stage_bytes > SMEM_LIMIT // 2:
        stages -= 1
    off = FIXED_SMEM
    off_slots = off
    off = _up(off + (stages + 1) * slot_words * 4, 16)
    off_repl = off
    off = _up(off + 4 * (3 * s + 2 * s * z) + 8 * t, 16)
    off_ring = off
    off += stages * stage_bytes
    if off > SMEM_LIMIT:
        raise ValueError(f"scan_chunk: {off} bytes of shared memory per CTA "
                         f"at C = {c} exceed {SMEM_LIMIT}")
    per_node = {"packed": 24, "alloc": 16, "node_zone": 4 if z else 0,
                "sp_node": 4 * s, "d_plane": 4 * t}
    offsets = {}
    for name in PLANES:
        need = _up(per_node[name] * slice_, 16)
        if need and off + need <= SMEM_LIMIT:
            offsets[name] = off
            off += need
        else:
            offsets[name] = -1
    return ScanPlan(n, c, slice_, threads, k, stages, off, slot_words,
                    off_slots, off_repl, off_ring, stage_bytes, offsets)

def term_lists(dense: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pod lists of a [P, S] table's set entries: (``off`` [P + 1],
    ``idx`` [P * S]) int32, row p's set columns in order at
    ``idx[off[p]:off[p + 1]]``.  Torch ops only, and no host sync: the
    entries are placed by a stable partition of the flattened table (set
    entries first, in row-major order, the unset ones after them), so
    every position is written once and the size is known in advance."""
    p, s = dense.shape
    dev = dense.device
    i32 = torch.int32
    flat = dense.reshape(-1)
    if flat.numel() == 0:
        return (torch.zeros(p + 1, dtype=i32, device=dev),
                torch.zeros(0, dtype=i32, device=dev))
    incl = torch.cumsum(flat, 0, dtype=torch.int64)       # set entries <= k
    k = torch.arange(flat.numel(), dtype=torch.int64, device=dev)
    dest = torch.where(flat, incl - 1, incl[-1] + k - incl)
    cols = (k % s).to(i32)
    # kt-xray: in-place(into a fresh tensor: every position once)
    idx = torch.empty_like(cols).scatter_(0, dest, cols)
    off = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                     incl.view(p, s)[:, -1].to(i32)])
    return off, idx


class _TermList(ctypes.Structure):
    """csrc/scan.cu ``TermList``."""

    _fields_ = [("off", ctypes.c_void_p), ("idx", ctypes.c_void_p)]


class _PdArgs(ctypes.Structure):
    """csrc/scan.cu ``PdArgs``."""

    _fields_ = [
        ("pod", _TermList), ("extra", ctypes.c_void_p),
        ("node_extra", ctypes.c_void_p), ("node_err", ctypes.c_void_p),
        ("node", ctypes.c_void_p), ("count", ctypes.c_void_p),
        ("w", ctypes.c_int), ("limit", ctypes.c_int), ("on", ctypes.c_int),
    ]


class _RichArgs(ctypes.Structure):
    """csrc/scan.cu ``RichArgs``, field for field."""

    _fields_ = [
        ("ports", _TermList), ("ports_used", ctypes.c_void_p),
        ("vol_rw", _TermList), ("vol_ro", _TermList),
        ("vol_any", ctypes.c_void_p), ("node_vol_rw", ctypes.c_void_p),
        ("ebs", _PdArgs), ("gce", _PdArgs),
        ("aff_need", _TermList), ("anti_need", _TermList),
        ("decl_match", _TermList), ("aff_self", ctypes.c_void_p),
        ("node_dom", ctypes.c_void_p), ("match_key", ctypes.c_void_p),
        ("decl_key", ctypes.c_void_p), ("sym_key", ctypes.c_void_p),
        ("match_cnt", ctypes.c_void_p), ("match_total", ctypes.c_void_p),
        ("decl_reach", ctypes.c_void_p), ("sym_cnt", ctypes.c_void_p),
        ("match_src", _TermList), ("decl_src", _TermList),
        ("sym_src", _TermList), ("pref", _TermList),
        ("sym_match", _TermList), ("pref_w", ctypes.c_void_p),
        ("sym_w", ctypes.c_void_p), ("schedulable", ctypes.c_void_p),
        ("saa_group", ctypes.c_void_p), ("saa_src", _TermList),
        ("saa_dom", ctypes.c_void_p), ("saa_labeled", ctypes.c_void_p),
        ("saa_cnt", ctypes.c_void_p), ("saa_num", ctypes.c_void_p),
        ("cp", ctypes.c_int), ("vw", ctypes.c_int), ("sm", ctypes.c_int),
        ("sd", ctypes.c_int), ("ss", ctypes.c_int), ("kd", ctypes.c_int),
        ("n_default", ctypes.c_int), ("l", ctypes.c_int),
        ("gy", ctypes.c_int), ("dd", ctypes.c_int),
        ("use_ports", ctypes.c_int), ("use_volumes", ctypes.c_int),
        ("use_interpod", ctypes.c_int), ("track_affinity", ctypes.c_int),
        ("track_saa", ctypes.c_int), ("use_interpod_prio", ctypes.c_int),
    ]


class _SmemPlan(ctypes.Structure):
    """csrc/scan.cu ``SmemPlan``, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "cluster", "slice", "threads", "k", "stages", "bytes", "slot_words",
        "off_slots", "off_repl", "off_ring", "stage_bytes", "off_packed",
        "off_alloc", "off_zone", "off_sp", "off_d")]


def plan_struct(plan: ScanPlan) -> _SmemPlan:
    """The kernel's ``SmemPlan`` for ``plan``."""
    return _SmemPlan(
        plan.cluster, plan.slice, plan.threads, plan.k, plan.stages,
        plan.smem, plan.slot_words, plan.off_slots, plan.off_repl,
        plan.off_ring, plan.stage_bytes, *(plan.offsets[k] for k in PLANES))


class _ScanArgs(ctypes.Structure):
    """csrc/scan.cu ``ScanArgs``, field for field."""

    _fields_ = [
        ("enc", ctypes.c_void_p), ("request", ctypes.c_void_p),
        ("nonzero", ctypes.c_void_p), ("zero_request", ctypes.c_void_p),
        ("tmpl_idx", ctypes.c_void_p), ("templates", ctypes.c_void_p),
        ("spread_group", ctypes.c_void_p), ("spread_incr", ctypes.c_void_p),
        ("has_zones", ctypes.c_void_p), ("node_zone", ctypes.c_void_p),
        ("alloc", ctypes.c_void_p), ("packed", ctypes.c_void_p),
        ("d_plane", ctypes.c_void_p), ("sp_node", ctypes.c_void_p),
        ("sp_maxn", ctypes.c_void_p), ("sp_zone", ctypes.c_void_p),
        ("sp_maxz", ctypes.c_void_p), ("counter", ctypes.c_void_p),
        ("choices", ctypes.c_void_p),
        ("p", ctypes.c_int), ("n", ctypes.c_int), ("t", ctypes.c_int),
        ("s", ctypes.c_int), ("z", ctypes.c_int), ("half", ctypes.c_int),
        ("use_resources", ctypes.c_int), ("use_templates", ctypes.c_int),
        ("track_spread", ctypes.c_int), ("track_zones", ctypes.c_int),
        ("n_terms", ctypes.c_int), ("n_tmpl_terms", ctypes.c_int),
        ("term_kind", ctypes.c_int * MAX_TERMS),
        ("term_w", ctypes.c_float * MAX_TERMS),
        ("tmpl_kind", ctypes.c_int * MAX_TERMS),
        ("tmpl_w", ctypes.c_float * MAX_TERMS),
        ("term_aux", ctypes.c_int * MAX_TERMS),
        ("rich", ctypes.c_int), ("r", _RichArgs), ("plan", _SmemPlan),
    ]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
            tuple(t.shape) != shape or not t.is_contiguous():
        got = (f"{t.dtype} {tuple(t.shape)}"
               f"{'' if t.is_contiguous() else ' non-contiguous'}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"scan_chunk: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, got {got}")
    return t


def _check_list(name: str, lst, p: int, s: int) -> tuple:
    """A :func:`term_lists` pair for a [p, s] table."""
    if not isinstance(lst, tuple) or len(lst) != 2:
        raise ValueError(f"scan_chunk: {name} must be an (off, idx) pair "
                         f"from term_lists")
    return (_check(f"{name} offsets", lst[0], torch.int32, (p + 1,)),
            _check(f"{name} entries", lst[1], torch.int32, (p * s,)))


def _width(name: str, t, dim: int) -> int:
    if not isinstance(t, torch.Tensor) or t.dim() <= dim:
        raise ValueError(f"scan_chunk: {name} must be a tensor with at "
                         f"least {dim + 1} dimensions")
    return int(t.shape[dim])


def _kinds(terms: tuple, what: str) -> tuple[list[int], list[float],
                                             list[int]]:
    if len(terms) > MAX_TERMS:
        raise ValueError(f"scan_chunk: at most {MAX_TERMS} {what}, got "
                         f"{len(terms)}")
    kinds, weights, aux = [], [], []
    for name, weight, a in terms:
        if name not in TERM_KINDS:
            raise ValueError(f"scan_chunk: {name!r} is not a priority the "
                             f"kernel computes")
        kinds.append(TERM_KINDS[name])
        weights.append(float(weight))
        aux.append(int(a))
    return kinds, weights, aux


def _rich_args(p: int, n: int, kinds: list[int], aux: list[int],
               rich: dict) -> tuple[dict, dict, dict, dict]:
    """Check the rich families' tensors.  Returns (tensors by field,
    term lists by field, the two disk families' fields, the ints)."""
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    tensors, lists, ints = {}, {}, {}
    pds = {}
    unknown = set(rich) - RICH_ARGS
    if unknown:
        raise ValueError(f"scan_chunk: unknown arguments {sorted(unknown)}")

    def given(*keys):
        return any(rich.get(k) is not None for k in keys)

    def need(what: str, *keys):
        missing = [k for k in keys if rich.get(k) is None]
        if missing:
            raise ValueError(f"scan_chunk: {what} needs {missing}")

    if given("ports_list", "ports_used"):
        need("ports", "ports_list", "ports_used")
        cp = _width("ports_used", rich["ports_used"], 1)
        tensors["ports_used"] = _check("ports_used", rich["ports_used"], b8,
                                       (n, cp))
        lists["ports"] = _check_list("ports_list", rich["ports_list"], p, cp)
        ints.update(cp=cp, use_ports=1)
    if given("vol_rw_list", "vol_ro_list", "vol_any", "vol_rw"):
        need("volumes", "vol_rw_list", "vol_ro_list", "vol_any", "vol_rw")
        vw = _width("vol_any", rich["vol_any"], 1)
        tensors["vol_any"] = _check("vol_any", rich["vol_any"], b8, (n, vw))
        tensors["node_vol_rw"] = _check("vol_rw", rich["vol_rw"], b8, (n, vw))
        lists["vol_rw"] = _check_list("vol_rw_list", rich["vol_rw_list"], p,
                                      vw)
        lists["vol_ro"] = _check_list("vol_ro_list", rich["vol_ro_list"], p,
                                      vw)
        ints.update(vw=vw, use_volumes=1)
    for fam in ("ebs", "gce"):
        keys = (f"{fam}_list", f"{fam}_extra", f"{fam}_node_extra",
                f"{fam}_node_err", f"pd_{fam}", f"{fam}_count",
                f"max_{fam}")
        if not given(*keys):
            continue
        need(f"max_{fam}", *keys)
        w = _width(f"pd_{fam}", rich[f"pd_{fam}"], 1)
        pds[fam] = {
            "pod": _check_list(f"{fam}_list", rich[f"{fam}_list"], p, w),
            "extra": _check(f"{fam}_extra", rich[f"{fam}_extra"], i32, (p,)),
            "node_extra": _check(f"{fam}_node_extra",
                                 rich[f"{fam}_node_extra"], i32, (n,)),
            "node_err": _check(f"{fam}_node_err", rich[f"{fam}_node_err"],
                               b8, (n,)),
            "node": _check(f"pd_{fam}", rich[f"pd_{fam}"], b8, (n, w)),
            "count": _check(f"{fam}_count", rich[f"{fam}_count"], i32, (n,)),
            "w": w, "limit": int(rich[f"max_{fam}"]), "on": 1}
    affinity = ("node_dom", "match_key", "decl_key", "sym_key", "match_cnt",
                "match_total", "decl_reach", "sym_cnt", "match_src_list",
                "decl_src_list", "sym_src_list")
    interpod = ("aff_need_list", "aff_self", "anti_need_list",
                "decl_match_list")
    prio = ("pref_list", "pref_w", "sym_match_list", "sym_w", "schedulable")
    if given(*affinity) or given(*interpod) or given(*prio) or \
            INTERPOD_KIND in kinds:
        need("the inter-pod affinity state", *affinity)
        kd = _width("node_dom", rich["node_dom"], 0)
        sm = _width("match_cnt", rich["match_cnt"], 0)
        sd = _width("decl_reach", rich["decl_reach"], 0)
        ss = _width("sym_cnt", rich["sym_cnt"], 0)
        tensors.update(
            node_dom=_check("node_dom", rich["node_dom"], i32, (kd, n)),
            match_key=_check("match_key", rich["match_key"], i32, (sm,)),
            decl_key=_check("decl_key", rich["decl_key"], i32, (sd,)),
            sym_key=_check("sym_key", rich["sym_key"], i32, (ss,)),
            match_cnt=_check("match_cnt", rich["match_cnt"], f32, (sm, n)),
            match_total=_check("match_total", rich["match_total"], f32,
                               (sm,)),
            decl_reach=_check("decl_reach", rich["decl_reach"], b8, (sd, n)),
            sym_cnt=_check("sym_cnt", rich["sym_cnt"], f32, (ss, n)))
        lists.update(
            match_src=_check_list("match_src_list", rich["match_src_list"],
                                  p, sm),
            decl_src=_check_list("decl_src_list", rich["decl_src_list"], p,
                                 sd),
            sym_src=_check_list("sym_src_list", rich["sym_src_list"], p, ss))
        ints.update(kd=kd, sm=sm, sd=sd, ss=ss, track_affinity=1,
                    n_default=min(N_DEFAULT_KEYS, kd))
        if given(*interpod):
            need("the inter-pod affinity predicate", *interpod)
            tensors["aff_self"] = _check("aff_self", rich["aff_self"], b8,
                                         (p, sm))
            lists.update(
                aff_need=_check_list("aff_need_list", rich["aff_need_list"],
                                     p, sm),
                anti_need=_check_list("anti_need_list",
                                      rich["anti_need_list"], p, sm),
                decl_match=_check_list("decl_match_list",
                                       rich["decl_match_list"], p, sd))
            ints["use_interpod"] = 1
        if given(*prio) or INTERPOD_KIND in kinds:
            if INTERPOD_KIND not in kinds:
                raise ValueError("scan_chunk: pref_list given without an "
                                 "InterPodAffinityPriority term")
            need("an InterPodAffinityPriority term", *prio)
            tensors.update(
                pref_w=_check("pref_w", rich["pref_w"], f32, (p, sm)),
                sym_w=_check("sym_w", rich["sym_w"], f32, (ss,)),
                schedulable=_check("schedulable", rich["schedulable"], b8,
                                   (n,)))
            lists.update(
                pref=_check_list("pref_list", rich["pref_list"], p, sm),
                sym_match=_check_list("sym_match_list",
                                      rich["sym_match_list"], p, ss))
            ints["use_interpod_prio"] = 1
    saa = ("saa_group", "saa_src_list", "saa_dom", "saa_labeled", "saa_cnt",
           "saa_num")
    if given(*saa) or SERVICE_ANTI_KIND in kinds:
        if SERVICE_ANTI_KIND not in kinds:
            raise ValueError("scan_chunk: saa_cnt given without a "
                             "ServiceAntiAffinityPriority term")
        need("a ServiceAntiAffinityPriority term", *saa)
        cnt = rich["saa_cnt"]
        if not isinstance(cnt, torch.Tensor) or cnt.dim() != 3:
            raise ValueError("scan_chunk: saa_cnt must be a [L, Gy, D] "
                             "tensor")
        nl, gy, dd = (int(x) for x in cnt.shape)
        tensors.update(
            saa_group=_check("saa_group", rich["saa_group"], i32, (p,)),
            saa_dom=_check("saa_dom", rich["saa_dom"], i32, (nl, n)),
            saa_labeled=_check("saa_labeled", rich["saa_labeled"], b8,
                               (nl, n)),
            saa_cnt=_check("saa_cnt", cnt, f32, (nl, gy, dd)),
            saa_num=_check("saa_num", rich["saa_num"], f32, (gy,)))
        lists["saa_src"] = _check_list("saa_src_list", rich["saa_src_list"],
                                       p, gy)
        bad = [x for k, x in zip(kinds, aux)
               if k == SERVICE_ANTI_KIND and not 0 <= x < nl]
        if bad:
            raise ValueError(f"scan_chunk: service anti-affinity rows {bad} "
                             f"outside [0, {nl})")
        ints.update(l=nl, gy=gy, dd=dd, track_saa=1)
    return tensors, lists, pds, ints


# Every keyword argument of the rich families.
RICH_ARGS = frozenset((
    "ports_list", "ports_used", "vol_rw_list", "vol_ro_list", "vol_any",
    "vol_rw", *(f"{f}_{k}" for f in ("ebs", "gce")
                for k in ("list", "extra", "node_extra", "node_err",
                          "count")),
    "pd_ebs", "pd_gce", "max_ebs", "max_gce", "node_dom", "match_key",
    "decl_key", "sym_key", "match_cnt", "match_total", "decl_reach",
    "sym_cnt", "match_src_list", "decl_src_list", "sym_src_list",
    "aff_need_list", "aff_self", "anti_need_list", "decl_match_list",
    "pref_list", "pref_w", "sym_match_list", "sym_w", "schedulable",
    "saa_group", "saa_src_list", "saa_dom", "saa_labeled", "saa_cnt",
    "saa_num"))


def _library() -> ctypes.CDLL:
    """The kernel library, checked to lay ``ScanArgs`` out as
    :class:`_ScanArgs` does and to reserve the fixed shared memory the
    plan reserves."""
    lib = library()
    size = lib.kt_scan_args_size()
    if size != ctypes.sizeof(_ScanArgs):
        raise RuntimeError(f"scan_chunk: ScanArgs is {size} bytes in "
                           f"csrc/scan.cu, {ctypes.sizeof(_ScanArgs)} in "
                           f"its ctypes mirror")
    fixed = lib.kt_scan_fixed_smem()
    if fixed != FIXED_SMEM:
        raise RuntimeError(f"scan_chunk: the kernel's fixed shared memory "
                           f"is {fixed} bytes, the plan reserves "
                           f"{FIXED_SMEM}")
    return lib


# Configurations whose occupancy was checked: (K, f16, rich, C, threads,
# shared-memory bytes).
_resident_ok: set = set()


def _check_resident(lib, c: "_ScanArgs", stream: ctypes.c_void_p,
                    key: tuple) -> None:
    """Raise unless one cluster of this launch can be resident."""
    if key in _resident_ok:
        return
    clusters = ctypes.c_int(0)
    err = lib.kt_scan_max_clusters(ctypes.byref(c), stream,
                                   ctypes.byref(clusters))
    pl = c.plan
    if err != 0 or clusters.value < 1:
        raise RuntimeError(
            f"scan_chunk: a cluster of C={pl.cluster} CTAs of {pl.threads} "
            f"threads with {pl.bytes} bytes of shared memory each cannot be "
            f"resident on this card (cudaOccupancyMaxActiveClusters = "
            f"{clusters.value}, cudaError {err})")
    _resident_ok.add(key)


def scan_chunk(enc: torch.Tensor, *, request: torch.Tensor,
               nonzero: torch.Tensor, zero_request: torch.Tensor,
               alloc: torch.Tensor, packed: torch.Tensor,
               counter: torch.Tensor, terms: tuple = (),
               use_resources: bool = True,
               templates: torch.Tensor | None = None,
               tmpl_idx: torch.Tensor | None = None,
               d_plane: torch.Tensor | None = None, tmpl_terms: tuple = (),
               spread_group: torch.Tensor | None = None,
               spread_incr: torch.Tensor | None = None,
               sp_node: torch.Tensor | None = None,
               sp_maxn: torch.Tensor | None = None,
               node_zone: torch.Tensor | None = None,
               has_zones: torch.Tensor | None = None,
               sp_zone: torch.Tensor | None = None,
               sp_maxz: torch.Tensor | None = None,
               cluster: int | None = None,
               **rich) -> torch.Tensor:
    """Run one chunk's P scan steps in one launch; returns ``choices``
    [P] int32 (-1 = unplaced).

    ``enc`` [P, N] f32 or f16 is the encoded static plane (-inf =
    statically infeasible); ``request`` [P, 4], ``nonzero`` [P, 2] int32
    and ``zero_request`` [P] bool are the pods'; ``alloc`` [N, 4] int32.
    The carried state is updated in place: ``packed`` [N, 6] int32,
    ``counter`` [1] int64 (its low 32 bits are the uint32 counter; the
    final value is written masked), and per family:

    * templates (``d_plane`` given): ``templates`` [T, 2] and
      ``tmpl_idx`` [P] int32, ``d_plane`` [T, N] f32, ``tmpl_terms`` the
      (name, weight, aux) priorities folded into it;
    * spread (``sp_node`` given): ``spread_group`` [P] int32,
      ``spread_incr`` [P, S] bool, ``sp_node`` [S, N] and ``sp_maxn`` [S]
      f32;
    * zones (``sp_zone`` given, needs spread): ``node_zone`` [N] int32,
      ``has_zones`` [S] bool, ``sp_zone`` [S, Z] and ``sp_maxz`` [S] f32.

    The rich families come as keyword arguments, each ``*_list`` a
    :func:`term_lists` pair of the pod-axis table it names, and each
    family on when its arguments are given:

    * host ports: ``ports_list`` [P, Cp], ``ports_used`` [N, Cp] bool;
    * volumes: ``vol_rw_list``, ``vol_ro_list`` [P, W], ``vol_any`` and
      ``vol_rw`` [N, W] bool;
    * disk counts, for ``fam`` in ebs and gce: ``{fam}_list`` [P, W],
      ``{fam}_extra`` [P] and ``{fam}_node_extra`` [N] int32,
      ``{fam}_node_err`` [N] bool, ``pd_{fam}`` [N, W] bool,
      ``{fam}_count`` [N] int32 (the set bits of each ``pd_{fam}`` row,
      kept up to date in place) and ``max_{fam}`` (an int);
    * the inter-pod state: ``node_dom`` [Kd, N], ``match_key`` [Sm],
      ``decl_key`` [Sd], ``sym_key`` [Ss] int32, ``match_cnt`` [Sm, N]
      and ``match_total`` [Sm] f32, ``decl_reach`` [Sd, N] bool,
      ``sym_cnt`` [Ss, N] f32, and the placed pod's rows
      ``match_src_list``, ``decl_src_list``, ``sym_src_list``;
    * its predicate: ``aff_need_list``, ``anti_need_list`` [P, Sm],
      ``aff_self`` [P, Sm] bool, ``decl_match_list`` [P, Sd];
    * its priority (an ``InterPodAffinityPriority`` term): ``pref_list``
      (of ``pref_w != 0``), ``pref_w`` [P, Sm] f32, ``sym_match_list``
      [P, Ss], ``sym_w`` [Ss] f32, ``schedulable`` [N] bool;
    * service anti-affinity (``ServiceAntiAffinityPriority`` terms, aux =
      the label row): ``saa_group`` [P] int32, ``saa_src_list`` [P, Gy],
      ``saa_dom`` [L, N] int32, ``saa_labeled`` [L, N] bool, ``saa_cnt``
      [L, Gy, D] and ``saa_num`` [Gy] f32.

    ``terms`` are the other dynamic priorities as (name, weight, aux), in
    the step loop's order.  ``cluster`` forces the cluster size (1, 2, 4,
    8 or 16; the checks use it); None takes :func:`cluster_plan`'s
    rule."""
    if not isinstance(enc, torch.Tensor) or enc.dim() != 2 or \
            enc.dtype not in (torch.float32, torch.float16) or \
            not enc.is_contiguous():
        raise ValueError("scan_chunk: enc must be a contiguous [P, N] "
                         "float32 or float16 tensor")
    p, n = enc.shape
    if p == 0 or n == 0 or n > MAX_NODES:
        raise ValueError(f"scan_chunk: takes 1 <= N <= {MAX_NODES} nodes "
                         f"and P >= 1 pods, got (P, N) = {(p, n)}")
    i32, f32 = torch.int32, torch.float32
    args = {
        "enc": enc,
        "request": _check("request", request, i32, (p, 4)),
        "nonzero": _check("nonzero", nonzero, i32, (p, 2)),
        "zero_request": _check("zero_request", zero_request, torch.bool,
                               (p,)),
        "alloc": _check("alloc", alloc, i32, (n, 4)),
        "packed": _check("packed", packed, i32, (n, 6)),
        "counter": _check("counter", counter, torch.int64, (1,)),
    }
    kinds, weights, aux = _kinds(tuple(terms), "dynamic priority terms")
    tmpl_kinds, tmpl_weights, _ = _kinds(tuple(tmpl_terms), "template terms")
    if {SPREAD_KIND, INTERPOD_KIND, SERVICE_ANTI_KIND} & set(tmpl_kinds):
        raise ValueError("scan_chunk: only resource priorities are "
                         "template-factored")
    t = s = z = 0
    if d_plane is not None:
        if templates is None or tmpl_idx is None:
            raise ValueError("scan_chunk: d_plane needs templates and "
                             "tmpl_idx")
        t = int(templates.shape[0]) if templates.dim() == 2 else -1
        args["templates"] = _check("templates", templates, i32, (t, 2))
        args["tmpl_idx"] = _check("tmpl_idx", tmpl_idx, i32, (p,))
        args["d_plane"] = _check("d_plane", d_plane, f32, (t, n))
    elif tmpl_terms:
        raise ValueError("scan_chunk: tmpl_terms given without d_plane")
    if sp_node is not None:
        if spread_group is None or spread_incr is None or sp_maxn is None:
            raise ValueError("scan_chunk: sp_node needs spread_group, "
                             "spread_incr and sp_maxn")
        s = int(sp_node.shape[0]) if sp_node.dim() == 2 else -1
        args["spread_group"] = _check("spread_group", spread_group, i32,
                                      (p,))
        args["spread_incr"] = _check("spread_incr", spread_incr,
                                     torch.bool, (p, s))
        args["sp_node"] = _check("sp_node", sp_node, f32, (s, n))
        args["sp_maxn"] = _check("sp_maxn", sp_maxn, f32, (s,))
    elif SPREAD_KIND in kinds:
        raise ValueError("scan_chunk: a spread term needs sp_node")
    if sp_zone is not None:
        if sp_node is None or node_zone is None or has_zones is None or \
                sp_maxz is None:
            raise ValueError("scan_chunk: sp_zone needs the spread state, "
                             "node_zone, has_zones and sp_maxz")
        z = int(sp_zone.shape[1]) if sp_zone.dim() == 2 else -1
        args["node_zone"] = _check("node_zone", node_zone, i32, (n,))
        args["has_zones"] = _check("has_zones", has_zones, torch.bool, (s,))
        args["sp_zone"] = _check("sp_zone", sp_zone, f32, (s, z))
        args["sp_maxz"] = _check("sp_maxz", sp_maxz, f32, (s,))
    r_tensors, r_lists, r_pds, r_ints = _rich_args(p, n, kinds, aux, rich)
    is_rich = bool(r_tensors or r_lists or r_pds)
    plan = cluster_plan(n, t=t, s=s, z=z, half=enc.dtype == torch.float16,
                        cluster=cluster)

    dev = enc.device
    if dev.type != "cuda":
        raise ValueError(f"scan_chunk: the kernel takes CUDA tensors, got "
                         f"{dev}; CPU tensors run the step loop")
    if dev.index != torch.cuda.current_device():
        raise ValueError("scan_chunk: tensors must lie on the current CUDA "
                         "device")
    if enc.data_ptr() % 4:
        raise ValueError("scan_chunk: enc must start on a 4-byte boundary")
    every = dict(args)
    every.update(r_tensors)
    for name, pair in r_lists.items():
        every[f"{name} offsets"], every[f"{name} entries"] = pair
    for fam, fields in r_pds.items():
        for key, val in fields.items():
            if isinstance(val, torch.Tensor):
                every[f"{fam} {key}"] = val
        every[f"{fam} offsets"], every[f"{fam} entries"] = fields["pod"]
    for name, tensor in every.items():
        if tensor.device != dev:
            raise ValueError(f"scan_chunk: {name} is on {tensor.device}, "
                             f"enc on {dev}")

    choices = torch.empty(p, dtype=i32, device=dev)
    c = _ScanArgs()
    for name, tensor in args.items():
        setattr(c, name, tensor.data_ptr())
    c.choices = choices.data_ptr()
    c.p, c.n, c.t, c.s, c.z = p, n, t, s, z
    c.half = int(enc.dtype == torch.float16)
    c.use_resources = int(bool(use_resources))
    c.use_templates = int(d_plane is not None)
    c.track_spread = int(sp_node is not None)
    c.track_zones = int(sp_zone is not None)
    c.n_terms, c.n_tmpl_terms = len(kinds), len(tmpl_kinds)
    c.term_kind[:len(kinds)] = kinds
    c.term_w[:len(weights)] = weights
    c.term_aux[:len(aux)] = aux
    c.tmpl_kind[:len(tmpl_kinds)] = tmpl_kinds
    c.tmpl_w[:len(tmpl_weights)] = tmpl_weights
    c.rich = int(is_rich)
    for name, tensor in r_tensors.items():
        setattr(c.r, name, tensor.data_ptr())
    for name, (off, idx) in r_lists.items():
        setattr(c.r, name, _TermList(off.data_ptr(), idx.data_ptr()))
    for fam, fields in r_pds.items():
        pd = getattr(c.r, fam)
        for key, val in fields.items():
            if key == "pod":
                pd.pod = _TermList(val[0].data_ptr(), val[1].data_ptr())
            elif isinstance(val, torch.Tensor):
                setattr(pd, key, val.data_ptr())
            else:
                setattr(pd, key, val)
    for name, val in r_ints.items():
        setattr(c.r, name, val)
    c.plan = plan_struct(plan)
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _check_resident(lib, c, stream, (plan.k, c.half, c.rich, plan.cluster,
                                     plan.threads, plan.smem))
    err = lib.kt_scan_chunk(ctypes.byref(c), stream)
    if err != 0:
        raise RuntimeError(f"scan_chunk: kernel launch failed (cudaError "
                           f"{err})")
    scan_chunk.launches += 1
    key = (plan.n, plan.cluster, plan.k)
    scan_chunk.plans[key] = scan_chunk.plans.get(key, 0) + 1
    return choices


scan_chunk.launches = 0
scan_chunk.plans = {}  # (N, C, K) -> launches

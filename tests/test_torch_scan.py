"""The scan kernel's dispatch, wrapper, build and plain path, on the CPU.

``engine/scan.py:scan_chunk`` launches ``csrc/scan.cu`` on CUDA tensors
only; its plain version is the step loop of ``Solver._fused_scan``, held
against the kernel on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Here: which chunks the dispatch sends to the kernel,
the wrapper's argument checks, the one ``nvcc`` command that builds the
library (hashing both sources, FMA contraction off), the C argument
struct against its ctypes mirror, the cluster plan (slices, threads,
shared memory and the planes it keeps resident) and the ``cluster=``
checks, and a chunked ``mixed`` drain through
the new dispatch still exactly equal to the JAX package's ``_solve_scan``
(choices, counter and every carried state plane).  Tolerance: exact."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine import solver as ref_sv
from kubernetes_tpu_torch.engine import convert, kernels, scan
from kubernetes_tpu_torch.engine import solver as t_sv
from kubernetes_tpu_torch.perf import scan_ablation

from torch_parity import both, host_inputs, ref_rig, same, torch_policy

MIXED = dict(use_resources=True, use_ports=False, use_volumes=False,
             use_interpod=False, use_max_ebs=False, use_max_gce=False,
             track_affinity=False, track_spread=True,
             track_spread_zones=True, track_saa=False)
CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.mark.parametrize("changes", [
    {}, {"track_spread_zones": False},
    {"track_spread": False, "track_spread_zones": False},
    {"use_resources": False}])
def test_mixed_families_route_to_the_kernel_on_cuda(changes):
    fams = {**MIXED, **changes}
    assert _routes(fams, "mixed") == {"cuda": "kernel", "cpu": "steps"}


RICH = ("use_ports", "use_volumes", "use_max_ebs", "use_max_gce",
        "use_interpod", "track_affinity", "track_saa")


@pytest.mark.parametrize("family", RICH)
def test_rich_families_stay_on_the_step_loop(family):
    """Only on the CPU: on CUDA tensors a chunk holding any rich family
    routes to the kernel, which carries them all."""
    fams = {**MIXED, family: True}
    # As _solve_scan derives them: the predicate reads the carried state.
    fams["track_affinity"] |= fams["use_interpod"]
    # The wide policy adds ServiceAntiAffinityPriority to the defaults.
    assert _routes(fams, "rich", "wide") == {"cuda": "kernel", "cpu": "steps"}


_CAPTURED: dict = {}


def _fams_of(profile: str, policy: str = "default"):
    """The families ``_solve_scan`` derives for a compiled batch, with
    the solver, the torch batch and cluster, the host batch and every
    argument ``_solve_scan`` hands ``_fused_scan`` (captured once per
    batch; the batch is never run here)."""
    if (profile, policy) in _CAPTURED:
        return _CAPTURED[profile, policy]
    eng, pods, _ = ref_rig(profile, 40, 64, n_existing=60, policy=policy)
    batch, hb, hc, _ = host_inputs(eng, pods)
    _, _, tb, tc = both(hb, hc)
    solver = t_sv.Solver(torch_policy(policy))
    seen = {}

    def capture(self, *args, route=None):
        seen["args"] = args
        raise StopIteration

    with pytest.MonkeyPatch.context() as m:
        m.setattr(t_sv.Solver, "_fused_scan", capture)
        with pytest.raises(StopIteration):
            solver._solve_scan(tb, tc, convert.counter_from_numpy(0, "cpu"),
                               None, t_sv.BatchFlags(*ref_sv.batch_flags(
                                   batch)), None, None, None)
    fams = seen["args"][7]
    _CAPTURED[profile, policy] = (fams, solver, tb, tc, batch, seen["args"])
    return _CAPTURED[profile, policy]


def _routes(fams: dict, profile: str, policy: str = "default") -> dict:
    """The body ``_fused_scan`` runs by default on each device, after
    showing that the kernel body takes ``fams``: forced onto it, a chunk
    of the compiled batch with these families (and only the dynamic
    priorities they carry) builds their arguments, passes every check of
    the wrapper and stops only at its CPU tensors, without launching."""
    _, solver, *_, args = _fams_of(profile, policy)
    needs = {"SelectorSpreadPriority": "track_spread",
             "ServiceSpreadingPriority": "track_spread",
             "InterPodAffinityPriority": "track_affinity",
             "ServiceAntiAffinityPriority": "track_saa"}
    prios = tuple(t for t in args[8] if fams.get(needs.get(t[0]), True))
    before = scan.scan_chunk.launches
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        solver._fused_scan(*args[:7], fams, prios, route="kernel")
    assert scan.scan_chunk.launches == before
    return {"cuda": t_sv.scan_route(CUDA), "cpu": t_sv.scan_route(CPU)}


@pytest.mark.parametrize("profile,policy,kernel", [
    ("mixed", "default", True), ("mixed", "f16", True),
    ("rich", "default", True)])
def test_compiled_batches_route_by_profile(profile, policy, kernel):
    fams, *_ = _fams_of(profile, policy)
    assert _routes(fams, profile, policy) == {
        "cuda": "kernel" if kernel else "steps", "cpu": "steps"}
    if profile == "rich":
        assert {f for f in RICH if fams[f]} >= {
            "use_ports", "use_volumes", "use_max_ebs", "use_interpod",
            "track_affinity"}


def test_forcing_the_kernel_on_rich_families_raises():
    """Forced onto the kernel, the compiled rich batch passes every
    argument check of the wrapper and stops only at the CPU tensors,
    without launching."""
    _, solver, tb, tc, batch, _ = _fams_of("rich")
    flags = t_sv.BatchFlags(*ref_sv.batch_flags(batch))
    counter = convert.counter_from_numpy(0, "cpu")
    before = scan.scan_chunk.launches
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        solver._solve_scan(tb, tc, counter, None, flags, None, None, None,
                           route="kernel")
    assert scan.scan_chunk.launches == before


def _args(p: int = 4, n: int = 8, t: int = 3, s: int = 2, z: int = 2):
    i32, f32 = torch.int32, torch.float32
    return dict(
        request=torch.zeros((p, 4), dtype=i32),
        nonzero=torch.zeros((p, 2), dtype=i32),
        zero_request=torch.zeros(p, dtype=torch.bool),
        alloc=torch.ones((n, 4), dtype=i32),
        packed=torch.zeros((n, 6), dtype=i32),
        counter=torch.zeros(1, dtype=torch.int64),
        terms=(("SelectorSpreadPriority", 1, 0),),
        templates=torch.zeros((t, 2), dtype=i32),
        tmpl_idx=torch.zeros(p, dtype=i32),
        d_plane=torch.zeros((t, n), dtype=f32),
        tmpl_terms=(("LeastRequestedPriority", 1, 0),
                    ("BalancedResourceAllocation", 1, 0)),
        spread_group=torch.zeros(p, dtype=i32),
        spread_incr=torch.zeros((p, s), dtype=torch.bool),
        sp_node=torch.zeros((s, n), dtype=f32),
        sp_maxn=torch.zeros(s, dtype=f32),
        node_zone=torch.zeros(n, dtype=i32),
        has_zones=torch.zeros(s, dtype=torch.bool),
        sp_zone=torch.zeros((s, z), dtype=f32),
        sp_maxz=torch.zeros(s, dtype=f32))


def _rich(p: int = 4, n: int = 8, cp: int = 3, w: int = 5, sm: int = 6,
          sd: int = 2, ss: int = 7, kd: int = 3, nl: int = 2, gy: int = 3,
          dd: int = 4) -> dict:
    """Every rich family's arguments, as ``_solve_scan`` passes them."""
    i32, f32, b8 = torch.int32, torch.float32, torch.bool

    def lists(s):
        return scan.term_lists(torch.zeros((p, s), dtype=b8))

    out = dict(
        ports_list=lists(cp), ports_used=torch.zeros((n, cp), dtype=b8),
        vol_rw_list=lists(w), vol_ro_list=lists(w),
        vol_any=torch.zeros((n, w), dtype=b8),
        vol_rw=torch.zeros((n, w), dtype=b8),
        node_dom=torch.zeros((kd, n), dtype=i32),
        match_key=torch.zeros(sm, dtype=i32),
        decl_key=torch.zeros(sd, dtype=i32),
        sym_key=torch.zeros(ss, dtype=i32),
        match_cnt=torch.zeros((sm, n), dtype=f32),
        match_total=torch.zeros(sm, dtype=f32),
        decl_reach=torch.zeros((sd, n), dtype=b8),
        sym_cnt=torch.zeros((ss, n), dtype=f32),
        match_src_list=lists(sm), decl_src_list=lists(sd),
        sym_src_list=lists(ss),
        aff_need_list=lists(sm), aff_self=torch.zeros((p, sm), dtype=b8),
        anti_need_list=lists(sm), decl_match_list=lists(sd),
        pref_list=lists(sm), pref_w=torch.zeros((p, sm), dtype=f32),
        sym_match_list=lists(ss), sym_w=torch.zeros(ss, dtype=f32),
        schedulable=torch.ones(n, dtype=b8),
        saa_group=torch.zeros(p, dtype=i32), saa_src_list=lists(gy),
        saa_dom=torch.zeros((nl, n), dtype=i32),
        saa_labeled=torch.zeros((nl, n), dtype=b8),
        saa_cnt=torch.zeros((nl, gy, dd), dtype=f32),
        saa_num=torch.zeros(gy, dtype=f32),
        terms=(("SelectorSpreadPriority", 1, 0),
               ("InterPodAffinityPriority", 1, 0),
               ("ServiceAntiAffinityPriority", 2, 1)))
    for fam, width in (("ebs", 4), ("gce", 2)):
        out.update({f"{fam}_list": lists(width),
                    f"{fam}_extra": torch.zeros(p, dtype=i32),
                    f"{fam}_node_extra": torch.zeros(n, dtype=i32),
                    f"{fam}_node_err": torch.zeros(n, dtype=b8),
                    f"pd_{fam}": torch.zeros((n, width), dtype=b8),
                    f"{fam}_count": torch.zeros(n, dtype=i32),
                    f"max_{fam}": 3})
    return out


def test_wrapper_refuses_cpu_tensors_without_launching():
    before = scan.scan_chunk.launches
    for enc_dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="CUDA"):
            scan.scan_chunk(torch.zeros((4, 8), dtype=enc_dtype), **_args())
    assert scan.scan_chunk.launches == before


def test_wrapper_takes_every_rich_family_and_refuses_cpu_tensors():
    before = scan.scan_chunk.launches
    for enc_dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="CUDA"):
            scan.scan_chunk(torch.zeros((4, 8), dtype=enc_dtype),
                            **{**_args(), **_rich()})
    assert scan.scan_chunk.launches == before


@pytest.mark.parametrize("field,bad", [
    ("ports_used", lambda a: a.to(torch.uint8)),
    ("ports_list", lambda a: (a[0][:2], a[1])),
    ("vol_any", lambda a: a[:3]),
    ("vol_rw", lambda a: a.t()),
    ("vol_ro_list", lambda a: (a[0], a[1][:3])),
    ("ebs_extra", lambda a: a.to(torch.int64)),
    ("ebs_node_err", lambda a: a[:2]),
    ("pd_gce", lambda a: a.to(torch.int32)),
    ("gce_count", lambda a: a.to(torch.float32)),
    ("node_dom", lambda a: a.t()),
    ("match_key", lambda a: a.to(torch.int64)),
    ("match_cnt", lambda a: a.half()),
    ("match_total", lambda a: a[:1]),
    ("decl_reach", lambda a: a.to(torch.float32)),
    ("sym_cnt", lambda a: a[:, :4]),
    ("decl_src_list", lambda a: (a[0].long(), a[1])),
    ("aff_self", lambda a: a.to(torch.uint8)),
    ("anti_need_list", lambda a: a[0]),
    ("pref_w", lambda a: a.double()),
    ("sym_w", lambda a: a[:2]),
    ("schedulable", lambda a: a.to(torch.int32)),
    ("saa_group", lambda a: a.to(torch.int64)),
    ("saa_labeled", lambda a: a[:1]),
    ("saa_num", lambda a: a[:1]),
    ("saa_src_list", lambda a: (a[0], a[1][:-1])),
])
def test_wrapper_checks_every_rich_tensor(field, bad):
    args = {**_args(), **_rich()}
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=field):
        scan.scan_chunk(torch.zeros((4, 8)), **args)


def test_wrapper_checks_the_rich_families():
    """Partial families, terms without their state, rows out of range and
    unknown arguments are refused before anything launches."""
    enc = torch.zeros((4, 8))
    base = _args()
    rich = _rich()
    with pytest.raises(ValueError, match="ports needs"):
        scan.scan_chunk(enc, **base, ports_used=rich["ports_used"])
    with pytest.raises(ValueError, match="max_ebs needs"):
        scan.scan_chunk(enc, **base, pd_ebs=rich["pd_ebs"])
    with pytest.raises(ValueError, match="inter-pod affinity state needs"):
        scan.scan_chunk(enc, **{**base, "terms": (
            ("InterPodAffinityPriority", 1, 0),)})
    with pytest.raises(ValueError, match="inter-pod affinity state needs"):
        scan.scan_chunk(enc, **base, aff_self=rich["aff_self"])
    with pytest.raises(ValueError, match="without an InterPodAffinity"):
        scan.scan_chunk(enc, **{**rich, **base})
    with pytest.raises(ValueError, match="without a ServiceAntiAffinity"):
        scan.scan_chunk(enc, **{**rich, **base, "terms": (
            ("InterPodAffinityPriority", 1, 0),)})
    with pytest.raises(ValueError, match=r"rows \[2\] outside"):
        scan.scan_chunk(enc, **{**base, **rich, "terms": (
            ("InterPodAffinityPriority", 1, 0),
            ("ServiceAntiAffinityPriority", 1, 2))})
    with pytest.raises(ValueError, match="unknown arguments"):
        scan.scan_chunk(enc, **base, vol_ro_used=rich["vol_rw"])
    with pytest.raises(ValueError, match="template-factored"):
        scan.scan_chunk(enc, **{**base, "tmpl_terms": (
            ("ServiceAntiAffinityPriority", 1, 0),)})


@pytest.mark.parametrize("p,s,density", [
    (1, 1, 1.0), (5, 1, 0.5), (7, 9, 0.0), (7, 9, 1.0), (33, 17, 0.1),
    (64, 300, 0.01), (3, 0, 0.5), (0, 4, 0.5)])
def test_term_lists_rebuild_the_dense_rows_in_order(p, s, density):
    rng = np.random.RandomState(p * 1000 + s)
    dense = torch.from_numpy(rng.rand(p, s) < density)
    off, idx = scan.term_lists(dense)
    assert off.dtype == idx.dtype == torch.int32
    assert tuple(off.shape) == (p + 1,) and tuple(idx.shape) == (p * s,)
    assert int(off[0]) == 0 and int(off[-1]) == int(dense.sum())
    for row in range(p):
        got = idx[int(off[row]):int(off[row + 1])].tolist()
        assert got == dense[row].nonzero().flatten().tolist()


@pytest.mark.parametrize("field,bad", [
    ("request", lambda a: a.to(torch.int64)),
    ("nonzero", lambda a: a[:, :1]),
    ("zero_request", lambda a: a.to(torch.int32)),
    ("alloc", lambda a: a.t()),
    ("packed", lambda a: a[:4]),
    ("counter", lambda a: a.to(torch.int32)),
    ("d_plane", lambda a: a.half()),
    ("tmpl_idx", lambda a: a[:2]),
    ("spread_incr", lambda a: a.to(torch.uint8)),
    ("sp_node", lambda a: a.t().contiguous().t()),
    ("sp_maxn", lambda a: a[:1]),
    ("node_zone", lambda a: a.to(torch.int64)),
    ("has_zones", lambda a: a[:1]),
    ("sp_zone", lambda a: a.t()),
    ("sp_maxz", lambda a: a.double()),
])
def test_wrapper_checks_every_tensor(field, bad):
    args = _args()
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=field):
        scan.scan_chunk(torch.zeros((4, 8)), **args)


def test_wrapper_checks_shapes_terms_and_families():
    enc = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="enc"):
        scan.scan_chunk(enc.double(), **_args())
    with pytest.raises(ValueError, match="enc"):
        scan.scan_chunk(torch.zeros((8, 4)).t(), **_args())
    with pytest.raises(ValueError, match="N <="):
        scan.scan_chunk(torch.zeros((1, scan.MAX_NODES + 1)),
                        **_args(p=1, n=scan.MAX_NODES + 1))
    with pytest.raises(ValueError, match="at most"):
        scan.scan_chunk(enc, **{**_args(), "terms": (
            ("LeastRequestedPriority", 1, 0),) * (scan.MAX_TERMS + 1)})
    with pytest.raises(ValueError, match="not a priority"):
        scan.scan_chunk(enc, **{**_args(), "terms": (
            ("ImageLocalityPriority", 1, 0),)})
    spreadless = {k: v for k, v in _args().items()
                  if k not in ("sp_node", "sp_zone")}
    with pytest.raises(ValueError, match="spread term needs sp_node"):
        scan.scan_chunk(enc, **spreadless)
    with pytest.raises(ValueError, match="tmpl_terms given"):
        scan.scan_chunk(enc, **{**_args(), "d_plane": None})


def test_build_is_one_nvcc_command_over_both_sources_without_fma():
    cmd = kernels.nvcc_command(kernels.BUILD_DIR / "lib.so")
    joined = " ".join(cmd)
    assert "--fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "fast-math" not in joined and "fast_math" not in joined
    assert [c for c in cmd if c.endswith(".cu")] == \
        [str(s) for s in kernels.SOURCES]
    assert {s.name for s in kernels.SOURCES} == {"select.cu", "scan.cu"}
    assert kernels.library_path().parent == kernels.BUILD_DIR


def test_library_name_hashes_both_sources(tmp_path, monkeypatch):
    a, b = tmp_path / "select.cu", tmp_path / "scan.cu"
    a.write_text("// a\n")
    b.write_text("// b\n")
    monkeypatch.setattr(kernels, "SOURCES", (a, b))
    first = kernels.library_path()
    b.write_text("// b, edited\n")
    second = kernels.library_path()
    a.write_text("// a, edited\n")
    third = kernels.library_path()
    assert len({first, second, third}) == 3


def _scan_source() -> str:
    return kernels.SOURCES[1].read_text()


def _struct_fields(src: str, name: str) -> list[str]:
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        for part in decl.split(","):
            names.append(re.sub(r"\[.*\]", "",
                                part.strip().split()[-1]).lstrip("*"))
    return names


def test_ctypes_struct_mirrors_the_kernel_struct():
    """Each C argument struct (``ScanArgs`` and the rich families'
    ``RichArgs``, ``PdArgs`` and ``TermList``) and its ctypes mirror list
    the same fields in the same order, with the same array sizes and term
    kinds (the wrapper also checks ``sizeof(ScanArgs)`` against the built
    library before its first launch)."""
    src = _scan_source()
    for c_name, mirror in (("ScanArgs", scan._ScanArgs),
                           ("RichArgs", scan._RichArgs),
                           ("PdArgs", scan._PdArgs),
                           ("TermList", scan._TermList),
                           ("SmemPlan", scan._SmemPlan)):
        assert _struct_fields(src, c_name) == \
            [f for f, _ in mirror._fields_], c_name
    assert f"constexpr int kMaxTerms = {scan.MAX_TERMS};" in src
    assert "16 * kMaxThreads" in src and \
        "constexpr int kMaxThreads = 1024;" in src
    assert scan.MAX_NODES == 16 * 1024
    kinds = dict(re.findall(r"constexpr int k(Least|Most|Balanced|Spread|"
                            r"InterPod|ServiceAnti) = (\d);", src))
    assert sorted(int(v) for v in kinds.values()) == list(range(6))
    assert scan.TERM_KINDS["LeastRequestedPriority"] == int(kinds["Least"])
    assert scan.TERM_KINDS["MostRequestedPriority"] == int(kinds["Most"])
    assert scan.TERM_KINDS["BalancedResourceAllocation"] == \
        int(kinds["Balanced"])
    assert scan.TERM_KINDS["SelectorSpreadPriority"] == \
        scan.TERM_KINDS["ServiceSpreadingPriority"] == int(kinds["Spread"])
    assert scan.TERM_KINDS["InterPodAffinityPriority"] == \
        scan.INTERPOD_KIND == int(kinds["InterPod"])
    assert scan.TERM_KINDS["ServiceAntiAffinityPriority"] == \
        scan.SERVICE_ANTI_KIND == int(kinds["ServiceAnti"])
    # The plan's constants: the shared-memory limit, the ring depth, the
    # instantiations, the pod slot's head and the fixed records.
    assert f"constexpr int kSmemLimit = {scan.SMEM_LIMIT};" in src
    assert f"constexpr int kMaxStages = {scan.MAX_STAGES};" in src
    ks = re.search(r"#define KT_SCAN_KS\(X\) (.*)", src).group(1)
    assert tuple(int(k) for k in re.findall(r"X\((\d+)\)", ks)) == scan.KS
    off = int(re.search(r"constexpr int kSlotOff = (\d+);", src).group(1))
    lists = int(re.search(r"kLists = (\d+);", src).group(1))
    assert "kSlotIncr = kSlotOff + 2 * kLists;" in src
    assert off + 2 * lists == scan.SLOT_HEAD
    assert _records_size(src) == scan.FIXED_SMEM


def _records_size(src: str) -> int:
    """sizeof(Records) from its declaration (4-, 8- and 16-byte
    fields)."""
    consts = {"kMaxWarps": 32, "kMaxK": 16,
              "kMaxStages": scan.MAX_STAGES}
    widths = {"int4": 16, "float2": 8, "unsigned long long": 8}
    body = re.search(r"struct Records \{(.*?)\};", src, re.S).group(1)
    size = align = 0
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        width = next((w for t, w in widths.items() if decl.startswith(t)),
                     4)
        count = 1
        for dim in re.findall(r"\[(\w+)\]", decl):
            count *= int(dim) if dim.isdigit() else consts[dim]
        size = -(-size // width) * width + width * count
        align = max(align, width)
    return -(-size // align) * align


@pytest.mark.parametrize("n", [1, 1025, 5000, 16384])
@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("s", [8, 64])
def test_cluster_plan_slices_cover_the_nodes_in_rank_order(n, t, s):
    """At the rule's cluster size and every allowed one: slices
    contiguous, in rank order, covering N exactly, none empty; each CTA's
    threads cover its slice at K nodes per thread; the shared memory
    (regions 16-byte aligned, not overlapping) within 232,448 bytes."""
    plans = [scan.cluster_plan(n, t=t, s=s, z=12)]
    plans += [scan.cluster_plan(n, t=t, s=s, z=12, cluster=c)
              for c in scan.allowed_clusters(n)]
    for plan in plans:
        slices = plan.slices
        assert len(slices) == plan.cluster
        assert slices[0][0] == 0 and slices[-1][1] == n
        for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
            assert hi == lo2
        assert all(hi > lo for lo, hi in slices)
        if plan.cluster > 1:
            assert plan.slice % 8 == 0
        assert plan.k in scan.KS
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.threads * plan.k >= plan.slice
        assert plan.threads - 32 < -(-plan.slice // plan.k)
        assert plan.smem <= scan.SMEM_LIMIT
        assert 2 <= plan.stages <= scan.MAX_STAGES
        starts = [plan.off_slots, plan.off_repl, plan.off_ring] + [
            off for off in plan.offsets.values() if off >= 0]
        assert all(x % 16 == 0 for x in starts[1:])
        assert sorted(starts) == starts
        assert plan.off_slots == scan.FIXED_SMEM
        assert plan.stage_bytes >= (plan.slice + 2) * 4
        assert plan.slot_words == scan.SLOT_HEAD + -(-s // 4) + 1


def test_the_plan_fills_the_kernel_struct():
    plan = scan.cluster_plan(5000, t=32, s=8, z=12, cluster=8)
    st = scan.plan_struct(plan)
    assert (st.cluster, st.slice, st.threads, st.k, st.stages, st.bytes,
            st.slot_words) == (8, 632, 640, 1, 4, plan.smem, 43)
    assert (st.off_slots, st.off_repl, st.off_ring, st.stage_bytes) == (
        plan.off_slots, plan.off_repl, plan.off_ring, plan.stage_bytes)
    assert [st.off_packed, st.off_alloc, st.off_zone, st.off_sp,
            st.off_d] == [plan.offsets[k] for k in scan.PLANES]


def test_the_rule_takes_a_cluster_at_the_north_star():
    assert scan.cluster_plan(1, t=32, s=8, z=12).cluster == 1
    assert scan.cluster_plan(5000, t=32, s=8, z=12).cluster >= 2
    assert scan.cluster_plan(16384, t=32, s=8, z=12).cluster == 16
    assert scan.allowed_clusters(1) == (1,)
    assert scan.allowed_clusters(5000) == scan.CLUSTER_SIZES
    # The rule's table, at its edges.
    for (bound, c), prev in zip(scan.RULE, (0,) + tuple(
            b for b, _ in scan.RULE)):
        assert scan.cluster_plan(bound, t=32, s=8, z=12).cluster == c
        assert scan.cluster_plan(prev + 1, t=32, s=8, z=12).cluster == c
    assert scan.RULE[-1][0] == scan.MAX_NODES


@pytest.mark.parametrize("n", [1, 31, 64, 320, 640, 641, 1000, 1025, 2048,
                               2049, 5000, 16384])
def test_the_rule_runs_one_node_per_thread_at_an_allowed_cluster(n):
    """Whatever N, the rule's cluster leaves no CTA without nodes and
    gives each thread one node (K = 1, the instantiation the rule runs;
    the others serve the checks' forced cluster sizes)."""
    plan = scan.cluster_plan(n, t=32, s=8, z=12)
    assert plan.cluster in scan.allowed_clusters(n)
    assert plan.k == 1
    assert plan.threads >= plan.slice


@pytest.mark.parametrize("n,t,s,cluster,resident", [
    # The north star's chunk at the rule's C: every small plane fits.
    (5000, 32, 8, None, scan.PLANES),
    # T = 64 at N = 16,384: D does not fit at any cluster size.
    (16384, 64, 8, 16, ("packed", "alloc", "node_zone", "sp_node")),
    (16384, 64, 8, 8, ("packed", "alloc", "node_zone", "sp_node")),
    # One CTA of 16,384 nodes holds only the zone ids.
    (16384, 32, 8, 1, ("node_zone",)),
    # S = 64 spread groups at 5,000 nodes and C = 8: D stays outside.
    (5000, 64, 64, 8, ("packed", "alloc", "node_zone", "sp_node")),
    (1, 64, 64, 1, scan.PLANES),
])
def test_the_byte_budget_chooses_the_resident_planes(n, t, s, cluster,
                                                     resident):
    plan = scan.cluster_plan(n, t=t, s=s, z=12, cluster=cluster)
    assert plan.resident == resident
    assert plan.smem <= scan.SMEM_LIMIT
    # A plane the budget skipped would not have fitted where it stood.
    used = plan.off_ring + plan.stages * plan.stage_bytes
    per_node = {"packed": 24, "alloc": 16, "node_zone": 4,
                "sp_node": 4 * s, "d_plane": 4 * t}
    for name in scan.PLANES:
        need = -(-per_node[name] * plan.slice // 16) * 16
        if name in resident:
            assert plan.offsets[name] == used
            used += need
        else:
            assert plan.offsets[name] == -1
            assert used + need > scan.SMEM_LIMIT


def test_a_plan_without_spread_or_templates_keeps_no_such_plane():
    plan = scan.cluster_plan(5000)
    assert plan.resident == ("packed", "alloc")
    assert plan.slot_words == scan.SLOT_HEAD


@pytest.mark.parametrize("cluster", [0, 3, 32, -8, True, 8.0])
def test_cluster_argument_outside_the_sizes_is_refused(cluster):
    before = scan.scan_chunk.launches
    with pytest.raises(ValueError, match="cluster"):
        scan.scan_chunk(torch.zeros((4, 8)), **_args(), cluster=cluster)
    assert scan.scan_chunk.launches == before


def test_a_forced_route_reaches_the_wrapper_with_its_cluster_size():
    """A ``kernel@C`` route of the checks reaches the solver as
    ``cluster=C``: C is checked by the plan, a valid C stops only at the
    CPU tensors, without launching, and a malformed route is refused by
    name."""
    from kubernetes_tpu_torch.perf import scan_check
    case = scan_check.case("N=31", "cpu")
    before = scan.scan_chunk.launches
    for route in ("kernel@x", "kernel@", "steps@2", "kernels"):
        with pytest.raises(ValueError, match="is not steps, kernel"):
            scan_check.run_routes(case, ("steps", route))
    with pytest.raises(ValueError, match="cluster must be one of"):
        scan_check.run_routes(case, ("steps", "kernel@3"))
    with pytest.raises(ValueError, match="without nodes"):
        scan_check.run_routes(case, ("steps", "kernel@8"))
    for route in ("kernel@2", "kernel@*"):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            scan_check.run_routes(case, ("steps", route))
    assert scan.scan_chunk.launches == before


def test_cluster_argument_is_checked_against_n_and_refuses_cpu_tensors():
    before = scan.scan_chunk.launches
    # N = 8 leaves CTAs without nodes at C = 2 and above.
    for cluster in (2, 4, 8, 16):
        with pytest.raises(ValueError, match="without nodes"):
            scan.scan_chunk(torch.zeros((4, 8)), **_args(), cluster=cluster)
    with pytest.raises(ValueError, match="CUDA"):
        scan.scan_chunk(torch.zeros((4, 8)), **_args(), cluster=1)
    n = 1025
    for cluster in scan.allowed_clusters(n):
        with pytest.raises(ValueError, match="CUDA"):
            scan.scan_chunk(torch.zeros((4, n)), **_args(n=n),
                            cluster=cluster)
    assert scan.scan_chunk.launches == before


@pytest.mark.parametrize("policy", ["default", "f16"])
@pytest.mark.parametrize("cap", [None, 2], ids=["templates", "over-cap"])
def test_cpu_chunked_mixed_drain_matches_reference(policy, cap, monkeypatch):
    """The new dispatch on CPU tensors (the step loop), in chunks of 24
    with carried state, against the reference's one-shot scan."""
    if cap is not None:
        monkeypatch.setattr(ref_sv, "DYN_TEMPLATE_CAP", cap)
    eng, pods, _ = ref_rig("mixed", 40, 96, n_existing=150, policy=policy)
    batch, hb, hc, _ = host_inputs(eng, pods)
    flags = ref_sv.batch_flags(batch)
    jb, jc, tb, tc = both(hb, hc)
    ch_j, cnt_j, fin_j = eng.solver._solve_scan(
        jb, jc, jnp.uint32(2 ** 32 - 7), None, flags, None, None, None)
    solver = t_sv.Solver(torch_policy(policy))
    counter = convert.counter_from_numpy(2 ** 32 - 7, "cpu")
    carry, outs = None, []
    for start in range(0, 96, 24):
        ch, counter, carry = solver._solve_scan(
            t_sv.slice_pod_axis(tb, start, start + 24), tc, counter, None,
            t_sv.BatchFlags(*flags), carry, None, None)
        outs.append(ch)
    assert same(torch.cat(outs), ch_j)
    assert int(counter[0]) == int(np.asarray(cnt_j))
    assert set(carry) == set(fin_j)
    for k in fin_j:
        if k != "counter":
            assert same(carry[k], fin_j[k]), k
    assert ("D" in carry) is (cap is None)


def test_a_library_laid_out_otherwise_is_refused(monkeypatch):
    """The wrapper checks ``sizeof(ScanArgs)`` of the built library
    against its ctypes mirror before it launches."""
    import ctypes

    class _Lib:
        def kt_scan_args_size(self):
            return ctypes.sizeof(scan._ScanArgs) - 8

    monkeypatch.setattr(scan, "library", _Lib)
    with pytest.raises(RuntimeError, match="ctypes mirror"):
        scan._library()



@pytest.mark.parametrize("cut", sorted(scan_ablation._CUTS))
def test_every_ablation_cut_applies_to_the_kernel_source(cut):
    """Each of ``perf/scan_ablation.py``'s cuts finds its anchor text in
    ``csrc/scan.cu`` exactly once, so the ablation still builds."""
    src = scan_ablation._SCAN.read_text()
    out = scan_ablation.variant_source(src, (cut,))
    assert out != src

"""The scan kernel's dispatch, wrapper, build and plain path, on the CPU.

``engine/scan.py:scan_chunk`` launches ``csrc/scan.cu`` on CUDA tensors
only; its plain version is the step loop of ``Solver._fused_scan``, held
against the kernel on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Here: which chunks the dispatch sends to the kernel,
the wrapper's argument checks, the one ``nvcc`` command that builds the
library (hashing both sources, FMA contraction off), the C argument
struct against its ctypes mirror, and a chunked ``mixed`` drain through
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
    assert scan.takes(fams)
    assert t_sv.scan_route(CUDA, fams) == "kernel"
    assert t_sv.scan_route(CPU, fams) == "steps"


@pytest.mark.parametrize("family", scan.RICH_FAMILIES)
def test_rich_families_stay_on_the_step_loop(family):
    fams = {**MIXED, family: True}
    assert not scan.takes(fams)
    assert t_sv.scan_route(CUDA, fams) == "steps"
    assert t_sv.scan_route(CPU, fams) == "steps"


def _fams_of(monkeypatch, profile: str, policy: str = "default"):
    """The families ``_solve_scan`` derives for a compiled batch."""
    eng, pods, _ = ref_rig(profile, 40, 64, n_existing=60, policy=policy)
    batch, hb, hc, _ = host_inputs(eng, pods)
    _, _, tb, tc = both(hb, hc)
    solver = t_sv.Solver(torch_policy(policy))
    seen = {}

    def capture(self, b, c, last, mask, score, carry, has_bias, fams,
                prios, route=None):
        seen["fams"] = fams
        raise StopIteration

    with monkeypatch.context() as m:
        m.setattr(t_sv.Solver, "_fused_scan", capture)
        with pytest.raises(StopIteration):
            solver._solve_scan(tb, tc, convert.counter_from_numpy(0, "cpu"),
                               None, t_sv.BatchFlags(*ref_sv.batch_flags(
                                   batch)), None, None, None)
    return seen["fams"], solver, tb, tc, batch


@pytest.mark.parametrize("profile,policy,kernel", [
    ("mixed", "default", True), ("mixed", "f16", True),
    ("rich", "default", False)])
def test_compiled_batches_route_by_profile(profile, policy, kernel,
                                           monkeypatch):
    fams, *_ = _fams_of(monkeypatch, profile, policy)
    assert scan.takes(fams) is kernel
    assert t_sv.scan_route(CUDA, fams) == ("kernel" if kernel else "steps")


def test_forcing_the_kernel_on_rich_families_raises(monkeypatch):
    _, solver, tb, tc, batch = _fams_of(monkeypatch, "rich")
    with pytest.raises(ValueError, match="does not carry"):
        solver._solve_scan(tb, tc, convert.counter_from_numpy(0, "cpu"),
                           None, t_sv.BatchFlags(*ref_sv.batch_flags(batch)),
                           None, None, None, route="kernel")


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


def test_wrapper_refuses_cpu_tensors_without_launching():
    before = scan.scan_chunk.launches
    for enc_dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="CUDA"):
            scan.scan_chunk(torch.zeros((4, 8), dtype=enc_dtype), **_args())
    assert scan.scan_chunk.launches == before


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
            ("InterPodAffinityPriority", 1, 0),)})
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


def test_ctypes_struct_mirrors_the_kernel_struct():
    """The C ``ScanArgs`` and ``_ScanArgs`` list the same fields in the
    same order, with the same array sizes and term kinds."""
    src = _scan_source()
    body = re.search(r"struct ScanArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        for part in decl.split(","):
            names.append(re.sub(r"\[.*\]", "",
                                part.strip().split()[-1]).lstrip("*"))
    assert names == [f for f, _ in scan._ScanArgs._fields_]
    assert f"constexpr int kMaxTerms = {scan.MAX_TERMS};" in src
    assert "16 * kMaxThreads" in src and \
        "constexpr int kMaxThreads = 1024;" in src
    assert scan.MAX_NODES == 16 * 1024
    kinds = dict(re.findall(r"constexpr int k(Least|Most|Balanced|Spread)"
                            r" = (\d);", src))
    assert {int(kinds["Least"]), int(kinds["Most"]),
            int(kinds["Balanced"]), int(kinds["Spread"])} == {0, 1, 2, 3}
    assert scan.TERM_KINDS["LeastRequestedPriority"] == int(kinds["Least"])
    assert scan.TERM_KINDS["MostRequestedPriority"] == int(kinds["Most"])
    assert scan.TERM_KINDS["BalancedResourceAllocation"] == \
        int(kinds["Balanced"])
    assert scan.TERM_KINDS["SelectorSpreadPriority"] == \
        scan.TERM_KINDS["ServiceSpreadingPriority"] == int(kinds["Spread"])


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

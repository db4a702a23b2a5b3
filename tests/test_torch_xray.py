"""kt-xray on the port (``kubernetes_tpu_torch/analysis/xray.py``, the
registry ``engine/entrypoints.py``) against the JAX package's.

* The committed manifest matches a rebuild (no drift, every finding
  justified, no stale justification), and the bench's stamp reads it.
* Each X rule trips on a planted fixture: a host sync (X01), a widening
  (X02, an int64 index is exempt), an unannotated or mis-annotated
  write (X03), a coverage gap, an unregistered kernel wrapper, symbol or
  live-path region and a warmed program the prewarm never runs (X04).
* X04 covers the real tree; the warmed programs equal
  ``prewarm_plan(ladder, cuda=True)``.
* The registry maps every JAX family, and where a family has a JAX
  counterpart its output shapes on ``meta`` tensors equal
  ``jax.eval_shape``'s for the same canonical inputs.
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.analysis import core as lint_core
from kubernetes_tpu_torch.analysis import xray
from kubernetes_tpu_torch.engine import entrypoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


@pytest.fixture(scope="module")
def built():
    return xray.build_manifest()


def test_committed_manifest_matches_a_rebuild():
    result = xray.run_check()
    assert not result.failed, "\n".join(
        result.drift + [f.text() for f in result.new] +
        [f"STALE {fp}" for fp in result.stale_justifications])
    data = xray.load_manifest()
    assert data["hash"] == xray.manifest_hash(data["programs"])
    assert data["canonical"] == xray.CANON
    for fp, why in data["justifications"].items():
        assert why and "JUSTIFY" not in why, fp
    assert xray.manifest_summary() == {"hash": data["hash"],
                                       "programs": len(data["programs"])}


def test_the_manifest_lives_in_the_port_package():
    assert xray.DEFAULT_MANIFEST == os.path.join(
        REPO, "kubernetes_tpu_torch", "analysis", "shape_manifest.json")


def test_driver_check_and_summary(capsys):
    assert xray.main(["--summary"]) == 0
    assert json.loads(capsys.readouterr().out)["programs"] > 10
    assert xray.main(["--rules"]) == 0
    assert xray.main([]) == 0


def test_write_manifest_keeps_justifications_and_drops_stale(tmp_path):
    path = str(tmp_path / "m.json")
    committed = xray.load_manifest()
    with open(path, "w") as f:
        json.dump(dict(committed, justifications=dict(
            committed["justifications"], **{"X01:ghost:gone": "stale"})), f)
    m = xray.write_manifest(path)
    assert "X01:ghost:gone" not in m["justifications"]
    assert m["justifications"] == committed["justifications"]
    assert m["programs"] == committed["programs"]


def test_build_is_deterministic_in_process(built):
    again, _ = xray.build_manifest()
    assert again["programs"] == built[0]["programs"]
    assert again["hash"] == built[0]["hash"]


def test_drift_detection(built):
    manifest, _ = built
    committed = {k: dict(v) for k, v in manifest["programs"].items()}
    assert xray.diff_programs(committed, manifest["programs"]) == []
    committed["joint@256"]["fingerprint"] = "sha256:tampered"
    drift = xray.diff_programs(committed, manifest["programs"])
    assert any("joint@256: fingerprint drifted" in d for d in drift)
    del committed["victim_solve"]
    drift = xray.diff_programs(committed, manifest["programs"])
    assert any("victim_solve: new program" in d for d in drift)


def test_a_kernel_source_edit_is_drift(built, monkeypatch):
    """The scan kernel's source hash is part of its programs."""
    manifest, _ = built
    real = xray._sha
    monkeypatch.setattr(xray, "_sha", lambda p: real(p) + (
        "-edited" if p.endswith("scan.cu") else ""))
    programs = {k: dict(v) for k, v in manifest["programs"].items()}
    for key, prog in programs.items():
        if prog["kernel"].get("source", "").endswith("scan.cu"):
            prog["kernel"] = xray._kernel_column(
                entrypoints.by_name()[prog["family"]],
                prog["kernel"]["launches"], xray.CANON["nodes"], 1)
    drift = xray.diff_programs(manifest["programs"], programs)
    assert any("scan_chunk@256: kernel drifted" in d for d in drift)


# -- X01 ---------------------------------------------------------------------

def test_x01_trips_on_a_host_sync():
    def kernel(x):
        if bool((x > 0).any()):          # aten::_local_scalar_dense
            x = x * 2.0
        return x.cpu() + 1.0             # a copy to the CPU

    rec, _, _ = xray.trace_program(kernel, (torch.empty(4, device=META),))
    found = xray.check_x01("synthetic", rec)
    assert {f.rule for f in found} == {"X01"} and len(found) == 2
    assert any("_local_scalar_dense" in f.message for f in found)
    rec, _, _ = xray.trace_program(lambda x: (x * 2.0).sum(),
                                   (torch.empty(4, device=META),))
    assert xray.check_x01("synthetic", rec) == []


# -- X02 ---------------------------------------------------------------------

def test_x02_trips_on_widening_and_exempts_indices():
    x = torch.empty(8, dtype=torch.float32, device=META)
    i = torch.empty(3, dtype=torch.int32, device=META)

    def widen(x, i):
        return x.double() * 2.0, i.long() + 1

    rec, _, _ = xray.trace_program(widen, (x, i))
    found = {f.message.split()[2] for f in xray.check_x02("p", rec)}
    assert found == {"float64", "int64"}

    def index_only(x, i):
        j = i.long()
        return x.index_select(0, j[1:] - 0)

    rec, _, _ = xray.trace_program(index_only, (x, i))
    assert xray.check_x02("p", rec) == []
    f16 = torch.empty(4, dtype=torch.float16, device=META)
    rec, _, _ = xray.trace_program(lambda t: t.float(), (f16,))
    assert xray.check_x02("p", rec) == []
    assert xray.check_x02("p", rec, {"float": 16, "int": 32})


def test_the_justified_widenings_are_the_named_designs():
    data = xray.load_manifest()
    just = data["justifications"]
    assert set(fp.split(":")[0] for fp in just) == {"X02"}
    for fp, why in just.items():
        if "float64" in fp:
            assert "float64" in why
        else:
            assert "int64" in why
    assert any("bid loads" in why for why in just.values())


# -- X03 ---------------------------------------------------------------------

def _engine_module(src: str) -> lint_core.Module:
    return lint_core.Module(path="kubernetes_tpu_torch/engine/fake.py",
                            src=src, tree=ast.parse(src))


def test_x03_unannotated_and_mismatched_writes_trip():
    src = ("def step(state, j, row):\n"
           "    state.index_copy_(0, j, row)\n")
    found = xray.check_x03([_engine_module(src)])
    assert len(found) == 1 and "in-place(<reason>)" in found[0].message
    assert found[0].program == "kubernetes_tpu_torch/engine/fake.py:step"
    wrong = ("def sync(planes, j, rows):\n"
             "    # kt-xray: in-place(wrong)\n"
             "    return planes.index_copy(0, j, rows)\n")
    found = xray.check_x03([_engine_module(wrong)])
    assert len(found) == 1 and "annotated in-place" in found[0].message
    kernel = ("def solve(enc, kw):\n"
              "    return scan_mod.scan_chunk(enc, **kw)\n")
    found = xray.check_x03([_engine_module(kernel)], {"scan_chunk"})
    assert len(found) == 1 and "scan_chunk()" in found[0].message


def test_x03_matching_annotations_clean_and_scope():
    src = ("def f(state, j, rows, planes):\n"
           "    # kt-xray: in-place(the carried state, a reason\n"
           "    # wrapped onto a second comment line)\n"
           "    state.index_add_(0, j, rows)\n"
           "    return planes.index_copy(0, j, rows)  "
           "# kt-xray: no-alias(new planes)\n")
    assert xray.check_x03([_engine_module(src)]) == []
    outside = lint_core.Module(path="kubernetes_tpu_torch/perf/fake.py",
                               src="x.add_(1)\n", tree=ast.parse("x.add_(1)\n"))
    assert xray.check_x03([outside]) == []


def test_the_scatter_is_the_founding_no_alias_case():
    mods = {m.path: m for m in xray.device_modules()}
    solver = mods["kubernetes_tpu_torch/engine/solver.py"]
    sites = [s for s in xray.discover_write_sites(solver)
             if s.func == "sync"]
    assert [s.method for s in sites] == ["index_copy"]
    assert xray._annotation_at(solver, sites[0].line) == "no-alias"


# -- X04 ---------------------------------------------------------------------

def test_x04_real_tree_is_fully_covered(built):
    manifest, _ = built
    assert xray.check_x04(manifest["programs"], xray.device_modules()) == []


def test_warmed_programs_equal_the_prewarm_plan():
    from kubernetes_tpu_torch.scheduler.scheduler import prewarm_plan
    data = xray.load_manifest()
    warmed = sorted(k for k, p in data["programs"].items() if p["warmed"])
    assert warmed == prewarm_plan(xray.canonical_ladder(), cuda=True)


def test_x04_coverage_gap_and_unreachable_warmed_program(built):
    manifest, _ = built
    programs = dict(manifest["programs"])
    del programs["scan_chunk@512"]
    found = xray.check_x04(programs, xray.device_modules())
    assert any("ladder coverage gap" in f.message for f in found)
    programs = dict(manifest["programs"])
    programs["scan_chunk@999"] = dict(programs["scan_chunk@256"])
    found = xray.check_x04(programs, xray.device_modules())
    assert any("unreachable-from-prewarm" in f.message for f in found)


def test_x04_unregistered_wrapper_region_and_symbol_trip(built):
    manifest, _ = built
    rogue = _engine_module(
        "def rogue_kernel(x):\n"
        "    rogue_kernel.launches += 1\n"
        "    return x\n"
        "def rogue_path(x):\n"
        "    with devicestats.live_path('rogue'):\n"
        "        return x\n")
    found = xray.check_x04(manifest["programs"],
                           xray.device_modules() + [rogue])
    msgs = {f.program: f.message for f in found}
    assert "unmanifested kernel wrapper" in \
        msgs["kubernetes_tpu_torch/engine/fake.py:rogue_kernel"]
    assert "unmanifested live-path region" in \
        msgs["kubernetes_tpu_torch/engine/fake.py:rogue_path"]
    symbols = dict(xray.extern_symbols(), kt_rogue="x/csrc/r.cu")
    found = xray.check_x04(manifest["programs"], xray.device_modules(),
                           symbols)
    assert any("unclaimed kernel symbol" in f.message and
               "kt_rogue" in f.program for f in found)


def test_every_extern_symbol_and_launch_site_is_claimed():
    syms = xray.extern_symbols()
    assert {"kt_scan_chunk", "kt_select_rows", "kt_select_hosts"} <= \
        set(syms)
    assert set(syms) == entrypoints.claimed_symbols()
    sites = entrypoints.claimed_launch_sites()
    for site in ("kubernetes_tpu_torch/engine/scan.py:scan_chunk",
                 "kubernetes_tpu_torch/engine/fused.py:select_rows",
                 "kubernetes_tpu_torch/ops/combine.py:select_hosts",
                 "kubernetes_tpu_torch/engine/solver.py:_price_iterate",
                 "kubernetes_tpu_torch/engine/solver.py:sync"):
        assert site in sites, site


def test_the_scan_programs_record_their_launch_and_reach(built):
    manifest, _ = built
    prog = manifest["programs"]["scan_chunk@2048"]
    (launch,) = prog["kernel"]["launches"]
    assert launch["symbol"] == "kt_scan_chunk" and launch["p"] == 2048
    assert launch["cluster"] == 1 and launch["instantiation"] == "mixed"
    reach = prog["kernel"]["reach"]
    from kubernetes_tpu_torch.engine import scan
    assert reach["k"] == list(scan.KS)
    assert reach["rule"] == [list(r) for r in scan.RULE]
    assert manifest["programs"]["build"]["fingerprint"] == \
        xray.library_digest()


# -- the registry against the JAX package's ------------------------------------

def test_registry_maps_every_jax_family():
    from kubernetes_tpu.engine import entrypoints as ref_entry
    ref = {e.name for e in ref_entry.ENTRYPOINTS}
    assert ref == set(entrypoints.JAX_FAMILIES)
    for name in ref:
        assert entrypoints.port_family(name) in entrypoints.by_name()
    for e in entrypoints.ENTRYPOINTS:
        assert e.doc and e.dispatch_site and e.launch_sites
        assert (e.kernel == "") == (e.source == "" or e.name == "build")


def test_canonical_constants_are_the_defaults():
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.utils import knobs
    assert xray.CANON["floor"] == Scheduler.STREAM_MIN_BUCKET
    assert xray.CANON["pad_limit"] == Scheduler._PAD_LIMIT
    assert xray.CANON["victims"] == int(
        knobs.REGISTRY["KT_PREEMPT_MAX_VICTIMS"][0])
    from kubernetes_tpu.analysis import xray as ref_xray
    for key in ("nodes", "floor", "pad_limit", "victims", "topo_terms",
                "topo_domains", "joint_iters", "feature_bits"):
        assert xray.CANON[key] == ref_xray.CANON[key], key
    assert xray.canonical_ladder() == ref_xray.canonical_ladder()


def _ref_out_avals() -> dict:
    """The JAX package's out avals per program, by jax.eval_shape, or
    None where the installed JAX cannot trace its manifest."""
    from kubernetes_tpu.analysis import xray as ref_xray
    import jax
    ctx = ref_xray.build_context()
    out = {}
    for key, (_fam, fn, args) in ref_xray.program_builders(ctx).items():
        try:
            out[key] = ref_xray._avals(jax.eval_shape(fn, *args))
        except Exception:  # noqa: BLE001 — recorded as untraceable
            out[key] = None
    return out


def _scalar_count(avals: list) -> list:
    return sorted(a.split("[")[1] for a in avals)


@pytest.mark.parametrize("ref_key,port_key,pick", [
    ("single_evaluate@1", "single_evaluate@1", slice(None)),
    ("victim_solve", "victim_solve", slice(None)),
    ("topo_planes", "topo_planes", slice(None)),
    ("select_hosts@1", "select_hosts@1", slice(0, 1)),
    ("scan_first@2048", "scan_chunk@2048", slice(0, 1)),
    ("scan_first@256", "scan_chunk@256", slice(0, 1)),
    ("joint@256", "joint@256", slice(0, 1)),
])
def test_output_shapes_equal_the_jax_eval_shape(built, ref_key, port_key,
                                                pick):
    """The choices / planes of a family have the JAX program's shapes
    (dtypes may differ: the port's counter is int64, its planes have no
    narrow form)."""
    ref = _ref_out_avals_cached()
    if ref.get(ref_key) is None:
        pytest.skip(f"the installed jax cannot trace {ref_key}")
    port = built[0]["programs"][port_key]["out_avals"]
    assert [a.split("[")[1] for a in ref[ref_key][pick]] == \
        [a.split("[")[1] for a in port[pick]]


_REF_CACHE: dict = {}


def _ref_out_avals_cached() -> dict:
    if not _REF_CACHE:
        _REF_CACHE.update(_ref_out_avals())
    return _REF_CACHE

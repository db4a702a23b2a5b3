"""kt-lint on the port (``kubernetes_tpu_torch/analysis/``) against the JAX
package's (``kubernetes_tpu/analysis/``).

* The JAX ``tests/test_ktlint.py`` fixtures, with ``jax`` rewritten to
  ``torch`` where a rule reads it, go through both packages' rule
  engines and give the same findings once the package prefix is mapped
  (rule, path, line; the message too where it names no layer).
* The core's fingerprints, suppressions, baseline grandfathering and
  staleness behave as the JAX core's.
* The port's tree is clean against its own (empty) baseline, its rule
  inventory is pinned against the README table, and its knob registry
  is in sync with the code.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from kubernetes_tpu.analysis import core as ref_core
from kubernetes_tpu.analysis import rules_concurrency as _ref_c  # noqa: F401
from kubernetes_tpu.analysis import rules_device as _ref_d  # noqa: F401
from kubernetes_tpu_torch.analysis import core
from kubernetes_tpu_torch.analysis import knobs_check
from kubernetes_tpu_torch.analysis import rules_concurrency  # noqa: F401
from kubernetes_tpu_torch.analysis import rules_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED_RULES = {"D01", "D02", "D03", "D04", "D05", "C01", "C02", "C03"}
REF, PORT = "kubernetes_tpu/", "kubernetes_tpu_torch/"


def _module(mod, src: str, path: str):
    return mod.Module(path=path, src=src, tree=ast.parse(src))


def _port(rule: str, src: str, sub: str) -> list:
    out = core.RULES[rule].check(_module(core, src, PORT + sub))
    return [f for f in out if f is not None]


def _ref(rule: str, src: str, sub: str) -> list:
    out = ref_core.RULES[rule].check(_module(ref_core, src, REF + sub))
    return [f for f in out if f is not None]


def _key(f, messages: bool = False) -> tuple:
    path = f.path.replace(PORT, REF, 1) if f.path.startswith(PORT) \
        else f.path
    return (f.rule, path, f.line) + ((f.message,) if messages else ())


def _same(rule: str, ref_src: str, port_src: str, sub: str,
          messages: bool = False) -> list:
    """The findings of both engines, asserted equal after mapping."""
    ref = sorted(_key(f, messages) for f in _ref(rule, ref_src, sub))
    port = sorted(_key(f, messages) for f in _port(rule, port_src, sub))
    assert ref == port, (ref, port)
    return port


def _to_torch(src: str) -> str:
    return src.replace("jax.device_get", "torch.cuda.synchronize") \
        .replace("import jax.numpy as jnp", "import torch.nn as nn") \
        .replace("jax", "torch")


# -- the tier-1 ratchet on the port's tree -----------------------------------

def test_port_tree_is_clean_against_its_baseline():
    result = core.run_project()
    msgs = [f.text() for f in result.new] + \
        [f"STALE: {fp}" for fp in result.stale_baseline]
    assert not result.failed, "\n".join(msgs)
    # The scope is this package, compared by exact prefix.
    paths = {m.path for m in core.load_project().modules}
    assert paths and all(p.startswith(PORT) for p in paths)
    assert not any(p.startswith(REF) for p in paths)


def test_port_baseline_is_empty_and_justified():
    baseline = core.load_baseline()
    assert baseline == {}
    assert core.DEFAULT_BASELINE.endswith(
        "kubernetes_tpu_torch/analysis/ktlint_baseline.json")
    for fp, why in baseline.items():
        assert why and "JUSTIFY" not in why, fp


def test_driver_json_output():
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["new"] == [] and payload["stale_baseline"] == []
    assert set(payload["rules"]) == EXPECTED_RULES


def test_driver_exits_one_on_a_new_finding(tmp_path):
    bad = tmp_path / "kubernetes_tpu_torch" / "scheduler" / "x.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n")
    result = core.run_project(str(tmp_path),
                              baseline_path=str(tmp_path / "none.json"))
    assert result.failed and [f.rule for f in result.new] == ["D01"]


# -- rule inventory: the README's table --------------------------------------

def _readme_inventory() -> str:
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    head = "### Static checks of the port"
    assert head in text
    return text.split(head, 1)[1].split("\n## ", 1)[0]


def test_rule_inventory_pinned_to_the_readme_table():
    assert set(core.RULES) == EXPECTED_RULES == set(ref_core.RULES)
    section = _readme_inventory()
    for rule in core.RULES.values():
        assert rule.title and rule.doc
        assert rule.check is not None or rule.finalize is not None
        assert f"| `{rule.id}` |" in section, rule.id


# -- D01: torch imports ------------------------------------------------------

def test_d01_flags_device_imports_outside_the_allowlist():
    src = "import jax\nimport jax.numpy as jnp\n"
    found = _same("D01", src, _to_torch(src), "scheduler/foo.py")
    assert len(found) == 2


def test_d01_allowlist_and_function_scope():
    src = "from jax import numpy\n"
    for sub in ("engine/foo.py", "perf/foo.py", "utils/profiling.py",
                "parallel/mesh.py"):
        assert not _same("D01", src, _to_torch(src), sub)
    nested = "def f():\n    import jax\n"
    assert _same("D01", nested, _to_torch(nested), "cache/foo.py")
    # The port's own allowlisted modules, each with its stated reason.
    for sub in ("utils/device.py", "analysis/xray.py"):
        assert not _port("D01", "import torch\n", sub)
        assert sub in " ".join(rules_device.DEVICE_ALLOWED)
    # An annotation-only import never runs.
    typed = ("from typing import TYPE_CHECKING\n"
             "if TYPE_CHECKING:\n    import torch\n")
    assert not _port("D01", typed, "scheduler/factory.py")


# -- D02: readbacks ----------------------------------------------------------

def test_d02_flags_raw_readbacks_outside_engine():
    ref_src = "x = jax.device_get(y)\nz = arr.block_until_ready()\n"
    port_src = "x = torch.cuda.synchronize(y)\nz = arr.cpu()\n"
    _same("D02", ref_src, port_src, "scheduler/foo.py")
    assert len(_port("D02", port_src, "scheduler/foo.py")) == 2
    assert not _port("D02", port_src, "engine/solver.py")
    assert _port("D02", "a = t.numpy()\n", "server/extender.py")
    # numpy's own .tolist() of a host index array is no readback.
    assert not _port("D02", "nodes = bad.tolist()\n", "cache/verifier.py")


# -- D03: kernel purity ------------------------------------------------------

_D03_REF = """
import jax, time, os

@jax.jit
def solve(x):
    t = time.time()
    return x + t

def pure(x):
    return time.time()

_impl = jax.vmap(victim)

def victim(x):
    return os.environ.get("KT_FOO", x)
"""

_D03_PORT = """
import torch, time, os

def solve(x):
    t = time.time()
    solve.launches += 1
    return x + t

def pure(x):
    return time.time()

def victim_plain(x):
    return os.environ.get("KT_FOO", x)
"""


def test_d03_flags_impure_kernel_bodies_only():
    """JAX's jitted/vmapped bodies are the port's kernel wrappers (they
    count launches) and plain versions: the same two findings."""
    ref = _ref("D03", _D03_REF, "engine/foo.py")
    port = _port("D03", _D03_PORT, "engine/foo.py")
    assert len(ref) == len(port) == 2
    assert [("time.time" in f.message, "environ" in f.message)
            for f in sorted(ref, key=lambda f: f.line)] == \
        [("time.time" in f.message, "environ" in f.message)
         for f in sorted(port, key=lambda f: f.line)]
    assert not _port("D03", _D03_PORT, "scheduler/x.py")
    rng = "import torch\ndef select_plain(x):\n    return torch.rand(3)\n"
    assert _port("D03", rng, "ops/foo.py")


# -- D04: knob discipline ----------------------------------------------------

def test_d04_raw_kt_env_reads():
    src = 'import os\nv = os.environ.get("KT_TRACE", "1")\n'
    found = _same("D04", src, src, "scheduler/foo.py")
    assert found
    quiet = ('import os\nv = os.environ.get("HOME")\n'
             'w = os.environ.get(name)\nos.environ["KT_X"] = "1"\n')
    assert not _same("D04", quiet, quiet, "scheduler/foo.py")


def test_d04_undeclared_knob_names():
    for pkg, find in (("kubernetes_tpu", _ref), ("kubernetes_tpu_torch",
                                                 _port)):
        src = (f"from {pkg}.utils import knobs\n"
               f"v = knobs.get_int('KT_NOT_A_REAL_KNOB')\n")
        found = find("D04", src, "scheduler/foo.py")
        assert found and "undeclared" in found[0].message


def test_d04_hot_path_reads_even_via_knobs():
    src = ("from kubernetes_tpu.utils import knobs\n"
           "class Scheduler:\n"
           "    def schedule_pending(self):\n"
           "        return knobs.get_int('KT_PIPELINE_WINDOW')\n")
    found = _same("D04", src, src.replace("kubernetes_tpu.",
                                          "kubernetes_tpu_torch."),
                  "scheduler/scheduler.py")
    assert found
    init = src.replace("schedule_pending", "__init__")
    assert not _same("D04", init, init, "scheduler/scheduler.py")


def test_d04_hot_path_table_names_real_port_functions():
    project = core.load_project()
    by_path = {m.path: m for m in project.modules}
    for path, fns in rules_device.HOT_PATH_FUNCTIONS.items():
        assert path.startswith(PORT) and path in by_path, path
        defined = {n.name for n in ast.walk(by_path[path].tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        assert fns <= defined, (path, fns - defined)


# -- D05: implicit host syncs ------------------------------------------------

_D05_SRC = """
import numpy as np

class Daemon:
    def drain(self):
        choices, counter, final = self.engine.solver.solve_joint(b, c, k)
        rows = np.asarray(choices)
        ok = bool(counter)
        n = int(final)
        plain = np.asarray(untracked)
"""


def test_d05_flags_sinks_on_engine_returned_values():
    found = _same("D05", _D05_SRC, _D05_SRC, "scheduler/foo.py",
                  messages=True)
    assert len(found) == 3
    src = "x = some_value.item()\n"
    assert _same("D05", src, src, "scheduler/foo.py", messages=True)
    assert not _same("D05", src, src, "perf/foo.py")
    # The port's tracker also reads .tolist() of an engine tensor.
    tolist = ("def f(self):\n"
              "    ch, k, fin = self.solver.solve_joint(b, c, k)\n"
              "    return ch.tolist()\n")
    assert _port("D05", tolist, "scheduler/foo.py")


def test_d05_host_solver_not_tracked():
    src = ("import numpy as np\n"
           "def f(self):\n"
           "    feas, scores = self.host_solver.evaluate(b, c)\n"
           "    arr = np.asarray(feas)\n")
    assert not _same("D05", src, src, "scheduler/foo.py")


# -- C01..C03: the concurrency rules carry over as they are -------------------

_CYCLE_SRC = """
import threading

class A:
    def f(self):
        with self.alpha_lock:
            with self.beta_lock:
                pass

    def g(self):
        with self.beta_lock:
            with self.alpha_lock:
                pass
"""

_C01_CASES = {
    "inverted": _CYCLE_SRC,
    "consistent": _CYCLE_SRC.replace(
        "with self.beta_lock:\n            with self.alpha_lock:",
        "with self.alpha_lock:\n            with self.beta_lock:"),
    "with_release": ("class A:\n    def f(self):\n"
                     "        with self.alpha_lock:\n            pass\n"
                     "        with self.beta_lock:\n            pass\n"
                     "    def g(self):\n"
                     "        with self.beta_lock:\n            pass\n"
                     "        with self.alpha_lock:\n            pass\n"),
    "acquire_release": ("class A:\n    def f(self):\n"
                        "        self.alpha_lock.acquire()\n"
                        "        with self.beta_lock:\n            pass\n"
                        "        self.alpha_lock.release()\n"
                        "    def g(self):\n"
                        "        with self.beta_lock:\n"
                        "            self.alpha_lock.acquire()\n"
                        "            self.alpha_lock.release()\n"),
    "call_under_lock": ("class A:\n    def outer_one(self):\n"
                        "        with self.alpha_lock:\n"
                        "            self.helper_takes_beta()\n"
                        "    def helper_takes_beta(self):\n"
                        "        with self.beta_lock:\n            pass\n"
                        "    def other(self):\n"
                        "        with self.beta_lock:\n"
                        "            with self.alpha_lock:\n"
                        "                pass\n"),
}


@pytest.mark.parametrize("case,cycle", [
    ("inverted", True), ("consistent", False), ("with_release", False),
    ("acquire_release", True), ("call_under_lock", True)])
def test_c01_cycle_detection_matches_the_reference(case, cycle):
    src = _C01_CASES[case]
    found = {}
    for name, mod, prefix in (("ref", ref_core, REF), ("port", core, PORT)):
        proj = mod.Project(root=REPO)
        proj.modules.append(_module(mod, src, prefix + "scheduler/foo.py"))
        found[name] = sorted(_key(f, messages=True)
                             for f in mod.RULES["C01"].finalize(proj) if f)
        graph = proj.scratch["lock_graph"]
        found[name + "_graph"] = graph
    assert found["ref"] == found["port"]
    assert found["ref_graph"] == found["port_graph"]
    assert bool(found["port"]) == cycle


def test_c01_real_tree_graph_is_exported_and_acyclic():
    project = core.load_project()
    findings = [f for f in core.run_rules(project) if f.rule == "C01"]
    assert not findings, [f.message for f in findings]
    graph = project.scratch["lock_graph"]
    assert graph["nodes"], "lock graph came back empty"


def test_c02_and_c03_match_the_reference():
    lock = "import threading\nlock = threading.Lock()\n"
    assert _same("C02", lock, lock, "utils/metrics.py", messages=True)
    assert not _same("C02", lock, lock, "controller/foo.py")
    thread = "import threading\nt = threading.Thread(target=print)\n"
    for sub in ("scheduler/foo.py", "tenancy/foo.py"):
        assert _same("C03", thread, thread, sub, messages=True)
    assert not _same("C03", thread, thread, "server/foo.py")


# -- suppressions, fingerprints and the baseline -----------------------------

def test_suppression_comment_silences_exact_rule_only():
    src = ("import threading\n"
           "t = threading.Thread(target=print)  # ktlint: disable=C03\n")
    assert not _same("C03", src, src, "scheduler/foo.py")
    wrong = src.replace("C03", "D01")
    assert _same("C03", wrong, wrong, "scheduler/foo.py")


def test_fingerprints_are_line_free_as_the_reference():
    a = core.Finding("C03", PORT + "x.py", 3, "m")
    b = core.Finding("C03", PORT + "x.py", 30, "m")
    assert a.fingerprint == b.fingerprint == f"C03:{PORT}x.py:m"
    r = ref_core.Finding("C03", REF + "x.py", 3, "m")
    assert a.fingerprint.replace(PORT, REF) == r.fingerprint
    assert a.to_json()["fingerprint"] == a.fingerprint


def test_baseline_grandfathers_and_goes_stale(tmp_path):
    """The JAX test's protocol on a tiny tree of each package."""
    for mod, rules_mod, pkg, imp in (
            (ref_core, _ref_d, "kubernetes_tpu", "jax"),
            (core, rules_device, "kubernetes_tpu_torch", "torch")):
        root = tmp_path / pkg
        tree = root / pkg / "scheduler"
        tree.mkdir(parents=True)
        (tree / "x.py").write_text(f"import {imp}\n")
        found = mod.run_project(str(root),
                                baseline_path=str(root / "b.json")).new
        assert [f.rule for f in found] == ["D01"]
        bl = root / "baseline.json"
        bl.write_text(json.dumps(
            {"findings": {found[0].fingerprint: "synthetic test entry"}}))
        result = mod.run_project(str(root), baseline_path=str(bl))
        assert not result.new and len(result.baselined) == 1
        assert not result.failed
        (tree / "x.py").write_text("import os\n")
        result = mod.run_project(str(root), baseline_path=str(bl))
        assert result.stale_baseline and result.failed
        # A partial run never calls the rest of the baseline stale.
        part = mod.run_project(str(root), baseline_path=str(bl),
                               paths=[str(tree / "x.py")])
        assert not part.stale_baseline


def test_write_baseline_keeps_justifications(tmp_path):
    path = str(tmp_path / "b.json")
    f1 = core.Finding("D01", PORT + "a.py", 1, "m1")
    f2 = core.Finding("D01", PORT + "b.py", 1, "m2")
    core.write_baseline([f1], path)
    data = json.loads(open(path).read())
    data["findings"][f1.fingerprint] = "a real reason"
    open(path, "w").write(json.dumps(data))
    core.write_baseline([f1, f2], path)
    merged = core.load_baseline(path)
    assert merged[f1.fingerprint] == "a real reason"
    assert "JUSTIFY" in merged[f2.fingerprint]


# -- the knob check ----------------------------------------------------------

def test_knob_registry_in_sync():
    assert knobs_check.problems() == [], knobs_check.problems()
    assert knobs_check.main([]) == 0


def test_knob_check_catches_undeclared_and_dead_names(tmp_path):
    pkg = tmp_path / "kubernetes_tpu_torch"
    (pkg / "utils").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "utils" / "knobs.py").write_text("")
    (pkg / "a.py").write_text('x = "KT_TRACE"\ny = "KT_NOT_DECLARED"\n')
    (pkg / "csrc" / "k.cu").write_text("#define KT_MACRO(x) x\n")
    (pkg / "b.py").write_text('# KT_MACRO\n')
    found = knobs_check.problems(str(tmp_path))
    assert any("undeclared: KT_NOT_DECLARED" in p for p in found)
    assert not any("KT_MACRO" in p for p in found)
    assert not any("KT_TRACE" in p and "undeclared" in p for p in found)
    assert any(p.startswith("dead: ") for p in found)

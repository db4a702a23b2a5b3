"""kt-lint framework: rule registry, suppressions, baseline, output.

A copy of the JAX package's ``analysis/core.py`` whose scope, baseline
and inventory are this package's:

* A **rule** has a stable id (``D01``..``C03``), a one-line title, and
  either a per-module ``check(module)`` hook, a whole-project
  ``finalize(project)`` hook, or both (C01 collects per module and
  detects cycles over the union).  Rules self-register into ``RULES``;
  the inventory self-check in tests/test_torch_ktlint.py pins the id set
  and the README's rule table (the port's section) against it, so a rule
  cannot be silently deleted.
* A **finding** is (rule, path, line, message).  Its *fingerprint* —
  ``rule:path:message`` — is deliberately line-number-free so ordinary
  edits above a grandfathered finding don't churn the baseline.
* **Suppression**: ``# ktlint: disable=D01`` (comma-separated ids) on
  the finding's line.  Suppressions are for sites where the rule is
  wrong by construction; the baseline is for findings where this package
  must differ by design, each with a mandatory justification naming the
  design.
* **Baseline**: ``analysis/ktlint_baseline.json`` (in this package) maps
  fingerprints to justifications.  ``run_project`` splits findings into
  new vs baselined; the run fails on any new finding (the
  zero-new-findings ratchet) and on stale baseline entries (a fixed
  finding must leave the baseline, or the ratchet rots).

The lint scope is every ``.py`` under ``kubernetes_tpu_torch/``; the
driver is ``python -m kubernetes_tpu_torch.analysis``.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "kubernetes_tpu_torch"
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "ktlint_baseline.json")

_SUPPRESS_RE = re.compile(r"#\s*ktlint:\s*disable=([A-Z0-9, ]+)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # repo-relative, forward slashes
    line: int      # 1-indexed
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.message}"

    def text(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message,
                "fingerprint": self.fingerprint}


@dataclass
class Module:
    """One parsed source file handed to per-module rule hooks."""
    path: str                   # repo-relative
    src: str
    tree: ast.AST
    lines: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.src.splitlines()

    def suppressed(self, rule: str, line: int) -> bool:
        if 1 <= line <= len(self.lines):
            m = _SUPPRESS_RE.search(self.lines[line - 1])
            if m and rule in [r.strip()
                              for r in m.group(1).split(",")]:
                return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str
                ) -> Optional[Finding]:
        line = getattr(node, "lineno", 0)
        if self.suppressed(rule, line):
            return None
        return Finding(rule, self.path, line, message)


@dataclass
class Project:
    """Whole-tree context for finalize hooks (C01's cross-module lock
    graph); per-module hooks stash collected state in ``scratch``."""
    root: str
    modules: list[Module] = field(default_factory=list)
    scratch: dict = field(default_factory=dict)


class Rule:
    """id + title + hooks; instantiate once to register."""

    def __init__(self, rule_id: str, title: str, kind: str = "ast",
                 check: Optional[Callable[[Module], list]] = None,
                 finalize: Optional[Callable[[Project], list]] = None,
                 doc: str = ""):
        self.id = rule_id
        self.title = title
        self.kind = kind  # "ast" | "project" | "runtime"
        self.check = check
        self.finalize = finalize
        self.doc = doc
        RULES[rule_id] = self


RULES: dict[str, Rule] = {}


def iter_source_files(root: str) -> list[str]:
    """Lint scope: every .py under kubernetes_tpu_torch/ (tests and the
    smoke are drivers, not the disciplined surface)."""
    pkg = os.path.join(root, PACKAGE)
    out = []
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(files):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def load_project(root: str = REPO,
                 paths: Optional[list[str]] = None) -> Project:
    project = Project(root=root)
    for path in (paths if paths is not None
                 else iter_source_files(root)):
        with open(path) as f:
            src = f.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as err:
            raise SystemExit(f"ktlint: cannot parse {rel}: {err}")
        project.modules.append(Module(path=rel, src=src, tree=tree))
    return project


def run_rules(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    rules = [RULES[r] for r in sorted(RULES)]
    for module in project.modules:
        for rule in rules:
            if rule.check is not None:
                findings.extend(
                    f for f in rule.check(module) if f is not None)
    for rule in rules:
        if rule.finalize is not None:
            findings.extend(
                f for f in rule.finalize(project) if f is not None)
    return sorted(findings,
                  key=lambda f: (f.path, f.line, f.rule, f.message))


def load_baseline(path: str = DEFAULT_BASELINE) -> dict[str, str]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return dict(data.get("findings") or {})


def write_baseline(findings: list[Finding],
                   path: str = DEFAULT_BASELINE) -> None:
    """Grandfather ``findings``, MERGING with the existing baseline:
    entries already present keep their justification (a regenerate must
    never erase the reasons the entries exist), new ones get the
    JUSTIFY placeholder the justification test rejects until edited."""
    existing = load_baseline(path)
    data = {
        "comment": "Grandfathered kt-lint findings. Every entry needs "
                   "a justification; fixing the finding must remove "
                   "the entry (stale entries fail the run).",
        "findings": {f.fingerprint: existing.get(
            f.fingerprint, "JUSTIFY: why this is grandfathered")
            for f in findings},
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


@dataclass
class Result:
    new: list[Finding]
    baselined: list[Finding]
    stale_baseline: list[str]   # fingerprints no current finding matches

    @property
    def failed(self) -> bool:
        return bool(self.new or self.stale_baseline)


def run_project(root: str = REPO,
                baseline_path: str = DEFAULT_BASELINE,
                paths: Optional[list[str]] = None) -> Result:
    project = load_project(root, paths=paths)
    findings = run_rules(project)
    baseline = load_baseline(baseline_path)
    new = [f for f in findings if f.fingerprint not in baseline]
    seen = {f.fingerprint for f in findings}
    # Stale entries only make sense against a full-tree run; a partial
    # --paths run must not declare the rest of the baseline rotten.
    stale = [] if paths is not None else \
        sorted(fp for fp in baseline if fp not in seen)
    return Result(new=new,
                  baselined=[f for f in findings
                             if f.fingerprint in baseline],
                  stale_baseline=stale)


# -- shared AST helpers --------------------------------------------------

def dotted(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted(call.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None

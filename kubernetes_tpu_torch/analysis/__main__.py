"""kt-lint on this package: ``python -m kubernetes_tpu_torch.analysis``.

Counterpart of the JAX package's ``tools/ktlint.py``.  Runs the rule
families of ``analysis/`` over ``kubernetes_tpu_torch/`` and fails on any
finding not in the committed baseline (``analysis/ktlint_baseline.json``)
and on any stale baseline entry.

Usage:
    python -m kubernetes_tpu_torch.analysis                # text, exit 1 on new
    python -m kubernetes_tpu_torch.analysis --json         # machine-readable
    python -m kubernetes_tpu_torch.analysis --rules        # rule inventory
    python -m kubernetes_tpu_torch.analysis --lock-graph   # C01's graph
    python -m kubernetes_tpu_torch.analysis --write-baseline
    python -m kubernetes_tpu_torch.analysis PATH [PATH..]  # these files

Suppressions: ``# ktlint: disable=D01`` on the finding's line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kubernetes_tpu_torch import analysis  # noqa: F401 (registers rules)
from kubernetes_tpu_torch.analysis import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="AST lint for device & concurrency discipline")
    ap.add_argument("paths", nargs="*",
                    help="specific files to lint (default: the "
                         "kubernetes_tpu_torch package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="JSON report on stdout")
    ap.add_argument("--baseline", default=core.DEFAULT_BASELINE)
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule inventory and exit")
    ap.add_argument("--lock-graph", action="store_true",
                    help="print C01's extracted lock graph and exit")
    opts = ap.parse_args(argv)

    if opts.rules:
        for rid in sorted(core.RULES):
            rule = core.RULES[rid]
            print(f"{rid} [{rule.kind}] {rule.title}")
        return 0

    if opts.lock_graph:
        project = core.load_project(core.REPO)
        core.run_rules(project)
        print(json.dumps(project.scratch.get("lock_graph", {}), indent=1))
        return 0

    paths = [os.path.abspath(p) for p in opts.paths] or None
    result = core.run_project(core.REPO, baseline_path=opts.baseline,
                              paths=paths)

    if opts.write_baseline:
        core.write_baseline(result.new + result.baselined,
                            path=opts.baseline)
        print(f"wrote {len(result.new) + len(result.baselined)} "
              f"finding(s) to {opts.baseline} — JUSTIFY each entry")
        return 0

    if opts.as_json:
        print(json.dumps({
            "new": [f.to_json() for f in result.new],
            "baselined": [f.to_json() for f in result.baselined],
            "stale_baseline": result.stale_baseline,
            "rules": sorted(core.RULES),
        }, indent=1))
    else:
        for f in result.new:
            print(f.text())
        for fp in result.stale_baseline:
            print(f"STALE baseline entry (finding fixed — remove it): "
                  f"{fp}")
        n_base = len(result.baselined)
        if result.failed:
            print(f"ktlint: {len(result.new)} new finding(s), "
                  f"{len(result.stale_baseline)} stale baseline "
                  f"entr(ies) ({n_base} grandfathered)", file=sys.stderr)
        else:
            print(f"ktlint: clean ({len(core.RULES)} rules, "
                  f"{n_base} grandfathered finding(s))")
    return 1 if result.failed else 0


if __name__ == "__main__":
    sys.exit(main())

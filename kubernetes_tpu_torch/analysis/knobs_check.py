"""The knob-registry drift check of this package.

Counterpart of the JAX package's ``tools/check_knobs.py``, held to this
package's ``utils/knobs.py``: every ``KT_*`` name that this package's
code or ``chip_smoke.py`` names must be declared in the registry, and
every declared knob must be named somewhere (this package, the smoke,
or the port's tests — a knob only tests exercise is still live; a dead
knob documents behaviour that no longer exists).  The tests may mint
synthetic ``KT_`` names for negative cases, so undeclared names fail
only in shipped code.  A ``KT_`` name that a ``#define`` makes (a macro
of ``csrc/*.cu`` or of a kernel source a script generates) is C, not a
knob.

Usage: ``python -m kubernetes_tpu_torch.analysis.knobs_check`` (exit 1
and the names on drift).
"""

from __future__ import annotations

import os
import re
import sys

from kubernetes_tpu_torch.analysis.core import PACKAGE, REPO

_KT_RE = re.compile(r"\bKT_[A-Z0-9_]+\b")
_MACRO_RE = re.compile(r"#define\s+(KT_[A-Z0-9_]+)")
_KNOBS_MODULE = os.path.join(PACKAGE, "utils", "knobs.py")
_SMOKE = "chip_smoke.py"
_TEST_PREFIXES = ("test_torch_", "torch_")


def _py_files(top: str) -> list[str]:
    out = []
    for dirpath, dirnames, fns in os.walk(top):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, fn) for fn in sorted(fns)
                   if fn.endswith(".py"))
    return out


def _names(paths: list[str], root: str) -> set[str]:
    names: set[str] = set()
    for path in paths:
        if os.path.relpath(path, root) == _KNOBS_MODULE:
            continue  # declarations are not references
        try:
            with open(path) as f:
                names.update(_KT_RE.findall(f.read()))
        except OSError:
            pass
    return names - macros(root)


def macros(root: str = REPO) -> set[str]:
    """The ``KT_`` names a ``#define`` makes, in this package's C
    sources and in the kernel sources its scripts generate."""
    paths = _py_files(os.path.join(root, PACKAGE))
    csrc = os.path.join(root, PACKAGE, "csrc")
    if os.path.isdir(csrc):
        paths += [os.path.join(csrc, fn) for fn in sorted(os.listdir(csrc))
                  if fn.endswith((".cu", ".h", ".cuh"))]
    out: set[str] = set()
    for path in paths:
        with open(path) as f:
            out.update(_MACRO_RE.findall(f.read()))
    return out


def shipped_files(root: str = REPO) -> list[str]:
    smoke = os.path.join(root, _SMOKE)
    return _py_files(os.path.join(root, PACKAGE)) + \
        ([smoke] if os.path.exists(smoke) else [])


def test_files(root: str = REPO) -> list[str]:
    tests = os.path.join(root, "tests")
    return [p for p in _py_files(tests)
            if os.path.basename(p).startswith(_TEST_PREFIXES)]


def problems(root: str = REPO) -> list[str]:
    """Every drift line; [] when the registry is in sync."""
    from kubernetes_tpu_torch.utils.knobs import REGISTRY
    declared = set(REGISTRY)
    in_code = _names(shipped_files(root), root)
    referenced = in_code | _names(test_files(root), root)
    out = [f"undeclared: {n} is named in shipped code but not declared "
           f"in {_KNOBS_MODULE}" for n in sorted(in_code - declared)]
    out += [f"dead: {n} is declared but named nowhere in code or tests"
            for n in sorted(declared - referenced)]
    return out


def main(argv=None) -> int:
    from kubernetes_tpu_torch.utils.knobs import REGISTRY
    found = problems()
    for line in found:
        print(line, file=sys.stderr)
    if not found:
        print(f"knob registry in sync ({len(REGISTRY)} knobs)")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Field selectors — server-side list/watch filtering (pkg/fields).

The reference's scheduler never sees assigned pods on its queue watch:
it lists/watches with ``fieldSelector=spec.nodeName=`` (factory.go:
466-469 ``selector.Everything`` + the nodeName field requirement), and
kubelets watch only their own pods via ``spec.nodeName=<node>``
(pkg/kubelet/config/apiserver.go).  Filtered client-side instead, at
30k-pod density every pod event would cross the wire to every
watcher.

Grammar (pkg/fields/selector.go ParseSelector): comma-separated
requirements, each ``path=value``, ``path==value`` or ``path!=value``.
A field missing from the object compares as ``""`` (fields.Set maps a
pod to a flat string map the same way, pkg/api/pod_fieldselector).

Matching walks the object's JSON dict by the dotted path; scalar
values compare by their string form.  This is deliberately generic
where the reference registers per-kind conversion functions — any
stored field is selectable, which the conformance tests pin on both
apiservers (Python and native).
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["Requirement", "parse", "matcher"]


class Requirement:
    __slots__ = ("path", "op", "value")

    def __init__(self, path: tuple[str, ...], op: str, value: str):
        self.path = path
        self.op = op        # "=" or "!="
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"Requirement({'.'.join(self.path)}{self.op}{self.value})"


def parse(selector: str) -> tuple[Requirement, ...]:
    """ParseSelector: raises ValueError on a malformed requirement so the
    server can 400 instead of silently matching everything."""
    reqs: list[Requirement] = []
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            field, _, value = part.partition("!=")
            op = "!="
        elif "==" in part:
            field, _, value = part.partition("==")
            op = "="
        elif "=" in part:
            field, _, value = part.partition("=")
            op = "="
        else:
            raise ValueError(f"invalid field selector {part!r}")
        field = field.strip()
        if not field:
            raise ValueError(f"invalid field selector {part!r}")
        reqs.append(Requirement(tuple(field.split(".")), op, value.strip()))
    return tuple(reqs)


def _get_field(obj: dict, path: tuple[str, ...]) -> str:
    cur = obj
    for seg in path:
        if not isinstance(cur, dict):
            return ""
        cur = cur.get(seg)
    if cur is None or isinstance(cur, (dict, list)):
        return ""
    if isinstance(cur, bool):  # JSON booleans stringify lowercase
        return "true" if cur else "false"
    return str(cur)


def matcher(selector: str) -> Optional[Callable[[dict], bool]]:
    """Compile a selector string to a predicate; None when the selector
    is empty (match-everything — the caller can skip filtering)."""
    reqs = parse(selector)
    if not reqs:
        return None

    def match(obj: dict) -> bool:
        for r in reqs:
            got = _get_field(obj, r.path)
            if (got == r.value) != (r.op == "="):
                return False
        return True
    return match

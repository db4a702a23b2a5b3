"""Concurrency rules C01..C03 (a copy of the JAX package's, held to this
package's modules).

47 lock sites and 5+ factory-started background threads accumulated
across scheduler/cache/tenancy/metrics over twelve PRs; the HA and
tenancy work now leans on all of them.  These rules extract the
cross-module lock-acquisition graph statically and fail on cycles
(C01), force the hot daemon locks through the instrumented
utils/locktrace.py factory so every chaos run doubles as a deadlock
detector (C02), and force every daemon thread through the
utils/threadreg.py stop/join-audit chokepoint (C03).
"""

from __future__ import annotations

import ast
from typing import Optional

from kubernetes_tpu_torch.analysis import core
from kubernetes_tpu_torch.analysis.core import Module, Project, Rule

# -- C01: static lock-order graph ---------------------------------------

# An expression is treated as a lock when its final attribute/name
# looks lock-ish.  Conditions count: waiting re-acquires them.
_LOCKISH = ("lock", "_mu", "mutex", "_cv", "cond")

# Cross-module identity: the same lock reached through different
# attribute chains must land on one graph node or order cycles hide
# behind spelling.  Keys are the canonical tails the resolver below
# produces; values are the owning class's node.
_ALIASES = {
    "cache.lock": "SchedulerCache.lock",
    "algorithm.cache.lock": "SchedulerCache.lock",
    "_BUCKETS_LOCK": "metrics._BUCKETS_LOCK",
}


def _module_stem(path: str) -> str:
    return path.rsplit("/", 1)[-1][:-3]


def _lock_id(expr: ast.AST, class_name: Optional[str],
             module_stem: str) -> Optional[str]:
    """Canonical graph-node name for a lock expression, or None."""
    name = core.dotted(expr)
    if not name:
        return None
    tail = name.split(".")[-1].lower()
    if not any(k in tail for k in _LOCKISH):
        return None
    parts = name.split(".")
    if parts[0] == "self":
        parts = parts[1:]
        if len(parts) == 1:
            node = f"{class_name or module_stem}.{parts[0]}"
        else:
            node = ".".join(parts[-2:])
    elif len(parts) == 1:
        node = f"{module_stem}.{parts[0]}"
    else:
        node = ".".join(parts[-2:])
    return _ALIASES.get(node, _ALIASES.get(".".join(parts[-2:]), node))


class _FnSummary:
    def __init__(self, qual: str, path: str):
        self.qual = qual          # "module:Class.fn"
        self.name = qual.rsplit(".", 1)[-1]
        self.path = path
        self.acquires: set[str] = set()
        # (held_lock, callee_simple_name, lineno)
        self.calls_under_lock: list[tuple[str, str, int]] = []
        # (outer, inner, lineno) direct nesting edges
        self.edges: list[tuple[str, str, int]] = []


def _collect_functions(module: Module) -> list[_FnSummary]:
    stem = _module_stem(module.path)
    out: list[_FnSummary] = []

    def walk_fn(fn: ast.AST, class_name: Optional[str]) -> None:
        summary = _FnSummary(
            f"{stem}:{class_name + '.' if class_name else ''}{fn.name}",
            module.path)
        out.append(summary)

        def record_acquire(lid: str, held: list[str],
                           lineno: int) -> None:
            summary.acquires.add(lid)
            for outer in held:
                if outer != lid:
                    summary.edges.append((outer, lid, lineno))

        def expr_calls(stmt: ast.stmt, held: list[str]) -> None:
            """acquire()/release()/call tracking over THIS statement's
            expressions only — child statements are scanned by the
            block recursion below, each under its own held state."""
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, (ast.stmt, ast.excepthandler)):
                    continue
                for node in ast.walk(child):
                    if not isinstance(node, ast.Call):
                        continue
                    func = node.func
                    if isinstance(func, ast.Attribute) and \
                            func.attr in ("acquire", "release"):
                        lid = _lock_id(func.value, class_name, stem)
                        if lid is None:
                            continue
                        if func.attr == "acquire":
                            record_acquire(lid, held, node.lineno)
                            held.append(lid)
                        elif lid in held:
                            held.remove(lid)
                    elif held:
                        callee = core.call_name(node).split(".")[-1]
                        if callee:
                            summary.calls_under_lock.append(
                                (held[-1], callee, node.lineno))

        def scan(stmts, held: list[str]) -> None:
            # ``held`` mutates linearly across THIS statement list
            # (.acquire() persists to later siblings); ``with`` bodies
            # get a copy so their locks never leak past the block.
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue  # nested defs are separate functions
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    inner = list(held)
                    for item in stmt.items:
                        lid = _lock_id(item.context_expr, class_name,
                                       stem)
                        if lid is not None:
                            record_acquire(lid, inner, stmt.lineno)
                            inner.append(lid)
                    scan(stmt.body, inner)
                    continue
                expr_calls(stmt, held)
                if isinstance(stmt, ast.Try):
                    scan(stmt.body, held)
                    for h in stmt.handlers:
                        scan(h.body, held)
                    scan(stmt.orelse, held)
                    scan(stmt.finalbody, held)
                else:
                    for block in ("body", "orelse"):
                        sub = getattr(stmt, block, None)
                        if sub and isinstance(sub[0], ast.stmt):
                            scan(sub, held)

        scan(fn.body, [])

    def walk(node: ast.AST, class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                walk_fn(child, class_name)
                walk(child, class_name)
            else:
                walk(child, class_name)

    walk(module.tree, None)
    return out


# Callee names too generic to resolve across modules — propagating
# through them would wire unrelated locks together.
_CALL_STOPLIST = {
    "get", "put", "set", "add", "pop", "run", "stop", "close", "open",
    "update", "create", "delete", "list", "items", "values", "keys",
    "append", "extend", "remove", "clear", "copy", "join", "start",
    "wait", "notify", "notify_all", "read", "write", "send", "recv",
    "info", "debug", "warning", "error", "exception", "log", "inc",
    "dec", "observe", "labels", "value", "expose", "format", "strip",
    "split", "encode", "decode", "sleep", "time", "monotonic",
    "perf_counter", "len", "int", "float", "str", "bool", "sorted",
    "min", "max", "sum", "abs", "round", "callback", "filter",
}


def _finalize_c01(project: Project) -> list:
    summaries: list[_FnSummary] = []
    for module in project.modules:
        summaries.extend(_collect_functions(module))

    by_name: dict[str, list[_FnSummary]] = {}
    for s in summaries:
        by_name.setdefault(s.name, []).append(s)

    # may-acquire fixed point over uniquely-resolvable calls (only
    # calls made UNDER a lock can mint edges, so only those resolve).
    may: dict[str, set[str]] = {s.qual: set(s.acquires)
                                for s in summaries}
    changed = True
    while changed:
        changed = False
        for s in summaries:
            for _held, callee, _ln in s.calls_under_lock:
                if callee in _CALL_STOPLIST:
                    continue
                cands = by_name.get(callee) or []
                if len(cands) != 1:
                    continue
                extra = may[cands[0].qual] - may[s.qual]
                if extra:
                    may[s.qual] |= extra
                    changed = True

    # Edge set: direct nesting + one level of call propagation.
    edges: dict[tuple[str, str], tuple[str, int]] = {}
    for s in summaries:
        for outer, inner, ln in s.edges:
            edges.setdefault((outer, inner), (s.path, ln))
        for held, callee, ln in s.calls_under_lock:
            if callee in _CALL_STOPLIST:
                continue
            cands = by_name.get(callee) or []
            if len(cands) != 1:
                continue
            for inner in may[cands[0].qual]:
                if inner != held:
                    edges.setdefault((held, inner), (s.path, ln))

    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    project.scratch["lock_graph"] = {
        "nodes": sorted(graph),
        "edges": sorted([a, b] for a, b in edges),
    }

    # Cycle detection (iterative DFS, report each cycle once).
    out = []
    seen_cycles: set[frozenset] = set()
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    for root in sorted(graph):
        if color[root] != WHITE:
            continue
        stack = [(root, iter(sorted(graph[root])))]
        color[root] = GREY
        path = [root]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GREY:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        src, ln = edges.get((node, nxt),
                                            ("kubernetes_tpu_torch", 0))
                        f = core.Finding(
                            "C01", src, ln,
                            "lock-order cycle: " + " -> ".join(cyc))
                        out.append(f)
                elif color[nxt] == WHITE:
                    color[nxt] = GREY
                    path.append(nxt)
                    stack.append((nxt, iter(sorted(graph[nxt]))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                path.pop()
                stack.pop()
    return out


Rule("C01", "cross-module lock-acquisition graph is acyclic",
     kind="project", finalize=_finalize_c01,
     doc="with-nesting and acquire()/release() chains per function, "
         "plus calls-under-lock resolved one level deep, build the "
         "global lock graph; any cycle is a deadlock precondition.")


# -- C02: daemon state locks go through the locktrace factory -----------

# Modules whose locks sit on the cross-module graph (cache lock,
# tenancy engine_lock, metrics registry, shard tick, SLO/telemetry/
# flight rings, guard state): construct them via locktrace.make_lock /
# make_rlock so KT_LOCKTRACE=1 traces them at runtime.
C02_SCOPE = (
    "kubernetes_tpu_torch/cache/scheduler_cache.py",
    "kubernetes_tpu_torch/tenancy/service.py",
    "kubernetes_tpu_torch/utils/metrics.py",
    "kubernetes_tpu_torch/scheduler/shards.py",
    "kubernetes_tpu_torch/scheduler/slo.py",
    "kubernetes_tpu_torch/scheduler/flightrecorder.py",
    "kubernetes_tpu_torch/utils/telemetry.py",
    "kubernetes_tpu_torch/engine/guard.py",
)
_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}


def _check_c02(module: Module) -> list:
    if module.path not in C02_SCOPE:
        return []
    out = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) and \
                core.call_name(node) in _LOCK_CTORS:
            out.append(module.finding(
                "C02", node,
                f"raw {core.call_name(node)}() in a graph-tracked "
                f"module: mint it via utils.locktrace.make_lock/"
                f"make_rlock (named, KT_LOCKTRACE-traceable)"))
    return out


Rule("C02", "graph-tracked locks are minted via utils/locktrace.py",
     check=_check_c02,
     doc="The runtime companion: named locks record per-thread "
         "acquisition chains under KT_LOCKTRACE=1, detecting order "
         "inversions and long holds in every chaos run; off-path "
         "cost is zero (plain threading locks).")


# -- C03: daemon threads go through the threadreg chokepoint ------------

C03_SCOPE = (
    "kubernetes_tpu_torch/scheduler/",
    "kubernetes_tpu_torch/cache/",
    "kubernetes_tpu_torch/tenancy/",
    "kubernetes_tpu_torch/client/",
    "kubernetes_tpu_torch/utils/telemetry.py",
)
_THREAD_CTORS = {"threading.Thread", "Thread"}


def _check_c03(module: Module) -> list:
    if not any(module.path.startswith(p) for p in C03_SCOPE):
        return []
    out = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call) and \
                core.call_name(node) in _THREAD_CTORS:
            out.append(module.finding(
                "C03", node,
                "unregistered Thread(...): daemon threads start via "
                "utils.threadreg.spawn (named + stop/join audit)"))
    return out


Rule("C03", "daemon threads start via utils/threadreg.spawn",
     check=_check_c03,
     doc="Every factory-started background thread must be registered "
         "for the stop/join audit; a raw Thread() is invisible to it.")

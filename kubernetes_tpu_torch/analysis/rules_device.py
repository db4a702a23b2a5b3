"""Device-discipline rules D01..D05, retargeted from jax to torch.

A copy of the JAX package's ``analysis/rules_device.py`` held to this
package: which modules may import ``torch``, where readbacks and syncs
happen, that kernel wrappers and their plain versions read no clock, RNG
or knob, when knobs are read, and that no engine-returned tensor is
synced implicitly.  The port has no host engine (a tripped breaker
requeues), so D01 keeps the daemon's layering rather than a fallback
guarantee: the scheduler, cache, apiserver, clients, controllers and
tenancy policy reach the card only through the engine.
"""

from __future__ import annotations

import ast

from kubernetes_tpu_torch.analysis import core
from kubernetes_tpu_torch.analysis.core import Module, Rule

# D01: the only modules allowed to import torch (or triton).  Everything
# else reaches the device through the engine.  Two modules of this
# package's own are allowlisted, each for a stated reason:
# utils/device.py resolves every entry point's ``device=`` (the
# "cuda unless the caller asks for the cpu" rule needs
# torch.cuda.is_available) and analysis/xray.py runs the program
# families on ``meta`` tensors (no device; imported by its driver and
# the tests, never by a daemon).
DEVICE_ALLOWED = (
    "kubernetes_tpu_torch/engine/",
    "kubernetes_tpu_torch/ops/",
    "kubernetes_tpu_torch/parallel/",
    "kubernetes_tpu_torch/perf/",
    "kubernetes_tpu_torch/utils/profiling.py",
    "kubernetes_tpu_torch/utils/device.py",
    "kubernetes_tpu_torch/analysis/xray.py",
)

_DEVICE_ROOTS = {"torch", "triton"}


def _device_allowed(path: str) -> bool:
    return any(path.startswith(p) for p in DEVICE_ALLOWED)


def _type_checking_only(tree: ast.AST) -> set[int]:
    """ids of the import nodes under ``if TYPE_CHECKING:`` (annotation
    imports: they never run)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and core.dotted(node.test) in (
                "TYPE_CHECKING", "typing.TYPE_CHECKING"):
            for stmt in node.body:
                out.update(id(sub) for sub in ast.walk(stmt))
    return out


def _check_d01(module: Module) -> list:
    if _device_allowed(module.path):
        return []
    out = []
    skip = _type_checking_only(module.tree)
    for node in ast.walk(module.tree):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                if root in _DEVICE_ROOTS:
                    out.append(module.finding(
                        "D01", node,
                        f"import {alias.name}: device imports are "
                        f"allowed only under "
                        f"{', '.join(DEVICE_ALLOWED)} — the daemon "
                        f"reaches the device through the engine"))
        elif isinstance(node, ast.ImportFrom):
            root = (node.module or "").split(".")[0]
            if root in _DEVICE_ROOTS:
                out.append(module.finding(
                    "D01", node,
                    f"from {node.module} import ...: device imports "
                    f"are allowed only under "
                    f"{', '.join(DEVICE_ALLOWED)}"))
    return out


Rule("D01", "device imports only in the engine/ops/parallel/perf "
     "layers", check=_check_d01,
     doc="torch/triton imports outside the allowlist (anywhere in the "
         "module, import time or call time) let the daemon's host layers "
         "touch the device around the engine's guard and accounting.")


# D02: raw readback/sync calls outside engine internals.  Every
# readback must flow through guard.checked_readback (sanity gate),
# devicestats (accounting; ``devicestats.to_host``/``synchronize``) or
# an engine readback site; a bare ``.cpu()``/``.numpy()`` or
# ``torch.cuda.synchronize`` elsewhere is an unguarded sync point.
# ``.tolist()``/``.item()`` are numpy methods too: D05 flags them on
# engine-returned values (and ``.item()`` everywhere).
_READBACK_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_READBACK_METHODS = {"cpu", "numpy"}


def _check_d02(module: Module) -> list:
    if _device_allowed(module.path):
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = core.call_name(node)
        if name in _READBACK_CALLS:
            out.append(module.finding(
                "D02", node,
                f"raw device sync {name}(): route through "
                f"engine.devicestats.synchronize / engine readback "
                f"sites"))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _READBACK_METHODS and not node.args:
            out.append(module.finding(
                "D02", node,
                f"raw readback .{node.func.attr}(): route through "
                f"engine.guard.checked_readback / "
                f"engine.devicestats.to_host"))
    return out


Rule("D02", "readbacks route through checked_readback/devicestats",
     check=_check_d02,
     doc=".cpu() / .numpy() / torch.cuda.synchronize() outside engine/ "
         "bypass the post-solve sanity gate and the transfer accounting "
         "plane.")


# D03: kernel purity.  JAX's rule holds jitted bodies pure (traced once
# per shape, a clock/RNG/env read is frozen into the program).  The port
# compiles no per-shape program; its counterpart is the pair a kernel is
# held to: the wrapper that launches a hand-written kernel (a function
# that counts ``<wrapper>.launches``) and the kernel's plain version
# (``*_plain``, and the step loop ``_fused_scan``).  Both must compute a
# function of their arguments alone: a clock, RNG or knob read inside
# either makes the kernel and its plain version answer differently for
# the same inputs.
_D03_SCOPE = ("kubernetes_tpu_torch/engine/", "kubernetes_tpu_torch/ops/")
_PLAIN_BODIES = {"_fused_scan"}
_IMPURE_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "random.random", "random.randint", "random.choice",
    "random.uniform", "random.shuffle",
    "np.random.rand", "np.random.randn", "numpy.random.rand",
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "os.getenv", "os.environ.get", "environ.get",
    "knobs.get", "knobs.get_int", "knobs.get_float",
    "knobs.get_bool", "knobs.get_str",
}


def _counts_launches(fn: ast.AST) -> bool:
    return any(isinstance(sub, ast.AugAssign) and
               isinstance(sub.target, ast.Attribute) and
               sub.target.attr == "launches"
               for sub in ast.walk(fn))


def _kernel_function_names(tree: ast.AST) -> set[str]:
    """Kernel wrappers (they count their launches) and plain versions
    (``*_plain``, the step loop)."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                (node.name.endswith("_plain") or
                 node.name in _PLAIN_BODIES or _counts_launches(node)):
            names.add(node.name)
    return names


def _check_d03(module: Module) -> list:
    if not any(module.path.startswith(p) for p in _D03_SCOPE):
        return []
    kernels = _kernel_function_names(module.tree)
    if not kernels:
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) or \
                node.name not in kernels:
            continue
        for sub in ast.walk(node):
            impure = None
            if isinstance(sub, ast.Call) and \
                    core.call_name(sub) in _IMPURE_CALLS:
                impure = f"{core.call_name(sub)}()"
            elif isinstance(sub, ast.Subscript) and \
                    core.dotted(sub.value) in ("os.environ", "environ"):
                impure = "os.environ[...]"
            if impure:
                out.append(module.finding(
                    "D03", sub,
                    f"{impure} inside kernel wrapper or plain version "
                    f"'{node.name}': the kernel and its plain version "
                    f"must compute a function of their arguments"))
    return out


Rule("D03", "no clock/RNG/env reads inside kernel wrappers or their "
     "plain versions", check=_check_d03,
     doc="A kernel is held bit for bit to its plain version; a wall-"
         "clock, RNG or knob read in either makes the pair answer "
         "differently for the same inputs.")


# D04: every KT_* env read goes through utils/knobs.py, against the
# declared registry — and NO knob read (raw or via knobs) happens
# inside a per-drain hot-path function (the stream_min_bucket bug
# class: a knob re-read after warmup minting unwarmed shapes).
_ENV_GET_CALLS = {"os.environ.get", "environ.get", "os.getenv",
                  "getenv", "_os.environ.get"}
_KNOBS_CALLS = {"knobs.get", "knobs.get_int", "knobs.get_float",
                "knobs.get_bool", "knobs.get_str"}
_KNOBS_MODULE = "kubernetes_tpu_torch/utils/knobs.py"

# Functions on the per-drain path: formation -> solve -> commit.  A
# knob read inside any of these runs once per drain (thousands/s under
# storm) and can observe a mid-run env change the prewarm never saw.
HOT_PATH_FUNCTIONS = {
    "kubernetes_tpu_torch/scheduler/scheduler.py": {
        "schedule_pending", "schedule_one", "_assume_and_bind_batch",
        "_bind_assumed_batch"},
    "kubernetes_tpu_torch/scheduler/pipeline.py": {
        "drain", "_solve", "_solve_stream", "_commit_chunk"},
    "kubernetes_tpu_torch/scheduler/batchformer.py": {"form"},
    "kubernetes_tpu_torch/engine/generic_scheduler.py": {
        "schedule_batch", "schedule_batch_stream", "schedule",
        "_schedule_device", "_compile"},
    "kubernetes_tpu_torch/engine/solver.py": {
        "evaluate", "_solve_scan", "_fused_scan",
        "solve_sequential_packed", "solve_joint", "_price_iterate",
        "sync"},
    "kubernetes_tpu_torch/engine/scan.py": {"scan_chunk"},
    "kubernetes_tpu_torch/engine/fused.py": {"select_rows"},
    "kubernetes_tpu_torch/ops/combine.py": {"select_hosts"},
    "kubernetes_tpu_torch/tenancy/packer.py": {"pack"},
    "kubernetes_tpu_torch/tenancy/service.py": {"submit", "_solve_packed"},
}


def _env_read_name(node: ast.Call) -> str | None:
    """The KT_* name read by this call, or None if not an env read."""
    name = core.call_name(node)
    if name in _ENV_GET_CALLS and node.args:
        return core.const_str(node.args[0])
    return None


def _check_d04(module: Module) -> list:
    from kubernetes_tpu_torch.utils.knobs import REGISTRY
    out = []
    hot = HOT_PATH_FUNCTIONS.get(module.path, set())
    in_knobs = module.path == _KNOBS_MODULE

    def visit(node: ast.AST, hot_fn: str | None) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            hot_fn = node.name if node.name in hot else hot_fn
        for child in ast.iter_child_nodes(node):
            visit(child, hot_fn)
        if isinstance(node, ast.Call):
            env_name = _env_read_name(node)
            name = core.call_name(node)
            if env_name and env_name.startswith("KT_") and \
                    not in_knobs:
                out.append(module.finding(
                    "D04", node,
                    f"raw env read of {env_name}: use "
                    f"utils.knobs.get_* (registry-backed, "
                    f"analysis/knobs_check.py ratchets it)"))
            if name in _KNOBS_CALLS and node.args:
                knob = core.const_str(node.args[0])
                if knob is not None and knob not in REGISTRY:
                    out.append(module.finding(
                        "D04", node,
                        f"knobs read of undeclared {knob}: declare "
                        f"it in utils/knobs.py"))
            if hot_fn and (name in _KNOBS_CALLS or env_name or
                           name in _ENV_GET_CALLS):
                out.append(module.finding(
                    "D04", node,
                    f"env/knob read inside per-drain hot path "
                    f"'{hot_fn}': read once at daemon init (the "
                    f"KT_STREAM_MIN_BUCKET bug class)"))
        elif isinstance(node, ast.Subscript) and \
                core.dotted(node.value) in ("os.environ", "environ") \
                and not in_knobs and not isinstance(
                    getattr(node, "ctx", None),
                    (ast.Store, ast.Del)):
            key = core.const_str(node.slice)
            if key is not None and key.startswith("KT_"):
                out.append(module.finding(
                    "D04", node,
                    f"raw env read of {key}: use utils.knobs.get_*"))

    visit(module.tree, None)
    return out


Rule("D04", "KT_* knobs resolve through the utils/knobs.py registry; "
     "no env reads on the per-drain path", check=_check_d04,
     doc="Scattered env reads drift from docs and re-read mid-run; "
         "the registry is the single source and hot paths read knobs "
         "only at init.")


# D05: implicit host syncs — the host-side complement of kt-xray's X01.
# A device tensor that escapes the engine and then gets materialized by
# ``.item()``, ``.tolist()``, ``bool()/int()/float()`` or
# ``np.asarray()`` is a blocking device->host sync outside the
# accounted/gated readback sites.  Tracking is deliberately coarse
# (names assigned anywhere in the module from a device-returning engine
# call): the engine's public surface returns HOST values, so the real
# tree is clean, and any future leak trips either the assignment
# tracker or the unconditional ``.item()`` check.
_D05_DEVICE_RETURNING = {
    "solve_sequential_packed", "solve_joint", "_solve_scan",
    "_price_iterate", "victim_solve", "to_device", "device_batch",
    "device_cluster", "term_planes", "spread_planes", "select_hosts",
    "select_rows", "scan_chunk",
}
# evaluate/masks return device tensors from the solver; flag them when
# the receiver chain names the solver.
_D05_SOLVER_METHODS = {"evaluate", "masks"}
_D05_SINK_CASTS = {"bool", "int", "float"}
_D05_ASARRAY = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}


def _d05_device_call(name: str) -> bool:
    if not name:
        return False
    parts = name.split(".")
    if parts[-1] in _D05_DEVICE_RETURNING:
        return True
    return parts[-1] in _D05_SOLVER_METHODS and "solver" in parts[:-1]


def _check_d05(module: Module) -> list:
    if _device_allowed(module.path):
        return []
    tracked: set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _d05_device_call(core.call_name(node.value)):
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                tracked.update(e.id for e in elts
                               if isinstance(e, ast.Name))
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "item" and not node.args:
            out.append(module.finding(
                "D05", node,
                ".item() is a blocking device->host sync: route "
                "through engine readback sites (checked_readback / "
                "devicestats-recorded)"))
            continue
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "tolist" and not node.args and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in tracked:
            out.append(module.finding(
                "D05", node,
                f".tolist() on engine-returned device value "
                f"'{node.func.value.id}': implicit host sync outside "
                f"checked_readback/devicestats"))
            continue
        name = core.call_name(node)
        arg = node.args[0] if node.args else None
        if not isinstance(arg, ast.Name) or arg.id not in tracked:
            continue
        if name in _D05_SINK_CASTS and len(node.args) == 1:
            out.append(module.finding(
                "D05", node,
                f"{name}() on engine-returned device value "
                f"'{arg.id}': implicit host sync outside "
                f"checked_readback/devicestats"))
        elif name in _D05_ASARRAY:
            out.append(module.finding(
                "D05", node,
                f"{name}() on engine-returned device value "
                f"'{arg.id}': implicit host sync outside "
                f"checked_readback/devicestats"))
    return out


Rule("D05", "no implicit host syncs on engine-returned device values "
     "outside engine readback sites", check=_check_d05,
     doc=".item(), .tolist(), bool()/int()/float() and np.asarray() on "
         "device values are unaccounted blocking syncs — the host-side "
         "complement of kt-xray's X01 rule.")

"""kt-xray on this package: the manifest of its compile surface.

Counterpart of the JAX package's ``analysis/xray.py``.  There, every
jitted program is traced abstractly (``jax.eval_shape`` /
``jax.make_jaxpr``) into a committed manifest.  Torch compiles nothing
per shape; what a live path runs on the card is a device program family
of ``engine/entrypoints.py``: a hand-written CUDA kernel with the torch
ops around it, or torch ops alone.  This module runs each family on
``torch.device("meta")`` tensors (shapes and dtypes, no data, no device)
under a ``TorchDispatchMode`` that records every aten op it dispatches,
and writes the committed ``analysis/shape_manifest.json``: per program,
its input and output shapes and dtypes, its op counts, the kernel
launches it makes and a fingerprint.

* The kernels' plain versions run on meta where they are a few ops
  (``fused.select_plain``, ``combine.select_hosts_plain``).  The scan
  kernel's plain version, the step loop, runs ~126 ops per pod, so the
  scan families run the card's route (``route="kernel"``) with the
  kernel's launch replaced by its wrapper up to the launch: every
  argument check of ``engine/scan.py:scan_chunk`` and the
  ``cluster_plan`` it picks.
* A kernel family's fingerprint covers the hash of its ``csrc/*.cu``
  source (the ``nvcc`` library is cached by the same hash) and the
  instantiations its wrapper can reach; the ``build`` program is the
  library itself (both sources and the flags).

Rules (ids pinned by tests/test_torch_xray.py and the README's
inventory):

* **X01** — no host-sync op (``aten::_local_scalar_dense``, a copy to
  the CPU) inside a family: its one readback happens at the dispatch
  site, after the program, through ``guard.checked_readback``.
* **X02** — no widening past the declared 32-bit width: a conversion
  to float64, or to int64 of a value that is not only an index (torch's
  index ops take int64), is a finding; the deliberate ones (float64 sums
  of whole numbers, int64 bid loads, the int64 round-robin counter and
  packed readback) are justified entries in the manifest.
* **X03** — the aliasing audit (the counterpart of JAX's donation
  audit): every in-place write under ``engine/`` (a ``*_`` tensor method,
  a kernel that updates its state arguments) carries ``# kt-xray:
  in-place(<reason>)``, and every out-of-place write of a resident plane
  (``index_copy`` and kin) carries ``# kt-xray: no-alias(<reason>)``; the
  dirty-row scatter of ``ResidentCluster.sync`` is the founding no-alias
  case, as ``_scatter_fn`` is the JAX one.
* **X04** — coverage: the manifest's warmed programs equal
  ``scheduler.prewarm_plan(ladder, cuda=True)``; every ``extern "C"``
  symbol of ``csrc/`` is claimed by a family; every kernel wrapper (a
  function that counts its launches) under ``engine/`` and ``ops/`` is a
  family's launch site and every ``devicestats.live_path`` region a
  family's dispatch site; every named site exists.

Protocol (kt-lint's): findings carry fingerprints; ``justifications``
grandfathers them with a reason; stale justifications and drift fail.

    python -m kubernetes_tpu_torch.analysis.xray                  # check
    python -m kubernetes_tpu_torch.analysis.xray --write-manifest
    python -m kubernetes_tpu_torch.analysis.xray --json | --rules | --summary

The canonical configuration is fixed here, never read from the
environment.  While it traces, the run replaces two module attributes
(the solver's ``scan_route`` and ``scan.scan_chunk``) with versions that
act only on the tracing thread: run it from a driver or a test.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import hashlib
import json
import os
import re
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubernetes_tpu_torch.analysis import core as lint_core

REPO = lint_core.REPO
PACKAGE = lint_core.PACKAGE
DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "shape_manifest.json")
META = torch.device("meta")

# -- canonical configuration (fixed, never read from the environment) ----

#: The manifest's canonical instantiation: the defaults of the matching
#: knobs and constants (tests/test_torch_xray.py pins them).
CANON = {
    "schema": 1,
    "nodes": 8,                  # canonical cluster rows
    "floor": 256,                # Scheduler.STREAM_MIN_BUCKET
    "pad_limit": 4096,           # Scheduler._PAD_LIMIT
    "stream_threshold_off": True,  # KT_STREAM_CHUNK default 0
    "victims": 16,               # KT_PREEMPT_MAX_VICTIMS default, pow2
    "topo_terms": 1,             # one canonical spread term
    "topo_domains": 8,           # topology._pow2 domain floor
    "joint_iters": 24,           # solve_joint default n_iters
    # Declared widths (bits): X02's widening bound.
    "feature_bits": {"float": 32, "int": 32},
}

_DTYPE_SHORT = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "int64": "i64", "int32": "i32", "int16": "i16",
    "int8": "i8", "uint64": "u64", "uint32": "u32", "uint16": "u16",
    "uint8": "u8", "bool": "b1",
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def aval_str(x: Any) -> str:
    """'f32[256x4]' for a tensor (or anything with .shape/.dtype)."""
    dt = x.dtype
    name = _dtype_name(dt) if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name
    short = _DTYPE_SHORT.get(name, name)
    return f"{short}[{'x'.join(str(d) for d in x.shape)}]"


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _avals(tree: Any) -> list[str]:
    return [aval_str(t) for t in _leaves(tree)]


# -- X-rule registry ----------------------------------------------------

@dataclass(frozen=True)
class XRule:
    id: str
    title: str
    doc: str


XRULES: dict[str, XRule] = {}


def _xrule(rule_id: str, title: str, doc: str) -> XRule:
    r = XRule(rule_id, title, doc)
    XRULES[rule_id] = r
    return r


_xrule("X01", "no host-sync op inside a manifested program",
       doc="aten::_local_scalar_dense (item/bool/int of a tensor) or a "
           "copy to the CPU inside a family is a hidden round trip; the "
           "family's one readback is the dispatch site's, gated by "
           "checked_readback.")
_xrule("X02", "no silent dtype widening past the declared width",
       doc="a conversion to float64, or to int64 of a value that is not "
           "only an index, doubles bytes; the deliberate ones are "
           "justified in the manifest.")
_xrule("X03", "every engine in-place write carries an in-place "
              "annotation; every out-of-place plane write a no-alias one",
       doc="Aliasing is a deliberate decision: a write that updates a "
           "plane a queued chunk still reads corrupts it, so each site "
           "says which it is.")
_xrule("X04", "coverage: warmed manifest == prewarm plan; every kernel "
              "symbol, wrapper and live-path region claimed; sites exist",
       doc="Makes 'every live-path launch lands on a planned, registered "
           "program' a check on the CPU; the build watchdog stays armed "
           "as the runtime backstop.")


@dataclass(frozen=True)
class XFinding:
    rule: str
    program: str   # program key, or "path:function" for source rules
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.program}:{self.message}"

    def text(self) -> str:
        return f"{self.program}: {self.rule}: {self.message}"


# -- the op recorder ----------------------------------------------------

_aten = torch.ops.aten
_SCALAR_SYNC = (_aten._local_scalar_dense.default,)
# Ops whose argument at the given position is an index tensor (or a list
# of them): an int64 conversion that only feeds these is an index.
_INDEX_ARGS = {
    "index_select": 2, "gather": 2, "index_add": 2, "index_add_": 2,
    "index_copy": 2, "index_copy_": 2, "index_fill": 2, "index_fill_": 2,
    "scatter": 2, "scatter_": 2, "scatter_add": 2, "scatter_add_": 2,
    "index_put": 1, "index_put_": 1, "index": 1, "take": 1,
    "_index_put_impl_": 1,
}


# ``aten::detach`` does no work outside autograd (a view of its input),
# and one can be dispatched on the tracing thread by code outside the
# program (seen mid-trace under parallel test workers): not recorded.
_UNRECORDED = ("aten::detach",)


class Recorder(TorchDispatchMode):
    """Records every aten op dispatched under it: its name and output
    shapes and dtypes, host syncs (answered with a zero so the trace
    goes on), copies to the CPU, and dtype widenings with whether each
    widened value only ever served as an index."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, tuple[str, ...]]] = []
        self.syncs: list[str] = []
        self.paused = 0
        self._widen: list[dict] = []          # one per widening event
        self._origin: dict[int, set[int]] = {}  # id(tensor) -> events
        self._keep: list[torch.Tensor] = []    # ids stay unique

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name()
        if self.paused or name in _UNRECORDED:
            return func(*args, **kwargs)
        if func in _SCALAR_SYNC:
            self.syncs.append(name)
            self.ops.append((name, ()))
            return False if args[0].dtype == torch.bool else 0
        if func is _aten._to_copy.default and \
                kwargs.get("device") is not None and \
                torch.device(kwargs["device"]).type == "cpu" and \
                args[0].device.type != "cpu":
            self.syncs.append(f"{name} to cpu")
            kwargs = dict(kwargs, device=META)
        if func is _aten.copy_.default and args[0].device.type == "cpu" \
                and args[1].device.type != "cpu":
            self.syncs.append(f"{name} to cpu")
            self.ops.append((name, (aval_str(args[0]),)))
            return args[0]
        out = func(*args, **kwargs)
        outs = list(_leaves(out))
        self.ops.append((name, tuple(aval_str(t) for t in outs)))
        self._track(func, name, args, kwargs, outs)
        return out

    def _track(self, func, name, args, kwargs, outs) -> None:
        base = name.split("::", 1)[-1].split(".", 1)[0]
        pos = _INDEX_ARGS.get(base)
        if pos is not None and len(args) > pos:
            for t in _leaves(args[pos]):
                for ev in self._origin.get(id(t), ()):
                    self._widen[ev]["index"] = True
        origins: set[int] = set()
        for t in _leaves((args, kwargs)):
            origins |= self._origin.get(id(t), set())
        if func is _aten._to_copy.default and "dtype" in kwargs:
            src = args[0].dtype
            dst = kwargs["dtype"]
            if dst is not None and dst.itemsize > src.itemsize and \
                    not dst.is_complex:
                self._widen.append({"to": _dtype_name(dst),
                                    "from": _dtype_name(src),
                                    "float": dst.is_floating_point,
                                    "index": False})
                origins = {len(self._widen) - 1}
        if origins:
            for t in outs:
                if t.dtype == torch.int64:
                    self._origin[id(t)] = set(origins)
                    self._keep.append(t)

    @contextlib.contextmanager
    def pause(self) -> Iterator[None]:
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def widenings(self) -> list[dict]:
        """The widening events that X02 counts: every float one, and the
        int ones whose value never served as an index."""
        return [w for w in self._widen if w["float"] or not w["index"]]


# -- the kernel launches a trace makes ----------------------------------

_SCAN_CU = os.path.join(REPO, PACKAGE, "csrc", "scan.cu")
_SELECT_CU = os.path.join(REPO, PACKAGE, "csrc", "select.cu")


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return "sha256:" + hashlib.sha256(f.read()).hexdigest()


def scan_reach() -> dict:
    """The scan kernel's instantiations its wrapper can reach: K from the
    source's ``KT_SCAN_KS`` list, both encoded-row widths, the mixed and
    rich families, and the cluster sizes of ``cluster_plan``'s rule."""
    from kubernetes_tpu_torch.engine import scan as scan_mod
    with open(_SCAN_CU) as f:
        m = re.search(r"#define\s+KT_SCAN_KS\(X\)\s+(.*)", f.read())
    ks = [int(k) for k in re.findall(r"X\((\d+)\)", m.group(1))] if m \
        else []
    return {"k": ks, "enc": ["f32", "f16"], "families": ["mixed", "rich"],
            "rule": [list(r) for r in scan_mod.RULE],
            "cluster_sizes": list(scan_mod.CLUSTER_SIZES)}


@contextlib.contextmanager
def card_route(rec: Recorder, launches: list) -> Iterator[None]:
    """Trace the card's dispatch on meta tensors: on the calling thread
    the solver takes the kernel route, and each ``scan_chunk`` call runs
    the wrapper's checks and ``cluster_plan`` and records the launch it
    would make.  Every other thread keeps the real functions."""
    from kubernetes_tpu_torch.engine import scan as scan_mod
    from kubernetes_tpu_torch.engine import solver as sv
    real_scan, real_route = scan_mod.scan_chunk, sv.scan_route
    tracer = threading.get_ident()

    def route_shim(device):
        if threading.get_ident() != tracer:
            return real_route(device)
        return "kernel"

    def scan_shim(enc, **kw):
        if threading.get_ident() != tracer:
            return real_scan(enc, **kw)
        with rec.pause():
            try:
                real_scan(enc, **kw)
            except ValueError as err:
                # The wrapper refuses a meta tensor only at its launch.
                if "the kernel takes CUDA tensors" not in str(err):
                    raise
            p, n = enc.shape
            t = kw["templates"].shape[0] \
                if kw.get("d_plane") is not None else 0
            s = kw["sp_node"].shape[0] if kw.get("sp_node") is not None \
                else 0
            z = kw["sp_zone"].shape[1] if kw.get("sp_zone") is not None \
                else 0
            half = enc.dtype == torch.float16
            plan = scan_mod.cluster_plan(n, t=t, s=s, z=z, half=half,
                                         cluster=kw.get("cluster"))
            rich = any(k in scan_mod.RICH_ARGS for k in kw)
            launches.append({
                "symbol": "kt_scan_chunk", "p": p, "n": n,
                "instantiation": "rich" if rich else "mixed",
                "enc": "f16" if half else "f32", "k": plan.k,
                "cluster": plan.cluster, "threads": plan.threads,
                "smem": plan.smem, "t": t, "s": s, "z": z})
            return torch.empty(p, dtype=torch.int32, device=enc.device)

    scan_mod.scan_chunk = scan_shim
    sv.scan_route = route_shim
    try:
        yield
    finally:
        scan_mod.scan_chunk = real_scan
        sv.scan_route = real_route


def kernel_launch(symbol: str, rows: int, n: int) -> dict:
    """The launch record of a select kernel (one CTA per row)."""
    return {"symbol": symbol, "p": rows, "n": n, "grid": rows}


# -- canonical context & program builders -------------------------------

def canonical_ladder() -> list[int]:
    from kubernetes_tpu_torch.scheduler.scheduler import bucket_ladder
    return bucket_ladder(CANON["floor"], 1 << 62, CANON["pad_limit"], 0)


def canonical_scatter_rows() -> list[int]:
    """Dirty-row counts the scatter runs at on the canonical cluster:
    powers of two below the full-upload fraction."""
    from kubernetes_tpu_torch.engine.solver import ResidentCluster
    n = CANON["nodes"]
    out, r = [], 1
    while r * ResidentCluster.FULL_FRACTION < n:
        out.append(r)
        r <<= 1
    return out


def canonical_plan() -> list[str]:
    from kubernetes_tpu_torch.scheduler.scheduler import prewarm_plan
    return prewarm_plan(canonical_ladder(), cuda=True, preempt=True,
                        joint=True)


@dataclass
class Context:
    """The canonical workload as meta tensors: a minimal pod over
    CANON['nodes'] identical nodes, through the real snapshot and feature
    compile, plus the solver whose policy constants the traces use."""
    solver: Any
    batch1: Any          # DeviceBatch at P=1 (meta)
    cluster: Any         # DeviceCluster at N nodes (meta)
    flags: Any
    cache: Any


def build_context() -> Context:
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.api.policy import (DEFAULT_MAX_EBS_VOLUMES,
                                                 DEFAULT_MAX_GCE_PD_VOLUMES)
    from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
    from kubernetes_tpu_torch.engine import solver as sv
    from kubernetes_tpu_torch.engine.generic_scheduler import \
        GenericScheduler
    cache = SchedulerCache()
    for i in range(CANON["nodes"]):
        cache.add_node(api.Node(
            name=f"__xray-{i}", labels={}, annotations={},
            allocatable_milli_cpu=4000, allocatable_memory=16 * 1024 ** 3,
            allocatable_gpu=0, allocatable_pods=110,
            conditions=[api.NodeCondition(type="Ready", status="True")]))
    eng = GenericScheduler(cache=cache, device="cpu")
    pods = [api.Pod(name="__xray-0", namespace="__xray__")]
    with cache.lock:
        nt, agg, ep, nodes = cache.snapshot()
        batch = eng._compile_batch(pods, nt, ep, nodes)
    # A fresh solver with the env-derived MaxPD caps pinned to their
    # provider defaults (an env override in the running process must not
    # move the committed surface).
    solver = sv.Solver(eng.policy)
    solver.extra = {"max_ebs": DEFAULT_MAX_EBS_VOLUMES,
                    "max_gce": DEFAULT_MAX_GCE_PD_VOLUMES}
    return Context(solver=solver, batch1=sv.device_batch(batch, META),
                   cluster=sv.device_cluster(nt, agg, cache.space, META),
                   flags=sv.batch_flags(batch), cache=cache)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def resize_pod_axis(b: Any, p: int) -> Any:
    """The batch with its pod axis resized to ``p`` — driven by the
    solver's own pod-axis field lists."""
    from kubernetes_tpu_torch.engine import solver as sv

    def rz(t: torch.Tensor) -> torch.Tensor:
        return _meta((p,) + tuple(t.shape[1:]), t.dtype)

    upd = {f: rz(getattr(b, f)) for f in sv._POD_AXIS_FIELDS}
    aff = b.aff._replace(**{f: rz(getattr(b.aff, f))
                            for f in sv._AFF_POD_AXIS_FIELDS})
    vs = b.volsvc._replace(**{f: rz(getattr(b.volsvc, f))
                              for f in sv._VS_POD_AXIS_FIELDS})
    return b._replace(aff=aff, volsvc=vs, **upd)


def program_builders(ctx: Context
                     ) -> dict[str, tuple[str, Callable, tuple]]:
    """program key -> (family name, fn, meta args)."""
    from kubernetes_tpu_torch.engine import fused
    from kubernetes_tpu_torch.engine import solver as sv
    from kubernetes_tpu_torch.engine.workloads import preemption, topology
    from kubernetes_tpu_torch.ops import combine
    solver, flags, c = ctx.solver, ctx.flags, ctx.cluster
    n, floor = CANON["nodes"], CANON["floor"]
    cnt = _meta((1,), torch.int64)
    progs: dict[str, tuple[str, Callable, tuple]] = {}

    def chunk(b, c, k, live):
        return solver._solve_scan(b, c, k, None, flags, None, live, None)

    for bucket in canonical_ladder():
        progs[f"scan_chunk@{bucket}"] = (
            "scan_chunk", chunk, (resize_pod_axis(ctx.batch1, bucket), c,
                                  cnt, _meta((bucket,), torch.bool)))

    b_f = resize_pod_axis(ctx.batch1, floor)
    live_f = _meta((floor,), torch.bool)

    def oneshot_topo(b, c, k, live, em, sb):
        return solver.solve_sequential_packed(
            b, c, k, flags, extra_mask=em, score_bias=sb, live=live)

    progs[f"oneshot_topo@{floor}"] = (
        "oneshot_topo", oneshot_topo,
        (b_f, c, cnt, live_f, _meta((floor, n), torch.bool),
         _meta((floor, n), torch.float32)))

    def joint(b, c, k, live):
        return solver.solve_joint(b, c, k, CANON["joint_iters"],
                                  flags=flags, live=live)

    progs[f"joint@{floor}"] = ("joint", joint, (b_f, c, cnt, live_f))
    progs["select_rows@1"] = ("select_rows", fused.select_plain, (
        _meta((1, n), torch.float32), cnt))
    progs["select_hosts@1"] = ("select_hosts", combine.select_hosts_plain, (
        _meta((1, n), torch.float32), _meta((1, n), torch.bool), cnt))
    progs["single_evaluate@1"] = (
        "single_evaluate", lambda b, c: solver.evaluate(b, c, flags),
        (ctx.batch1, c))
    progs["single_masks@1"] = (
        "single_masks", lambda b, c: solver.masks(b, c), (ctx.batch1, c))

    with ctx.cache.lock:
        nt, agg, _ep, _nodes = ctx.cache.snapshot()
    space, epoch = ctx.cache.space, ctx.cache.tensor_epoch
    for rows in canonical_scatter_rows():
        def scatter(dirty, nt=nt, agg=agg):
            rc = sv.ResidentCluster(device=META)
            rc.dc, rc._sig, rc._epoch = c, rc.signature(nt, space), epoch
            return rc.sync(nt, agg, space, dirty, epoch)

        progs[f"scatter@{rows}"] = ("scatter", scatter,
                                    (set(range(rows)),))

    v = CANON["victims"]
    i32, b1 = torch.int32, torch.bool
    progs["victim_solve"] = ("victim_solve", preemption.victim_solve, (
        _meta((n, 4), i32), _meta((n, 4), i32), _meta((n,), b1),
        _meta((n, v, 4), i32), _meta((n, v), i32), _meta((n, v), b1),
        _meta((4,), i32), _meta((), b1), _meta((), i32)))

    t, d = CANON["topo_terms"], CANON["topo_domains"]
    terms = topology.SpreadTerms(
        np.zeros(t, np.int32), np.ones(t, np.float32), np.ones(t, bool),
        np.zeros((t, d), np.float32), np.ones((t, d), bool),
        np.zeros((floor, t), bool), any_hard=True, any_soft=True)
    progs["topo_planes"] = (
        "topo_planes", lambda dom: topology.TermPlanes(terms, dom).rows(),
        (_meta((n, 1), torch.int32),))
    return progs


def _in_avals(args: tuple) -> list:
    return [_avals(a) if not isinstance(a, set) else [f"rows[{len(a)}]"]
            for a in args]


def _canon_text(ops: list, launches: list, extra: dict) -> str:
    lines = [f"{name} -> {','.join(outs)}" for name, outs in ops]
    lines += [json.dumps(x, sort_keys=True) for x in launches]
    lines.append(json.dumps(extra, sort_keys=True))
    return "\n".join(lines)


def _fingerprint(text: str) -> str:
    return "sha256:" + hashlib.sha256(text.encode()).hexdigest()


def library_digest() -> str:
    """The kernel library's build key: both sources and the flags, as
    ``engine/kernels.py:library_path`` names the library."""
    from kubernetes_tpu_torch.engine import kernels
    digest = hashlib.sha256()
    for src in kernels.SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(kernels.NVCC_FLAGS).encode())
    return "sha256:" + digest.hexdigest()


def trace_program(fn: Callable, args: tuple
                  ) -> tuple[Recorder, list, Any]:
    """(recorder, kernel launches, output) of ``fn(*args)`` on meta."""
    rec = Recorder()
    launches: list = []
    with card_route(rec, launches), rec:
        out = fn(*args)
    return rec, launches, out


def _kernel_column(spec, launches: list, n: int, rows: int) -> dict:
    if not spec.kernel:
        return {}
    src = os.path.join(REPO, spec.source)
    col = {"symbol": spec.kernel, "source": spec.source,
           "source_sha256": _sha(src)}
    if spec.kernel == "kt_scan_chunk":
        col["reach"] = scan_reach()
        col["launches"] = launches
    else:
        col["launches"] = [kernel_launch(spec.kernel, rows, n)]
    return col


def build_manifest() -> tuple[dict, dict[str, Recorder]]:
    """(manifest dict sans justifications, {program key: recorder})."""
    from kubernetes_tpu_torch.engine import entrypoints
    ctx = build_context()
    families = entrypoints.by_name()
    programs: dict[str, dict] = {}
    recs: dict[str, Recorder] = {}
    build = families["build"]
    programs["build"] = {
        "family": "build", "live_path": build.live_path,
        "warmed": build.warmed, "dispatch_site": build.dispatch_site,
        "launch_sites": sorted(build.launch_sites),
        "in_avals": [], "out_avals": [], "ops": {},
        "kernel": {"sources": build.source.split(),
                   "library": library_digest()},
        "fingerprint": library_digest(),
    }
    for key, (family, fn, args) in sorted(program_builders(ctx).items()):
        spec = families[family]
        rec, launches, out = trace_program(fn, args)
        recs[key] = rec
        counts: dict[str, int] = {}
        for name, _outs in rec.ops:
            counts[name] = counts.get(name, 0) + 1
        kernel = _kernel_column(spec, launches, CANON["nodes"], 1)
        programs[key] = {
            "family": family,
            "live_path": spec.live_path,
            "warmed": spec.warmed,
            "dispatch_site": spec.dispatch_site,
            "launch_sites": sorted(spec.launch_sites),
            "in_avals": _in_avals(args),
            "out_avals": _avals(out),
            "ops": dict(sorted(counts.items())),
            "kernel": kernel,
            "fingerprint": _fingerprint(_canon_text(rec.ops, launches,
                                                    kernel)),
        }
    manifest = {
        "comment": "kt-xray compile-surface manifest of "
                   "kubernetes_tpu_torch, generated by `python -m "
                   "kubernetes_tpu_torch.analysis.xray --write-manifest`"
                   "; the check fails on drift.",
        "canonical": dict(CANON),
        "torch": torch.__version__.split("+")[0],
        "programs": programs,
        "hash": manifest_hash(programs),
    }
    return manifest, recs


def manifest_hash(programs: dict) -> str:
    return "sha256:" + hashlib.sha256(
        json.dumps(programs, sort_keys=True).encode()).hexdigest()


# -- X01 / X02 over one trace -------------------------------------------

def check_x01(program: str, rec: Recorder) -> list[XFinding]:
    out, seen = [], set()
    for name in rec.syncs:
        if name not in seen:
            seen.add(name)
            out.append(XFinding(
                "X01", program,
                f"host-sync op '{name}' inside the program"))
    return out


def check_x02(program: str, rec: Recorder,
              feature_bits: Optional[dict] = None) -> list[XFinding]:
    bits = feature_bits or CANON["feature_bits"]
    out, seen = [], set()
    for w in rec.widenings():
        limit = bits["float"] if w["float"] else bits["int"]
        dst = getattr(torch, w["to"])
        if dst.itemsize * 8 <= limit or w["to"] in seen:
            continue
        seen.add(w["to"])
        out.append(XFinding(
            "X02", program,
            f"conversion to {w['to']} widens past the declared "
            f"{limit}-bit width"))
    return out


# -- X03: the aliasing audit --------------------------------------------

_ANNOT_RE = re.compile(r"#\s*kt-xray:\s*(in-place|no-alias)\b")
#: Out-of-place writers of a plane: the result is a new tensor.
OUT_OF_PLACE_WRITERS = {"index_copy", "index_put", "index_add",
                        "index_fill", "scatter", "scatter_add",
                        "masked_scatter"}


def _inplace_kernels() -> set[str]:
    """The wrappers of kernels that update state arguments in place."""
    from kubernetes_tpu_torch.engine import entrypoints
    return {e.wrapper.rsplit(":", 1)[1] for e in entrypoints.ENTRYPOINTS
            if e.in_place and e.wrapper}


@dataclass(frozen=True)
class WriteSite:
    path: str
    func: str        # enclosing def
    line: int
    method: str
    in_place: bool

    @property
    def key(self) -> str:
        return f"{self.path}:{self.func}"


def discover_write_sites(module: lint_core.Module,
                         kernels: Optional[set] = None) -> list[WriteSite]:
    """Every tensor write of one module: in-place methods (``x.add_()``,
    name ending in one underscore), calls of in-place kernel wrappers,
    and out-of-place plane writers (``index_copy`` and kin)."""
    kernels = _inplace_kernels() if kernels is None else kernels
    sites: list[WriteSite] = []

    def visit(node: ast.AST, enclosing: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            enclosing = node.name
        elif isinstance(node, ast.Call):
            name = lint_core.call_name(node)
            last = name.split(".")[-1] if name else ""
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr.endswith("_") and not attr.startswith("_") and \
                        not attr.endswith("__"):
                    sites.append(WriteSite(module.path, enclosing,
                                           node.lineno, attr, True))
                elif attr in OUT_OF_PLACE_WRITERS:
                    sites.append(WriteSite(module.path, enclosing,
                                           node.lineno, attr, False))
            if last in kernels:
                sites.append(WriteSite(module.path, enclosing, node.lineno,
                                       last, True))
        for child in ast.iter_child_nodes(node):
            visit(child, enclosing)

    visit(module.tree, "<module>")
    return sites


def _annotation_at(module: lint_core.Module, line: int) -> Optional[str]:
    """'in-place' | 'no-alias' from the site's line, or the run of
    comment lines directly above it."""
    for ln in range(line, 0, -1):
        text = module.lines[ln - 1]
        m = _ANNOT_RE.search(text)
        if m:
            return m.group(1)
        if ln != line and not text.strip().startswith("#"):
            return None
    return None


def check_x03(modules: list[lint_core.Module],
              kernels: Optional[set] = None) -> list[XFinding]:
    out = []
    for module in modules:
        if not module.path.startswith(f"{PACKAGE}/engine/"):
            continue
        for site in discover_write_sites(module, kernels):
            kind = _annotation_at(module, site.line)
            want = "in-place" if site.in_place else "no-alias"
            if kind is None:
                out.append(XFinding(
                    "X03", site.key,
                    f"{site.method}() has no '# kt-xray: {want}(<reason>)' "
                    f"annotation"))
            elif kind != want:
                out.append(XFinding(
                    "X03", site.key,
                    f"{site.method}() is annotated {kind} but is an "
                    f"{'in-place' if site.in_place else 'out-of-place'} "
                    f"write"))
    return out


# -- X04: coverage ------------------------------------------------------

def _function_exists(module: lint_core.Module, name: str) -> bool:
    return any(isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
               and node.name == name for node in ast.walk(module.tree))


def device_modules(root: str = REPO) -> list[lint_core.Module]:
    """engine/, engine/workloads/ and ops/ of this package."""
    dirs = [os.path.join(root, PACKAGE, d)
            for d in ("engine", "engine/workloads", "ops")]
    files = sorted(os.path.join(d, f) for d in dirs if os.path.isdir(d)
                   for f in os.listdir(d) if f.endswith(".py"))
    return lint_core.load_project(root, paths=files).modules


def extern_symbols(root: str = REPO) -> dict[str, str]:
    """symbol -> source (repo-relative) of every ``extern "C"`` function
    of ``csrc/``."""
    csrc = os.path.join(root, PACKAGE, "csrc")
    out: dict[str, str] = {}
    for fn in sorted(os.listdir(csrc)):
        if not fn.endswith((".cu", ".cuh", ".h")):
            continue
        with open(os.path.join(csrc, fn)) as f:
            for m in re.finditer(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(',
                                 f.read()):
                out[m.group(1)] = f"{PACKAGE}/csrc/{fn}"
    return out


def _counts_launches(fn: ast.AST) -> bool:
    return any(isinstance(sub, ast.AugAssign) and
               isinstance(sub.target, ast.Attribute) and
               sub.target.attr == "launches" for sub in ast.walk(fn))


def _opens_live_path(fn: ast.AST) -> bool:
    return any(isinstance(sub, ast.Call) and
               lint_core.call_name(sub).endswith("live_path")
               for sub in ast.walk(fn))


def check_x04(programs: dict, modules: list[lint_core.Module],
              symbols: Optional[dict] = None) -> list[XFinding]:
    from kubernetes_tpu_torch.engine import entrypoints
    out: list[XFinding] = []
    # (a) the warmed programs ARE the prewarm plan.
    warmed = sorted(k for k, p in programs.items() if p["warmed"])
    plan = canonical_plan()
    for missing in sorted(set(plan) - set(warmed)):
        out.append(XFinding(
            "X04", missing,
            "prewarm plan program missing from the manifest "
            "(ladder coverage gap)"))
    for extra in sorted(set(warmed) - set(plan)):
        out.append(XFinding(
            "X04", extra,
            "manifest marks this program warmed but Scheduler.prewarm "
            "never runs it (unreachable-from-prewarm program)"))
    # (b) every extern "C" symbol is claimed, and only real ones are.
    symbols = extern_symbols() if symbols is None else symbols
    claimed = entrypoints.claimed_symbols()
    for sym in sorted(set(symbols) - claimed):
        out.append(XFinding(
            "X04", f"{symbols[sym]}:{sym}",
            "unclaimed kernel symbol: no entry in engine/entrypoints.py "
            "owns this extern \"C\" function"))
    for sym in sorted(claimed - set(symbols)):
        out.append(XFinding(
            "X04", sym, "entrypoints.py claims a kernel symbol csrc/ "
                        "does not define"))
    # (c) kernel wrappers and live-path regions are claimed.
    sites = entrypoints.claimed_launch_sites()
    dispatch = {e.dispatch_site for e in entrypoints.ENTRYPOINTS}
    for module in modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            key = f"{module.path}:{node.name}"
            if _counts_launches(node) and key not in sites:
                out.append(XFinding(
                    "X04", key,
                    "unmanifested kernel wrapper: no entry in "
                    "engine/entrypoints.py claims this launch site"))
            if _opens_live_path(node) and key not in dispatch and \
                    not key.endswith("devicestats.py:live_path"):
                out.append(XFinding(
                    "X04", key,
                    "unmanifested live-path region: no entry in "
                    "engine/entrypoints.py names this dispatch site"))
    # (d) every named site exists.
    by_path = {m.path: m for m in modules}

    def exists(site: str) -> bool:
        path, _, func = site.partition(":")
        module = by_path.get(path)
        if module is None and os.path.exists(os.path.join(REPO, path)):
            module = lint_core.load_project(
                REPO, paths=[os.path.join(REPO, path)]).modules[0]
        return module is not None and _function_exists(module, func)

    for spec in entrypoints.ENTRYPOINTS:
        for site in (spec.dispatch_site,) + spec.launch_sites:
            if not exists(site):
                out.append(XFinding(
                    "X04", site,
                    f"site of family '{spec.name}' not found"))
    # (e) every program belongs to a registered family.
    families = entrypoints.by_name()
    for key, prog in sorted(programs.items()):
        if prog["family"] not in families:
            out.append(XFinding(
                "X04", key, f"program family '{prog['family']}' is not "
                            f"registered in engine/entrypoints.py"))
    return out


# -- the check ----------------------------------------------------------

@dataclass
class Result:
    drift: list[str]
    new: list[XFinding]
    justified: list[XFinding]
    stale_justifications: list[str]
    programs: dict

    @property
    def failed(self) -> bool:
        return bool(self.drift or self.new or self.stale_justifications)


def load_manifest(path: str = DEFAULT_MANIFEST) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def manifest_summary(path: str = DEFAULT_MANIFEST) -> Optional[dict]:
    """{'hash', 'programs'} of the COMMITTED manifest (no tracing): the
    bench's ``xray`` stamp."""
    data = load_manifest(path)
    if data is None:
        return None
    return {"hash": data.get("hash"),
            "programs": len(data.get("programs") or {})}


_DRIFT_COLUMNS = ("fingerprint", "in_avals", "out_avals", "warmed",
                  "dispatch_site", "launch_sites", "family", "kernel",
                  "ops")


def diff_programs(committed: dict, rebuilt: dict) -> list[str]:
    drift = []
    for key in sorted(set(committed) - set(rebuilt)):
        drift.append(f"{key}: program vanished from the compile surface "
                     f"(manifest not regenerated)")
    for key in sorted(set(rebuilt) - set(committed)):
        drift.append(f"{key}: new program not in the committed manifest")
    for key in sorted(set(rebuilt) & set(committed)):
        for col in _DRIFT_COLUMNS:
            was, now = committed[key].get(col), rebuilt[key].get(col)
            if was == now:
                continue
            detail = ""
            if col == "ops":
                moved = {op: (now or {}).get(op, 0) - (was or {}).get(op, 0)
                         for op in set(was or {}) | set(now or {})}
                detail = " " + ", ".join(f"{op} {n:+d}" for op, n in
                                         sorted(moved.items()) if n)
            drift.append(f"{key}: {col} drifted{detail} (regenerate the "
                         f"manifest)")
    return drift


def collect_findings(programs: dict, recs: dict[str, Recorder]
                     ) -> list[XFinding]:
    """Every X01–X04 finding of one rebuilt manifest (the one collection
    both the check and the regenerator use)."""
    findings: list[XFinding] = []
    for key, rec in sorted(recs.items()):
        findings.extend(check_x01(key, rec))
        findings.extend(check_x02(key, rec))
    modules = device_modules()
    findings.extend(check_x03(modules))
    findings.extend(check_x04(programs, modules))
    return findings


def run_check(manifest_path: str = DEFAULT_MANIFEST) -> Result:
    rebuilt, recs = build_manifest()
    committed = load_manifest(manifest_path)
    drift: list[str] = []
    justifications: dict[str, str] = {}
    if committed is None:
        drift.append(f"missing committed manifest {manifest_path} — run "
                     f"`python -m kubernetes_tpu_torch.analysis.xray "
                     f"--write-manifest`")
    else:
        justifications = dict(committed.get("justifications") or {})
        drift.extend(diff_programs(committed.get("programs") or {},
                                   rebuilt["programs"]))
        if committed.get("hash") != manifest_hash(
                committed.get("programs") or {}):
            drift.append("committed manifest hash does not match its own "
                         "programs section (hand-edited?)")
        if committed.get("canonical") != CANON:
            drift.append("committed manifest's canonical configuration "
                         "differs from CANON")
    findings = collect_findings(rebuilt["programs"], recs)
    new = [f for f in findings if f.fingerprint not in justifications]
    seen = {f.fingerprint for f in findings}
    stale = sorted(fp for fp in justifications if fp not in seen)
    return Result(drift=drift, new=new,
                  justified=[f for f in findings
                             if f.fingerprint in justifications],
                  stale_justifications=stale,
                  programs=rebuilt["programs"])


def write_manifest(path: str = DEFAULT_MANIFEST) -> dict:
    """Regenerate the manifest, keeping the justification of every
    finding that still exists (stale ones go with their finding)."""
    manifest, recs = build_manifest()
    committed = load_manifest(path)
    old_just = dict((committed or {}).get("justifications") or {})
    findings = collect_findings(manifest["programs"], recs)
    manifest["justifications"] = {
        f.fingerprint: old_just.get(
            f.fingerprint, "JUSTIFY: why this finding is accepted")
        for f in findings}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the compile-surface manifest of kubernetes_tpu_torch")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--manifest", default=DEFAULT_MANIFEST)
    ap.add_argument("--write-manifest", action="store_true")
    ap.add_argument("--rules", action="store_true")
    ap.add_argument("--summary", action="store_true")
    opts = ap.parse_args(argv)

    if opts.rules:
        for rid in sorted(XRULES):
            print(f"{rid} {XRULES[rid].title}")
        return 0
    if opts.summary:
        summary = manifest_summary(opts.manifest)
        print(json.dumps(summary, indent=1))
        return 0 if summary else 1
    if opts.write_manifest:
        manifest = write_manifest(opts.manifest)
        pending = [fp for fp, why in manifest["justifications"].items()
                   if "JUSTIFY" in why]
        print(f"wrote {len(manifest['programs'])} program(s) to "
              f"{opts.manifest} (hash {manifest['hash'][:19]}…)")
        for fp in pending:
            print(f"  needs justification: {fp}")
        return 0

    result = run_check(opts.manifest)
    if opts.as_json:
        print(json.dumps({
            "drift": result.drift,
            "new": [f.fingerprint for f in result.new],
            "justified": [f.fingerprint for f in result.justified],
            "stale_justifications": result.stale_justifications,
            "programs": sorted(result.programs),
            "rules": sorted(XRULES),
        }, indent=1))
    else:
        for line in result.drift:
            print(f"DRIFT: {line}")
        for f in result.new:
            print(f.text())
        for fp in result.stale_justifications:
            print(f"STALE justification (finding fixed — remove it): {fp}")
        if result.failed:
            print(f"ktxray: {len(result.drift)} drift line(s), "
                  f"{len(result.new)} new finding(s), "
                  f"{len(result.stale_justifications)} stale "
                  f"justification(s)", file=sys.stderr)
        else:
            print(f"ktxray: clean ({len(result.programs)} programs, "
                  f"{len(result.justified)} justified finding(s))")
    return 1 if result.failed else 0


if __name__ == "__main__":
    sys.exit(main())

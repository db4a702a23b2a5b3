"""The sequential-greedy scan of a whole chunk in one CUDA launch.

:func:`scan_chunk` wraps the kernel of ``csrc/scan.cu``, which runs the P
dependent steps of ``Solver._fused_scan``'s step loop for the ``mixed``
family set in one CTA: dynamic PodFitsResources, the template-factored
or in-step resource priorities, selector/service spread with or without
zones, and selectHost inlined.  It replaces, on the card, the per-pod
launches of the select kernel and of the ~120 small PyTorch kernels
around it.

Its plain version is the step loop itself (``engine/solver.py``), which
``tests/test_torch_solver.py`` pins to the JAX package; the kernel is
held against it bit for bit on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  :func:`takes` is the dispatch predicate:
``_fused_scan`` sends a chunk on CUDA tensors here when it holds no
family beyond ``mixed``, and to the step loop otherwise.

:func:`scan_chunk` takes CUDA tensors only, launches on the current
stream, never synchronises, raises on a failed launch, and counts its
launches in ``scan_chunk.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.engine.kernels import library

# Dynamic priority -> term kind of csrc/scan.cu.
TERM_KINDS = {"LeastRequestedPriority": 0, "MostRequestedPriority": 1,
              "BalancedResourceAllocation": 2, "SelectorSpreadPriority": 3,
              "ServiceSpreadingPriority": 3}
SPREAD_KIND = 3
MAX_TERMS = 8
MAX_NODES = 16384

# Scan families (``_solve_scan``'s ``fams``) the kernel does not carry:
# a chunk holding any of them runs the step loop.
RICH_FAMILIES = ("use_ports", "use_volumes", "use_max_ebs", "use_max_gce",
                 "use_interpod", "track_affinity", "track_saa")


def takes(fams: dict) -> bool:
    """Whether the kernel carries every family of ``fams``."""
    return not any(fams[f] for f in RICH_FAMILIES)


class _ScanArgs(ctypes.Structure):
    """csrc/scan.cu ``ScanArgs``, field for field."""

    _fields_ = [
        ("enc", ctypes.c_void_p), ("request", ctypes.c_void_p),
        ("nonzero", ctypes.c_void_p), ("zero_request", ctypes.c_void_p),
        ("tmpl_idx", ctypes.c_void_p), ("templates", ctypes.c_void_p),
        ("spread_group", ctypes.c_void_p), ("spread_incr", ctypes.c_void_p),
        ("has_zones", ctypes.c_void_p), ("node_zone", ctypes.c_void_p),
        ("alloc", ctypes.c_void_p), ("packed", ctypes.c_void_p),
        ("d_plane", ctypes.c_void_p), ("sp_node", ctypes.c_void_p),
        ("sp_maxn", ctypes.c_void_p), ("sp_zone", ctypes.c_void_p),
        ("sp_maxz", ctypes.c_void_p), ("counter", ctypes.c_void_p),
        ("choices", ctypes.c_void_p),
        ("p", ctypes.c_int), ("n", ctypes.c_int), ("t", ctypes.c_int),
        ("s", ctypes.c_int), ("z", ctypes.c_int), ("half", ctypes.c_int),
        ("use_resources", ctypes.c_int), ("use_templates", ctypes.c_int),
        ("track_spread", ctypes.c_int), ("track_zones", ctypes.c_int),
        ("n_terms", ctypes.c_int), ("n_tmpl_terms", ctypes.c_int),
        ("term_kind", ctypes.c_int * MAX_TERMS),
        ("term_w", ctypes.c_float * MAX_TERMS),
        ("tmpl_kind", ctypes.c_int * MAX_TERMS),
        ("tmpl_w", ctypes.c_float * MAX_TERMS),
    ]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or \
            tuple(t.shape) != shape or not t.is_contiguous():
        got = (f"{t.dtype} {tuple(t.shape)}"
               f"{'' if t.is_contiguous() else ' non-contiguous'}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"scan_chunk: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape}, got {got}")
    return t


def _kinds(terms: tuple, what: str) -> tuple[list[int], list[float]]:
    if len(terms) > MAX_TERMS:
        raise ValueError(f"scan_chunk: at most {MAX_TERMS} {what}, got "
                         f"{len(terms)}")
    kinds, weights = [], []
    for name, weight, _aux in terms:
        if name not in TERM_KINDS:
            raise ValueError(f"scan_chunk: {name!r} is not a priority the "
                             f"kernel computes")
        kinds.append(TERM_KINDS[name])
        weights.append(float(weight))
    return kinds, weights


def scan_chunk(enc: torch.Tensor, *, request: torch.Tensor,
               nonzero: torch.Tensor, zero_request: torch.Tensor,
               alloc: torch.Tensor, packed: torch.Tensor,
               counter: torch.Tensor, terms: tuple = (),
               use_resources: bool = True,
               templates: torch.Tensor | None = None,
               tmpl_idx: torch.Tensor | None = None,
               d_plane: torch.Tensor | None = None, tmpl_terms: tuple = (),
               spread_group: torch.Tensor | None = None,
               spread_incr: torch.Tensor | None = None,
               sp_node: torch.Tensor | None = None,
               sp_maxn: torch.Tensor | None = None,
               node_zone: torch.Tensor | None = None,
               has_zones: torch.Tensor | None = None,
               sp_zone: torch.Tensor | None = None,
               sp_maxz: torch.Tensor | None = None) -> torch.Tensor:
    """Run one chunk's P scan steps in one launch; returns ``choices``
    [P] int32 (-1 = unplaced).

    ``enc`` [P, N] f32 or f16 is the encoded static plane (-inf =
    statically infeasible); ``request`` [P, 4], ``nonzero`` [P, 2] int32
    and ``zero_request`` [P] bool are the pods'; ``alloc`` [N, 4] int32.
    The carried state is updated in place: ``packed`` [N, 6] int32,
    ``counter`` [1] int64 (its low 32 bits are the uint32 counter; the
    final value is written masked), and per family:

    * templates (``d_plane`` given): ``templates`` [T, 2] and
      ``tmpl_idx`` [P] int32, ``d_plane`` [T, N] f32, ``tmpl_terms`` the
      (name, weight, aux) priorities folded into it;
    * spread (``sp_node`` given): ``spread_group`` [P] int32,
      ``spread_incr`` [P, S] bool, ``sp_node`` [S, N] and ``sp_maxn`` [S]
      f32;
    * zones (``sp_zone`` given, needs spread): ``node_zone`` [N] int32,
      ``has_zones`` [S] bool, ``sp_zone`` [S, Z] and ``sp_maxz`` [S] f32.

    ``terms`` are the other dynamic priorities as (name, weight, aux), in
    the step loop's order."""
    if not isinstance(enc, torch.Tensor) or enc.dim() != 2 or \
            enc.dtype not in (torch.float32, torch.float16) or \
            not enc.is_contiguous():
        raise ValueError("scan_chunk: enc must be a contiguous [P, N] "
                         "float32 or float16 tensor")
    p, n = enc.shape
    if p == 0 or n == 0 or n > MAX_NODES:
        raise ValueError(f"scan_chunk: takes 1 <= N <= {MAX_NODES} nodes "
                         f"and P >= 1 pods, got (P, N) = {(p, n)}")
    i32, f32 = torch.int32, torch.float32
    args = {
        "enc": enc,
        "request": _check("request", request, i32, (p, 4)),
        "nonzero": _check("nonzero", nonzero, i32, (p, 2)),
        "zero_request": _check("zero_request", zero_request, torch.bool,
                               (p,)),
        "alloc": _check("alloc", alloc, i32, (n, 4)),
        "packed": _check("packed", packed, i32, (n, 6)),
        "counter": _check("counter", counter, torch.int64, (1,)),
    }
    kinds, weights = _kinds(tuple(terms), "dynamic priority terms")
    tmpl_kinds, tmpl_weights = _kinds(tuple(tmpl_terms), "template terms")
    if SPREAD_KIND in tmpl_kinds:
        raise ValueError("scan_chunk: spread is not template-factored")
    t = s = z = 0
    if d_plane is not None:
        if templates is None or tmpl_idx is None:
            raise ValueError("scan_chunk: d_plane needs templates and "
                             "tmpl_idx")
        t = int(templates.shape[0]) if templates.dim() == 2 else -1
        args["templates"] = _check("templates", templates, i32, (t, 2))
        args["tmpl_idx"] = _check("tmpl_idx", tmpl_idx, i32, (p,))
        args["d_plane"] = _check("d_plane", d_plane, f32, (t, n))
    elif tmpl_terms:
        raise ValueError("scan_chunk: tmpl_terms given without d_plane")
    if sp_node is not None:
        if spread_group is None or spread_incr is None or sp_maxn is None:
            raise ValueError("scan_chunk: sp_node needs spread_group, "
                             "spread_incr and sp_maxn")
        s = int(sp_node.shape[0]) if sp_node.dim() == 2 else -1
        args["spread_group"] = _check("spread_group", spread_group, i32,
                                      (p,))
        args["spread_incr"] = _check("spread_incr", spread_incr,
                                     torch.bool, (p, s))
        args["sp_node"] = _check("sp_node", sp_node, f32, (s, n))
        args["sp_maxn"] = _check("sp_maxn", sp_maxn, f32, (s,))
    elif SPREAD_KIND in kinds:
        raise ValueError("scan_chunk: a spread term needs sp_node")
    if sp_zone is not None:
        if sp_node is None or node_zone is None or has_zones is None or \
                sp_maxz is None:
            raise ValueError("scan_chunk: sp_zone needs the spread state, "
                             "node_zone, has_zones and sp_maxz")
        z = int(sp_zone.shape[1]) if sp_zone.dim() == 2 else -1
        args["node_zone"] = _check("node_zone", node_zone, i32, (n,))
        args["has_zones"] = _check("has_zones", has_zones, torch.bool, (s,))
        args["sp_zone"] = _check("sp_zone", sp_zone, f32, (s, z))
        args["sp_maxz"] = _check("sp_maxz", sp_maxz, f32, (s,))

    dev = enc.device
    if dev.type != "cuda":
        raise ValueError(f"scan_chunk: the kernel takes CUDA tensors, got "
                         f"{dev}; CPU tensors run the step loop")
    if dev.index != torch.cuda.current_device():
        raise ValueError("scan_chunk: tensors must lie on the current CUDA "
                         "device")
    for name, tensor in args.items():
        if tensor.device != dev:
            raise ValueError(f"scan_chunk: {name} is on {tensor.device}, "
                             f"enc on {dev}")

    choices = torch.empty(p, dtype=i32, device=dev)
    c = _ScanArgs()
    for name, tensor in args.items():
        setattr(c, name, tensor.data_ptr())
    c.choices = choices.data_ptr()
    c.p, c.n, c.t, c.s, c.z = p, n, t, s, z
    c.half = int(enc.dtype == torch.float16)
    c.use_resources = int(bool(use_resources))
    c.use_templates = int(d_plane is not None)
    c.track_spread = int(sp_node is not None)
    c.track_zones = int(sp_zone is not None)
    c.n_terms, c.n_tmpl_terms = len(kinds), len(tmpl_kinds)
    c.term_kind[:len(kinds)] = kinds
    c.term_w[:len(weights)] = weights
    c.tmpl_kind[:len(tmpl_kinds)] = tmpl_kinds
    c.tmpl_w[:len(tmpl_weights)] = tmpl_weights
    err = library().kt_scan_chunk(
        ctypes.byref(c),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"scan_chunk: kernel launch failed (cudaError "
                           f"{err})")
    scan_chunk.launches += 1
    return choices


scan_chunk.launches = 0

"""The registry of this package's device program families.

Counterpart of the JAX package's ``engine/entrypoints.py`` (its table of
jitted XLA programs).  Torch compiles no per-shape program, so a family
here is what a live path launches on the card: a hand-written CUDA
kernel (its ``extern "C"`` symbol in ``csrc/*.cu``, the instantiations
its wrapper can pick) with the torch ops around it, or a sequence of
torch ops alone.  Each entry names:

* ``launch_sites``: ``"<repo-relative path>:<function>"`` of each
  function the family's work runs through (the kernel wrapper, the
  torch-op programs around it);
* ``kernel``/``wrapper``/``symbols``/``source``: for a CUDA kernel, the
  symbol its wrapper calls, that wrapper (one of the launch sites), every
  ``extern "C"`` symbol of the source the family owns (helpers the
  wrapper queries included), and the source file;
* ``instantiations``: the template instantiations the wrapper can reach
  (``engine/scan.py:cluster_plan`` picks C and K for each launch);
* ``dispatch_site``: the runtime function that opens the family's
  ``devicestats.live_path`` region (or, off a live path, runs it);
* ``live_path``: that label ("" = launched outside a labelled region);
* ``warmed``: a key of ``scheduler.prewarm_plan(ladder, cuda=True)``;
* ``in_place``: the family's kernel writes some of its arguments in
  place (the aliasing audit, rule X03, reads this);
* ``jax_families``: the JAX package's families this one stands for.

Consumers: ``analysis/xray.py`` runs every family on ``meta`` tensors
into the committed manifest and checks rule X04 against this table:
every ``extern "C"`` symbol of ``csrc/`` and every kernel wrapper and
``live_path`` region under ``engine/`` is claimed by an entry, and every
named site exists.
"""

from __future__ import annotations

from typing import NamedTuple


class EntrySpec(NamedTuple):
    """One device program family (see the module docstring)."""

    name: str
    live_path: str
    launch_sites: tuple[str, ...]
    dispatch_site: str
    warmed: bool
    doc: str
    kernel: str = ""
    wrapper: str = ""
    symbols: tuple[str, ...] = ()
    source: str = ""
    instantiations: tuple[str, ...] = ()
    in_place: bool = False
    jax_families: tuple[str, ...] = ()


_PKG = "kubernetes_tpu_torch"
_SOLVER = f"{_PKG}/engine/solver.py"
_SCAN = f"{_PKG}/engine/scan.py"
_GS = f"{_PKG}/engine/generic_scheduler.py"
_PRE = f"{_PKG}/engine/workloads/preemption.py"
_TOPO = f"{_PKG}/engine/workloads/topology.py"
_SCAN_CU = f"{_PKG}/csrc/scan.cu"
_SCAN_WRAPPER = f"{_SCAN}:scan_chunk"
_SELECT_CU = f"{_PKG}/csrc/select.cu"
# The scan kernel's instantiations: scan_chunk_kernel<K, EncT, RICH> for
# K in engine/scan.py:KS, an f32 or f16 encoded row, the mixed or the
# rich families; launched as one cluster of C CTAs (cluster_plan).
SCAN_INSTANTIATIONS = ("mixed", "rich")
_SCAN_SYMBOLS = ("kt_scan_chunk", "kt_scan_max_clusters",
                 "kt_scan_args_size", "kt_scan_fixed_smem")
_SCAN_SITES = (f"{_SOLVER}:_solve_scan", f"{_SOLVER}:_fused_scan",
               f"{_SOLVER}:_predicate_mask", f"{_SOLVER}:_priority_plane",
               f"{_SCAN}:term_lists", _SCAN_WRAPPER)

ENTRYPOINTS: tuple[EntrySpec, ...] = (
    EntrySpec(
        "build", "", (f"{_PKG}/engine/kernels.py:build",),
        f"{_PKG}/engine/kernels.py:library", True,
        "The one nvcc build of the kernel library (csrc/select.cu and "
        "csrc/scan.cu, sm_90a), named by the hash of both sources and "
        "the flags; the prewarm's first key on a card.",
        source=f"{_SELECT_CU} {_SCAN_CU}"),
    EntrySpec(
        "scan_chunk", "stream", _SCAN_SITES,
        f"{_GS}:schedule_batch_stream", True,
        "One stream chunk at a ladder bucket: the hoisted static planes "
        "(_predicate_mask/_priority_plane into the encoded plane, the "
        "term lists) then ONE launch of the scan kernel over the chunk, "
        "which updates the carried state in place.  First and carried "
        "chunks are the same launch (the carry is its state arguments).",
        kernel="kt_scan_chunk", wrapper=_SCAN_WRAPPER,
        symbols=_SCAN_SYMBOLS, source=_SCAN_CU,
        instantiations=SCAN_INSTANTIATIONS, in_place=True,
        jax_families=("scan_first", "scan_carry")),
    EntrySpec(
        "oneshot_topo", "oneshot", _SCAN_SITES,
        f"{_GS}:schedule_batch", True,
        "The workload-constrained one-shot solve at the floor bucket: "
        "the spread planes' extra mask and f32 score bias enter the "
        "encoded plane, then one scan-kernel launch.",
        kernel="kt_scan_chunk", wrapper=_SCAN_WRAPPER, source=_SCAN_CU,
        instantiations=SCAN_INSTANTIATIONS, in_place=True,
        jax_families=("oneshot_topo",)),
    EntrySpec(
        "joint", "joint",
        (f"{_SOLVER}:solve_joint", f"{_SOLVER}:_price_iterate",
         f"{_SOLVER}:evaluate") + _SCAN_SITES,
        f"{_GS}:_schedule_batch_joint", True,
        "The LP-relaxed joint assignment at the floor bucket: 24 dual-"
        "price steps in torch ops, the regret order, then the repair "
        "scan as one scan-kernel launch over the permuted batch.",
        kernel="kt_scan_chunk", wrapper=_SCAN_WRAPPER, source=_SCAN_CU,
        instantiations=SCAN_INSTANTIATIONS, in_place=True,
        jax_families=("joint",)),
    EntrySpec(
        "select_rows", "stream", (f"{_PKG}/engine/fused.py:select_rows",),
        f"{_SOLVER}:_fused_scan", True,
        "The fused select of one scan step (the Pallas kernel's port): "
        "launched by the step loop, the scan kernel's plain version; "
        "inlined in the scan kernel on the card's drains.",
        kernel="kt_select_rows", wrapper=f"{_PKG}/engine/fused.py:select_rows",
        symbols=("kt_select_rows",),
        source=_SELECT_CU),
    EntrySpec(
        "select_hosts", "single_pod",
        (f"{_PKG}/ops/combine.py:select_hosts",),
        f"{_GS}:schedule", True,
        "selectHost of one schedule(pod) over its score and feasible "
        "rows, one CTA per row.",
        kernel="kt_select_hosts",
        wrapper=f"{_PKG}/ops/combine.py:select_hosts",
        symbols=("kt_select_hosts",),
        source=_SELECT_CU, jax_families=("select_hosts",)),
    EntrySpec(
        "single_evaluate", "single_pod", (f"{_SOLVER}:evaluate",),
        f"{_GS}:schedule", False,
        "The single-pod feasibility/score planes in torch ops (run by "
        "the prewarm's single-pod decision, which the plan names by its "
        "kernel, select_hosts@1).",
        jax_families=("single_evaluate",)),
    EntrySpec(
        "single_masks", "", (f"{_SOLVER}:masks",),
        f"{_GS}:_fit_error", False,
        "Per-predicate masks for FitError detail and explain_failures, "
        "outside the live-path clock.",
        jax_families=("single_masks",)),
    EntrySpec(
        "scatter", "stream", (f"{_SOLVER}:sync",),
        f"{_SOLVER}:sync", False,
        "The dirty-row scatter into the resident cluster: an out-of-"
        "place index_copy per plane (a queued chunk still reads the "
        "planes it started from).",
        jax_families=("scatter",)),
    EntrySpec(
        "victim_solve", "victim", (f"{_PRE}:victim_solve",),
        f"{_GS}:find_preemptions", True,
        "The minimal-victim-prefix planes of priority preemption at the "
        "cluster's (N, V).",
        jax_families=("victim_solve",)),
    EntrySpec(
        "topo_planes", "oneshot",
        (f"{_TOPO}:term_planes", f"{_TOPO}:contract"),
        f"{_GS}:_topo_planes", True,
        "Topology-spread hard-mask/soft-score term planes and their "
        "float64 contraction against a batch's term rows.",
        jax_families=("topo_planes",)),
)

#: The JAX package's families (its engine/entrypoints.py); each maps to
#: a family above through ``jax_families``.
JAX_FAMILIES = ("scan_first", "scan_carry", "oneshot_topo", "joint",
                "single_evaluate", "single_masks", "select_hosts",
                "scatter", "victim_solve", "topo_planes")


def by_name() -> dict[str, EntrySpec]:
    return {e.name: e for e in ENTRYPOINTS}


def claimed_launch_sites() -> set[str]:
    """Every ``path:function`` some family runs through."""
    return {site for e in ENTRYPOINTS for site in e.launch_sites}


def claimed_symbols() -> set[str]:
    """Every ``extern "C"`` symbol some family owns."""
    return {sym for e in ENTRYPOINTS for sym in e.symbols}


def port_family(jax_family: str) -> str:
    """The family of this package that stands for a JAX family."""
    for e in ENTRYPOINTS:
        if jax_family in e.jax_families:
            return e.name
    raise KeyError(jax_family)

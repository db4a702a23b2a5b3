"""Where the scan kernel's step time goes: ablations of ``csrc/scan.cu``.

Run on a card from the root of a checkout::

    python -m kubernetes_tpu_torch.perf.scan_ablation [--profile mixed|rich]

It compiles variants of ``csrc/scan.cu`` (all with one ``nvcc`` each,
started together, into ``build/kubernetes_tpu_torch/ablation/``), each
with one part of the step cut out, and times each on the same
north-star chunk (2,048 pods x 5,000 nodes of the ``mixed`` rig, or the
first chunk of the 30,000-pod ``rich`` queue; the state restored before
every launch), at the cluster size the plan's rule picks (``--cluster``
forces one), in turns, with CUDA events.  A cut variant is NOT
decision-identical (its ``exact`` column says whether it happened to
agree with the real kernel on this chunk); the cuts only tell what each
part costs.  The real kernel is ``base``; ``select and commit only``
cuts all the per-node work, so its time per step is the step's floor:
the barriers, the pick and the commit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

from kubernetes_tpu_torch.engine import kernels
from kubernetes_tpu_torch.engine import scan as scan_mod
from kubernetes_tpu_torch.perf import scan_check

_SCAN = kernels.SOURCES[1]
OUT_DIR = kernels.BUILD_DIR / "ablation"

# Per cut, its (text in csrc/scan.cu, replacement) pairs.
_CUTS = {
    "d_row": [("      if (d_row != nullptr) acc = __fadd_rn(acc, d_row[x]);",
               "")],
    "zone": [("            const int zj = P.zone[x];\n"
              "            if (g_zones && zj >= 0 && maxz > 0.0f) {",
              "            const int zj = P.zone[x];\n"
              "            if (false) {")],
    "spread": [("        if (kind == kSpread) {\n"
                "          const float cnt",
                "        if (kind == kSpread) { plane = 0.0f; } else\n"
                "        if (kind == kSpread) {\n"
                "          const float cnt")],
    "fits": [("      if (a.use_resources) {\n"
              "        const bool fits_pods",
              "      if (false) {\n"
              "        const bool fits_pods")],
    "d_commit": [("        if (a.use_templates) {\n"
                  "          const int cap_cpu",
                  "        if (false) {\n"
                  "          const int cap_cpu")],
    # The rich parts: the inter-pod counts with their CTA and cluster
    # barrier (the plane is then 0.0), the rich predicates, the service
    # anti-affinity term, and the rich commit (the owner's rows and the
    # every-CTA topology rows).
    "interpod": [("      if (ip_on) {\n"
                  "        interpod_counts(",
                  "      if (false) {\n"
                  "        interpod_counts(")],
    "rich_predicates": [
        ("    if constexpr (RICH) rich_bad = rich_mask(r, i, n, slot, sl);",
         "")],
    "saa": [("          plane = saa_score(r, a.term_aux[q], saa_g, saa_n, j, "
             "n);", "          plane = 0.0f;")],
    "rich_commit": [
        ("        rich_commit_owner(r, slot, j, n);\n", ""),
        ("      if (r.track_affinity &&\n"
         "          !(span(slot, kMatchSrc).empty()",
         "      if (false &&\n"
         "          !(span(slot, kMatchSrc).empty()")],
}

# Phase stamps: thread 0 of every CTA adds the clock64() cycles between
# consecutive points of the step to one of PHASES' counters; the totals
# land in kt_phase_cycles[rank][phase], read by kt_phase_read.
PHASES = ("step top", "slot and row pointers",
          "inter-pod counts and their barriers", "per-node scores",
          "warp records, slot store, copy wait", "CTA barrier",
          "CTA reduce", "pick cluster barrier, next copies issued",
          "cluster reduce (warp 0) and its CTA barrier",
          "owner commit", "commit signal wait", "topology rows")
_STAMP = "KT_STAMP({});\n"


def _before(anchor: str, k: int) -> tuple[str, str]:
    return anchor, _STAMP.format(k) + anchor


def _after(anchor: str, k: int) -> tuple[str, str]:
    return anchor, anchor + _STAMP.format(k)


_CUTS["phases"] = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long kt_phase_cycles[16][12];\n"
     "#define KT_STAMP(k) do { if (threadIdx.x == 0) { "
     "const long long kt_now = clock64(); kt_ph[k] += kt_now - kt_last; "
     "kt_last = kt_now; } } while (0)\n"),
    ("  uint32_t ctr = static_cast<uint32_t>(",
     "  long long kt_ph[12] = {};\n  long long kt_last = clock64();\n"
     "  uint32_t ctr = static_cast<uint32_t>("),
    _before("    const int* slot = slots + (i % (ns + 1)) * sw;\n", 0),
    _after("    const int* slot = slots + (i % (ns + 1)) * sw;\n", 1),
    _before("    // The rich predicates of this thread's nodes", 2),
    _before("    // 5. selectHost.  Each warp publishes", 3),
    _before("    cp_async_wait_ahead(ns);\n    __syncthreads();\n", 4),
    _before("    // ... every warp reduces the CTA's warps", 5),
    _before("    if (ncta > 1) cluster_arrive();\n"
            "    // In the barrier's shadow", 6),
    _before("    // ... and warp 0 reduces", 7),
    _before("    if (total == 0) {\n      if (rank == 0 && tid == 0)", 8),
    _before("    // Every CTA takes the owner's signal", 9),
    _after("    ++placed;\n", 10),
    _before("    // 7. The counter.\n", 11),
    ("  // No CTA leaves while another may still read its shared memory.\n",
     "  if (tid == 0) {\n    for (int k = 0; k < 12; ++k) "
     "kt_phase_cycles[rank][k] = kt_ph[k];\n  }\n"
     "  // No CTA leaves while another may still read its shared memory.\n"),
    ("extern \"C\" int kt_scan_fixed_smem() {",
     "extern \"C\" int kt_phase_read(unsigned long long* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      host, kt_phase_cycles, sizeof(kt_phase_cycles)));\n}\n\n"
     "extern \"C\" int kt_scan_fixed_smem() {"),
]

# Probes: additions and copy cuts that keep the kernel safe to run (the
# cut copies leave valid, stale values), to price the step's fixed costs.
_TOP = "    const int* slot = slots + (i % (ns + 1)) * sw;\n"
_CUTS["extra_cluster_barrier"] = [(_TOP, _TOP + "    cluster_sync();\n")]
_CUTS["extra_cluster_fence"] = [
    (_TOP, _TOP + "    asm volatile(\"fence.acq_rel.cluster;\\n\" ::: "
     "\"memory\");\n")]
_CUTS["no_slot_copies"] = [
    ("    if (q < sw) copy_slot_word(slot + q, row, p, q, w);",
     "    if (q < sw && row < ns) copy_slot_word(slot + q, row, p, q, w);")]
_CUTS["no_enc_copies"] = [
    ("      for (int w = tid; w < words; w += nt) {",
     "      for (int w = tid; w < (row < ns ? words : 0); w += nt) {")]

_MIXED_WORK = ("d_row", "spread", "fits", "d_commit")
_RICH_WORK = ("interpod", "rich_predicates", "saa", "rich_commit")

PROBES = {
    "base": (),
    "select and commit only": _MIXED_WORK,
    "an extra cluster barrier": ("extra_cluster_barrier",),
    "an extra cluster fence": ("extra_cluster_fence",),
    "no pod-slot copies": ("no_slot_copies",),
    "no enc row copies": ("no_enc_copies",),
    "phase stamps": ("phases",),
}

VARIANTS = {
    "mixed": {
        "base": (),
        "no D-column commit": ("d_commit",),
        "no D-row add": ("d_row",),
        "no zone blend": ("zone",),
        "no spread term": ("spread",),
        "no resource fit": ("fits",),
        "select and commit only": _MIXED_WORK,
        "phase stamps": ("phases",),
    },
    "rich": {
        "base": (),
        "no inter-pod counts": ("interpod",),
        "no rich predicates": ("rich_predicates",),
        "no service anti-affinity": ("saa",),
        "no rich commit": ("rich_commit",),
        "no rich per-node work": _RICH_WORK,
        "select and commit only": _MIXED_WORK + _RICH_WORK,
        "phase stamps": ("phases",),
    },
}


def variant_source(src: str, cuts: tuple = ()) -> str:
    """``src`` with ``cuts`` stubbed out."""
    for cut in cuts:
        for old, new in _CUTS[cut]:
            if src.count(old) != 1:
                raise ValueError(f"scan_ablation: {old!r} is not in "
                                 f"{_SCAN.name} exactly once")
            src = src.replace(old, new)
    return src


def build_all(variants: dict) -> dict[str, ctypes.CDLL]:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = _SCAN.read_text()
    procs = {}
    for i, (name, cuts) in enumerate(variants.items()):
        cu = OUT_DIR / f"scan_v{i}.cu"
        cu.write_text(variant_source(src, cuts))
        lib = OUT_DIR / f"libscan_v{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].kt_scan_chunk.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p]
        libs[name].kt_scan_chunk.restype = ctypes.c_int
        libs[name].kt_scan_fixed_smem.restype = ctypes.c_int
    return libs


def recorded_args(enc, kw: dict) -> tuple[bytes, torch.Tensor]:
    """The argument struct ``scan_chunk`` passes the kernel for these
    arguments, recorded without a launch, and the choices tensor it
    points at (keep it alive while the struct is used)."""
    seen = {}

    class _Record:
        def kt_scan_chunk(self, args, stream):
            seen["args"] = bytes(args._obj)
            return 0

        def kt_scan_args_size(self):
            return ctypes.sizeof(scan_mod._ScanArgs)

        def kt_scan_fixed_smem(self):
            return scan_mod.FIXED_SMEM

        def kt_scan_max_clusters(self, args, stream, clusters):
            clusters._obj.value = 1
            return 0

    library = scan_mod.library
    scan_mod.library = _Record
    try:
        choices = scan_mod.scan_chunk(enc, **kw)
    finally:
        scan_mod.library = library
    return seen["args"], choices


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", choices=("mixed", "rich"),
                    default="mixed")
    ap.add_argument("--probes", action="store_true",
                    help="time the fixed-cost probes instead of the cuts")
    ap.add_argument("--cluster", type=int, default=None,
                    help="force the cluster size (default: the plan's "
                         "rule)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    variants = PROBES if args.probes else VARIANTS[args.profile]
    libs = build_all(variants)
    ns = scan_check.north_star_chunk(
        args.nodes, args.pods, profile=args.profile,
        batch_pods=30000 if args.profile == "rich" else None)
    kw, init = ns["kw"], ns["init"]
    kw["cluster"] = args.cluster
    raw, choices = recorded_args(ns["enc"], kw)
    buf = ctypes.create_string_buffer(raw, len(raw))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(name: str) -> float:
        for k, v in init.items():
            kw[k].copy_(v)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = libs[name].kt_scan_chunk(ctypes.addressof(buf), stream)
        stop.record()
        stop.synchronize()
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return start.elapsed_time(stop)

    run("base")
    ref = (choices.clone(), {k: kw[k].clone() for k in init})
    times = {name: [] for name in variants}
    exact = {}
    for rep in range(args.reps):
        for name in variants:
            times[name].append(run(name))
            if rep == 0:
                exact[name] = torch.equal(choices, ref[0]) and all(
                    torch.equal(kw[k], v) for k, v in ref[1].items())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    pl = scan_mod._ScanArgs.from_buffer_copy(raw).plan
    print(f"scan_ablation: {card}; {args.profile} chunk {args.pods} pods x "
          f"{args.nodes} nodes; C={pl.cluster} x {pl.threads} threads, "
          f"K={pl.k}, {pl.bytes} B shared memory per CTA; median of "
          f"{args.reps} launches each, in turns")
    base = statistics.median(times["base"])
    if "phase stamps" in libs:
        run("phase stamps")
        cycles = (ctypes.c_ulonglong * (16 * len(PHASES)))()
        err = libs["phase stamps"].kt_phase_read(cycles)
        if err:
            raise RuntimeError(f"kt_phase_read: cudaError {err}")
        ms = statistics.median(times["phase stamps"])
        rows = [[cycles[r * len(PHASES) + k] for k in range(len(PHASES))]
                for r in range(pl.cluster)]
        total = sum(rows[0])
        print(f"phase stamps (thread 0 of each CTA; cycles per step, rank 0 "
              f"/ mean / max over the {pl.cluster} CTAs); rank 0 counted "
              f"{total / args.pods:.0f} cycles per step in "
              f"{ms / args.pods * 1e3:.6f} us: "
              f"{total / (ms * 1e3) / 1e3:.3f} GHz")
        for k, name in enumerate(PHASES):
            col = [row[k] / args.pods for row in rows]
            print(f"  {name:38s} {col[0]:9.1f} {statistics.mean(col):9.1f} "
                  f"{max(col):9.1f}")
    for name in variants:
        ms = statistics.median(times[name])
        print(f"{name:24s} {ms:10.6f} ms/chunk {ms / args.pods * 1e3:9.6f} "
              f"us/step  {ms - base:+10.6f} ms vs base  exact={exact[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

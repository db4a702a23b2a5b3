"""Where the scan kernel's step time goes: ablations of ``csrc/scan.cu``.

Run on a card from the root of a checkout::

    python -m kubernetes_tpu_torch.perf.scan_ablation

It compiles variants of ``csrc/scan.cu`` (all with one ``nvcc`` each,
started together, into ``build/kubernetes_tpu_torch/ablation/``), each
with one part of the step cut out or with a smaller thread count, and
times each on the same north-star chunk (2,048 ``mixed`` pods x 5,000
nodes, the state restored before every launch), in turns, with CUDA
events.  A cut variant is NOT decision-identical (its ``exact`` column
says whether it happened to agree with the real kernel on this chunk);
the cuts only tell what each part costs.  The real kernel is
``base``.
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

# (text in csrc/scan.cu, replacement) per cut.
_CUTS = {
    "d_row": ("      if (d_row != nullptr) acc = __fadd_rn(acc, d_row[j]);",
              ""),
    "zone": ("          if (a.track_zones) {\n"
             "            const int zj = __ldg(a.node_zone + j);",
             "          if (false) {\n"
             "            const int zj = __ldg(a.node_zone + j);"),
    "spread": ("        if (kind == kSpread) {\n"
               "          const float cnt",
               "        if (kind == kSpread) { plane = 0.0f; } else\n"
               "        if (kind == kSpread) {\n"
               "          const float cnt"),
    "fits": ("      if (a.use_resources) {\n"
             "        const bool fits_pods",
             "      if (false) {\n"
             "        const bool fits_pods"),
    "d_commit": ("    if (a.use_templates) {\n"
                 "      const int q0",
                 "    if (false) {\n"
                 "      const int q0"),
}
_THREADS = ("constexpr int kMaxThreads = 1024;",
            "constexpr int kMaxThreads = {};")
# Larger K for fewer threads (N up to 5,000 at 256 threads).
_KS = ("X(12) X(16)\n", "X(12) X(16) X(20) X(24) X(32)\n")
_LIMIT = ("a.n > 16 * kMaxThreads ||", "a.n > 32 * kMaxThreads ||")

VARIANTS = {
    "base": {},
    "512 threads": {"threads": 512},
    "256 threads": {"threads": 256},
    "no D-column commit": {"cuts": ("d_commit",)},
    "no D-row add": {"cuts": ("d_row",)},
    "no zone blend": {"cuts": ("zone",)},
    "no spread term": {"cuts": ("spread",)},
    "no resource fit": {"cuts": ("fits",)},
    "select and commit only": {"cuts": ("d_row", "spread", "fits",
                                        "d_commit")},
}


def variant_source(src: str, threads: int = 1024,
                   cuts: tuple = ()) -> str:
    """``src`` with ``cuts`` stubbed out and at most ``threads``."""
    edits = [_KS, _LIMIT] + [_CUTS[c] for c in cuts]
    if threads != 1024:
        edits.append((_THREADS[0], _THREADS[1].format(threads)))
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"scan_ablation: {old!r} is not in "
                             f"{_SCAN.name} exactly once")
        src = src.replace(old, new)
    return src


def build_all() -> dict[str, ctypes.CDLL]:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = _SCAN.read_text()
    procs = {}
    for i, (name, spec) in enumerate(VARIANTS.items()):
        cu = OUT_DIR / f"scan_v{i}.cu"
        cu.write_text(variant_source(src, **spec))
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    libs = build_all()
    ns = scan_check.north_star_chunk(args.nodes, args.pods)
    kw, init = ns["kw"], ns["init"]
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
    times = {name: [] for name in VARIANTS}
    exact = {}
    for rep in range(args.reps):
        for name in VARIANTS:
            times[name].append(run(name))
            if rep == 0:
                exact[name] = torch.equal(choices, ref[0]) and all(
                    torch.equal(kw[k], v) for k, v in ref[1].items())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"scan_ablation: {card}; chunk {args.pods} pods x {args.nodes} "
          f"nodes; median of {args.reps} launches each, in turns")
    base = statistics.median(times["base"])
    for name in VARIANTS:
        ms = statistics.median(times[name])
        print(f"{name:24s} {ms:10.6f} ms/chunk {ms / args.pods * 1e3:9.6f} "
              f"us/step  {ms - base:+10.6f} ms vs base  exact={exact[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

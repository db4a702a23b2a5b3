"""The port's CUDA kernel library: built from ``csrc/*.cu`` with one
``nvcc`` command at first use, loaded with ``ctypes``.

It holds three kernels, each with a plain C entry point:

* ``kt_select_rows`` (``csrc/select.cu``) — the fused selectHost, one
  CTA per row (wrapper: ``engine/fused.py:select_rows``);
* ``kt_select_hosts`` (``csrc/select.cu``) — the single-pod path's
  selectHost over a score and a feasible plane, one CTA per row
  (wrapper: ``ops/combine.py:select_hosts``);
* ``kt_scan_chunk`` (``csrc/scan.cu``) — the sequential scan of a whole
  chunk of pods in one launch of one thread-block cluster (wrapper:
  ``engine/scan.py:scan_chunk``).

The library is named by the hash of both sources and the flags, so an
edited source rebuilds.  ``--fmad=false`` keeps ``nvcc`` from contracting
``a * b + c`` into one FMA: the scan's f32 arithmetic must round as the
step loop's separate PyTorch ops do.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (_CSRC / "select.cu", _CSRC / "scan.cu")
# build/kubernetes_tpu_torch/ at the root of the checkout (git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "kubernetes_tpu_torch"
# --split-compile=0: the optimizer and ptxas work on the scan kernel's
# instantiations in parallel, one thread per core.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "--split-compile=0", "-shared",
              "-Xcompiler", "-fPIC")

_lib_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkt_kernels_{digest.hexdigest()[:16]}.so"


def nvcc_command(out: Path, verbose: bool = False) -> list[str]:
    """The one ``nvcc`` command that builds every source into ``out``;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel)."""
    return [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
            "-o", str(out), *map(str, SOURCES)]


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the library unless it exists.  Returns (library path,
    compiler output); ``verbose`` always rebuilds, to show ptxas's
    report."""
    lib = library_path()
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = nvcc_command(tmp, verbose)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    # Every build is visible to the post-prewarm watchdog (the guard
    # classifies the failure below as a ``compile`` fault).
    from kubernetes_tpu_torch.engine import devicestats
    devicestats.record_build(time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded library (built first if needed), with its entry
    points' argument types declared."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path, _ = build()
                lib = ctypes.CDLL(str(path))
                lib.kt_select_rows.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                lib.kt_select_rows.restype = ctypes.c_int
                lib.kt_select_hosts.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
                lib.kt_select_hosts.restype = ctypes.c_int
                lib.kt_scan_chunk.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p]
                lib.kt_scan_chunk.restype = ctypes.c_int
                lib.kt_scan_max_clusters.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                lib.kt_scan_max_clusters.restype = ctypes.c_int
                lib.kt_scan_args_size.argtypes = []
                lib.kt_scan_args_size.restype = ctypes.c_int
                lib.kt_scan_fixed_smem.argtypes = []
                lib.kt_scan_fixed_smem.restype = ctypes.c_int
                _lib = lib
    return _lib

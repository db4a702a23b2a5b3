"""Build and locate the native apiserver (``native/apiserver.cpp``).

The C++ core implements the same storage/watch/bind contract as the
Python apiserver (see the header comment in ``native/apiserver.cpp``);
the wire rigs prefer it because the Python server's measured wire
ceiling is its interpreter lock.

Counterpart of ``kubernetes_tpu/apiserver/native.py``, rebuilt so that
it writes nothing beside the source: ``native/`` holds a tracked binary
and the JAX package's own build outputs.  Here

* the kind table ``kinds.inc`` is generated from this package's
  ``api/types.py:NAMESPACED_KINDS``;
* ``apiserver.cpp`` is copied next to it in
  ``build/kubernetes_tpu_torch/native/`` (git-ignored) and compiled
  there with ``g++ -O2 -std=c++17``: a quoted ``#include "kinds.inc"``
  searches the source file's own directory first, so compiling the
  file in place would pick up whatever ``native/kinds.inc`` holds;
* the binary is named by the hash of the source, the table and the
  flags, and a probe marker beside it records that it ran on this
  machine's C library (a build directory copied from another machine
  is probed again and rebuilt if its binary does not start).

A failed build raises ``NativeBuildError`` with the compiler's message;
nothing falls back to the Python server behind the caller's back.
Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS

SOURCE = Path(__file__).resolve().parents[2] / "native" / "apiserver.cpp"
# build/kubernetes_tpu_torch/native/ at the root of the checkout.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "kubernetes_tpu_torch" / "native"
CXX_FLAGS = ("-O2", "-std=c++17")
BINARY_STEM = "kube-apiserver-native"


class NativeBuildError(RuntimeError):
    """The native apiserver could not be built or does not start."""


def kinds_inc() -> str:
    """The C++ kind table, one line per namespaced kind in sorted order
    (the layout of ``native/gen_kinds.py``'s output)."""
    lines = ["// GENERATED by kubernetes_tpu_torch/apiserver/native.py "
             "from kubernetes_tpu_torch/api/types.py — do not edit.",
             "static const std::set<std::string> kNamespaced = {"]
    lines += [f'    "{kind}",' for kind in sorted(NAMESPACED_KINDS)]
    lines.append("};")
    return "\n".join(lines) + "\n"


def _machine_tag() -> str:
    """The axis a binary's exec-compatibility varies on: the libc."""
    try:
        return os.confstr("CS_GNU_LIBC_VERSION") or "unknown"
    except (OSError, ValueError):
        return "unknown"


def _cxx() -> str:
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def binary_path(build_dir: Optional[Path] = None) -> Path:
    """Where the binary for the current source, table and flags lives."""
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    digest.update(kinds_inc().encode())
    digest.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / \
        f"{BINARY_STEM}-{digest.hexdigest()[:16]}"


def compile_command(build_dir: Path, out: Path) -> list[str]:
    """The one compiler command, run with ``build_dir`` as its working
    directory, where the copied source and the table sit together."""
    return [_cxx(), *CXX_FLAGS, "-o", str(out),
            str(Path(build_dir) / SOURCE.name)]


def _probe(path: Path) -> bool:
    """True when the binary serves: a healthy server keeps running on an
    ephemeral port, a broken one (loader or libc mismatch) exits at
    once.  A positive result is kept in ``<binary>.probe_ok``."""
    marker = path.with_name(path.name + ".probe_ok")
    stamp = f"{path.stat().st_mtime} {_machine_tag()}"
    try:
        if marker.read_text().strip() == stamp:
            return True
    except OSError:
        pass
    try:
        proc = subprocess.Popen([str(path), "--port", "0"],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    except OSError:
        return False
    try:
        proc.wait(timeout=0.3)
        return False  # exited at once: it cannot start here
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    marker.write_text(stamp)
    return True


def build(build_dir: Optional[Path] = None) -> Path:
    """Build the binary into ``build_dir`` (default
    ``build/kubernetes_tpu_torch/native/``) unless a binary for the
    current inputs is there and starts.  Returns its path; raises
    ``NativeBuildError`` with the compiler's output on failure."""
    build_dir = Path(build_dir or BUILD_DIR)
    out = binary_path(build_dir)
    if out.exists() and _probe(out):
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    (build_dir / "kinds.inc").write_text(kinds_inc())
    shutil.copyfile(SOURCE, build_dir / SOURCE.name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = compile_command(build_dir, tmp)
    try:
        proc = subprocess.run(cmd, cwd=build_dir, capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as err:
        raise NativeBuildError(f"{' '.join(cmd)}: {err}") from None
    if proc.returncode != 0:
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    if not _probe(out):
        raise NativeBuildError(f"{out} was built but does not start")
    return out


def server_command(port: int) -> list[str]:
    """The command line of a wire rig's apiserver on ``port``: the native
    binary (built first if needed) unless ``KT_NATIVE_APISERVER=0``, then
    ``python -m kubernetes_tpu_torch.apiserver``."""
    from kubernetes_tpu_torch.utils import knobs
    if knobs.get_bool("KT_NATIVE_APISERVER"):
        return [str(build()), "--port", str(port)]
    return [sys.executable, "-m", "kubernetes_tpu_torch.apiserver",
            "--port", str(port)]

"""The port's native apiserver build (``kubernetes_tpu_torch/apiserver/
native.py``) and the binary it builds.

* The build goes into a temporary directory (or the default
  ``build/kubernetes_tpu_torch/native/``) and nowhere else: ``kinds.inc``
  is generated from the port's ``NAMESPACED_KINDS`` next to a copy of
  ``native/apiserver.cpp``, so a ``native/kinds.inc`` left by the JAX
  package's build cannot shadow it.
* Nothing under ``native/`` changes: every file's hash and mtime are
  the same after the build, and an audit hook in the building process
  sees no write, rename, removal or directory creation under
  ``native/``, and a compiler run whose output and working directory
  are the build directory.  The comparison leaves out only the JAX
  package's own build outputs there (``native/kinds.inc``,
  ``native/*.probe_ok``, both git-ignored): its tests, which may run in
  parallel with these, write them.
* The binary's kind table equals the port's ``NAMESPACED_KINDS`` (the
  generated table, and every namespaced kind defaults its namespace).
* The apiserver parity script gets the same statuses from the binary as
  from the port's Python server, and the port's daemon binds through it.

Each test skips, with the reason, where ``g++`` is missing.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS
from kubernetes_tpu_torch.apiserver import memstore as t_memstore
from kubernetes_tpu_torch.apiserver import native
from kubernetes_tpu_torch.apiserver import server as t_server
from torch_wire import (REPO, create_lists, crud_script, env, pod_nodes,
                        request, start_native, stop, wait_bound)

NATIVE = REPO / "native"
# The JAX package's own build outputs under native/ (.gitignore).
JAX_BUILD_OUTPUTS = ("kinds.inc",)
JAX_BUILD_SUFFIXES = (".probe_ok",)


def _snapshot() -> dict:
    out = {}
    for f in sorted(NATIVE.rglob("*")):
        if not f.is_file() or f.name in JAX_BUILD_OUTPUTS or \
                f.name.endswith(JAX_BUILD_SUFFIXES):
            continue
        out[f.relative_to(NATIVE).as_posix()] = (
            hashlib.sha256(f.read_bytes()).hexdigest(), f.stat().st_mtime_ns)
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Build once into a temporary directory, in a subprocess that
    records every write and every command through an audit hook."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native apiserver cannot be "
                    "built here")
    out_dir = tmp_path_factory.mktemp("native-build")
    before = _snapshot()
    proc = subprocess.run([sys.executable, "-c", _AUDITED_BUILD,
                           str(out_dir)], cwd=REPO, env=env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"dir": out_dir, "before": before, "after": _snapshot(),
            **report}


_AUDITED_BUILD = r"""
import json, os, sys
writes, commands = [], []
def hook(event, args):
    if event == "open" and args[0] is not None and not isinstance(
            args[0], int):
        mode, flags = args[1] or "", args[2] or 0
        if any(c in mode for c in "wax+") or flags & (
                os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_TRUNC):
            writes.append(os.fspath(args[0]))
    elif event in ("os.rename", "shutil.copyfile", "shutil.copymode"):
        writes.append(os.fspath(args[1]))
    elif event in ("os.remove", "os.mkdir", "os.rmdir", "os.truncate",
                   "os.chmod", "os.utime"):
        writes.append(os.fspath(args[0]))
    elif event == "subprocess.Popen":
        commands.append([os.fspath(a) for a in args[1]] + [
            os.fspath(args[2]) if args[2] else os.getcwd()])
sys.addaudithook(hook)
from pathlib import Path
from kubernetes_tpu_torch.apiserver import native
out = native.build(Path(sys.argv[1]))
print(json.dumps({"binary": str(out), "writes": writes,
                  "commands": commands}))
"""


def _under(path: str, root: Path) -> bool:
    try:
        Path(path).resolve().relative_to(root.resolve())
        return True
    except ValueError:
        return False


def test_the_build_writes_only_its_build_directory(built):
    assert built["after"] == built["before"]
    assert built["writes"], "the audit hook saw no write at all"
    assert not [w for w in built["writes"] if _under(w, NATIVE)]
    # The probe's stdout and stderr go to os.devnull.
    assert all(_under(w, built["dir"]) for w in built["writes"]
               if w != "/dev/null")
    compiles = [c for c in built["commands"] if "-std=c++17" in c]
    assert len(compiles) == 1
    cmd = compiles[0]
    out = cmd[cmd.index("-o") + 1]
    assert _under(out, built["dir"]) and _under(cmd[-1], built["dir"])
    assert not [a for a in cmd if _under(a, NATIVE)]
    assert (built["dir"] / "apiserver.cpp").read_bytes() == \
        (NATIVE / "apiserver.cpp").read_bytes()
    assert _under(built["binary"], built["dir"])
    # Built once, found again without a compile.
    assert native.build(built["dir"]) == native.binary_path(built["dir"])


def test_the_kind_table_is_the_ports(built):
    table = (built["dir"] / "kinds.inc").read_text()
    assert table == native.kinds_inc()
    assert {line.strip().rstrip(",").strip('"')
            for line in table.splitlines()
            if line.strip().startswith('"')} == NAMESPACED_KINDS
    proc, base = start_native(built["binary"])
    try:
        for kind in sorted(NAMESPACED_KINDS):
            status, _, body = request(base, "POST", f"/api/v1/{kind}", {
                "metadata": {"name": f"k-{kind}"},
                "spec": {"containers": [{"name": "c"}]}})
            assert status == 201, (kind, body)
            assert json.loads(body)["metadata"]["namespace"] == "default"
            assert request(base, "GET", f"/api/v1/namespaces/default/"
                           f"{kind}/k-{kind}")[0] == 200, kind
        status, _, body = request(base, "POST", "/api/v1/nodes",
                                  {"metadata": {"name": "n0"}})
        assert status == 201 and "namespace" not in \
            json.loads(body)["metadata"]
    finally:
        stop(proc)


def test_the_parity_script_gets_the_python_servers_statuses(built,
                                                            monkeypatch):
    monkeypatch.setenv("KT_BIND_CAPACITY", "1")
    store = t_memstore.MemStore()
    srv = t_server.serve(store, port=0)
    try:
        python = crud_script(f"http://127.0.0.1:{srv.server_address[1]}")
    finally:
        srv.shutdown()
        srv.server_close()
    proc, base = start_native(built["binary"])
    try:
        got = crud_script(base)
    finally:
        stop(proc)
    assert [s[0] for s in got] == [s[0] for s in python]
    for a, b in zip(python, got):
        if a[1] == "watch":
            assert [e.get("type") for e in b[2]] == \
                [e.get("type") for e in a[2]], a[0]
        else:
            assert b[1] == a[1], f"step {a[0]!r}: native {b[1]} != {a[1]}"


def test_the_ports_daemon_binds_through_the_binary(built):
    from kubernetes_tpu_torch.api.types import node_to_json, pod_to_json
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    proc, base = start_native(built["binary"])
    try:
        create_lists(base, "nodes", [node_to_json(n) for n in
                                     synth.make_nodes(16, profile="mixed")])
        pods = synth.make_pods(64, profile="mixed", n_services=4)
        create_lists(base, "pods", [pod_to_json(p) for p in pods])
        f = ConfigFactory(base, device="cpu", qps=5000, burst=5000).run()
        try:
            placed = wait_bound(base, len(pods), 60)
        finally:
            f.stop()
        assert set(placed) == {p.key for p in pods}
        assert pod_nodes(base) == placed
    finally:
        stop(proc)


def test_server_command_follows_the_knob(built, monkeypatch):
    monkeypatch.setenv("KT_NATIVE_APISERVER", "0")
    cmd = native.server_command(8080)
    assert cmd[1:] == ["-m", "kubernetes_tpu_torch.apiserver", "--port",
                       "8080"]
    monkeypatch.setattr(native, "BUILD_DIR", built["dir"])
    monkeypatch.setenv("KT_NATIVE_APISERVER", "1")
    assert native.server_command(8080) == [built["binary"], "--port",
                                           "8080"]

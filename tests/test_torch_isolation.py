"""The PyTorch port imports neither ``jax`` nor the JAX package.

``kubernetes_tpu_torch`` starts with ``kubernetes_tpu``, so every check
matches the name ``kubernetes_tpu`` exactly or names starting with
``kubernetes_tpu.``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "kubernetes_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            out.append(node.module)
    return out


def test_forbidden_name_match_is_exact():
    assert _forbidden("kubernetes_tpu") and _forbidden("kubernetes_tpu.api")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_x")
    assert not _forbidden("kubernetes_tpu_torch.engine.solver")


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"ops/combine.py", "server/extender.py", "utils/debugmux.py",
            "utils/metrics.py", "engine/extender_client.py",
            "api/validation.py"} <= names
    # The daemon slice.
    assert {"utils/featuregate.py", "utils/threadreg.py", "utils/events.py",
            "chaos/device.py", "engine/devicestats.py", "engine/guard.py",
            "engine/workloads/gang.py", "engine/workloads/preemption.py",
            "apiserver/memstore.py", "api/fieldsel.py", "client/__init__.py",
            "client/reflector.py", "scheduler/backoff.py",
            "scheduler/queue.py", "scheduler/batchformer.py",
            "scheduler/flightrecorder.py", "scheduler/binder.py",
            "scheduler/pipeline.py", "scheduler/scheduler.py",
            "scheduler/slo.py", "scheduler/recovery.py",
            "scheduler/factory.py", "scheduler/__main__.py",
            "api/componentconfig.py"} <= names
    # The wire slice.
    assert {"utils/flowcontrol.py", "utils/cron.py", "client/http.py",
            "utils/leaderelection.py", "apiserver/validation.py",
            "apiserver/auth.py", "apiserver/flowcontrol.py",
            "apiserver/server.py", "apiserver/__main__.py",
            "apiserver/native.py", "controller/replication.py"} <= names
    # The bench and observability slice.
    assert {"perf/bench.py", "perf/harness.py", "perf/serving.py",
            "perf/profiler_cost.py", "utils/profiler.py",
            "utils/telemetry.py",
            "utils/profiling.py", "utils/debugmux.py",
            "utils/knobs.py"} <= names
    # The HA, tenancy, defrag and verifier slice.
    assert {"scheduler/shards.py", "tenancy/__init__.py",
            "tenancy/packer.py", "tenancy/service.py",
            "scheduler/defrag.py", "cache/verifier.py",
            "perf/tenancy.py"} <= names
    # The kubemark control plane.
    assert {"controller/node.py", "controller/endpoints.py",
            "kubelet/kubelet.py", "kubelet/__main__.py", "proxy/proxy.py",
            "proxy/__main__.py"} <= names
    # The controller-manager and kubectl.
    assert {"utils/timeutil.py", "controller/disruption.py",
            "controller/deployment.py", "controller/daemonset.py",
            "controller/job.py", "controller/podgc.py",
            "controller/garbagecollector.py", "controller/namespace.py",
            "controller/serviceaccounts.py", "controller/resourcequota.py",
            "controller/podautoscaler.py", "controller/scheduledjob.py",
            "controller/petset.py", "controller/__main__.py",
            "kubectl/__init__.py", "kubectl/__main__.py"} <= names
    bad = {str(f.relative_to(REPO)): [m for m in _imports(f)
                                      if _forbidden(m)]
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


_DRAIN = r"""
import json, sys
from kubernetes_tpu_torch.perf import synth
eng, pods = synth.make_rig(24, 40, profile="rich", device="cpu")
placed = [n for _, pl in eng.schedule_batch_stream(pods, chunk_size=16)
          for n in pl]
placed += eng.schedule_batch(pods[:8])
placed.append(eng.schedule(pods[8]))
eng.explain_failures(pods[:2])
from kubernetes_tpu_torch.perf.synth import make_nodes
from kubernetes_tpu_torch.api.types import node_to_json
from kubernetes_tpu_torch.server.extender import ExtenderCore
body = json.dumps({"Pod": {"metadata": {"name": "p"}}, "Nodes": {"Items": [
    node_to_json(n) for n in make_nodes(8)]}}).encode()
verdict = json.loads(ExtenderCore(device="cpu").handle("filter", body))
placed += [n["metadata"]["name"] for n in verdict["nodes"]["items"]]
mods = sorted(m for m in sys.modules
              if m in ("jax", "jaxlib", "kubernetes_tpu")
              or m.startswith(("jax.", "jaxlib.", "kubernetes_tpu.")))
print(json.dumps({"placed": sum(p is not None for p in placed),
                  "forbidden": mods}))
"""


def test_a_port_drain_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRAIN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["placed"] > 0
    assert out["forbidden"] == []


_DAEMON = r"""
import json, sys, time
import kubernetes_tpu_torch.scheduler.__main__ as entry
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.api.types import node_to_json, pod_to_json
from kubernetes_tpu_torch.perf.synth import make_nodes, make_pods
from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
store = MemStore()
for nd in make_nodes(8):
    store.create("nodes", node_to_json(nd))
for pod in make_pods(12):
    store.create("pods", pod_to_json(pod))
factory = ConfigFactory(store, device="cpu").run()
try:
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        bound = sum(bool((o.get("spec") or {}).get("nodeName"))
                    for o in store.list("pods")[0])
        if bound == 12:
            break
        time.sleep(0.05)
    from kubernetes_tpu_torch.chaos import device
    from kubernetes_tpu_torch.engine import guard
    from kubernetes_tpu_torch.engine.workloads import preemption
finally:
    factory.stop()
mods = sorted(m for m in sys.modules
              if m in ("jax", "jaxlib", "kubernetes_tpu")
              or m.startswith(("jax.", "jaxlib.", "kubernetes_tpu.")))
print(json.dumps({"bound": bound, "entry": entry.DEFAULT_PORT,
                  "forbidden": mods}))
"""


def test_the_daemon_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DAEMON], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bound"] == 12
    assert out["forbidden"] == []


def test_the_daemon_binary_on_the_cpu_and_without_a_card(tmp_path):
    """``--device cpu`` serves /healthz and exits 0 on SIGTERM; the
    default ``--device cuda`` exits with an error where there is no
    card; ``--api-server`` against the port's apiserver in a subprocess
    binds a pod on ``--device cpu`` with ``--profile-dir`` set, which
    writes a ``torch.profiler`` trace of the solve that placed it and
    serves the telemetry and profiler routes."""
    import signal
    import urllib.request
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "kubernetes_tpu_torch.scheduler"]
    proc = subprocess.Popen(cmd + ["--device", "cpu", "--port", "0"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = json.loads(proc.stdout.readline())["port"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            assert resp.read() == b"ok"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/configz",
                                    timeout=30) as resp:
            assert json.loads(resp.read())["device"] == "cpu"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    from torch_wire import request, start_python_apiserver, stop, wait_until
    traces = tmp_path / "traces"
    api, base = start_python_apiserver()
    try:
        proc = subprocess.Popen(cmd + ["--device", "cpu", "--port", "0",
                                       "--api-server", base,
                                       "--profile-dir", str(traces)],
                                cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            port = json.loads(proc.stdout.readline())["port"]
            for kind, obj in (
                    ("nodes", {"metadata": {"name": "n0"}, "status": {
                        "allocatable": {"cpu": "4", "memory": "8Gi",
                                        "pods": "110"},
                        "conditions": [{"type": "Ready",
                                        "status": "True"}]}}),
                    ("pods", {"metadata": {"name": "p0"}, "spec": {
                        "containers": [{"name": "c"}]}})):
                assert request(base, "POST", f"/api/v1/{kind}", obj)[0] == 201

            def bound():
                body = request(base, "GET",
                               "/api/v1/namespaces/default/pods/p0")[2]
                return json.loads(body)["spec"].get("nodeName") == "n0"
            wait_until(bound, 60, "the daemon to bind p0 over HTTP")
            written = sorted(traces.glob("solve_*.pt.trace.json"))
            assert written
            events = json.loads(written[0].read_text())["traceEvents"]
            assert any(e.get("name", "").startswith("solve_")
                       for e in events)
            mux = f"http://127.0.0.1:{port}"
            for route, ctype in (("/debug/timeseries", "application/json"),
                                 ("/debug/dashboard", "text/html"),
                                 ("/debug/pprof/goroutine", "text/plain"),
                                 ("/debug/profile", "application/json")):
                status, headers, body = request(mux, "GET", route)
                assert status == 200 and body, route
                assert headers["content-type"].startswith(ctype), route
        finally:
            assert stop(proc) == 0
    finally:
        stop(api)
    if not torch.cuda.is_available():
        bad = subprocess.run(cmd + ["--port", "0"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert bad.returncode != 0 and "no CUDA device" in bad.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    from kubernetes_tpu_torch.engine.solver import ResidentCluster
    from kubernetes_tpu_torch.perf import synth
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.make_rig(4, 4)


def test_the_apiserver_binary_loads_no_jax_module():
    """``python -m kubernetes_tpu_torch.apiserver`` serves, exits 0 on
    SIGTERM, and loads no ``jax`` and no ``kubernetes_tpu`` module (the
    interpreter's ``-X importtime`` report lists every import).  It does
    not import ``torch`` either, so it cannot initialise CUDA."""
    import signal
    import urllib.request
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "kubernetes_tpu_torch.apiserver", "--port", "0"], cwd=REPO,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        lines = []
        while True:
            line = proc.stderr.readline()
            assert line, "".join(lines[-20:])
            lines.append(line)
            if "listening on" in line:
                break
        addr = line.rsplit(" ", 1)[1].strip()
        with urllib.request.urlopen(f"http://{addr}/healthz",
                                    timeout=30) as resp:
            assert resp.read() == b"ok"
        proc.send_signal(signal.SIGTERM)
        lines += proc.stderr.read().splitlines(keepends=True)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    mods = [ln.rsplit("|", 1)[1].strip() for ln in lines
            if ln.startswith("import time:") and "|" in ln]
    assert "kubernetes_tpu_torch.apiserver.server" in mods
    assert [m for m in mods if _forbidden(m)] == []
    assert [m for m in mods if m == "torch" or m.startswith("torch.")] == []


# Each binary's line on standard error once it runs, and a module it
# must have loaded by then.
_BINARIES = {
    "kubelet": ("running", "kubernetes_tpu_torch.kubelet.kubelet"),
    "proxy": ("running", "kubernetes_tpu_torch.proxy.proxy"),
    "controller": ("controller-manager running (",
                   "kubernetes_tpu_torch.controller.scheduledjob"),
}


@pytest.mark.parametrize("binary", ["kubelet", "proxy", "controller",
                                    "kubectl"])
def test_the_hollow_binaries_load_no_jax_module(binary):
    """``python -m kubernetes_tpu_torch.kubelet`` (registering its Node),
    ``python -m kubernetes_tpu_torch.proxy``, ``python -m
    kubernetes_tpu_torch.controller --api-server URL`` (its loops
    running) and ``python -m kubernetes_tpu_torch.kubectl --server URL
    get nodes`` run against the port's apiserver, exit 0 (on SIGTERM for
    the daemons), and load no ``jax``, no ``kubernetes_tpu`` and no
    ``torch`` module (``-X importtime``)."""
    from torch_wire import start_python_apiserver, stop
    env = dict(os.environ, PYTHONPATH=str(REPO))
    api, base = start_python_apiserver()
    try:
        if binary == "kubectl":
            proc = subprocess.run(
                [sys.executable, "-X", "importtime", "-m",
                 "kubernetes_tpu_torch.kubectl", "--server", base, "get",
                 "nodes"], cwd=REPO, env=env, capture_output=True,
                text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr[-2000:]
            assert proc.stdout.split()[:2] == ["NAME", "STATUS"]
            lines = proc.stderr.splitlines()
            loaded = "kubernetes_tpu_torch.client.http"
        else:
            ready, loaded = _BINARIES[binary]
            extra = {"kubelet": ["--node-name", "iso-0"],
                     "controller": ["--port", "-1"]}.get(binary, [])
            lines = _run_daemon(binary, base, extra, ready, env)
    finally:
        stop(api)
    mods = [ln.rsplit("|", 1)[1].strip() for ln in lines
            if ln.startswith("import time:") and "|" in ln]
    assert loaded in mods
    assert [m for m in mods if _forbidden(m)] == []
    assert [m for m in mods if m == "torch" or m.startswith("torch.")] == []


def _run_daemon(binary: str, base: str, extra: list, ready: str,
                env: dict) -> list:
    """Run ``python -m kubernetes_tpu_torch.<binary>`` until it logs
    ``ready`` (and, for the kubelet and the controller-manager, what it
    writes exists), then SIGTERM it: it must exit 0.  Returns its
    standard error's lines."""
    import signal
    import time
    import urllib.request
    from torch_wire import wait_until
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         f"kubernetes_tpu_torch.{binary}", "--api-server", base, *extra],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        while True:
            line = proc.stderr.readline()
            assert line, "".join(lines[-20:])
            lines.append(line)
            if line.rstrip().endswith("running") if ready == "running" \
                    else ready in line:
                break
        # What the running binary writes: the kubelet its Node, the
        # controller-manager (its SIGTERM handler installed just after
        # its "running" line) the default ServiceAccount, a sync later.
        written = {"kubelet": "/api/v1/nodes/iso-0",
                   "controller": "/api/v1/namespaces/default/"
                                 "serviceaccounts/default"}.get(binary)
        if written:
            def registered():
                try:
                    with urllib.request.urlopen(f"{base}{written}",
                                                timeout=30) as resp:
                        return resp.status == 200
                except OSError:
                    return False
            wait_until(registered, 60, f"{written} written by the "
                                       f"{binary}")
        # Each binary logs its running line, then installs its SIGTERM
        # handler and parks its main thread in Event.wait() (both
        # packages).  A SIGTERM in between kills it (-15), or lands while
        # the main thread holds the Event's lock, where the handler's
        # Event.set() blocks for good: let the main thread park first.
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        lines += proc.communicate(timeout=60)[1].splitlines(keepends=True)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    return lines

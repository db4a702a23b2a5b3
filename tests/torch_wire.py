"""Shared rigs for the wire tests of the PyTorch port
(tests/test_torch_wire_*.py, tests/test_torch_native_apiserver.py and the
card test in tests/test_torch_cuda.py).

Imports nothing of JAX: the card machine runs the card tests without it.
Every request has a timeout, every server binds port 0 (the native
binary, which cannot report an ephemeral port, gets one that a socket
bound to port 0 was handed), and every subprocess is stopped by PID."""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional
from urllib.parse import quote

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 30.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(base: str, method: str, path: str, body=None,
            headers: Optional[dict] = None, raw: Optional[bytes] = None
            ) -> tuple[int, dict, bytes]:
    """One exchange on a fresh connection: (status, headers, body)."""
    host, _, port = base.rpartition("/")[2].partition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        data = raw if raw is not None else \
            (json.dumps(body).encode() if body is not None else None)
        hdrs = {"Content-Type": "application/json"} if data else {}
        hdrs.update(headers or {})
        c.request(method, path, data, hdrs)
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def read_watch(base: str, path: str, n: int, seconds: float = TIMEOUT,
               headers: Optional[dict] = None) -> list[dict]:
    """Open a watch (NDJSON lines or ``=<len>`` frames) and return its
    first ``n`` events as {type, object} dicts."""
    host, _, port = base.rpartition("/")[2].partition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=seconds)
    try:
        c.request("GET", path, headers=headers or {})
        r = c.getresponse()
        if r.status != 200:
            return [{"status": r.status, "body": json.loads(r.read())}]
        out: list[dict] = []
        buf = b""
        deadline = time.monotonic() + seconds
        while len(out) < n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(out)} of {n} watch events")
            chunk = r.read1(65536)
            if not chunk:
                break
            buf += chunk
            while True:
                if buf.startswith(b"="):
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    size = int(buf[1:nl])
                    if len(buf) < nl + 1 + size + 1:
                        break
                    doc = json.loads(buf[nl + 1:nl + 1 + size])
                    out.extend(doc.get("items") or [])
                    buf = buf[nl + 1 + size + 1:]
                    continue
                nl = buf.find(b"\n")
                if nl < 0:
                    break
                line, buf = buf[:nl].strip(), buf[nl + 1:]
                if line:
                    out.append(json.loads(line))
        return out[:n]
    finally:
        c.close()


def wait_until(cond: Callable[[], bool], seconds: float, what: str) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {seconds} s waiting for "
                                 f"{what}")
        time.sleep(0.05)


def wait_healthy(base: str, seconds: float = TIMEOUT,
                 proc: Optional[subprocess.Popen] = None) -> None:
    deadline = time.monotonic() + seconds
    while True:
        try:
            if request(base, "GET", "/healthz")[0] == 200:
                return
        except OSError:
            pass
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{base} never answered /healthz")
        time.sleep(0.05)


def env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO))


def start_python_apiserver(module: str = "kubernetes_tpu_torch.apiserver",
                           extra: tuple = ()) -> tuple[subprocess.Popen,
                                                       str]:
    """``python -m <module> --port 0`` as a subprocess; returns (process,
    base URL) once it answers /healthz."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0", *extra], cwd=REPO,
        env=env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stderr.readline()
        if "listening on" not in line:
            raise AssertionError(f"apiserver did not start: {line!r} "
                                 f"{proc.stderr.read()[-2000:]}")
        base = "http://" + line.rsplit(" ", 1)[1].strip()
        wait_healthy(base, proc=proc)
    except BaseException:
        stop(proc)
        raise
    return proc, base


def start_native(binary: str) -> tuple[subprocess.Popen, str]:
    port = free_port()
    proc = subprocess.Popen([binary, "--port", str(port)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        wait_healthy(base, proc=proc)
    except BaseException:
        stop(proc)
        raise
    return proc, base


def stop(proc: subprocess.Popen, seconds: float = 30.0) -> int:
    """SIGTERM by PID, then SIGKILL past ``seconds``; the exit code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=seconds)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    for f in (proc.stdout, proc.stderr):
        if f is not None:
            f.close()
    return proc.returncode


def create_lists(base: str, kind: str, objs: list[dict],
                 size: int = 1000) -> None:
    """POST ``objs`` as v1 List bodies of ``size`` items; every item must
    be created."""
    for i in range(0, len(objs), size):
        part = objs[i:i + size]
        status, _, body = request(base, "POST", f"/api/v1/{kind}",
                                  {"kind": "List", "items": part})
        got = json.loads(body)
        assert status == 200 and got.get("created") == len(part), \
            (status, body[:500])


def pod_nodes(base: str) -> dict[str, str]:
    """Every pod's ``ns/name`` -> ``spec.nodeName`` ("" when unbound)."""
    status, _, body = request(base, "GET", "/api/v1/pods")
    assert status == 200
    return {f"{o['metadata'].get('namespace', 'default')}/"
            f"{o['metadata']['name']}":
            (o.get("spec") or {}).get("nodeName") or ""
            for o in json.loads(body)["items"]}


def wait_bound(base: str, n: int, seconds: float) -> dict[str, str]:
    """Poll until ``n`` pods are bound; the pod -> node map."""
    got: dict[str, str] = {}

    def bound() -> bool:
        got.clear()
        got.update(pod_nodes(base))
        return sum(bool(v) for v in got.values()) >= n
    wait_until(bound, seconds, f"{n} pods bound at {base}")
    return dict(got)


def wait_settled(read_map: Callable[[], dict], seconds: float,
                 quiet: float = 1.0) -> dict[str, str]:
    """Poll a pod -> node map until its bound count is nonzero and has
    not moved for ``quiet`` seconds; the map."""
    last, since = -1, time.monotonic()
    deadline = since + seconds
    while True:
        got = read_map()
        n = sum(bool(v) for v in got.values())
        now = time.monotonic()
        if n != last:
            last, since = n, now
        elif n and now - since >= quiet:
            return got
        if now > deadline:
            raise AssertionError(f"{n} pods bound, still moving after "
                                 f"{seconds} s")
        time.sleep(0.05)


def store_nodes(store) -> dict[str, str]:
    """A ``MemStore``'s pod -> node map, as ``pod_nodes`` reads it."""
    return {f"{o['metadata'].get('namespace', 'default')}/"
            f"{o['metadata']['name']}":
            (o.get("spec") or {}).get("nodeName") or ""
            for o in store.list("pods")[0]}


# -- the scripted request sequence of the apiserver parity tests ----------

# The only wall-clock field in any body (memstore.py:_now_rfc3339).
WALL_CLOCK_FIELDS = ("creationTimestamp",)


def normalise(obj):
    if isinstance(obj, dict):
        return {k: ("<wall clock>" if k in WALL_CLOCK_FIELDS else
                    normalise(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [normalise(v) for v in obj]
    return obj


def node(name: str, pods: str = "110") -> dict:
    return {"metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                       "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def pod(name: str) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {"cpu": "100m"}}}]}}


class Recorder:
    def __init__(self, base: str):
        self.base = base
        self.steps: list[tuple] = []

    def __call__(self, step: str, method: str, path: str, body=None,
                 headers=None) -> dict:
        status, hdrs, raw = request(self.base, method, path, body, headers)
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = raw.decode(errors="replace")
        self.steps.append((step, status, hdrs.get("content-type"),
                           hdrs.get("retry-after"), normalise(doc)))
        return doc if isinstance(doc, dict) else {}

    def watch(self, step: str, path: str, n: int) -> None:
        self.steps.append((step, "watch", normalise(
            read_watch(self.base, path, n))))


def crud_script(base: str) -> list[tuple]:
    r = Recorder(base)
    r("create node", "POST", "/api/v1/nodes", node("n1", pods="1"))
    r("create node list", "POST", "/api/v1/nodes",
      {"kind": "List", "items": [node("n2"), node("n3")]})
    r("create pod", "POST", "/api/v1/pods", pod("p1"))
    r("create pod list", "POST", "/api/v1/pods",
      {"kind": "List", "items": [pod(f"p{i}") for i in range(2, 7)]
       + [{"metadata": {"name": "p2"}, "spec": {"containers": [
           {"name": "c"}]}}]})
    listed = r("list pods", "GET", "/api/v1/pods")
    rv0 = int(listed["metadata"]["resourceVersion"])
    got = r("get pod", "GET", "/api/v1/namespaces/default/pods/p1")
    r("get node", "GET", "/api/v1/nodes/n1")
    r("get missing", "GET", "/api/v1/namespaces/default/pods/nope")
    got["metadata"]["labels"] = {"app": "web"}
    stale = json.loads(json.dumps(got))
    r("update pod", "PUT", "/api/v1/namespaces/default/pods/p1", got)
    r("update stale (CAS 409)", "PUT", "/api/v1/namespaces/default/pods/p1",
      stale)
    r("validation error", "POST", "/api/v1/pods",
      {"metadata": {"name": "bad"}, "spec": {"containers": []}})
    r("bad json", "POST", "/api/v1/pods", None,
      {"Content-Length": "0"})
    r("bind one", "POST", "/api/v1/namespaces/default/bindings",
      {"kind": "Binding", "metadata": {"name": "p1"},
       "target": {"kind": "Node", "name": "n2"}})
    r("bind again (CAS 409)", "POST", "/api/v1/namespaces/default/bindings",
      {"kind": "Binding", "metadata": {"name": "p1"},
       "target": {"kind": "Node", "name": "n3"}})
    r("bind triples (CAS 409, 404)", "POST",
      "/api/v1/namespaces/default/bindings",
      {"kind": "BindingList", "triples": [
          ["default", "p2", "n2"], ["default", "p1", "n3"],
          ["default", "ghost", "n2"]]})
    r("bind triples (capacity 409)", "POST",
      "/api/v1/namespaces/default/bindings",
      {"kind": "BindingList", "triples": [
          ["default", "p3", "n1"], ["default", "p4", "n1"]]})
    r("bind items, all bound", "POST", "/api/v1/namespaces/default/bindings",
      {"kind": "BindingList", "items": [
          {"metadata": {"name": "p4"}, "target": {"name": "n3"}}]})
    unbound = quote("spec.nodeName=")
    bound = quote("spec.nodeName!=")
    r("list unbound", "GET", f"/api/v1/pods?fieldSelector={unbound}")
    r("list bound", "GET", f"/api/v1/pods?fieldSelector={bound}")
    r("bad field selector", "GET", "/api/v1/pods?fieldSelector=nonsense")
    r("delete pod", "DELETE", "/api/v1/namespaces/default/pods/p6")
    r("delete again", "DELETE", "/api/v1/namespaces/default/pods/p6")
    # Replay from an rv, NDJSON and framed, with and without a selector:
    # a bound pod leaves the unbound set as a DELETED event.
    r.watch("watch pods from rv0 (ndjson)",
            f"/api/v1/pods?watch=1&resourceVersion={rv0}", 6)
    r.watch("watch pods from rv0 (frames)",
            f"/api/v1/pods?watch=1&resourceVersion={rv0}&frames=1", 6)
    r.watch("watch unbound from rv0",
            f"/api/v1/pods?watch=1&resourceVersion={rv0}"
            f"&fieldSelector={unbound}", 6)
    r.watch("watch bound from 0 (frames)",
            f"/api/v1/pods?watch=1&resourceVersion=0&frames=1"
            f"&fieldSelector={bound}", 4)
    r.watch("watch nodes from 0",
            "/api/v1/nodes?watch=1&resourceVersion=0", 3)
    r("fill the watch window", "POST", "/api/v1/configmaps",
      {"kind": "List", "items": [{"metadata": {"name": f"cm{i}"}}
                                 for i in range(1100)]})
    r("watch too old (410)", "GET",
      "/api/v1/pods?watch=1&resourceVersion=1")
    r("healthz", "GET", "/healthz")
    return r.steps

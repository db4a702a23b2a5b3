"""HTTP front end over the in-memory store — the apiserver surface the
scheduler stack speaks (pkg/apiserver handler chain, scheduler-relevant
subset):

    GET    /api/v1/{kind}                      list (+ ?watch=1&resourceVersion=N)
    GET    /api/v1/namespaces/{ns}/{kind}/{name}
    POST   /api/v1/{kind}                      create
    PUT    /api/v1/namespaces/{ns}/{kind}/{name}   update (CAS on resourceVersion)
    DELETE /api/v1/namespaces/{ns}/{kind}/{name}
    POST   /api/v1/namespaces/{ns}/bindings    the binding subresource
    GET    /healthz, /metrics

Watches stream newline-delimited JSON events ({"type": ..., "object": ...})
over a chunked response, the reference's watch wire shape; a stale
resourceVersion returns 410 Gone, telling the client to relist.  Nodes are
cluster-scoped (no namespace segment), pods/services namespaced.

The request loop is hand-parsed HTTP/1.1 (request line + the one header
the routes need) rather than ``BaseHTTPRequestHandler``: at wire bind
rates the stdlib handler's email-module header parsing and per-response
string plumbing cost ~300 µs of a 380 µs request — measured 3.2× more
verbs/s per connection with this loop, with JSON itself at only ~2% of
request cost (so a binary codec would buy nothing; the framing layer was
the bottleneck).

Counterpart of ``kubernetes_tpu/apiserver/server.py``, with the same
/debug/timeseries, /debug/dashboard (the self-scrape telemetry ring) and
/debug/profile (the sampling CPU profiler) routes.
"""

from __future__ import annotations

import contextlib
import json
import socketserver
import threading
import time
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.api import fieldsel
from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS as _NAMESPACED
from kubernetes_tpu_torch.apiserver import flowcontrol as apf
from kubernetes_tpu_torch.apiserver.memstore import (ConflictError, MemStore,
                                               TooOldError)
from kubernetes_tpu_torch.apiserver.validation import (AdmissionError,
                                                 admit_and_validate,
                                                 store_admission)
from kubernetes_tpu_torch.utils import trace as trace_mod
from kubernetes_tpu_torch.utils.metrics import (APISERVER_REQUEST_LATENCY,
                                          APISERVER_SERIALIZE_OPS,
                                          APISERVER_SERIALIZE_SECONDS,
                                          expose_registry)

# Watch-stream serialize accounting children, resolved once — the
# stream loop flushes per coalesced batch, not per event.
_WATCH_SER_S = APISERVER_SERIALIZE_SECONDS.labels(verb="WATCH")
_WATCH_SER_OPS = APISERVER_SERIALIZE_OPS.labels(verb="WATCH")

# Idle watch streams carry a blank heartbeat chunk this often so clients'
# read deadlines only fire on genuinely dead sockets.
WATCH_HEARTBEAT_PERIOD = 10.0


_NULL_GATE = contextlib.nullcontext()


def _resource_of(parts: list) -> str:
    """The {kind} segment of an (already group-rebased) API path; top-level
    paths (healthz, metrics) are their own nameable resources — the one
    mapping both authorization and the request-latency metric use."""
    if len(parts) >= 5 and parts[2] == "namespaces":
        return parts[4]
    if len(parts) >= 3 and parts[:2] == ["api", "v1"]:
        return parts[2]
    return parts[0] if parts else ""


# Resource values admitted as a metric label: the known kind table plus
# the cluster-scoped kinds and the mux's own top-level paths.  Everything
# else (scanner probes, typos) collapses to "other" — label values are
# memoized forever, so client-controlled strings must not mint series.
_METRIC_RESOURCES = frozenset(_NAMESPACED) | frozenset({
    "nodes", "namespaces", "persistentvolumes", "bindings", "watch",
    "clusterroles", "clusterrolebindings", "healthz", "metrics", "debug"})
_METRIC_VERBS = frozenset({"GET", "POST", "PUT", "DELETE", "HEAD",
                           "PATCH", "WATCH"})


def _metric_resource(parts: list) -> str:
    resource = _resource_of(parts)
    return resource if resource in _METRIC_RESOURCES else "other"


def _rebase_group_path(parts: list) -> list:
    """Group API paths (/apis/{group}/{version}/...) serve the same kind
    table as the legacy core path — the reference's clients address
    extensions/v1beta1 replicasets, batch/v1 jobs, autoscaling/v1 HPAs
    etc.; kind names are globally unique here, so the group/version
    segments just route.  ONE helper used by both the auth block and
    the dispatcher, so authorization always names the resource dispatch
    serves."""
    if len(parts) >= 3 and parts[0] == "apis":
        return ["api", "v1"] + parts[3:]
    return parts

_STATUS_LINES = {
    200: b"HTTP/1.1 200 OK\r\n",
    201: b"HTTP/1.1 201 Created\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    401: b"HTTP/1.1 401 Unauthorized\r\n",
    403: b"HTTP/1.1 403 Forbidden\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    409: b"HTTP/1.1 409 Conflict\r\n",
    410: b"HTTP/1.1 410 Gone\r\n",
    422: b"HTTP/1.1 422 Unprocessable Entity\r\n",
    429: b"HTTP/1.1 429 Too Many Requests\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    501: b"HTTP/1.1 501 Not Implemented\r\n",
}


def make_handler(store: MemStore, auth=None, admission_control=None,
                 flow=None):
    # Store-aware admission chain (--admission-control order; default:
    # NamespaceLifecycle -> ServiceAccount -> anti-affinity veto ->
    # LimitRanger defaulting -> ResourceQuota), built once per server.
    # Pod admit+create pairs serialize under one gate: ResourceQuota is
    # check-then-act against the stored pod list, and two concurrent
    # creates racing the same quota headroom must not both pass before
    # either lands (the reference serializes via CAS on quota status).
    admission_chain = store_admission(store, admission_control)
    pod_write_gate = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        # Response header/body write pairs on keep-alive connections stall
        # ~40 ms under Nagle + the peer's delayed ACK; verbs are small.
        disable_nagle_algorithm = True

        def setup(self):
            super().setup()
            import socket as _socket
            self.connection.setsockopt(_socket.IPPROTO_TCP,
                                       _socket.TCP_NODELAY, 1)
            # Per-operation socket deadline: bounds a peer that stalls
            # mid-body and reaps idle keep-alive connections (clients
            # transparently reconnect); without it one lying client pins
            # a handler thread forever.
            self.connection.settimeout(120.0)

        def handle(self):
            # Deferred TLS handshake (see serve()): completes here, in
            # this connection's thread, bounded by setup()'s 120 s socket
            # deadline.  A verified client certificate then authenticates
            # the whole connection (x509 request authenticator): subject
            # CN is the user, O entries the groups; it outranks tokens.
            self._peer_user = None
            if hasattr(self.connection, "do_handshake"):
                import ssl
                try:
                    self.connection.do_handshake()
                except (ssl.SSLError, TimeoutError, OSError):
                    return  # bad/absent TLS from the peer: drop quietly
                try:
                    cert = self.connection.getpeercert()
                except ValueError:
                    cert = None
                if cert:
                    from kubernetes_tpu_torch.apiserver.auth import user_from_cert
                    self._peer_user = user_from_cert(cert)
            try:
                self._handle_loop()
            except (TimeoutError, OSError):
                return  # stalled/idle peer: reap the connection quietly

        def _handle_loop(self):
            # Keep-alive loop: one request per iteration until the peer
            # closes (or a watch takes the connection over).
            while True:
                line = self.rfile.readline(65536)
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _ = line.split(b" ", 2)
                except ValueError:
                    return
                clen = 0
                authz = ""
                traceparent = ""
                chunked = False
                while True:
                    h = self.rfile.readline(65536)
                    if h in (b"\r\n", b"\n", b""):
                        break
                    if h[:15].lower() == b"content-length:":
                        try:
                            clen = int(h[15:].strip())
                        except ValueError:
                            return
                    elif h[:18].lower() == b"transfer-encoding:":
                        chunked = True
                    elif h[:12].lower() == b"traceparent:":
                        # Trace propagation: the request span joins the
                        # caller's trace (the scheduler's bind fan-out).
                        traceparent = h[12:].strip().decode(
                            errors="replace")
                    elif auth is not None and \
                            h[:14].lower() == b"authorization:":
                        authz = h[14:].strip().decode(errors="replace")
                if chunked:
                    # This loop only understands Content-Length framing.
                    # Silently treating a chunked body as empty would make
                    # the body bytes misparse as the next pipelined
                    # request — reject and close instead.
                    self._send_json(501, {"error":
                                          "chunked requests unsupported"})
                    return
                # Bound the body: a negative length would read-to-EOF and
                # an overstated one would block the thread until the peer
                # gives up (mutual deadlock).
                if not 0 <= clen <= 64 * 1024 * 1024:
                    return
                raw = self.rfile.read(clen) if clen else b""
                if len(raw) < clen:
                    return  # short body: peer lied or died
                try:
                    if auth is not None:
                        # Auth runs FIRST in the chain (pkg/apiserver:
                        # auth -> admission -> validation -> registry).
                        target_s = target.decode()
                        parts = _rebase_group_path(
                            [p for p in
                             target_s.split("?", 1)[0].split("/") if p])
                        # Resource name for ABAC: the {kind} segment of
                        # API paths; top-level paths (healthz, metrics)
                        # are their own nameable resources — the same
                        # mapping the request-latency metric labels use.
                        resource = _resource_of(parts)
                        ns = parts[3] if len(parts) >= 5 and \
                            parts[2] == "namespaces" else ""
                        denied = auth.check(authz, method.decode(),
                                            resource, ns,
                                            peer_user=self._peer_user)
                        if denied is not None:
                            code, msg = denied
                            self._send_json(code, {"error": msg})
                            continue
                    if not self._dispatch(method.decode(), target.decode(),
                                          raw, traceparent):
                        return  # watch served; connection consumed
                except (BrokenPipeError, ConnectionResetError):
                    return

        # Per-request serialize accounting (wire attribution):
        # _send_json accumulates dumps() nanoseconds here; _dispatch
        # flushes the sum under the request's verb in its finally.
        _ser_ns = 0
        _ser_ops = 0

        def _send_json(self, code: int, obj, retry_after=None) -> None:
            t0 = time.perf_counter_ns()
            body = json.dumps(obj).encode()
            self._ser_ns += time.perf_counter_ns() - t0
            self._ser_ops += 1
            self._send_raw(code, body, "application/json", retry_after)

        def _send_raw(self, code: int, body: bytes, ctype: str,
                      retry_after=None) -> None:
            """One response-assembly path for every content type.
            ``retry_after`` (seconds, float ok — our clients parse it as
            one) rides shed responses as a Retry-After header."""
            self._code = code
            extra = b"" if retry_after is None else \
                b"Retry-After: " + f"{retry_after:g}".encode() + b"\r\n"
            self.wfile.write(
                _STATUS_LINES.get(code, _STATUS_LINES[400])
                + b"Content-Type: " + ctype.encode()
                + b"\r\n" + extra + b"Content-Length: "
                + str(len(body)).encode() + b"\r\n\r\n" + body)
            self.wfile.flush()

        def _send_json_bytes(self, code: int, body: bytes) -> None:
            """Pre-serialized JSON body (the trace export)."""
            self._send_raw(code, body, "application/json")

        def _send_text(self, code: int, body: bytes) -> None:
            self._send_raw(code, body, "text/plain")

        def _admit(self, kind: str, body: dict,
                   op: str = "create") -> bool:
            """Write-path chain (pkg/apiserver: admission -> validation):
            403 on an admission veto, 422 with collected reasons on a
            structurally invalid object.  True = proceed to the store."""
            try:
                errors = admit_and_validate(kind, body, admission_chain, op)
            except AdmissionError as err:
                self._send_json(403, {"error": str(err)})
                return False
            if errors:
                self._send_json(422, {"error": "validation failed",
                                      "reasons": errors})
                return False
            return True

        def _dispatch(self, method: str, target: str, raw: bytes,
                      traceparent: str = "") -> bool:
            """Route one request.  Returns False when the connection was
            taken over by a watch stream (caller must stop the loop).
            Every handled request records its latency in the per-
            verb/resource/code histogram and (when tracing is on) a
            request span under the caller's propagated trace."""
            parsed = urlparse(target)
            parts = _rebase_group_path(
                [p for p in parsed.path.split("/") if p])
            query = parse_qs(parsed.query)
            is_watch = method == "GET" and \
                query.get("watch", ["0"])[0] in ("1", "true")
            t0 = time.perf_counter()
            self._code = 200
            ticket = None
            try:
                if flow is not None:
                    # Priority-level admission BEFORE any routing work:
                    # shed requests must cost the server nothing but the
                    # classification and a 429 write.  The ticket spans
                    # the whole request — for a watch, the whole stream.
                    sub = parts[6] if len(parts) == 7 else ""
                    ticket = flow.admit(method, _resource_of(parts),
                                        is_watch, sub)
                    if not ticket.ok:
                        self._send_json(
                            429, {"error": "the server is overloaded "
                                  f"({ticket.reason}); retry later"},
                            retry_after=ticket.retry_after)
                        return True
                return self._dispatch_inner(method, parts, query, raw)
            finally:
                if ticket is not None:
                    ticket.release()
                dur = time.perf_counter() - t0
                verb = "WATCH" if is_watch else (
                    method if method in _METRIC_VERBS else "other")
                resource = _metric_resource(parts)
                APISERVER_REQUEST_LATENCY.labels(
                    verb=verb, resource=resource,
                    code=str(self._code)).observe(dur * 1e6)
                if self._ser_ns:
                    APISERVER_SERIALIZE_SECONDS.labels(verb=verb).inc(
                        self._ser_ns / 1e9)
                    APISERVER_SERIALIZE_OPS.labels(verb=verb).inc(
                        self._ser_ops)
                    self._ser_ns = self._ser_ops = 0
                trace_mod.record_server_span(
                    "apiserver.request", traceparent, dur,
                    verb=verb, resource=resource, code=self._code)

        def _dispatch_inner(self, method: str, parts: list, query,
                            raw: bytes) -> bool:
            if method == "GET":
                return self._do_get(parts, query)
            body_obj: dict = {}
            if raw:
                try:
                    body_obj = json.loads(raw)
                except ValueError:
                    self._send_json(400, {"error": "bad json"})
                    return True
                if not isinstance(body_obj, dict):
                    self._send_json(400, {"error": "body must be an object"})
                    return True
                if body_obj.get("metadata") is None:
                    # Normalize "metadata": null so downstream setdefault
                    # paths never trip on None.
                    body_obj["metadata"] = {}
            if method == "POST":
                self._do_post(parts, body_obj)
            elif method == "PUT":
                self._do_put(parts, body_obj)
            elif method == "DELETE":
                self._do_delete(parts)
            else:
                self._send_json(404, {"error": "unknown method"})
            return True

        def _do_get(self, parts, query) -> bool:
            if parts == ["healthz"]:
                self._send_text(200, b"ok")
                return True
            if parts == ["metrics"]:
                if query.get("format", [""])[0] == "openmetrics":
                    # Exemplar-carrying OpenMetrics rendering.
                    from kubernetes_tpu_torch.utils.debugmux import \
                        OPENMETRICS_CTYPE
                    from kubernetes_tpu_torch.utils.metrics import \
                        expose_registry_openmetrics
                    body = expose_registry_openmetrics().encode()
                    self._send_raw(200, body, OPENMETRICS_CTYPE)
                    return True
                # Prometheus text exposition: the default registry carries
                # the per-verb/resource/code request latencies this server
                # records plus the shared client/breaker counters.
                self._send_text(200, expose_registry().encode())
                return True
            if parts == ["debug", "traces"]:
                # The span ring as Chrome trace-event JSON (Perfetto):
                # request spans land here under the caller's trace id when
                # a traceparent header was propagated.
                self._send_json_bytes(200,
                                      trace_mod.to_chrome_trace().encode())
                return True
            if parts == ["debug", "timeseries"]:
                from kubernetes_tpu_torch.utils import telemetry
                self._send_json_bytes(
                    200, telemetry.timeseries_json().encode())
                return True
            if parts == ["debug", "dashboard"]:
                from kubernetes_tpu_torch.utils import telemetry
                self._send_raw(200, telemetry.dashboard_html().encode(),
                               "text/html; charset=utf-8")
                return True
            if parts == ["debug", "profile"]:
                # kt-prof continuous CPU profile; disabled (KT_PROF=0)
                # is a client-visible 404, never a 500.
                from kubernetes_tpu_torch.utils import profiler
                resolved = profiler.render(query)
                if resolved is None:
                    self._send_raw(404,
                                   b"profiling disabled (KT_PROF=0)",
                                   "text/plain")
                else:
                    body, ctype = resolved
                    self._send_raw(200, body, ctype)
                return True
            if parts == ["debug", "vars"]:
                # Live flow-control state (the scheduler's /debug/vars
                # idiom): per-level inflight/queue/shed counters — what
                # the soak overload wave scrapes for its queue-depth
                # bound.
                self._send_json(200, {"overload": flow.report()
                                      if flow is not None else None})
                return True
            if len(parts) == 3 and parts[:2] == ["api", "v1"]:
                kind = parts[2]
                try:
                    selector = fieldsel.matcher(
                        query.get("fieldSelector", [""])[0])
                except ValueError as err:
                    self._send_json(400, {"error": str(err)})
                    return True
                if query.get("watch", ["0"])[0] in ("1", "true"):
                    self._serve_watch(kind, query, selector)
                    return False
                items, rv = store.list(kind, selector)
                self._send_json(200, {"kind": kind.capitalize() + "List",
                                      "items": items,
                                      "metadata": {
                                          "resourceVersion": str(rv)}})
                return True
            if len(parts) == 6 and parts[2] == "namespaces":
                # /api/v1/namespaces/{ns}/{kind}/{name}
                _, _, _, ns, kind, name = parts
                obj = store.get(kind, f"{ns}/{name}")
                if obj is None:
                    self._send_json(404, {"error": "not found"})
                else:
                    self._send_json(200, obj)
                return True
            if len(parts) == 4 and parts[:2] == ["api", "v1"]:
                obj = store.get(parts[2], parts[3])
                if obj is None:
                    self._send_json(404, {"error": "not found"})
                else:
                    self._send_json(200, obj)
                return True
            self._send_json(404, {"error": "unknown path"})
            return True

        def _serve_watch(self, kind: str, query, selector=None) -> None:
            rv = int(query.get("resourceVersion", ["0"])[0])
            # Framed multi-event encoding (opt-in via ?frames=1): queued
            # events coalesce into ONE length-prefixed {"items":[...]}
            # batch per write — the client decodes a whole batch with a
            # single json.loads instead of one per event line, and the
            # length prefix lets its pump slice without rescanning the
            # buffer for newlines.  The NDJSON per-event form stays the
            # default for compatibility.
            frames = query.get("frames", ["0"])[0] in ("1", "true")
            sel_key = query.get("fieldSelector", [""])[0] or None
            try:
                watcher = store.watch([kind], rv, selector=selector,
                                      selector_key=sel_key)
            except TooOldError:
                self._send_json(410, {"error": "too old resource version"})
                return
            self.wfile.write(
                b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n")
            self.wfile.flush()
            try:
                idle = 0.0
                while True:
                    ev = watcher.next(timeout=0.5)
                    if ev is None:
                        # Idle: send a blank-line heartbeat chunk every
                        # ~10 s so clients can tell a quiet stream from a
                        # dead socket (their read timeout only fires when
                        # heartbeats stop — reflector.go bounds watches
                        # the same way server-side).
                        idle += 0.5
                        if idle >= WATCH_HEARTBEAT_PERIOD:
                            idle = 0.0
                            self.wfile.write(b"1\r\n\n\r\n")
                            self.wfile.flush()
                        continue
                    idle = 0.0
                    # Coalesce whatever else is already queued into ONE
                    # chunk write (bounded): under a density burst the
                    # per-event write+flush pair — not serialization — was
                    # the stream cost, and the NDJSON framing is unchanged
                    # (clients parse by lines, not chunks).
                    batch = [ev]
                    while len(batch) < 512:
                        nxt = watcher.next(timeout=0)
                        if nxt is None:
                            break
                        batch.append(nxt)
                    t0 = time.perf_counter_ns()
                    if frames:
                        body = b'{"items":[' + b",".join(
                            e.wire_json() for e in batch) + b"]}"
                        payload = b"=%d\n%s\n" % (len(body), body)
                    else:
                        payload = b"".join(e.wire_line() for e in batch)
                    _WATCH_SER_S.inc((time.perf_counter_ns() - t0) / 1e9)
                    _WATCH_SER_OPS.inc(len(batch))
                    self.wfile.write(f"{len(payload):x}\r\n".encode()
                                     + payload + b"\r\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                watcher.stop()

        def _do_post(self, parts, body) -> None:
            try:
                if len(parts) == 7 and parts[2] == "namespaces" and \
                        parts[4] == "pods" and parts[6] == "eviction":
                    self._do_eviction(parts[3], parts[5])
                    return
                if len(parts) == 5 and parts[2] == "namespaces" and \
                        parts[4] == "bindings":
                    ns = parts[3]
                    if isinstance(body.get("triples"), list):
                        # Compact bulk-bind fast path: [ns, pod, node]
                        # rows, no per-item Binding scaffolding to parse.
                        self._do_bind_triples([
                            ((t[0] if len(t) > 0 and t[0] else ns),
                             t[1] if len(t) > 1 else "",
                             t[2] if len(t) > 2 else "")
                            for t in body["triples"]
                            if isinstance(t, (list, tuple))])
                        return
                    if isinstance(body.get("items"), list):
                        self._do_bind_list(ns, body["items"])
                        return
                    name = (body.get("metadata") or {}).get("name", "")
                    target = (body.get("target") or {}).get("name", "")
                    store.bind(ns, name, target)
                    self._send_json(201, {"status": "Success"})
                    return
                if len(parts) == 3 and parts[:2] == ["api", "v1"]:
                    kind = parts[2]
                    if isinstance(body.get("items"), list):
                        self._do_create_list(kind, body["items"])
                        return
                    if kind in _NAMESPACED:
                        body.setdefault("metadata", {}).setdefault(
                            "namespace", "default")
                    if kind == "pods":
                        with pod_write_gate:
                            if not self._admit(kind, body):
                                return
                            created = store.create(kind, body, owned=True)
                    else:
                        if not self._admit(kind, body):
                            return
                        # owned: the handler's parsed body dies with this
                        # request — the store may keep it without copying.
                        created = store.create(kind, body, owned=True)
                    self._send_json(201, created)
                    return
            except ConflictError as err:
                self._send_json(409, {"error": str(err)})
                return
            except KeyError as err:
                self._send_json(404, {"error": str(err)})
                return
            self._send_json(404, {"error": "unknown path"})

        def _do_eviction(self, ns: str, name: str) -> None:
            """The eviction subresource (POST .../pods/{name}/eviction —
            EvictionREST, pkg/registry/pod/etcd/etcd.go:138-230): delete
            the pod ONLY if its PodDisruptionBudget allows it, with a
            CAS verify-and-decrement on ``status.disruptionAllowed`` so
            two racing evictions can't both spend the same budget slot.
            429 when the budget blocks; >1 matching PDB is the
            reference's unsupported 500."""
            from kubernetes_tpu_torch.controller.replication import _matches
            pod = store.get("pods", f"{ns}/{name}")
            if pod is None:
                self._send_json(404, {"error": f"pod {ns}/{name} "
                                      f"not found"})
                return
            pdbs, _ = store.list(
                "poddisruptionbudgets",
                lambda o: (o.get("metadata") or {})
                .get("namespace", "default") == ns)
            matching = [p for p in pdbs
                        if _matches((p.get("spec") or {})
                                    .get("selector") or {}, pod)]
            if len(matching) > 1:
                self._send_json(500, {"error":
                                      "This pod has more than one "
                                      "PodDisruptionBudget, which the "
                                      "eviction subresource does not "
                                      "support."})
                return
            if matching:
                pdb_key = f"{ns}/" + (matching[0].get("metadata") or {}) \
                    .get("name", "")
                for _attempt in range(3):
                    cur = store.get("poddisruptionbudgets", pdb_key)
                    if cur is None:
                        break  # PDB vanished: no budget to honor
                    if not (cur.get("status") or {}) \
                            .get("disruptionAllowed"):
                        self._send_json(429, {
                            "error": "Cannot evict pod as it would "
                                     "violate the pod's disruption "
                                     "budget."})
                        return
                    # verify-and-decrement: flip allowed -> False under
                    # CAS; the disruption controller recomputes it after
                    # the delete lands.
                    cur.setdefault("status", {})["disruptionAllowed"] = \
                        False
                    try:
                        store.update(
                            "poddisruptionbudgets", cur,
                            expected_rv=(cur.get("metadata") or {})
                            .get("resourceVersion"))
                        break
                    except ConflictError:
                        continue  # racing eviction/controller: re-check
                else:
                    self._send_json(429, {"error":
                                          "disruption budget contended; "
                                          "retry"})
                    return
            try:
                store.delete("pods", f"{ns}/{name}")
            except KeyError:
                self._send_json(404, {"error": "not found"})
                return
            self._send_json(201, {"status": "Success"})

        def _do_bind_list(self, default_ns: str, items: list) -> None:
            """Batch form of the binding subresource: per-item CAS under
            one store lock — semantically identical to N sequential
            BindingREST.Create POSTs, without N requests through the
            framing layer (the measured wire bottleneck at density rates).
            Per-item results keep the conflict detector observable."""
            triples = []
            for it in items:
                it = it if isinstance(it, dict) else {}
                meta = it.get("metadata") or {}
                triples.append((meta.get("namespace") or default_ns,
                                meta.get("name", ""),
                                (it.get("target") or {}).get("name", "")))
            self._do_bind_triples(triples)

        def _do_bind_triples(self, triples: list) -> None:
            """Bulk CAS over fully-resolved (ns, pod, node) rows; callers
            default empty namespaces before reaching here."""
            errors = store.bind_many(triples)
            failed = sum(1 for e in errors if e is not None)
            if failed == 0:
                # All bound: per-item results would be N copies of
                # {"code": 201} — serialized, shipped and parsed for
                # nothing at density rates.  The count is the contract;
                # items are detailed only when something failed.
                self._send_json(200, {"kind": "BindingListResult",
                                      "failed": 0,
                                      "bound": len(errors)})
                return
            results = [{"code": 201} if e is None else
                       {"code": 404 if "not found" in e else 409,
                        "error": e}
                       for e in errors]
            self._send_json(200, {"kind": "BindingListResult",
                                  "failed": failed, "results": results})

        def _do_create_list(self, kind: str, items: list) -> None:
            """Batch create (a v1 List body): each item runs the same
            admission -> validation -> store chain as a single POST;
            per-item results, partial success allowed."""
            results = []
            created = 0
            for it in items:
                if not isinstance(it, dict):
                    results.append({"code": 400, "error": "not an object"})
                    continue
                if it.get("metadata") is None:
                    it["metadata"] = {}
                if kind in _NAMESPACED:
                    it["metadata"].setdefault("namespace", "default")
                gate = pod_write_gate if kind == "pods" else \
                    _NULL_GATE
                with gate:
                    try:
                        errors = admit_and_validate(kind, it,
                                                    admission_chain)
                    except AdmissionError as err:
                        results.append({"code": 403, "error": str(err)})
                        continue
                    if errors:
                        results.append({"code": 422,
                                        "error": "validation failed",
                                        "reasons": errors})
                        continue
                    try:
                        obj = store.create(kind, it, owned=True)
                    except ConflictError as err:
                        results.append({"code": 409, "error": str(err)})
                        continue
                created += 1
                results.append({"code": 201, "resourceVersion":
                                obj["metadata"]["resourceVersion"]})
            self._send_json(200, {"kind": "CreateListResult",
                                  "created": created, "results": results})

        def _do_put(self, parts, body) -> None:
            try:
                if len(parts) == 6 and parts[2] == "namespaces":
                    kind = parts[4]
                    # The path names the namespace; an object missing
                    # metadata.namespace would otherwise key as
                    # cluster-scoped and miss the stored object.
                    body.setdefault("metadata", {}).setdefault(
                        "namespace", parts[3])
                elif len(parts) == 4 and parts[:2] == ["api", "v1"]:
                    kind = parts[2]
                else:
                    self._send_json(404, {"error": "unknown path"})
                    return
                gate = pod_write_gate if kind == "pods" else _NULL_GATE
                with gate:
                    if not self._admit(kind, body, op="update"):
                        return
                    # GuaranteedUpdate semantics: a submitted
                    # resourceVersion is a CAS precondition
                    # (pkg/storage/etcd/etcd_helper.go).
                    rv = (body.get("metadata") or {}).get("resourceVersion")
                    updated = store.update(kind, body, expected_rv=rv,
                                           owned=True)
                self._send_json(200, updated)
            except ConflictError as err:
                self._send_json(409, {"error": str(err)})
            except KeyError as err:
                self._send_json(404, {"error": str(err)})

        def _do_delete(self, parts) -> None:
            try:
                if len(parts) == 6 and parts[2] == "namespaces":
                    store.delete(parts[4], f"{parts[3]}/{parts[5]}")
                elif len(parts) == 4 and parts[:2] == ["api", "v1"]:
                    store.delete(parts[2], parts[3])
                else:
                    self._send_json(404, {"error": "unknown path"})
                    return
                self._send_json(200, {"status": "Success"})
            except KeyError as err:
                self._send_json(404, {"error": str(err)})

    return Handler


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def handle_error(self, request, client_address):
        # TLS handshake failures and peer resets are routine connection
        # noise (a port scanner, a curl without the CA), not tracebacks.
        # Deliberately NOT the blanket OSError: fd exhaustion and other
        # OSError-derived faults must still surface.
        import ssl
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLError, ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def serve(store: MemStore, port: int = 0,
          host: str = "127.0.0.1", auth=None,
          tls_cert: str = "", tls_key: str = "",
          client_ca: str = "", admission_control=None,
          flow=None) -> _Server:
    """``auth``: an apiserver.auth.AuthConfig; None = the reference's
    insecure port (no authn/z).

    ``tls_cert``/``tls_key`` serve HTTPS (the reference's secure port);
    ``client_ca`` additionally verifies client certificates against that
    CA, and a verified cert's subject becomes the request's user (CN ->
    name, O -> groups — the x509 request authenticator,
    plugin/pkg/auth/authenticator/request/x509), taking precedence over
    bearer tokens."""
    # The apiserver self-scrapes like every other daemon: its request-
    # latency registry lands in the ring /debug/timeseries serves.
    from kubernetes_tpu_torch.utils import profiler, telemetry
    telemetry.ensure_started()
    # kt-prof sampling starts with the daemon (one branch when KT_PROF=0)
    # so /debug/profile covers the server's whole life.
    profiler.ensure_started()
    # Priority-level flow control, knobs read once here (never per
    # request); pass an explicit FlowController to override caps in
    # tests/rigs.
    if flow is None:
        flow = apf.FlowController.from_knobs()
    server = _Server((host, port),
                     make_handler(store, auth, admission_control, flow))
    if tls_cert:
        import ssl
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key or None)
        if client_ca:
            ctx.load_verify_locations(client_ca)
            # OPTIONAL: token-bearing clients without certs still pass
            # TLS and then authenticate at the token layer.
            ctx.verify_mode = ssl.CERT_OPTIONAL
        # Handshake-on-first-read, NOT on accept: with the default, the
        # handshake runs inside the single serve_forever accept loop, so
        # one stalled client (connect, send nothing) would freeze every
        # new connection.  Deferred, it runs in the per-connection handler
        # thread under that connection's own timeout.
        server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                        do_handshake_on_connect=False)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="apiserver-http")
    t.start()
    return server

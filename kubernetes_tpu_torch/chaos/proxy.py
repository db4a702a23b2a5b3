"""In-process fault-injecting HTTP proxy (toxiproxy-style).

``ChaosProxy`` listens on its own port and forwards every request to an
upstream apiserver, applying matching fault rules first.  It speaks the
same HTTP/1.1 subset as the apiserver front end (Content-Length framed
requests, Content-Length or chunked responses) so every client in this
repo — ``APIClient``, ``HTTPWatcher``, ``HTTPBinder``, kubectl — can point
at the proxy instead of the apiserver and exercise its failure paths.

Faults (``Rule.fault``):

* ``error``      — answer ``status`` (500/503/409/410/...) without
  forwarding; optional ``retry_after`` sets a Retry-After header.
* ``reset``      — close the client connection without a response, BEFORE
  forwarding (the request never reaches the upstream, so a client-side
  resend cannot double-apply a write).
* ``latency``    — sleep ``delay_s`` before forwarding (stacks with other
  rules: a latency rule plus an error rule delays the error).
* ``cut-stream`` — on a streamed (watch) response, forward
  ``after_events`` event lines then cut the stream MID-EVENT: half of the
  next event's bytes are written and the connection dropped, so the
  client's JSON parse fails exactly as a half-delivered chunk would.

Rules match on ``method`` (empty = any) and ``path`` (regex, searched in
the full request target including the query string), fire with
``probability`` — or deterministically on every ``every_nth`` matching
request (the Nth, 2Nth, ... match fires; 0 = off) — and at most
``count`` times (-1 = unlimited).

Admin endpoints (served by the proxy itself, never faulted):

    GET    /chaos/rules        list rules
    POST   /chaos/rules        add a rule (JSON body = Rule fields)
    DELETE /chaos/rules        clear all rules
    DELETE /chaos/rules/{id}   remove one rule
    GET    /chaos/stats        request/injection counters

A copy of ``kubernetes_tpu/chaos/proxy.py`` (standard library only), with
one change: a rule that fires by ``probability`` draws from the proxy's
own ``random.Random(seed)``, not from the process-wide generator, so a
run with the same seed and the same requests injects the same faults.
"""

from __future__ import annotations

import http.client
import json
import random
import re
import socket
import socketserver
import struct
import threading
import time
import urllib.parse
from dataclasses import asdict, dataclass

FAULT_ERROR = "error"
FAULT_RESET = "reset"
FAULT_LATENCY = "latency"
FAULT_CUT_STREAM = "cut-stream"

_FAULTS = (FAULT_ERROR, FAULT_RESET, FAULT_LATENCY, FAULT_CUT_STREAM)

# Upstream read deadline while relaying a watch: the apiserver heartbeats
# every ~10 s, so a genuinely dead upstream is detected within this.
_UPSTREAM_WATCH_DEADLINE = 75.0

_REASONS = {200: "OK", 201: "Created", 409: "Conflict", 410: "Gone",
            429: "Too Many Requests", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable"}


@dataclass
class Rule:
    fault: str = FAULT_ERROR
    method: str = ""          # "" = any verb
    path: str = ""            # regex searched in the full request target
    probability: float = 1.0
    count: int = -1           # max fires; -1 = unlimited
    every_nth: int = 0        # fire on every Nth matching request (0 = off)
    status: int = 500         # for fault="error"
    body: str = ""            # error body ("" = a default message)
    retry_after: float | None = None   # Retry-After header seconds
    delay_s: float = 0.0      # for fault="latency"
    after_events: int = 0     # for fault="cut-stream": events to pass first
    id: int = 0
    fired: int = 0
    seen: int = 0             # matching requests observed (every_nth cadence)

    def __post_init__(self):
        if self.fault not in _FAULTS:
            raise ValueError(f"unknown fault {self.fault!r}")
        self._pattern = re.compile(self.path) if self.path else None

    def matches(self, method: str, target: str) -> bool:
        if self.method and self.method.upper() != method.upper():
            return False
        if self._pattern is not None and \
                not self._pattern.search(target):
            return False
        return True

    def to_json(self) -> dict:
        d = asdict(self)
        d.pop("_pattern", None)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Rule":
        known = {k: d[k] for k in (
            "fault", "method", "path", "probability", "count", "every_nth",
            "status", "body", "retry_after", "delay_s", "after_events")
            if k in d}
        return cls(**known)


# -- composable node-lifecycle rule helpers ----------------------------------
#
# Soak scenarios are DECLARED out of these, not hand-rolled per test:
# each helper returns a list of Rules (compose by concatenation, install
# with ChaosProxy.add_rules) built on the deterministic every_nth cadence
# so a scenario replays identically run over run.


def heartbeat_drop(every_nth: int = 3, count: int = -1,
                   name: str = "", status: int = 503) -> list[Rule]:
    """Drop every Nth node-status heartbeat PUT (one node's when ``name``
    is given, the fleet's otherwise) — the flapping-kubelet shape: the
    apiserver's view of Ready goes stale in deterministic waves while
    lists and pod traffic flow normally."""
    path = rf"^/api/v1/nodes/{re.escape(name)}" if name \
        else r"^/api/v1/nodes/"
    return [Rule(fault=FAULT_ERROR, method="PUT", path=path,
                 status=status, every_nth=every_nth, count=count)]


def node_flap(kind: str = "reset", period: int = 2, name: str = "",
              count: int = -1, delay_s: float = 0.2) -> list[Rule]:
    """A node's control-plane path flaps on a deterministic cadence:
    every ``period``-th request touching the node's object fails by
    ``kind`` — ``reset`` (connection torn down, the half-dead-node
    shape), ``drop`` (5xx answered, the sick-apiserver-shard shape), or
    ``latency`` (the congested-link shape).  All three leave the
    intervening requests untouched, so the node looks alive-then-dead-
    then-alive to whoever heartbeats or updates it."""
    path = rf"/api/v1/nodes/{re.escape(name)}" if name \
        else r"/api/v1/nodes/"
    if kind == "reset":
        return [Rule(fault=FAULT_RESET, path=path, every_nth=period,
                     count=count)]
    if kind == "drop":
        return [Rule(fault=FAULT_ERROR, path=path, status=503,
                     every_nth=period, count=count)]
    if kind == "latency":
        return [Rule(fault=FAULT_LATENCY, path=path, delay_s=delay_s,
                     every_nth=period, count=count)]
    raise ValueError(f"unknown node_flap kind {kind!r} "
                     f"(reset/drop/latency)")


def watch_cut_on_relist(kind: str = "pods", every_nth: int = 2,
                        after_events: int = 0, count: int = -1
                        ) -> list[Rule]:
    """Cut every Nth watch stream of ``kind`` mid-event, right after the
    relist's replay window (``after_events`` events pass first) — the
    storm shape that makes a reflector relist repeatedly and exercises
    the resume-after-410/fresh-resourceVersion path without ever letting
    a stale event replay look healthy."""
    return [Rule(fault=FAULT_CUT_STREAM, method="GET",
                 path=rf"/{re.escape(kind)}\?watch=1",
                 after_events=after_events, every_nth=every_nth,
                 count=count)]


def overload(kind: int = 429, retry_after_s: float | None = 0.5,
             path: str = "", method: str = "", every_nth: int = 1,
             count: int = -1) -> list[Rule]:
    """A shedding control plane: answer ``kind`` (429 by default, or 503
    for the generic brown-out shape) with an optional Retry-After on
    every ``every_nth``-th matching request — the sustained-overload
    shape the client's retry budget and AIMD window must absorb without
    amplification.  ``path``/``method`` scope the storm (e.g. only
    creates, only binds); the default sheds everything forwarded."""
    return [Rule(fault=FAULT_ERROR, method=method, path=path, status=kind,
                 retry_after=retry_after_s, every_nth=every_nth,
                 count=count)]


def bind_conflict_storm(every_nth: int = 3, count: int = -1) -> list[Rule]:
    """409 every Nth binding POST — the competing-writer shape: the
    daemon must forget+requeue exactly the victims while the rest of the
    batch lands (pinned by the chaos e2e suites; the soak keeps it on for
    the whole run)."""
    return [Rule(fault=FAULT_ERROR, method="POST", path=r"/bindings",
                 status=409, every_nth=every_nth, count=count)]


class _ProxyServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def handle_error(self, request, client_address):
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
            return  # connection churn IS this proxy's business; stay quiet
        super().handle_error(request, client_address)


class ChaosProxy:
    """Programmatic handle + HTTP admin surface over the fault rules."""

    def __init__(self, upstream: str, host: str = "127.0.0.1",
                 port: int = 0, seed: int = 0):
        parsed = urllib.parse.urlparse(upstream)
        if parsed.scheme not in ("", "http"):
            raise ValueError("ChaosProxy fronts plain-HTTP upstreams only")
        self._up_host = parsed.hostname or "127.0.0.1"
        self._up_port = parsed.port or 80
        self._lock = threading.Lock()
        self._rules: list[Rule] = []
        self._next_id = 1
        self._rng = random.Random(seed)
        self.requests_total = 0
        self.injected_total = 0
        self._server = _ProxyServer((host, port), self._make_handler())
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------

    @property
    def base_url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ChaosProxy":
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},  # tests stop proxies often
            daemon=True, name="chaos-proxy")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- rule management (programmatic; the admin endpoint calls these) --

    def add_rule(self, rule: Rule | None = None, **kw) -> int:
        rule = rule or Rule(**kw)
        with self._lock:
            rule.id = self._next_id
            self._next_id += 1
            self._rules.append(rule)
            return rule.id

    def add_rules(self, rules: list[Rule]) -> list[int]:
        """Install a composed rule set (the node-lifecycle helpers below
        return lists so scenarios compose by concatenation)."""
        return [self.add_rule(rule) for rule in rules]

    def remove_rule(self, rule_id: int) -> bool:
        with self._lock:
            before = len(self._rules)
            self._rules = [r for r in self._rules if r.id != rule_id]
            return len(self._rules) < before

    def clear(self) -> int:
        with self._lock:
            n = len(self._rules)
            self._rules = []
            return n

    def rules(self) -> list[Rule]:
        with self._lock:
            return list(self._rules)

    def stats(self) -> dict:
        with self._lock:
            return {"requests": self.requests_total,
                    "injected": self.injected_total,
                    "rules": [r.to_json() for r in self._rules]}

    def _fire(self, method: str, target: str) -> list[Rule]:
        """Decide which rules fire for this request (count decremented,
        probability rolled, all under one lock so concurrent requests
        can't overspend a count-limited rule)."""
        fired: list[Rule] = []
        with self._lock:
            self.requests_total += 1
            for rule in self._rules:
                if rule.count == 0 or not rule.matches(method, target):
                    continue
                if rule.every_nth:
                    # Deterministic cadence: the Nth, 2Nth, ... matching
                    # request fires (e.g. "409 every 3rd bind").
                    rule.seen += 1
                    if rule.seen % rule.every_nth:
                        continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                if rule.count > 0:
                    rule.count -= 1
                rule.fired += 1
                self.injected_total += 1
                fired.append(rule)
        return fired

    # -- the wire --------------------------------------------------------

    def _make_handler(proxy):  # noqa: N805 — closure style, like server.py

        class Handler(socketserver.StreamRequestHandler):
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                self.connection.setsockopt(socket.IPPROTO_TCP,
                                           socket.TCP_NODELAY, 1)
                self.connection.settimeout(120.0)
                self._upstream: http.client.HTTPConnection | None = None

            def finish(self):
                if self._upstream is not None:
                    self._upstream.close()
                super().finish()

            def handle(self):
                try:
                    while self._handle_one():
                        pass
                except (TimeoutError, OSError):
                    return

            # -- request parsing (Content-Length framing, the subset every
            # client in this repo speaks) -------------------------------

            def _handle_one(self) -> bool:
                line = self.rfile.readline(65536)
                if not line or line in (b"\r\n", b"\n"):
                    return False
                try:
                    method_b, target_b, _ = line.split(b" ", 2)
                except ValueError:
                    return False
                method = method_b.decode()
                target = target_b.decode()
                headers: list[tuple[str, str]] = []
                clen = 0
                while True:
                    h = self.rfile.readline(65536)
                    if h in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = h.decode(errors="replace").partition(":")
                    name = name.strip()
                    value = value.strip()
                    if name.lower() == "content-length":
                        try:
                            clen = int(value)
                        except ValueError:
                            return False
                    headers.append((name, value))
                if not 0 <= clen <= 64 * 1024 * 1024:
                    return False
                body = self.rfile.read(clen) if clen else b""
                if len(body) < clen:
                    return False
                if target.startswith("/chaos/") or target == "/chaos":
                    return self._admin(method, target, body)
                return self._proxy(method, target, headers, body)

            # -- admin surface ------------------------------------------

            def _send_json(self, code: int, obj,
                           retry_after: float | None = None) -> bool:
                body = json.dumps(obj).encode()
                reason = _REASONS.get(code, "")
                extra = b""
                if retry_after is not None:
                    extra = (f"Retry-After: {retry_after:g}\r\n").encode()
                self.wfile.write(
                    f"HTTP/1.1 {code} {reason}\r\n".encode() + extra +
                    b"Content-Type: application/json\r\nContent-Length: " +
                    str(len(body)).encode() + b"\r\n\r\n" + body)
                self.wfile.flush()
                return True

            def _admin(self, method: str, target: str, body: bytes) -> bool:
                path = target.split("?", 1)[0]
                if path == "/chaos/rules":
                    if method == "GET":
                        return self._send_json(200, {
                            "rules": [r.to_json() for r in proxy.rules()]})
                    if method == "POST":
                        try:
                            rule = Rule.from_json(json.loads(body or b"{}"))
                        except (ValueError, TypeError) as err:
                            return self._send_json(400, {"error": str(err)})
                        return self._send_json(201,
                                               {"id": proxy.add_rule(rule)})
                    if method == "DELETE":
                        return self._send_json(200,
                                               {"removed": proxy.clear()})
                m = re.fullmatch(r"/chaos/rules/(\d+)", path)
                if m and method == "DELETE":
                    ok = proxy.remove_rule(int(m.group(1)))
                    return self._send_json(200, {"removed": int(ok)})
                if path == "/chaos/stats" and method == "GET":
                    return self._send_json(200, proxy.stats())
                return self._send_json(404, {"error": "unknown chaos path"})

            # -- fault application + relay ------------------------------

            def _proxy(self, method: str, target: str,
                       headers: list[tuple[str, str]], body: bytes) -> bool:
                fired = proxy._fire(method, target)
                cut_rule = None
                terminal = None
                for rule in fired:
                    if rule.fault == FAULT_LATENCY:
                        time.sleep(rule.delay_s)
                    elif rule.fault == FAULT_CUT_STREAM:
                        cut_rule = cut_rule or rule
                    elif terminal is None:
                        terminal = rule
                if terminal is not None:
                    if terminal.fault == FAULT_RESET:
                        # Abortive close (RST where the stack allows): the
                        # request never reached the upstream.
                        try:
                            self.connection.setsockopt(
                                socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))
                        except OSError:
                            pass
                        self.connection.close()
                        return False
                    msg = terminal.body or \
                        f"chaos: injected {terminal.status}"
                    self._send_json(terminal.status, {"error": msg},
                                    retry_after=terminal.retry_after)
                    return True
                return self._forward(method, target, headers, body,
                                     cut_rule)

            def _up_conn(self) -> http.client.HTTPConnection:
                if self._upstream is None:
                    self._upstream = http.client.HTTPConnection(
                        proxy._up_host, proxy._up_port, timeout=30.0)
                return self._upstream

            def _forward(self, method: str, target: str,
                         headers: list[tuple[str, str]], body: bytes,
                         cut_rule: Rule | None) -> bool:
                hop = {"connection", "keep-alive", "transfer-encoding",
                       "content-length", "host"}
                fwd = {n: v for n, v in headers if n.lower() not in hop}
                for attempt in (0, 1):
                    c = self._up_conn()
                    try:
                        c.request(method, target, body or None, fwd)
                    except (http.client.HTTPException, OSError):
                        # Stale upstream keep-alive: the request was not
                        # delivered; one reconnect + resend is safe for
                        # any verb.
                        c.close()
                        self._upstream = None
                        if attempt:
                            return self._send_json(
                                502, {"error": "chaos proxy: upstream "
                                               "unreachable"})
                        continue
                    try:
                        resp = c.getresponse()
                        break
                    except (http.client.HTTPException, OSError):
                        # Response lost: the upstream may have processed
                        # the request — resending a write would double-
                        # apply it.  Relay the fault to the client (502)
                        # and let ITS retry policy decide; reads get one
                        # transparent resend.
                        c.close()
                        self._upstream = None
                        if attempt or method not in ("GET", "HEAD"):
                            return self._send_json(
                                502, {"error": "chaos proxy: upstream "
                                               "dropped the response"})
                if resp.getheader("Transfer-Encoding", ""
                                  ).lower() == "chunked":
                    if c.sock is not None:
                        c.sock.settimeout(_UPSTREAM_WATCH_DEADLINE)
                    self._relay_stream(resp, cut_rule)
                    return False  # stream consumed the connection
                payload = resp.read()
                reason = resp.reason or _REASONS.get(resp.status, "")
                ctype = resp.getheader("Content-Type", "application/json")
                hdr = (f"HTTP/1.1 {resp.status} {reason}\r\n"
                       f"Content-Type: {ctype}\r\n"
                       f"Content-Length: {len(payload)}\r\n")
                ra = resp.getheader("Retry-After")
                if ra:
                    hdr += f"Retry-After: {ra}\r\n"
                self.wfile.write(hdr.encode() + b"\r\n" + payload)
                self.wfile.flush()
                return True

            def _relay_stream(self, resp, cut_rule: Rule | None) -> None:
                """Relay a chunked (watch) response line-by-line.  Each
                event is one NDJSON line; heartbeats are blank lines.
                With a cut rule: pass ``after_events`` event lines, then
                write HALF of the next event and drop the connection."""
                self.wfile.write(
                    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n")
                self.wfile.flush()
                passed = 0
                try:
                    while True:
                        line = resp.readline()
                        if not line:
                            break  # upstream closed the stream
                        is_event = bool(line.strip())
                        if cut_rule is not None and is_event and \
                                passed >= cut_rule.after_events:
                            half = line[:max(1, len(line) // 2)]
                            self.wfile.write(
                                f"{len(half):x}\r\n".encode() + half +
                                b"\r\n")
                            self.wfile.flush()
                            break  # mid-event cut: close abruptly
                        if is_event:
                            passed += 1
                        self.wfile.write(f"{len(line):x}\r\n".encode() +
                                         line + b"\r\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError,
                        socket.timeout, OSError):
                    pass
                finally:
                    resp.close()
                    if self._upstream is not None:
                        self._upstream.close()
                        self._upstream = None

        return Handler

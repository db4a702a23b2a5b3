"""HTTP apiserver client: rate-limited REST verbs + chunked watch streams.

The reference's client stack is ``pkg/client/restclient`` (QPS/Burst
rate-limited REST) under ``pkg/client/cache/listwatch.go`` (ListFunc/
WatchFunc against ``/api/v1/...``).  This module is that stack for the
kubernetes_tpu_torch apiserver surface (apiserver/server.py): JSON verbs, list at
a resourceVersion, and a newline-delimited-JSON chunked watch that raises
``TooOldError`` on 410 Gone so the reflector relists — reflector.go's
ListAndWatch contract.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS
from kubernetes_tpu_torch.apiserver.memstore import (ConflictError, Event,
                                               TooOldError)
from kubernetes_tpu_torch.utils import knobs, metrics, threadreg
from kubernetes_tpu_torch.utils import trace
from kubernetes_tpu_torch.utils.flowcontrol import (AIMDLimiter,
                                              TokenBucketRateLimiter)

DEFAULT_QPS = 5.0     # restclient/config.go:186 (perf rigs raise to 5000)
DEFAULT_BURST = 10    # restclient/config.go:190

# Retry policy for idempotent verbs (GET/HEAD list/get; watch reconnects
# are paced by the reflector's relist backoff).  Non-idempotent verbs
# (POST bindings!) are never retried on transport faults or 5xx — their
# callers own the semantics (the scheduler forgets + requeues on bind
# failure).  The ONE exception is a 429 carrying Retry-After: that is the
# apiserver flow controller's shed contract, emitted BEFORE dispatch
# touched the store, so re-sending any verb is safe — and binds are
# CAS-idempotent and creates name-deduped regardless.
RETRIABLE_STATUS = (429, 500, 502, 503, 504)
DEFAULT_MAX_RETRIES = 3
RETRY_BACKOFF_BASE = 0.05   # jittered, doubling per attempt
RETRY_BACKOFF_CAP = 2.0
# Retry budget (the reference's client-go retry budgets / Finagle shape):
# retries spend from a token bucket refilled at a fraction of normal
# traffic, so a flapping apiserver sees bounded retry amplification
# instead of a coordinated storm from every cached client.
RETRY_BUDGET_QPS = 5.0
RETRY_BUDGET_BURST = 20


class TLSConfig:
    """restclient.TLSClientConfig (pkg/client/restclient/config.go:
    81-117): the client side of the secure port — a CA bundle to verify
    the server, an optional client certificate pair for x509
    authentication (CN -> user, O -> groups server-side), an optional
    ServerName override, and the insecure escape hatch: how every client
    of this package talks to a secure port."""

    __slots__ = ("ca_file", "cert_file", "key_file",
                 "insecure_skip_verify", "server_name", "_ctx")

    def __init__(self, ca_file: str = "", cert_file: str = "",
                 key_file: str = "", insecure_skip_verify: bool = False,
                 server_name: str = ""):
        self.ca_file = ca_file
        self.cert_file = cert_file
        self.key_file = key_file
        self.insecure_skip_verify = insecure_skip_verify
        self.server_name = server_name
        self._ctx = None

    def __bool__(self) -> bool:
        return bool(self.ca_file or self.cert_file or
                    self.insecure_skip_verify or self.server_name)

    def context(self):
        """The ssl.SSLContext, built once and shared (contexts are
        thread-safe for use; sessions cache across connections)."""
        if self._ctx is None:
            import ssl
            ctx = ssl.create_default_context(
                cafile=self.ca_file or None)
            if self.cert_file:
                ctx.load_cert_chain(self.cert_file,
                                    self.key_file or None)
            if self.insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ctx = ctx
        return self._ctx

    @staticmethod
    def add_flags(parser) -> None:
        """kubectl's flag names, shared by every daemon."""
        parser.add_argument("--certificate-authority", default="",
                            help="CA bundle that verifies the "
                                 "apiserver's serving certificate")
        parser.add_argument("--client-certificate", default="",
                            help="client certificate for x509 "
                                 "authentication (CN -> user, O -> "
                                 "groups)")
        parser.add_argument("--client-key", default="")
        parser.add_argument("--insecure-skip-tls-verify",
                            action="store_true",
                            help="skip server certificate verification "
                                 "(testing only)")
        parser.add_argument("--tls-server-name", default="",
                            help="server name for certificate "
                                 "verification (SNI), when it differs "
                                 "from the connection address")

    @classmethod
    def from_opts(cls, opts) -> "TLSConfig":
        return cls(ca_file=getattr(opts, "certificate_authority", ""),
                   cert_file=getattr(opts, "client_certificate", ""),
                   key_file=getattr(opts, "client_key", ""),
                   insecure_skip_verify=getattr(
                       opts, "insecure_skip_tls_verify", False),
                   server_name=getattr(opts, "tls_server_name", ""))


class APIError(Exception):
    def __init__(self, status: int, message: str = "",
                 retry_after: Optional[float] = None):
        self.status = status
        # Retry-After seconds from a shedding server (flow-control 429);
        # the reflector's relist backoff honors it over its own schedule.
        self.retry_after = retry_after
        super().__init__(f"HTTP {status}: {message}")


class _SNIHTTPSConnection(http.client.HTTPSConnection):
    """HTTPSConnection with an explicit SNI / verification hostname —
    restclient's TLSClientConfig.ServerName (a cert naming the cluster
    DNS name, dialed by IP)."""

    def __init__(self, *args, sni: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self._sni = sni

    def connect(self):
        http.client.HTTPConnection.connect(self)
        if self._tunnel_host:  # pragma: no cover — no proxies here
            server_hostname = self._tunnel_host
        else:
            server_hostname = self._sni or self.host
        self.sock = self._context.wrap_socket(
            self.sock, server_hostname=server_hostname)


def _make_connection(scheme: str, host: str, port: int, timeout: float,
                     tls: Optional[TLSConfig]):
    if scheme != "https":
        return http.client.HTTPConnection(host, port, timeout=timeout)
    if tls is not None and tls:
        ctx = tls.context()
        sni = tls.server_name
    else:
        import ssl
        ctx = ssl.create_default_context()
        sni = ""
    return _SNIHTTPSConnection(host, port, timeout=timeout, context=ctx,
                               sni=sni)


class APIClient:
    """Rate-limited JSON client for the apiserver HTTP surface."""

    _NAMESPACED = NAMESPACED_KINDS

    def __init__(self, base_url: str, qps: float = DEFAULT_QPS,
                 burst: int = DEFAULT_BURST, timeout: float = 10.0,
                 token: str = "", tls: Optional[TLSConfig] = None,
                 max_retries: int = DEFAULT_MAX_RETRIES):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token  # bearer token (restclient.Config.BearerToken)
        self.tls = tls
        self.max_retries = max_retries
        self.limiter = TokenBucketRateLimiter(qps, burst)
        # Budget shared by every verb on this client (not per request):
        # the amplification bound must cover the whole client's traffic.
        self._retry_budget = TokenBucketRateLimiter(RETRY_BUDGET_QPS,
                                                    RETRY_BUDGET_BURST)
        parsed = urllib.parse.urlparse(self.base_url)
        self._scheme = parsed.scheme or "http"
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if self._scheme == "https"
                                     else 80)
        self._local = threading.local()
        # Lazy bind_list pipeline workers; creation is locked because
        # concurrent async-bind threads share this client and a lost
        # race would orphan a ThreadPoolExecutor for process lifetime.
        self._bind_pool = None
        self._bind_pool_lock = threading.Lock()
        # Adaptive bind fan-out window: a shedding server (429) halves
        # the concurrent chunk POSTs instead of re-offering the storm;
        # clean round-trips probe back up to KT_BIND_PIPELINE.
        self._bind_aimd = AIMDLimiter(
            min_limit=knobs.get_int("KT_AIMD_MIN"),
            max_limit=max(self.BIND_PIPELINE, 1),
            backoff=knobs.get_float("KT_AIMD_BACKOFF"))

    def clone(self, qps: float = DEFAULT_QPS,
              burst: int = DEFAULT_BURST) -> "APIClient":
        """A second client to the same server with its own rate bucket,
        carrying the credentials and TLS config (the factory's events
        client)."""
        return APIClient(self.base_url, qps=qps, burst=burst,
                         timeout=self.timeout, token=self.token,
                         tls=self.tls, max_retries=self.max_retries)


    # -- verbs -----------------------------------------------------------

    def _conn(self):
        """Per-thread keep-alive connection: a TCP handshake per verb
        multiplies wire latency several-fold at bind rates; the reference
        restclient reuses Go's pooled Transport the same way."""
        c = getattr(self._local, "conn", None)
        if c is None:
            c = _make_connection(self._scheme, self._host, self._port,
                                 self.timeout, self.tls)
            c.connect()
            # Nagle + delayed-ACK stalls every header/body write pair on a
            # keep-alive connection by ~40 ms; verbs are small and latency
            # bound, so flush segments immediately.
            c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.conn = c
        return c

    def _send_once(self, method: str, path: str, data, headers
                   ) -> tuple[int, bytes, Optional[float]]:
        """One request/response exchange, absorbing stale keep-alives.
        Returns (status, body, Retry-After seconds or None); raises the
        transport error when the exchange could not complete safely."""
        for attempt in (0, 1):
            c = self._conn()
            try:
                c.request(method, path, data, headers)
            except (http.client.HTTPException, OSError):
                # Stale keep-alive (server closed between verbs): the
                # request was not delivered, so one reconnect + resend is
                # safe for any verb.
                c.close()
                self._local.conn = None
                if attempt:
                    raise
                continue
            try:
                resp = c.getresponse()
                status = resp.status
                retry_after = resp.getheader("Retry-After")
                body = resp.read()
                break
            except (http.client.HTTPException, OSError):
                # The request may have been processed even though the
                # response was lost; blindly re-sending a non-idempotent
                # verb (POST bindings!) would double-apply it.  Retry
                # reads only.
                c.close()
                self._local.conn = None
                if attempt or method not in ("GET", "HEAD"):
                    raise
        try:
            after = float(retry_after) if retry_after else None
        except ValueError:
            after = None
        return status, body, after

    def _retry_permitted(self, attempt: int) -> bool:
        """Bounded by max_retries AND the client-wide retry budget."""
        if attempt >= self.max_retries:
            return False
        if not self._retry_budget.try_accept():
            metrics.CLIENT_RETRY_BUDGET_EXHAUSTED.inc()
            return False
        return True

    def _retry_sleep(self, attempt: int,
                     retry_after: Optional[float] = None,
                     verb: str = "GET") -> None:
        """Retry-After is honored exactly; otherwise jittered exponential
        backoff (full jitter: U(0.5, 1.5) x base x 2^attempt, capped)."""
        metrics.CLIENT_RETRIES.labels(verb=verb).inc()
        if retry_after is not None:
            time.sleep(min(retry_after, RETRY_BACKOFF_CAP * 4))
            return
        delay = min(RETRY_BACKOFF_BASE * (2 ** attempt), RETRY_BACKOFF_CAP)
        time.sleep(delay * (0.5 + random.random()))

    def _request(self, method: str, path: str,
                 obj: Optional[dict] = None,
                 retry_state: Optional[dict] = None) -> dict:
        self.limiter.accept()
        data = json.dumps(obj).encode() if obj is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        # Trace propagation: when this verb runs under an active span
        # (the drain's bind fan-out), the server's request span joins the
        # batch's trace.  One cheap call when tracing is off.
        tp = trace.traceparent()
        if tp:
            headers["traceparent"] = tp
        idempotent = method in ("GET", "HEAD")
        attempt = 0
        while True:
            try:
                status, body, retry_after = self._send_once(
                    method, path, data, headers)
            except (http.client.HTTPException, OSError):
                # Transport fault past the stale-keep-alive absorption:
                # retriable only for idempotent verbs, within budget.
                if not idempotent or not self._retry_permitted(attempt):
                    raise
                self._retry_sleep(attempt, verb=method)
                attempt += 1
                continue
            if status < 300:
                return json.loads(body or b"{}")
            # A 429 WITH Retry-After is the flow controller's pre-dispatch
            # shed: nothing was applied, so any verb may re-send.  (The
            # eviction subresource's PDB-denial 429 carries no Retry-After
            # and stays terminal.)  The AIMD window shrinks on every bind
            # shed — even one the budget won't retry — so offered load
            # tracks the server's capacity signal.
            shed = status == 429 and retry_after is not None
            if shed and "/bindings" in path:
                self._bind_aimd.on_throttle()
            if (shed or (idempotent and status in RETRIABLE_STATUS)) and \
                    self._retry_permitted(attempt):
                if shed and not idempotent and retry_state is not None:
                    retry_state["mutating_retries"] = \
                        retry_state.get("mutating_retries", 0) + 1
                self._retry_sleep(attempt, retry_after, verb=method)
                attempt += 1
                continue
            text = body.decode(errors="replace")
            if status == 409:
                raise ConflictError(text)
            if status == 410:
                raise TooOldError(text)
            raise APIError(status, text, retry_after=retry_after)

    def _object_path(self, kind: str, key: str) -> str:
        if kind in self._NAMESPACED or "/" in key:
            ns, _, name = key.partition("/")
            return f"/api/v1/namespaces/{ns}/{kind}/{name}"
        return f"/api/v1/{kind}/{key}"

    def get(self, kind: str, key: str) -> Optional[dict]:
        try:
            return self._request("GET", self._object_path(kind, key))
        except APIError as err:
            if err.status == 404:
                return None
            raise

    def create(self, kind: str, obj: dict) -> dict:
        st: dict = {}
        try:
            return self._request("POST", f"/api/v1/{kind}", obj,
                                 retry_state=st)
        except ConflictError:
            if not st.get("mutating_retries"):
                raise
            # Named-object dedupe: a shed-then-retried create may have
            # landed on an attempt whose response never reached us (a
            # proxy that 429s after forwarding).  Objects are named, so
            # "already exists" after OUR retry means OUR create
            # succeeded — return the stored object instead of a phantom
            # conflict.
            meta = obj.get("metadata") or {}
            name = meta.get("name", "")
            ns = meta.get("namespace") or \
                ("default" if kind in self._NAMESPACED else "")
            cur = self.get(kind, f"{ns}/{name}" if ns else name)
            if cur is not None:
                return cur
            raise

    def update(self, kind: str, obj: dict) -> dict:
        ns = (obj.get("metadata") or {}).get("namespace", "")
        name = (obj.get("metadata") or {}).get("name", "")
        if not ns and kind in self._NAMESPACED:
            # Match the server's POST defaulting: a namespaced object
            # without metadata.namespace lives in "default" — without
            # this, _object_path would treat the bare name as the
            # namespace and PUT to an empty object name.
            ns = "default"
        key = f"{ns}/{name}" if ns else name
        return self._request("PUT", self._object_path(kind, key), obj)

    def delete(self, kind: str, key: str) -> None:
        self._request("DELETE", self._object_path(kind, key))

    def bind(self, namespace: str, pod_name: str, node_name: str) -> None:
        """POST the Binding subresource (factory.go:576-587)."""
        self._request("POST", f"/api/v1/namespaces/{namespace}/bindings", {
            "apiVersion": "v1", "kind": "Binding",
            "metadata": {"name": pod_name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": "Node",
                       "name": node_name}})

    def evict(self, namespace: str, pod_name: str) -> None:
        """POST the eviction subresource (policy Eviction,
        pkg/registry/pod/etcd/etcd.go EvictionREST): delete-if-budget-
        allows.  Raises APIError(429) when a PodDisruptionBudget blocks
        the eviction."""
        self._request(
            "POST",
            f"/api/v1/namespaces/{namespace}/pods/{pod_name}/eviction",
            {"apiVersion": "policy/v1alpha1", "kind": "Eviction",
             "metadata": {"name": pod_name, "namespace": namespace}})

    # bind_list request shaping: bindings per POST (bounds request size
    # and keeps per-item results cheap server-side) and the number of
    # concurrent in-flight chunk POSTs, each on its own per-thread
    # keep-alive connection.
    BIND_CHUNK = 4096
    BIND_PIPELINE = knobs.get_int("KT_BIND_PIPELINE")

    def bind_list(self, bindings: list[tuple[str, str, str]],
                  chunk_size: Optional[int] = None
                  ) -> list[Optional[tuple[int, str]]]:
        """Batch bindings: POSTs carrying compact ``triples`` Binding
        lists; the server runs the same per-pod CAS as N single POSTs and
        returns a per-item ``(status_code, error)`` (None = bound).  The
        code matters to the caller: a 409 CAS conflict and a 404 require
        different handling/counting.

        This is the wire-gap lever twice over: one request per chunk
        replaces one request per pod, and when the list spans several
        chunks the chunk POSTs are PIPELINED over up to ``BIND_PIPELINE``
        persistent connections instead of waiting out each round-trip —
        the server CASes chunk k while chunk k+1's bytes are in flight.
        Results come back in input order regardless.

        Failure granularity is PER CHUNK: a transport fault (or a
        whole-request HTTP error) on one pipelined chunk yields
        ``(0, reason)`` for exactly that chunk's items — the other
        in-flight chunks' results stand, and the caller retries/requeues
        only the affected pods (code 0 = "delivery unknown", distinct
        from every real per-item CAS status)."""
        if not bindings:
            return []
        chunk_size = chunk_size or self.BIND_CHUNK
        if len(bindings) <= chunk_size:
            return self._bind_list_chunk(bindings)
        chunks = [bindings[i:i + chunk_size]
                  for i in range(0, len(bindings), chunk_size)]
        if self._bind_pool is None:
            with self._bind_pool_lock:
                if self._bind_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._bind_pool = ThreadPoolExecutor(
                        max_workers=max(self.BIND_PIPELINE, 1),
                        thread_name_prefix="bind-list")

        def one_chunk(chunk):
            # The AIMD window gates fan-out INSIDE the worker: the pool
            # keeps BIND_PIPELINE threads, but only window-many run a
            # POST concurrently — after a server shed the window halves,
            # so retried load decreases instead of re-offering the storm.
            self._bind_aimd.acquire()
            try:
                res = self._bind_list_chunk(chunk)
                self._bind_aimd.on_success()
                return res
            except Exception as err:  # noqa: BLE001 — isolate the chunk
                return [(0, f"bulk bind chunk failed: {err}")] * len(chunk)
            finally:
                self._bind_aimd.release()

        out: list[Optional[tuple[int, str]]] = []
        # Executor.map preserves chunk order, so per-item results stay
        # positionally attributable to their bindings.
        for res in self._bind_pool.map(one_chunk, chunks):
            out.extend(res)
        return out

    def _bind_list_chunk(self, bindings: list[tuple[str, str, str]]
                         ) -> list[Optional[tuple[int, str]]]:
        """One bulk-bind POST.  The compact ``triples`` form ([namespace,
        pod, node] rows) is the bulk-bind fast path both servers parse
        without per-item object scaffolding — ~3x fewer request bytes
        than the Binding-object ``items`` form it supersedes."""
        resp = self._request("POST", "/api/v1/namespaces/default/bindings", {
            "kind": "BindingList",
            "triples": [[ns, pod, node] for ns, pod, node in bindings]})
        if resp.get("failed") == 0:
            # Success fast path: the server omits per-item results when
            # every bind landed (nothing to detail).
            return [None] * len(bindings)
        return [None if r.get("code") == 201 else
                (r.get("code", 0), r.get("error", f"HTTP {r.get('code')}"))
                for r in resp.get("results", [])]

    def flow_report(self) -> dict:
        """Client-side backpressure state for /debug/vars: the adaptive
        bind window and how much of the retry budget a flapping or
        shedding server has consumed."""
        return {"aimd": self._bind_aimd.report(),
                "retryBudgetSaturation":
                    round(self._retry_budget.saturation(), 3),
                "limiterSaturation": round(self.limiter.saturation(), 3)}

    def create_list(self, kind: str, objs: list[dict]) -> list[dict]:
        """Batch create: one POST carrying a v1 List; per-item results
        ({"code": 201, ...} or {"code": 4xx, "error": ...})."""
        if not objs:
            return []
        resp = self._request("POST", f"/api/v1/{kind}",
                             {"kind": "List", "items": objs})
        return resp.get("results", [])

    # -- list + watch ----------------------------------------------------

    def list(self, kind: str,
             selector: Optional[Callable[[dict], bool]] = None,
             field_selector: str = "") -> tuple[list[dict], int]:
        """``field_selector`` filters SERVER-side (?fieldSelector=...,
        pkg/fields); ``selector`` remains a client-side predicate."""
        path = f"/api/v1/{kind}"
        if field_selector:
            path += "?fieldSelector=" + urllib.parse.quote(field_selector)
        obj = self._request("GET", path)
        items = obj.get("items") or []
        if selector is not None:
            items = [o for o in items if selector(o)]
        rv = int((obj.get("metadata") or {}).get("resourceVersion", "0"))
        return items, rv

    def watch(self, kind: str, from_rv: int,
              field_selector: str = "",
              frames: Optional[bool] = None) -> "HTTPWatcher":
        """Open a chunked watch stream; TooOldError on 410 forces relist.
        With ``field_selector`` the server applies set-transition
        semantics (an object leaving the set arrives as DELETED).
        ``frames`` requests the framed multi-event encoding (default
        from the KT_WATCH_FRAMES knob): servers that support it batch
        queued events
        into one length-prefixed JSON doc per write; servers that don't
        ignore the parameter and the NDJSON decode path still applies."""
        self.limiter.accept()
        url = (f"{self.base_url}/api/v1/{kind}?watch=1"
               f"&resourceVersion={from_rv}")
        if field_selector:
            url += "&fieldSelector=" + urllib.parse.quote(field_selector)
        if frames if frames is not None else WATCH_FRAMES:
            url += "&frames=1"
        return HTTPWatcher(url, kind, token=self.token, tls=self.tls)


# Framed multi-event watch encoding requested by default (read once at
# import: knobs are never read per drain).
WATCH_FRAMES = knobs.get_bool("KT_WATCH_FRAMES")

# A healthy watch stream carries a server heartbeat every ~10 s
# (apiserver/server.py WATCH_HEARTBEAT_PERIOD); a read deadline several
# periods long therefore only fires on a genuinely dead socket — the pump
# then surfaces ERROR and the reflector relists instead of hanging forever
# (the reference bounds watches the same way, reflector.go timeout).
WATCH_READ_DEADLINE = 45.0


class HTTPWatcher:
    """Reads newline-delimited JSON events off a chunked watch response in a
    thread; ``next(timeout)``/``stop()`` mirror the memstore Watcher so the
    Reflector is transport-agnostic."""

    def __init__(self, url: str, kind: str,
                 read_deadline: float = WATCH_READ_DEADLINE,
                 token: str = "", tls: Optional[TLSConfig] = None):
        self.kind = kind
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._stopped = threading.Event()
        # Wire-attribution children resolved once per stream: the pump
        # flushes decode time per read chunk, never per event.
        from kubernetes_tpu_torch.utils.metrics import (WATCH_DECODE_EVENTS,
                                                  WATCH_DECODE_SECONDS)
        self._m_decode_s = WATCH_DECODE_SECONDS.labels(kind=kind)
        self._m_decode_n = WATCH_DECODE_EVENTS.labels(kind=kind)
        headers = {"Authorization": f"Bearer {token}"} if token else {}
        parsed = urllib.parse.urlsplit(url)
        # The timeout is the per-read socket deadline, not a stream
        # lifetime: heartbeats reset it, so it only fires when the
        # peer stops transmitting entirely (half-open TCP).
        self._conn = _make_connection(
            parsed.scheme or "http", parsed.hostname or "127.0.0.1",
            parsed.port or (443 if parsed.scheme == "https" else 80),
            read_deadline, tls)
        path = parsed.path + ("?" + parsed.query if parsed.query else "")
        self._conn.request("GET", path, headers=headers)
        resp = self._conn.getresponse()
        if resp.status >= 300:
            body = resp.read().decode(errors="replace")
            retry_after = resp.getheader("Retry-After")
            self._conn.close()
            if resp.status == 410:
                raise TooOldError(body)
            try:
                after = float(retry_after) if retry_after else None
            except ValueError:
                after = None
            # A shed watch open (flow-control 429) carries the server's
            # honest Retry-After so the reflector paces its re-open.
            raise APIError(resp.status, body, retry_after=after)
        self._resp = resp
        self._thread = threadreg.spawn(self._pump, name=f"watch-{kind}",
                                       transient=True)

    def _pump(self) -> None:
        # Decode fast path: bulk read1() into ONE reused bytearray and
        # json.loads straight off the line slices, instead of the
        # per-line readline() -> str dance (each line there paid a
        # buffered-readline call plus strip/str copies — reflector-thread
        # GIL time stolen from the solve at density event rates).
        try:
            q_put = self._q.put
            kind = self.kind
            m_decode_s, m_decode_n = self._m_decode_s, self._m_decode_n
            perf_ns = time.perf_counter_ns
            n_emitted = 0

            def emit(d: dict) -> None:
                nonlocal n_emitted
                obj = d.get("object") or {}
                meta = obj.get("metadata") or {}
                ns = meta.get("namespace")
                key = f"{ns}/{meta.get('name')}" if ns \
                    else meta.get("name")
                q_put(Event(
                    type=d.get("type", ""), kind=kind, key=key or "",
                    object=obj,
                    rv=int(meta.get("resourceVersion", "0") or "0")))
                n_emitted += 1

            buf = bytearray()
            while True:
                chunk = self._resp.read1(65536)
                if not chunk or self._stopped.is_set():
                    break
                buf += chunk
                # Per-CHUNK decode accounting (wire attribution):
                # one clock read pair + at most two counter updates per
                # read1 chunk, amortized across every event it carried.
                t_chunk = perf_ns()
                n_before = n_emitted
                start = 0
                while True:
                    # Framed batch: '=<len>\n' then exactly len bytes of
                    # {"items":[...]} and a closing newline.  ONE
                    # json.loads decodes the whole batch, and the length
                    # prefix slices it without rescanning a large buffer
                    # for newlines.
                    if start < len(buf) and buf[start] == 0x3d:  # '='
                        nl = buf.find(b"\n", start)
                        if nl < 0:
                            break
                        n = int(bytes(memoryview(buf)[start + 1:nl]))
                        body_start = nl + 1
                        if len(buf) < body_start + n + 1:
                            break  # frame body still in flight
                        d = json.loads(
                            bytes(memoryview(buf)[body_start:
                                                  body_start + n]))
                        start = body_start + n + 1
                        for item in d.get("items") or ():
                            emit(item)
                        continue
                    nl = buf.find(b"\n", start)
                    if nl < 0:
                        break
                    end = nl - 1 if nl > start and buf[nl - 1] == 0x0d \
                        else nl  # trim one \r without a strip() copy
                    line = bytes(memoryview(buf)[start:end])
                    start = nl + 1
                    if not line:
                        continue  # heartbeat
                    emit(json.loads(line))
                if start:
                    del buf[:start]
                m_decode_s.inc((perf_ns() - t_chunk) / 1e9)
                if n_emitted != n_before:
                    m_decode_n.inc(n_emitted - n_before)
        except Exception:  # noqa: BLE001 — stream died: deliver EOF
            pass
        finally:
            # EOF: a typed ERROR event (not None, which next() also returns
            # on timeout) tells the reflector to drop the stream and relist.
            self._q.put(Event(type="ERROR", kind=self.kind, key="",
                              object={}, rv=0))

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._stopped.set()
        # Shut the socket down FIRST: the pump thread is usually blocked
        # in recv() holding the response's buffer lock, and resp.close()
        # waits on that lock — without the shutdown, stop() stalls until
        # the next server heartbeat (up to WATCH_HEARTBEAT_PERIOD).
        # shutdown() wakes the blocked read with EOF immediately.
        try:
            sock = getattr(self._conn, "sock", None)
            if sock is not None:
                sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._resp.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001
            pass

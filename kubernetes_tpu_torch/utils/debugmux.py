"""The shared daemon debug mux (app/server.go:93-109's shape).

Counterpart of ``kubernetes_tpu/utils/debugmux.py``.

Every reference binary serves the same status surface: /healthz, /metrics,
/configz, and a /debug tree (pprof).  Here that surface is one helper so
the scheduler, controller-manager and any future daemon expose identical
routes — including the span tracer's ``/debug/traces`` (Chrome trace-event
JSON, loadable in Perfetto) and the ``/debug/pprof`` thread-dump analogue.

``serve_status_mux`` builds and starts the server; ``common_route``
resolves the shared routes for servers with their own HTTP loop (the
hand-parsed apiserver, the extender's BaseHTTPRequestHandler).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from kubernetes_tpu_torch.utils import trace
from kubernetes_tpu_torch.utils.metrics import (expose_registry,
                                                expose_registry_openmetrics)

OPENMETRICS_CTYPE = "application/openmetrics-text; version=1.0.0; " \
                    "charset=utf-8"


def common_route(path: str,
                 metrics_fn: Optional[Callable[[], str]] = None,
                 query: str = "",
                 openmetrics_fn: Optional[Callable[[], str]] = None
                 ) -> Optional[tuple[int, bytes, str]]:
    """Resolve a shared status route to (code, body, content-type), or
    None when the path is not one of ours.  ``metrics_fn`` overrides the
    default-registry exposition (daemons with their own metric set);
    ``openmetrics_fn`` likewise for ``/metrics?format=openmetrics``,
    the exemplar-carrying rendering."""
    if path == "/healthz":
        return 200, b"ok", "text/plain"
    if path == "/metrics":
        if "format=openmetrics" in query:
            text = (openmetrics_fn or expose_registry_openmetrics)()
            return 200, text.encode(), OPENMETRICS_CTYPE
        text = (metrics_fn or expose_registry)()
        return 200, text.encode(), "text/plain"
    if path == "/debug/traces":
        return 200, trace.to_chrome_trace().encode(), "application/json"
    if path == "/debug/timeseries":
        from kubernetes_tpu_torch.utils import telemetry
        return (200, telemetry.timeseries_json().encode(),
                "application/json")
    if path == "/debug/dashboard":
        from kubernetes_tpu_torch.utils import telemetry
        return (200, telemetry.dashboard_html().encode(),
                "text/html; charset=utf-8")
    if path.startswith("/debug/pprof"):
        from kubernetes_tpu_torch.utils.profiling import thread_stacks
        return 200, thread_stacks().encode(), "text/plain"
    if path == "/debug/profile":
        from kubernetes_tpu_torch.utils import profiler
        resolved = profiler.render(query)
        if resolved is None:
            # Disabled is a client-visible state, not a server fault.
            return 404, b"profiling disabled (KT_PROF=0)", "text/plain"
        body, ctype = resolved
        return 200, body, ctype
    return None


def serve_status_mux(port: int = 0, host: str = "127.0.0.1",
                     metrics_fn: Optional[Callable[[], str]] = None,
                     configz: Optional[dict] = None,
                     extra: Optional[dict[str, Callable]] = None,
                     name: str = "status-http") -> ThreadingHTTPServer:
    """Start a daemon status server in a thread.  ``extra`` maps a path
    prefix to ``handler(path, query_string) -> (code, body, ctype)`` for
    daemon-specific routes (the scheduler's decisions endpoint)."""
    extra = extra or {}
    # The self-scrape ring behind /debug/timeseries + /debug/dashboard
    # starts with the mux: a daemon that serves the routes also samples.
    from kubernetes_tpu_torch.utils import profiler, telemetry
    telemetry.ensure_started()
    # Same deal for the kt-prof sampler (one branch when KT_PROF=0):
    # continuous profiling starts with the daemon, not the first scrape.
    profiler.ensure_started()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "text/plain") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if configz is not None and path == "/configz":
                self._send(200, json.dumps(configz).encode(),
                           "application/json")
                return
            for prefix, handler in extra.items():
                if path == prefix or path.startswith(prefix + "/"):
                    self._send(*handler(path, query))
                    return
            resolved = common_route(path, metrics_fn, query=query)
            if resolved is None:
                self._send(404, b"not found")
            else:
                self._send(*resolved)

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=name).start()
    return server

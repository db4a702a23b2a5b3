"""The shared daemon status routes (app/server.go:93-109's shape).

Counterpart of ``kubernetes_tpu/utils/debugmux.py`` for the servers this
package has (the extender sidecar): ``common_route`` resolves /healthz,
/metrics (Prometheus text, or OpenMetrics with
``?format=openmetrics``) and the span tracer's ``/debug/traces``
(Chrome trace-event JSON, loadable in Perfetto).

The routes backed by the self-scrape telemetry ring and the sampling
profiler (/debug/timeseries, /debug/dashboard, /debug/pprof*,
/debug/profile) answer 501: this package has neither yet.
"""

from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch.utils import trace
from kubernetes_tpu_torch.utils.metrics import (expose_registry,
                                                expose_registry_openmetrics)

OPENMETRICS_CTYPE = "application/openmetrics-text; version=1.0.0; " \
                    "charset=utf-8"

NOT_PORTED = (501, b"not ported to kubernetes_tpu_torch (telemetry and "
                   b"profiler routes)", "text/plain")


def common_route(path: str,
                 metrics_fn: Optional[Callable[[], str]] = None,
                 query: str = "",
                 openmetrics_fn: Optional[Callable[[], str]] = None
                 ) -> Optional[tuple[int, bytes, str]]:
    """Resolve a shared status route to (code, body, content-type), or
    None when the path is not one of ours.  ``metrics_fn`` overrides the
    default-registry exposition (daemons with their own metric set);
    ``openmetrics_fn`` likewise for ``/metrics?format=openmetrics``."""
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
    if path in ("/debug/timeseries", "/debug/dashboard",
                "/debug/profile") or path.startswith("/debug/pprof"):
        return NOT_PORTED
    return None

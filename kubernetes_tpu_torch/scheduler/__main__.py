"""The standalone scheduler daemon binary on PyTorch.

``python -m kubernetes_tpu_torch.scheduler --device cuda`` is the
counterpart of ``python -m kubernetes_tpu.scheduler`` (itself the
analogue of plugin/cmd/kube-scheduler, app/server.go:71-183): the flag
surface (options/options.go:55-77) plus ``--device``, the policy-file
load (server.go:165-183), feature gates and ``--config``, an HTTP mux
serving /healthz, /metrics and /configz (server.go:93-109) with the
flight recorder, the span ring, /debug/vars, the telemetry ring
(/debug/timeseries, /debug/dashboard), the thread dump (/debug/pprof) and
the sampling CPU profiler (/debug/profile), and an optional
leader-election-wrapped run on an Endpoints annotation lease
(server.go:142-159).  ``--api-server URL`` schedules a separate
apiserver over HTTP list/watch/bind; without it the daemon runs against
a fresh in-process ``MemStore``, exposed over HTTP with
``--serve-apiserver PORT`` (the all-in-one dev mode).

``--device`` defaults to ``cuda`` and the daemon exits with an error
without a card; ``--device cpu`` must be asked for.  ``--profile-dir
DIR`` (or ``KT_PROFILE_DIR``) writes a ``torch.profiler`` Chrome trace of
every device solve into DIR (``utils/profiling.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import (cluster_autoscaler_provider,
                                             default_provider,
                                             policy_from_json)
from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
from kubernetes_tpu_torch.utils import threadreg
from kubernetes_tpu_torch.utils.leaderelection import (APIResourceLock,
                                                       LeaderElector)
from kubernetes_tpu_torch.utils.logging import configure, get_logger

log = get_logger("scheduler")

DEFAULT_PORT = 10251  # options/options.go:49 SchedulerDefaultPort

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kube-scheduler (kubernetes_tpu_torch)",
        description="Batched scheduler daemon on PyTorch; watches an "
                    "apiserver and binds pods (plugin/cmd/kube-scheduler "
                    "analogue)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; the "
                        "daemon exits without a card unless 'cpu' is "
                        "asked for)")
    p.add_argument("--api-server", default="",
                   help="apiserver base URL; empty runs an in-process "
                        "MemStore control plane")
    p.add_argument("--serve-apiserver", type=int, default=0, metavar="PORT",
                   help="with no --api-server: also expose the in-process "
                        "store over HTTP on this port (0 = off)")
    p.add_argument("--port", type=int, default=DEFAULT_PORT,
                   help="healthz/metrics/configz port (0 = ephemeral)")
    p.add_argument("--algorithm-provider", default="DefaultProvider",
                   choices=["DefaultProvider", "ClusterAutoscalerProvider"])
    p.add_argument("--policy-config-file", default="",
                   help="scheduler policy JSON (overrides the provider)")
    p.add_argument("--scheduler-name", default=api.DEFAULT_SCHEDULER_NAME)
    p.add_argument("--kube-api-qps", type=float, default=50.0)
    p.add_argument("--kube-api-burst", type=int, default=100)
    p.add_argument("--kube-api-token", default="",
                   help="bearer token for an authenticated apiserver")
    from kubernetes_tpu_torch.client.http import TLSConfig
    TLSConfig.add_flags(p)
    p.add_argument("--hard-pod-affinity-symmetric-weight", type=int,
                   default=None)
    p.add_argument("--leader-elect", action="store_true", default=False)
    p.add_argument("--leader-elect-lease-duration", type=float, default=15.0)
    p.add_argument("--leader-elect-renew-deadline", type=float, default=10.0)
    p.add_argument("--leader-elect-retry-period", type=float, default=2.0)
    p.add_argument("--v", type=int, default=None,
                   help="log verbosity (glog-style; also KT_LOG_V)")
    p.add_argument("--profile-dir", default="",
                   help="write torch.profiler Chrome traces of every "
                        "device solve here (also KT_PROFILE_DIR; view in "
                        "Perfetto)")
    p.add_argument("--config", default="",
                   help="KubeSchedulerConfiguration JSON file "
                        "(componentconfig/types.go:426-457); explicit "
                        "flags override file values")
    p.add_argument("--feature-gates", default="",
                   help="comma-separated Name=true|false pairs "
                        "(BatchBindings, StreamingDrain, JointSolver, "
                        "Preemption, GangScheduling)")
    return p


def apply_component_config(p: argparse.ArgumentParser, argv):
    """--config provides flag DEFAULTS, explicit flags override (the
    reference's scheme-defaults-then-flags order).  Returns parsed opts
    with the validated config folded in."""
    pre, _ = p.parse_known_args(argv)
    if pre.config:
        from kubernetes_tpu_torch.api.componentconfig import (
            KubeSchedulerConfiguration)
        with open(pre.config) as f:
            cfg = KubeSchedulerConfiguration.from_json(f.read())
        errors = cfg.validate()
        if errors:
            raise SystemExit("invalid --config: " + "; ".join(errors))
        p.set_defaults(
            port=cfg.port,
            algorithm_provider=cfg.algorithm_provider,
            policy_config_file=cfg.policy_config_file,
            scheduler_name=cfg.scheduler_name,
            kube_api_qps=cfg.kube_api_qps,
            kube_api_burst=cfg.kube_api_burst,
            hard_pod_affinity_symmetric_weight=(
                cfg.hard_pod_affinity_symmetric_weight),
            feature_gates=cfg.feature_gates,
            enable_profiling=cfg.enable_profiling,
            leader_elect=cfg.leader_election.leader_elect,
            leader_elect_lease_duration=cfg.leader_election.lease_duration,
            leader_elect_renew_deadline=cfg.leader_election.renew_deadline,
            leader_elect_retry_period=cfg.leader_election.retry_period)
    opts = p.parse_args(argv)
    if not hasattr(opts, "enable_profiling"):
        opts.enable_profiling = True  # reference scheduler default
    return opts


def load_policy(opts):
    """createConfig (server.go:165-183): policy file beats provider; file
    policies are validated (CreateFromConfig -> validation.ValidatePolicy)."""
    if opts.policy_config_file:
        from kubernetes_tpu_torch.api.validation import validate_policy
        with open(opts.policy_config_file) as f:
            policy = policy_from_json(f.read())
        validate_policy(policy)
    elif opts.algorithm_provider == "ClusterAutoscalerProvider":
        policy = cluster_autoscaler_provider()
    else:
        policy = default_provider()
    if opts.hard_pod_affinity_symmetric_weight is not None:
        policy.hard_pod_affinity_symmetric_weight = \
            opts.hard_pod_affinity_symmetric_weight
    return policy


def _decisions_route(daemon, query: str) -> tuple[int, bytes, str]:
    """/debug/scheduler/decisions: the flight recorder's batch ring;
    ``?pod=ns/name`` explains one pod's latest decision (chosen node, or
    per-predicate failure counts and top-scoring candidates);
    ``?tenant=name`` filters batch summaries to one tenant's rows (the
    multi-tenant service's per-tenant decision history)."""
    from urllib.parse import parse_qs
    recorder = daemon.config.flight_recorder
    if recorder is None:
        return 404, b"flight recorder disabled", "text/plain"
    q = parse_qs(query)
    pod = q.get("pod", [""])[0]
    if pod:
        decision = recorder.explain(pod)
        if decision is None:
            return (404,
                    json.dumps({"pod": pod,
                                "error": "no recorded decision"}).encode(),
                    "application/json")
        return 200, json.dumps(decision).encode(), "application/json"
    try:
        limit = int(q.get("limit", ["0"])[0] or "0")
    except ValueError:
        return (400, b'{"error": "limit must be an integer"}',
                "application/json")
    tenant = q.get("tenant", [""])[0]
    return (200, json.dumps(recorder.snapshot(
        limit=limit, tenant=tenant)).encode(), "application/json")


def debug_vars(factory: ConfigFactory) -> dict:
    """The /debug/vars payload."""
    from kubernetes_tpu_torch.engine import devicestats, fused, scan
    from kubernetes_tpu_torch.ops import combine
    from kubernetes_tpu_torch.utils.metrics import (
        CACHE_INVARIANT_VIOLATIONS, POST_PREWARM_COMPILES)
    cache = factory.algorithm.cache
    queue = factory.daemon.queue
    return {
        "device": str(factory.algorithm.device),
        "queueDepth": len(queue),
        "queueHighWatermark": queue.high_watermark,
        "queuePeakDepth": queue.peak_depth,
        "degraded": queue.degraded(),
        "batchDeadlineMs": round(
            factory.daemon.pipeline.former.deadline_s * 1e3, 1),
        "batchFormerTarget": factory.daemon.pipeline.former.target,
        "prewarmCacheStats": factory.daemon.prewarm_cache_stats,
        "slo": factory.slo.report(),
        # The device-fault plane: breaker state, last classified fault,
        # bisect cap, gate rejects (engine/guard.py).
        "engine": factory.algorithm.guard.report(),
        "postPrewarmCompiles": POST_PREWARM_COMPILES.value,
        # This process's kernel launches (each wrapper's own count) and
        # the device memory peak: several daemons on one card are told
        # apart by these.
        "kernelLaunches": {"scan_chunk": scan.scan_chunk.launches,
                           "select_rows": fused.select_rows.launches,
                           "select_hosts": combine.select_hosts.launches},
        "hbmPeakBytes": devicestats.hbm_peak_bytes(),
        "invariantViolations": CACHE_INVARIANT_VIOLATIONS.value,
        "lastRecovery": factory.last_recovery,
        # Active-active HA (scheduler/shards.py): this incarnation's id,
        # the shards it holds, and the recent shard-takeover reconciles;
        # null when running single-scheduler (KT_HA_SHARDS=0).
        "ha": (factory.shards.report()
               if factory.shards is not None else None),
        # The multi-tenant solver service (tenancy/): per-tenant
        # mode/weights/trips/fault attribution; null when KT_TENANTS is
        # unset.
        "tenancy": (factory.tenancy.report()
                    if factory.tenancy is not None else None),
        "shardRecoveries": factory.shard_recoveries[-8:],
        # Client-side backpressure against a shedding apiserver
        # (utils/flowcontrol.py): the AIMD bind window and the retry
        # budget's saturation; null when the store is in-process.
        "overload": (factory.store.flow_report()
                     if hasattr(factory.store, "flow_report") else None),
        "cachedPods": cache.pod_count(),
        "cachedNodes": len(cache.nodes()),
        "cacheStats": cache.stats,
        "generation": cache.generation,
    }


def status_mux(factory: ConfigFactory, configz: dict, port: int
               ) -> ThreadingHTTPServer:
    """The daemon's own HTTP surface (server.go:93-109)."""
    from kubernetes_tpu_torch.utils import profiler, telemetry
    from kubernetes_tpu_torch.utils.debugmux import common_route
    metrics = factory.daemon.config.metrics
    # Self-scrape ring: the daemon-scoped metric set (queue depth, batch
    # size, attempts) rides the ring next to the default registry so the
    # dashboard's queue/stage/SLO sparklines have their sources.
    telemetry.ensure_started(metrics.all_metrics())
    # kt-prof rides the same lifecycle: sampling starts with the mux so
    # the profile covers the daemon's whole life (KT_PROF=0 = no-op).
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
            if path.startswith("/debug/pprof") and \
                    not configz.get("enableProfiling", True):
                # EnableProfiling=false removes the handlers, as the
                # reference's mux does (server.go:96).
                self._send(404, b"profiling disabled")
                return
            shared = common_route(path, metrics_fn=metrics.expose,
                                  query=query,
                                  openmetrics_fn=metrics.expose_openmetrics)
            if shared is not None:
                self._send(*shared)
            elif path == "/configz":
                self._send(200, json.dumps(configz).encode(),
                           "application/json")
            elif path == "/debug/scheduler/decisions":
                self._send(*_decisions_route(factory.daemon, query))
            elif path == "/debug/vars":
                self._send(200, json.dumps(debug_vars(factory)).encode(),
                           "application/json")
            elif path == "/tenancy":
                if factory.tenancy is None:
                    self._send(404, b"tenancy disabled")
                else:
                    self._send(200,
                               json.dumps(factory.tenancy.report())
                               .encode(), "application/json")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            # The solver-service boundary over the daemon's existing
            # HTTP surface: with KT_TENANTS set, other control planes
            # POST /solve {tenant, pods:[...]} and get placements from
            # THIS daemon's device (tenancy/service.solve_route).
            path = self.path.partition("?")[0]
            if path != "/solve":
                self._send(404, b"not found")
                return
            if factory.tenancy is None:
                self._send(404, b"tenancy disabled")
                return
            try:
                clen = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                clen = 0
            body = self.rfile.read(clen) if clen else b""
            from kubernetes_tpu_torch.tenancy.service import solve_route
            self._send(*solve_route(factory.tenancy, body))

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threadreg.spawn(server.serve_forever, name="scheduler-status-http")
    return server


def main(argv=None) -> int:
    opts = apply_component_config(build_parser(), argv)
    configure(v=opts.v)
    if opts.profile_dir:
        from kubernetes_tpu_torch.utils.profiling import set_profile_dir
        set_profile_dir(opts.profile_dir)
    from kubernetes_tpu_torch.utils import featuregate
    try:
        gates = featuregate.FeatureGate.parse(opts.feature_gates)
    except ValueError as err:
        raise SystemExit(f"--feature-gates: {err}")
    featuregate.set_default(gates)
    policy = load_policy(opts)
    configz = {
        "apiServer": opts.api_server or "(in-process)",
        "device": opts.device,
        "algorithmProvider": opts.algorithm_provider,
        "policyConfigFile": opts.policy_config_file,
        "schedulerName": opts.scheduler_name,
        "kubeAPIQPS": opts.kube_api_qps,
        "kubeAPIBurst": opts.kube_api_burst,
        "leaderElect": opts.leader_elect,
        "featureGates": gates.as_dict(),
        "enableProfiling": getattr(opts, "enable_profiling", True),
        "predicates": [s.name for s in policy.predicates],
        "priorities": [[s.name, s.weight] for s in policy.priorities],
    }
    if opts.api_server:
        from kubernetes_tpu_torch.client.http import APIClient, TLSConfig
        source = APIClient(opts.api_server, qps=opts.kube_api_qps,
                           burst=opts.kube_api_burst,
                           token=opts.kube_api_token,
                           tls=TLSConfig.from_opts(opts))
    else:
        from kubernetes_tpu_torch.apiserver.memstore import MemStore
        source = MemStore()
        if opts.serve_apiserver:
            from kubernetes_tpu_torch.apiserver.server import serve
            serve(source, port=opts.serve_apiserver)
            log.info("in-process apiserver on :%d", opts.serve_apiserver)

    # source is a ready APIClient (credentials + TLS) or a MemStore;
    # qps/burst still feed the factory's event-sink rate bucket.
    try:
        factory = ConfigFactory(source, policy=policy,
                                scheduler_name=opts.scheduler_name,
                                qps=opts.kube_api_qps,
                                burst=opts.kube_api_burst,
                                device=opts.device)
    except RuntimeError as err:
        raise SystemExit(f"--device {opts.device}: {err}")
    mux = status_mux(factory, configz, opts.port)
    log.info("status http on :%d (healthz, metrics, configz)",
             mux.server_address[1])
    # The bound port on stdout, for callers that asked for --port 0.
    print(json.dumps({"port": mux.server_address[1]}), flush=True)

    stop = threading.Event()

    def shutdown(*_):
        stop.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    if opts.leader_elect:
        identity = f"{socket.gethostname()}-{os.getpid()}"
        lock = APIResourceLock(factory.store) if opts.api_server else None
        if lock is None:
            log.warning("--leader-elect without --api-server: using an "
                        "in-process lock (single candidate)")
            from kubernetes_tpu_torch.utils.leaderelection import \
                InMemoryLock
            lock = InMemoryLock()
        elector = LeaderElector(
            lock=lock, identity=identity,
            lease_duration=opts.leader_elect_lease_duration,
            renew_deadline=opts.leader_elect_renew_deadline,
            retry_period=opts.leader_elect_retry_period,
            on_started_leading=lambda: (log.info("leading as %s", identity),
                                        factory.run()),
            on_stopped_leading=lambda: (log.warning("lost lease; exiting"),
                                        stop.set()))
        elector.run()
        log.info("leader election: candidate %s", identity)
    else:
        factory.run()
        log.info("scheduler loop running on %s (no leader election)",
                 factory.algorithm.device)
    stop.wait()
    factory.stop()
    mux.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

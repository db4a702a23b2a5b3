"""kube-controller-manager analogue: the control loops that keep desired
state true (cmd/kube-controller-manager) — the replication manager
(RCs + ReplicaSets), the deployment controller (rolling updates), the
node lifecycle controller, and the endpoints controller.

Like the reference (cmd/kube-controller-manager/app/controllermanager.go:
171-189 wraps every loop in leaderelection.RunOrDie), ``--leader-elect``
gates the loops behind an annotation-CAS lease on
kube-system/kube-controller-manager so two replicas never both act —
without it, two controller-managers would double-create replicas and
double-evict nodes.

    python -m kubernetes_tpu_torch.controller --api-server http://... \
        [--leader-elect]
"""

# A copy of ``kubernetes_tpu/controller/__main__.py`` with its imports
# pointed at this package; the docstring is the program's --help text,
# so it stays the reference's.

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading

from kubernetes_tpu_torch.client.http import (DEFAULT_BURST, DEFAULT_QPS,
                                        APIClient, TLSConfig)
from kubernetes_tpu_torch.controller.daemonset import DaemonSetController
from kubernetes_tpu_torch.controller.deployment import DeploymentController
from kubernetes_tpu_torch.controller.disruption import DisruptionController
from kubernetes_tpu_torch.controller.endpoints import EndpointsController
from kubernetes_tpu_torch.controller.garbagecollector import GarbageCollector
from kubernetes_tpu_torch.controller.job import JobController
from kubernetes_tpu_torch.controller.namespace import NamespaceController
from kubernetes_tpu_torch.controller.node import NodeLifecycleController
from kubernetes_tpu_torch.controller.petset import PetSetController
from kubernetes_tpu_torch.controller.podautoscaler import (
    HorizontalPodAutoscaler)
from kubernetes_tpu_torch.controller.podgc import PodGCController
from kubernetes_tpu_torch.controller.replication import ReplicationManager
from kubernetes_tpu_torch.controller.resourcequota import (
    ResourceQuotaController)
from kubernetes_tpu_torch.controller.scheduledjob import ScheduledJobController
from kubernetes_tpu_torch.controller.serviceaccounts import (
    ServiceAccountsController)
from kubernetes_tpu_torch.utils.logging import configure, get_logger

log = get_logger("controller-manager")


def status_mux(port: int = 10252):
    """The controller-manager's status surface (the reference serves
    healthz/metrics on 10252): default-registry metrics — every client
    retry/relist counter the control loops feed — plus /debug/traces and
    the /debug/pprof thread dump."""
    from kubernetes_tpu_torch.utils.debugmux import serve_status_mux
    return serve_status_mux(port=port, name="controller-status-http")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kube-controller-manager (kubernetes_tpu_torch)",
        description=__doc__)
    p.add_argument("--api-server", required=True)
    p.add_argument("--node-monitor-grace-period", type=float, default=40.0)
    p.add_argument("--pod-eviction-timeout", type=float, default=60.0)
    p.add_argument("--terminated-pod-gc-threshold", type=int, default=1000,
                   help="delete the oldest terminated pods beyond this "
                        "count (gc_controller.go)")
    p.add_argument("--kube-api-token", default="",
                   help="bearer token for an authenticated apiserver")
    TLSConfig.add_flags(p)
    p.add_argument("--leader-elect", action="store_true",
                   help="gate the control loops behind a leader lease "
                        "(controllermanager.go:171-189)")
    p.add_argument("--leader-elect-lease-duration", type=float, default=15.0)
    p.add_argument("--leader-elect-renew-deadline", type=float, default=10.0)
    p.add_argument("--leader-elect-retry-period", type=float, default=2.0)
    p.add_argument("--port", type=int, default=10252,
                   help="healthz/metrics/debug status port (the "
                        "reference controller-manager's 10252; 0 = "
                        "ephemeral, -1 = off)")
    p.add_argument("--v", type=int, default=None)
    opts = p.parse_args(argv)
    configure(v=opts.v)

    mux = None
    if opts.port >= 0:
        mux = status_mux(opts.port)
        log.info("status http on :%d (healthz, metrics, debug/traces)",
                 mux.server_address[1])

    tok = opts.kube_api_token
    controllers: list = []
    stop = threading.Event()

    tls = TLSConfig.from_opts(opts)

    def client(qps: float = DEFAULT_QPS,
               burst: int = DEFAULT_BURST) -> APIClient:
        """One APIClient per controller (own rate bucket), all carrying
        the daemon's credentials + TLS config — the restclient.Config
        every loop copies in the reference controller-manager."""
        return APIClient(opts.api_server, qps=qps, burst=burst,
                         token=tok, tls=tls)

    def start_controllers() -> None:
        controllers.append(ReplicationManager(client()).run())
        controllers.append(DeploymentController(client()).run())
        controllers.append(NodeLifecycleController(
            client(),
            monitor_grace=opts.node_monitor_grace_period,
            eviction_timeout=opts.pod_eviction_timeout).run())
        controllers.append(EndpointsController(client()).run())
        controllers.append(NamespaceController(client()).run())
        controllers.append(DaemonSetController(client()).run())
        controllers.append(JobController(client()).run())
        controllers.append(PodGCController(
            client(),
            threshold=opts.terminated_pod_gc_threshold).run())
        controllers.append(HorizontalPodAutoscaler(client()).run())
        controllers.append(DisruptionController(client()).run())
        controllers.append(ScheduledJobController(client()).run())
        controllers.append(PetSetController(client()).run())
        controllers.append(ResourceQuotaController(client()).run())
        controllers.append(
            GarbageCollector(client(qps=200, burst=400)).run())
        controllers.append(ServiceAccountsController(client()).run())
        log.info("controller-manager running (replication + deployment + "
                 "node lifecycle + endpoints + namespace + daemonset + "
                 "job + podgc + hpa + disruption + scheduledjob + "
                 "petset + resourcequota + gc + serviceaccounts)")

    elector = None
    if opts.leader_elect:
        from kubernetes_tpu_torch.utils.leaderelection import (APIResourceLock,
                                                         LeaderElector)
        identity = f"{socket.gethostname()}-{os.getpid()}"
        lock = APIResourceLock(
            client(),
            name="kube-controller-manager")
        elector = LeaderElector(
            lock=lock, identity=identity,
            lease_duration=opts.leader_elect_lease_duration,
            renew_deadline=opts.leader_elect_renew_deadline,
            retry_period=opts.leader_elect_retry_period,
            on_started_leading=lambda: (
                log.info("leading as %s", identity), start_controllers()),
            # A lost lease must not leave two actors: this replica exits
            # and its supervisor restarts it as a standby (the reference
            # leaderelection.RunOrDie is likewise fatal on loss).
            on_stopped_leading=lambda: (
                log.warning("lost leader lease; exiting"), stop.set()))
        elector.run()
        log.info("leader election: candidate %s", identity)
    else:
        start_controllers()

    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    if elector is not None:
        elector.stop()
    for c in controllers:
        c.stop()
    if mux is not None:
        mux.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

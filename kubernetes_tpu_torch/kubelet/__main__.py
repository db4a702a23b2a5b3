"""Hollow-kubelet binary (cmd/kubemark hollow-node --morph=kubelet):

    python -m kubernetes_tpu_torch.kubelet --api-server http://... \
        --node-name hollow-1 [--cpu 4000] [--memory-gib 32] [--pods 110]
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.kubelet.kubelet import HollowKubelet
from kubernetes_tpu_torch.utils.logging import configure, get_logger

log = get_logger("kubelet")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kubelet (kubernetes_tpu_torch, hollow)",
                                description=__doc__)
    p.add_argument("--api-server", required=True)
    p.add_argument("--node-name", required=True)
    p.add_argument("--cpu", type=int, default=4000, help="milli-CPU")
    p.add_argument("--memory-gib", type=int, default=32)
    p.add_argument("--pods", type=int, default=110)
    p.add_argument("--label", action="append", default=[],
                   metavar="K=V", help="node label (repeatable)")
    p.add_argument("--heartbeat-period", type=float, default=10.0)
    p.add_argument("--kube-api-token", default="",
                   help="bearer token for an authenticated apiserver")
    from kubernetes_tpu_torch.client.http import APIClient, TLSConfig
    TLSConfig.add_flags(p)
    p.add_argument("--v", type=int, default=None)
    opts = p.parse_args(argv)
    configure(v=opts.v)

    labels = {api.HOSTNAME_LABEL: opts.node_name}
    for kv in opts.label:
        k, _, v = kv.partition("=")
        labels[k] = v
    node = api.Node(
        name=opts.node_name, labels=labels,
        allocatable_milli_cpu=opts.cpu,
        allocatable_memory=opts.memory_gib * 1024 ** 3,
        allocatable_pods=opts.pods,
        conditions=[api.NodeCondition("Ready", "True")])
    source = APIClient(opts.api_server, token=opts.kube_api_token,
                       tls=TLSConfig.from_opts(opts))
    kubelet = HollowKubelet(source, node,
                            heartbeat_period=opts.heartbeat_period).run()
    log.info("hollow kubelet %s running", opts.node_name)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    kubelet.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

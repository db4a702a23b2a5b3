"""Hollow kube-proxy binary (cmd/kubemark --morph=proxy):

    python -m kubernetes_tpu_torch.proxy --api-server http://...
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from kubernetes_tpu_torch.proxy.proxy import HollowProxy
from kubernetes_tpu_torch.utils.logging import configure, get_logger

log = get_logger("kube-proxy")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kube-proxy (kubernetes_tpu_torch, hollow)",
                                description=__doc__)
    p.add_argument("--api-server", required=True)
    p.add_argument("--kube-api-token", default="",
                   help="bearer token for an authenticated apiserver")
    from kubernetes_tpu_torch.client.http import APIClient, TLSConfig
    TLSConfig.add_flags(p)
    p.add_argument("--v", type=int, default=None)
    opts = p.parse_args(argv)
    configure(v=opts.v)
    proxy = HollowProxy(APIClient(
        opts.api_server, token=opts.kube_api_token,
        tls=TLSConfig.from_opts(opts))).run()
    log.info("hollow kube-proxy running")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

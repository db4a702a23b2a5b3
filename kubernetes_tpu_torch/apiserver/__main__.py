"""Standalone apiserver: ``python -m kubernetes_tpu_torch.apiserver --port 8080``
serves the MemStore-backed HTTP surface (the in-process master the perf rig
uses, run as its own process — test/integration/framework/master_utils.go
RunAMaster's role)."""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.apiserver.server import serve


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kube-apiserver (kubernetes_tpu_torch)")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--token-auth-file", default="",
                   help="CSV token,user,uid[,group1|group2] per line "
                        "(tokenfile authenticator)")
    p.add_argument("--basic-auth-file", default="",
                   help="CSV password,user,uid[,group1|group2] per line "
                        "(HTTP basic authenticator)")
    p.add_argument("--authentication-token-webhook-url", default="",
                   help="TokenReview webhook URL (the reference "
                        "configures it via a kubeconfig file; a flat "
                        "URL here)")
    p.add_argument("--authorization-policy-file", default="",
                   help="ABAC policy file, one JSON object per line")
    p.add_argument("--authorization-webhook-url", default="",
                   help="SubjectAccessReview webhook URL for "
                        "--authorization-mode Webhook")
    p.add_argument("--authorization-mode", default="",
                   choices=["", "ABAC", "RBAC", "Webhook"],
                   help="RBAC authorizes from live Role/RoleBinding/"
                        "ClusterRole/ClusterRoleBinding objects "
                        "(system:masters group bypasses, the bootstrap "
                        "superuser convention); Webhook defers to "
                        "--authorization-webhook-url; default ABAC when "
                        "a policy file is given")
    p.add_argument("--storage-dir", default="",
                   help="durable storage directory (snapshot + WAL): a "
                        "restart recovers objects and the resourceVersion "
                        "counter, like etcd behind the reference apiserver")
    p.add_argument("--storage-fsync", action="store_true",
                   help="fsync the WAL per write (etcd's default "
                        "durability; slower)")
    p.add_argument("--tls-cert-file", default="",
                   help="serve HTTPS with this certificate (the secure "
                        "port)")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument("--client-ca-file", default="",
                   help="verify client certificates against this CA; a "
                        "verified cert's CN/O become the request's "
                        "user/groups (x509 authenticator)")
    p.add_argument("--admission-control", default="",
                   help="comma-separated admission plugins applied in "
                        "order (default: NamespaceLifecycle,"
                        "ServiceAccount,LimitPodHardAntiAffinity"
                        "Topology,LimitRanger,ResourceQuota; also: "
                        "AlwaysPullImages, SecurityContextDeny, "
                        "AlwaysAdmit, AlwaysDeny)")
    opts = p.parse_args(argv)
    # share_events: this process's only consumers are HTTP watch streams
    # (read-only serializers), so events may reference stored objects
    # directly — no per-write deepcopy (see MemStore.__init__).
    store = MemStore(share_events=True,
                     storage_dir=opts.storage_dir or None,
                     fsync=opts.storage_fsync)
    auth = None
    if opts.token_auth_file or opts.basic_auth_file or \
            opts.authentication_token_webhook_url or \
            opts.authorization_policy_file or \
            opts.authorization_mode in ("RBAC", "Webhook"):
        from kubernetes_tpu_torch.apiserver.auth import (
            ABACAuthorizer, AuthConfig, BasicAuthenticator,
            RBACAuthorizer, ServiceAccountAuthenticator,
            TokenAuthenticator, UnionAuthenticator,
            WebhookAuthorizer, WebhookTokenAuthenticator)
        if opts.authorization_mode == "RBAC":
            authorizer = RBACAuthorizer(store)
        elif opts.authorization_mode == "Webhook":
            if not opts.authorization_webhook_url:
                p.error("--authorization-mode Webhook needs "
                        "--authorization-webhook-url")
            authorizer = WebhookAuthorizer(opts.authorization_webhook_url)
        elif opts.authorization_policy_file:
            authorizer = ABACAuthorizer.from_file(
                opts.authorization_policy_file)
        else:
            authorizer = None
        # Union authenticator (the reference's request-auth union):
        # static tokenfile entries, basic-auth passwords, live
        # service-account token secrets and the token-review webhook
        # all authenticate.
        auth = AuthConfig(
            authenticator=UnionAuthenticator(
                TokenAuthenticator.from_file(opts.token_auth_file)
                if opts.token_auth_file else None,
                BasicAuthenticator.from_file(opts.basic_auth_file)
                if opts.basic_auth_file else None,
                ServiceAccountAuthenticator(store),
                WebhookTokenAuthenticator(
                    opts.authentication_token_webhook_url)
                if opts.authentication_token_webhook_url else None),
            authorizer=authorizer,
            # No credential source at all -> the x509-only posture,
            # where a certless, tokenless request is system:anonymous
            # for the authorizer (the secure-port behavior); with any
            # credential source (tokenfile, password file, token
            # webhook), credential-less requests are 401.
            anonymous=not (opts.token_auth_file or
                           opts.basic_auth_file or
                           opts.authentication_token_webhook_url))
    server = serve(store, port=opts.port, host=opts.host, auth=auth,
                   tls_cert=opts.tls_cert_file,
                   tls_key=opts.tls_private_key_file,
                   client_ca=opts.client_ca_file,
                   admission_control=opts.admission_control.split(",")
                   if opts.admission_control else None)
    print(f"apiserver listening on {server.server_address[0]}:"
          f"{server.server_address[1]}", file=sys.stderr, flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.shutdown()
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

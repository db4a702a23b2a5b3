"""The port's HTTP client (``kubernetes_tpu_torch.client.http``) and its
flow control against the JAX package's.

* The port's ``APIClient`` against both packages' apiservers, and the
  JAX package's ``APIClient`` against the port's: ``create_list``,
  ``list`` (plain and field-selected), ``watch`` (framed and NDJSON),
  ``bind_list`` (bound, then CAS 409 per item) and a bindings POST shed
  with 429 + ``Retry-After`` that the client retries — every result
  equal across the three pairings.
* ``TokenBucketRateLimiter`` and ``AIMDLimiter`` against the reference's
  under one fake clock: every answer equal.
* ``TLSConfig`` against the port's apiserver on its secure port, the
  cases of ``tests/test_tls.py``: a certificate's subject is the user
  (``system:masters`` bypasses RBAC, a plain CN needs a binding, no
  certificate is anonymous), a certificate from another CA fails the
  handshake, a plaintext client cannot speak; plus the flags, ``bool``
  and the one shared context.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess

import pytest

from kubernetes_tpu.apiserver import flowcontrol as r_flow
from kubernetes_tpu.apiserver import memstore as r_memstore
from kubernetes_tpu.apiserver import server as r_server
from kubernetes_tpu.client import http as r_http
from kubernetes_tpu.utils import flowcontrol as r_fc
from kubernetes_tpu_torch.apiserver import flowcontrol as t_flow
from kubernetes_tpu_torch.apiserver import memstore as t_memstore
from kubernetes_tpu_torch.apiserver import server as t_server
from kubernetes_tpu_torch.client import http as t_http
from kubernetes_tpu_torch.utils import flowcontrol as t_fc

SERVERS = {"ref": (r_memstore, r_server, r_flow),
           "port": (t_memstore, t_server, t_flow)}
CLIENTS = {"ref": r_http, "port": t_http}
PAIRINGS = [("port", "ref"), ("port", "port"), ("ref", "port")]


class ShedBindings:
    """A flow controller that sheds the first ``n`` bindings POSTs with
    429 + Retry-After and admits everything else."""

    def __init__(self, flow_mod, n: int):
        self.flow_mod = flow_mod
        self.n = n

    def admit(self, method, resource, is_watch, subresource=""):
        if resource == "bindings" and self.n > 0:
            self.n -= 1
            return self.flow_mod.Ticket(False, "test shed", 0.05)
        return self.flow_mod.Ticket(True)

    def report(self) -> dict:
        return {}


@contextlib.contextmanager
def served(side: str, **kw):
    memstore, server, _ = SERVERS[side]
    srv = server.serve(memstore.MemStore(), port=0, **kw)
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def node(name: str) -> dict:
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def pod(name: str) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c"}]}}


def events(w, n: int) -> list[tuple]:
    out = []
    try:
        while len(out) < n:
            ev = w.next(timeout=10)
            assert ev is not None, f"{len(out)} of {n} watch events"
            out.append((ev.type, ev.kind, ev.key, ev.rv,
                        (ev.object.get("spec") or {}).get("nodeName")))
    finally:
        w.stop()
    return out


def session(client_mod, base: str) -> dict:
    c = client_mod.APIClient(base, qps=0)
    out = {}
    out["create nodes"] = [r.get("code") for r in
                           c.create_list("nodes", [node(f"n{i}")
                                                   for i in range(3)])]
    out["create pods"] = [r.get("code") for r in
                          c.create_list("pods", [pod(f"p{i}")
                                                 for i in range(6)]
                                        + [pod("p0")])]
    items, rv = c.list("pods")
    out["list"] = (sorted(o["metadata"]["name"] for o in items), rv)
    out["bind"] = c.bind_list([("default", f"p{i}", f"n{i % 3}")
                               for i in range(4)])
    out["bind again (409)"] = c.bind_list([("default", "p0", "n2"),
                                           ("default", "p1", "n2")])
    out["bind chunked"] = c.bind_list([("default", "p4", "n0"),
                                       ("default", "ghost", "n0")],
                                      chunk_size=1)
    out["list unbound"] = sorted(
        o["metadata"]["name"] for o in
        c.list("pods", field_selector="spec.nodeName=")[0])
    out["watch framed"] = events(c.watch("pods", rv, frames=True), 5)
    out["watch ndjson"] = events(c.watch("pods", rv, frames=False), 5)
    out["watch unbound"] = events(
        c.watch("pods", 0, field_selector="spec.nodeName="), 11)
    out["get"] = c.get("pods", "default/p1")["spec"]["nodeName"]
    out["get missing"] = c.get("pods", "default/nope")
    with pytest.raises(client_mod.APIError) as err:
        c.create("pods", {"metadata": {"name": "bad"},
                          "spec": {"containers": []}})
    out["validation"] = err.value.status
    return out


def test_clients_and_servers_answer_alike():
    got = {}
    for client, server in PAIRINGS:
        with served(server) as base:
            got[(client, server)] = session(CLIENTS[client], base)
    first = got[PAIRINGS[0]]
    assert first["bind"] == [None] * 4
    assert [r[0] for r in first["bind again (409)"]] == [409, 409]
    assert first["bind chunked"][0] is None and \
        first["bind chunked"][1][0] == 404
    assert first["create pods"] == [201] * 6 + [409]
    for pairing in PAIRINGS[1:]:
        assert got[pairing] == first, pairing


@pytest.mark.parametrize("client,server", PAIRINGS)
def test_a_shed_bind_is_retried_after_retry_after(client, server):
    mod = CLIENTS[client]
    _, _, flow_mod = SERVERS[server]
    with served(server, flow=ShedBindings(flow_mod, 1)) as base:
        c = mod.APIClient(base, qps=0)
        c.create_list("nodes", [node("n0")])
        c.create_list("pods", [pod("p0"), pod("p1"), pod("p2")])
        before = mod.metrics.CLIENT_RETRIES.labels(verb="POST").value
        assert c.bind_list([("default", "p0", "n0"),
                            ("default", "p1", "n0"),
                            ("default", "p2", "n0")]) == [None] * 3
        assert mod.metrics.CLIENT_RETRIES.labels(
            verb="POST").value == before + 1
        assert c.flow_report()["aimd"]["throttles"] == 1
        # A shed watch open surfaces the server's Retry-After.
    with served(server, flow=flow_mod.FlowController(
            watch_inflight=0)) as base:
        c = mod.APIClient(base, qps=0)
        with pytest.raises(mod.APIError) as err:
            c.watch("pods", 0)
        assert err.value.status == 429 and err.value.retry_after == 1.0


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


def _bucket_trace(mod) -> list:
    clock = FakeClock()
    b = mod.TokenBucketRateLimiter(4.0, 3, now=clock, sleep=clock.sleep)
    out = []
    for step in range(12):
        out.append(("try", b.try_accept(), round(b.saturation(), 9)))
        if step % 4 == 3:
            b.accept()
            out.append(("accept", clock.t))
        clock.t += 0.1 * (step % 3)
    off = mod.TokenBucketRateLimiter(0, 1, now=clock, sleep=clock.sleep)
    out.append(("off", off.try_accept(), off.saturation()))
    return out


def _aimd_trace(mod) -> list:
    a = mod.AIMDLimiter(min_limit=1, max_limit=4, backoff=0.5)
    out = [a.report()]
    for _ in range(3):
        a.acquire()
    out.append(a.report())
    for op in ("on_throttle", "on_throttle", "on_throttle", "release",
               "on_success", "on_success", "release", "release",
               "on_success"):
        getattr(a, op)()
        out.append((op, a.report(), a.limit(), a.inflight()))
    clamp = mod.AIMDLimiter(min_limit=0, max_limit=0, backoff=2.0)
    out.append(clamp.report())
    return out


def test_flow_limiters_match_the_reference_under_a_fake_clock():
    assert _bucket_trace(t_fc) == _bucket_trace(r_fc)
    assert _aimd_trace(t_fc) == _aimd_trace(r_fc)


# -- TLS, mirroring tests/test_tls.py ---------------------------------------

@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A CA, a server certificate and three client certificates (one in
    system:masters, one plain user, one from another CA), minted with
    the openssl CLI."""
    d = tmp_path_factory.mktemp("pki")

    def sh(*args):
        subprocess.run(args, cwd=d, check=True, timeout=60,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    for ca in ("ca", "evil-ca"):
        sh("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
           "-keyout", f"{ca}.key", "-out", f"{ca}.crt", "-days", "1",
           "-subj", f"/CN={ca}")
    for name, subj, ca in (
            ("server", "/CN=127.0.0.1", "ca"),
            ("admin", "/O=system:masters/CN=cluster-admin", "ca"),
            ("alice", "/CN=alice", "ca"),
            ("mallory", "/O=system:masters/CN=mallory", "evil-ca")):
        sh("openssl", "req", "-newkey", "rsa:2048", "-nodes",
           "-keyout", f"{name}.key", "-out", f"{name}.csr", "-subj", subj)
        ext = d / f"{name}.ext"
        ext.write_text("subjectAltName=IP:127.0.0.1\n"
                       if name == "server" else "basicConstraints=CA:FALSE\n")
        sh("openssl", "x509", "-req", "-in", f"{name}.csr", "-CA",
           f"{ca}.crt", "-CAkey", f"{ca}.key", "-CAcreateserial", "-out",
           f"{name}.crt", "-days", "1", "-extfile", str(ext))
    return d


@pytest.fixture(scope="module")
def secure(pki):
    from kubernetes_tpu_torch.apiserver.auth import AuthConfig, RBACAuthorizer
    store = t_memstore.MemStore()
    srv = t_server.serve(store, port=0,
                         auth=AuthConfig(authorizer=RBACAuthorizer(store),
                                         anonymous=True),
                         tls_cert=str(pki / "server.crt"),
                         tls_key=str(pki / "server.key"),
                         client_ca=str(pki / "ca.crt"))
    yield f"https://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _client(pki, base, cert=""):
    tls = t_http.TLSConfig(ca_file=str(pki / "ca.crt"),
                           cert_file=str(pki / f"{cert}.crt") if cert else "",
                           key_file=str(pki / f"{cert}.key") if cert else "")
    return t_http.APIClient(base, qps=0, tls=tls, max_retries=0)


def _status(fn) -> int:
    try:
        fn()
        return 200
    except t_http.APIError as err:
        return err.status


def test_tls_cert_subject_becomes_user(pki, secure):
    admin, alice, anon = (_client(pki, secure, c)
                          for c in ("admin", "alice", ""))
    assert _status(lambda: admin.list("pods")) == 200
    assert _status(lambda: alice.list("pods")) == 403
    assert _status(lambda: anon.list("pods")) == 403
    admin.create("clusterroles", {"metadata": {"name": "reader"},
                                  "rules": [{"verbs": ["get"],
                                             "resources": ["pods"]}]})
    admin.create("clusterrolebindings", {
        "metadata": {"name": "alice-reads"},
        "subjects": [{"kind": "User", "name": "alice"}],
        "roleRef": {"kind": "ClusterRole", "name": "reader"}})
    assert _status(lambda: alice.list("pods")) == 200
    assert _status(lambda: alice.create("pods", pod("nope"))) == 403


def test_tls_untrusted_cert_and_plaintext_fail(pki, secure):
    evil = _client(pki, secure, "mallory")
    evil.tls.ca_file = str(pki / "ca.crt")
    with pytest.raises(OSError):
        evil.list("pods")
    plain = t_http.APIClient(secure.replace("https://", "http://"), qps=0,
                             max_retries=0)
    with pytest.raises(Exception):
        plain.list("pods")
    # A server name the certificate does not carry fails verification;
    # the insecure escape hatch skips it.
    wrong = t_http.TLSConfig(ca_file=str(pki / "ca.crt"),
                             server_name="not-the-server")
    with pytest.raises(OSError):
        t_http.APIClient(secure, qps=0, tls=wrong, max_retries=0).list("pods")
    skip = t_http.TLSConfig(insecure_skip_verify=True,
                            cert_file=str(pki / "admin.crt"),
                            key_file=str(pki / "admin.key"))
    assert t_http.APIClient(secure, qps=0, tls=skip).list("pods")[0] == []


def test_tls_config_flags_and_context():
    for mod in (t_http, r_http):
        p = argparse.ArgumentParser()
        mod.TLSConfig.add_flags(p)
        opts = p.parse_args(["--certificate-authority", "ca.crt",
                             "--client-certificate", "c.crt",
                             "--client-key", "c.key",
                             "--tls-server-name", "api.local"])
        tls = mod.TLSConfig.from_opts(opts)
        assert (tls.ca_file, tls.cert_file, tls.key_file, tls.server_name,
                tls.insecure_skip_verify) == ("ca.crt", "c.crt", "c.key",
                                              "api.local", False)
        assert bool(tls)
        assert not mod.TLSConfig()
        assert not mod.TLSConfig.from_opts(p.parse_args([]))
        assert bool(mod.TLSConfig(insecure_skip_verify=True))
    skip = t_http.TLSConfig(insecure_skip_verify=True)
    assert skip.context() is skip.context()
    c = t_http.APIClient("https://127.0.0.1:1", tls=skip, token="t")
    twin = c.clone(qps=0)
    assert (twin.tls, twin.token, twin.base_url) == (skip, "t", c.base_url)

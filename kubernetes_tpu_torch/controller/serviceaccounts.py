"""ServiceAccounts + tokens controllers.

Two reference loops in one daemon:

* pkg/controller/serviceaccount/serviceaccounts_controller.go — every
  namespace gets the ``default`` ServiceAccount (created on namespace
  add, re-created if deleted);
* pkg/controller/serviceaccount/tokens_controller.go — every
  ServiceAccount gets a token Secret of type
  ``kubernetes.io/service-account-token`` (annotated with the SA name,
  referenced from ``sa.secrets``); deleting the SA deletes its tokens.

The implicit ``default`` namespace (the store serves it without a
Namespace object) is seeded at startup so the ServiceAccount admission
plugin always finds ``default/default``.

A copy of ``kubernetes_tpu/controller/serviceaccounts.py`` with its
imports pointed at this package.
"""

from __future__ import annotations

import secrets as pysecrets
import threading
from typing import Union

from kubernetes_tpu_torch.apiserver.auth import (SA_NAME_ANNOTATION,
                                           SA_TOKEN_TYPE)
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client import cas_update
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("serviceaccounts-controller")

SYNC_PERIOD = 0.5
DEFAULT_SA = "default"


class ServiceAccountsController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._namespaces: dict[str, dict] = {}
        self._sas: dict[str, dict] = {}
        self._secrets: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "ServiceAccountsController":
        for kind, handler in (("namespaces", self._on_ns),
                              ("serviceaccounts", self._on_sa),
                              ("secrets", self._on_secret)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="serviceaccounts-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_ns(self, etype: str, obj: dict) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        with self._lock:
            if etype == "DELETED":
                self._namespaces.pop(name, None)
            else:
                self._namespaces[name] = obj

    def _on_sa(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._sas.pop(key, None)
            else:
                self._sas[key] = obj

    def _on_secret(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._secrets.pop(key, None)
            else:
                self._secrets[key] = obj

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("serviceaccounts sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            namespaces = dict(self._namespaces)
            sas = dict(self._sas)
            secrets = dict(self._secrets)
        # The implicit default namespace always gets its SA; Terminating
        # namespaces don't (NamespaceLifecycle would 403 the create, and
        # the namespace GC is about to sweep anyway) — including a
        # Terminating Namespace OBJECT named "default", which must not
        # re-enter via the implicit union (it would retry a 403'd create
        # every sync forever).
        def _live(obj: dict) -> bool:
            return (obj.get("status") or {}).get("phase") != \
                "Terminating" and \
                not (obj.get("metadata") or {}).get("deletionTimestamp")
        live_ns = {n for n, obj in namespaces.items() if _live(obj)}
        if "default" not in namespaces:
            live_ns.add("default")
        for ns in sorted(live_ns):
            if f"{ns}/{DEFAULT_SA}" not in sas:
                self._ensure_default_sa(ns)
        # Tokens: every SA has at least one live token secret.
        token_secrets_by_sa: dict[str, list[str]] = {}
        for skey, secret in secrets.items():
            if secret.get("type") != SA_TOKEN_TYPE:
                continue
            meta = secret.get("metadata") or {}
            ann_sa = (meta.get("annotations") or {}).get(
                SA_NAME_ANNOTATION, "")
            sa_key = f"{meta.get('namespace', 'default')}/{ann_sa}"
            token_secrets_by_sa.setdefault(sa_key, []).append(skey)
        for sa_key, sa in sas.items():
            live_tokens = token_secrets_by_sa.get(sa_key, [])
            if not live_tokens:
                self._mint_token(sa)
            elif not any(
                    r.get("name") in {k.partition("/")[2]
                                      for k in live_tokens}
                    for r in sa.get("secrets") or []):
                # Secret exists but the SA never got its reference (the
                # link CAS lost a race in a previous sync): re-link, or
                # admission would skip the token mount forever.
                self._link_secret(sa, live_tokens[0].partition("/")[2])
        # Reap tokens whose SA is gone (tokens_controller's
        # secretDeleted path).
        for sa_key, skeys in token_secrets_by_sa.items():
            if sa_key in sas:
                continue
            for skey in skeys:
                try:
                    self.store.delete("secrets", skey)
                    log.info("deleted orphaned token secret %s", skey)
                except Exception:  # noqa: BLE001 — already gone
                    pass

    def _ensure_default_sa(self, ns: str) -> None:
        try:
            self.store.create("serviceaccounts", {
                "metadata": {"name": DEFAULT_SA, "namespace": ns}})
            log.info("created default serviceaccount in %s", ns)
        except Exception:  # noqa: BLE001 — exists / ns terminating
            pass

    def _mint_token(self, sa: dict) -> None:
        meta = sa.get("metadata") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        # Bearer credentials: CSPRNG only (random.Random is MT19937,
        # state-recoverable from outputs; the suffix is public in the
        # secret name).
        secret_name = f"{name}-token-{pysecrets.token_hex(3)}"
        token = pysecrets.token_hex(16)
        try:
            self.store.create("secrets", {
                "metadata": {"name": secret_name, "namespace": ns,
                             "annotations": {SA_NAME_ANNOTATION: name}},
                "type": SA_TOKEN_TYPE,
                "data": {"token": token}})
        except Exception:  # noqa: BLE001 — raced another replica
            return
        self._link_secret(sa, secret_name)

    def _link_secret(self, sa: dict, secret_name: str) -> None:
        """Reference the token secret from ``sa.secrets`` so admission
        can mount it without scanning.  A lost CAS here is retried by
        the sync loop's re-link pass."""
        meta = sa.get("metadata") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        try:
            cur = self.store.get("serviceaccounts", f"{ns}/{name}")
            if cur is not None:
                refs = list(cur.get("secrets") or [])
                if not any(r.get("name") == secret_name for r in refs):
                    refs.append({"name": secret_name})
                    cas_update(self.store, "serviceaccounts",
                               {**cur, "secrets": refs})
        except Exception:  # noqa: BLE001 — sync re-link pass retries
            pass

"""Replication controllers: keep spec.replicas pods alive.

The reference's replication manager (pkg/controller/replication) and
replica-set controller (pkg/controller/replicaset — the same loop over
set-based selectors) watch their resources plus pods, diff desired vs
actual, and create/delete pods stamped from the template.  This is that
loop over the apiserver surface: works on raw v1 JSON (the controller has
no scheduling opinions), labels created pods from the template, and names
them ``{rc}-{suffix}`` the way the reference's pod generator does.

ReplicaSets use a LabelSelector (matchLabels + matchExpressions);
ReplicationControllers a plain label map — both handled by _matches.

A copy of ``kubernetes_tpu/controller/replication.py`` with its imports
pointed at this package; the apiserver's eviction subresource matches
PodDisruptionBudgets to pods with the same ``_matches``.
"""

from __future__ import annotations

import random
import string
import threading
import time
from typing import Union

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("rc-controller")

SYNC_PERIOD = 1.0


def _alive(pod: dict) -> bool:
    status = pod.get("status") or {}
    return status.get("phase") not in ("Failed", "Succeeded") and \
        not (pod.get("metadata") or {}).get("deletionTimestamp")


def _is_label_selector(selector: dict) -> bool:
    return "matchLabels" in selector or "matchExpressions" in selector


def _matches(selector: dict, pod: dict) -> bool:
    """RC map selector or RS LabelSelector against a pod's labels.  The
    set-based semantics are api.types.LabelSelector.matches — one
    implementation, not a copy."""
    labels = (pod.get("metadata") or {}).get("labels") or {}
    if _is_label_selector(selector):
        parsed = api._parse_label_selector(selector)
        if parsed is None or (not parsed.match_labels
                              and not parsed.match_expressions):
            return False
        return parsed.matches(labels)
    return bool(selector) and \
        all(labels.get(k) == v for k, v in selector.items())


def _selector_labels(selector: dict) -> dict:
    """Labels a freshly stamped replica needs to match its selector."""
    if _is_label_selector(selector):
        return dict(selector.get("matchLabels") or {})
    return dict(selector)


class ReplicationManager:
    """controller-manager's replication controller loop."""

    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._rcs: dict[str, dict] = {}
        # Namespace-sliced pod index + dirty RC set: the loop syncs only
        # controllers whose own object or namespace pods moved (the
        # endpoints controller's discipline), with a periodic full resync
        # as the safety net — a flat 1 s rescan of all RCs x all pods
        # dominated at kubemark scale (500+ nodes, thousands of pods).
        self._pods_by_ns: dict[str, dict[str, dict]] = {}
        self._dirty: set[str] = set()
        self._full_resync_period = 30.0  # the informer resync analogue
        self._last_full = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []
        # Entropy-seeded: two manager instances (an HA failover pair, or a
        # restarted process) must not replay the same suffix sequence —
        # with a fixed seed, a standby taking over would re-mint the dead
        # leader's pod names and collide with its survivors.
        self._rand = random.Random()
        # Expectations (the reference's RCExpectations): pods this
        # controller created/deleted whose watch event hasn't landed in
        # the reflector cache yet.  Counting them toward `have` stops a
        # lagging pod watch (one sync period in-process, longer over
        # HTTP) from re-creating want-have replicas every sync and then
        # deleting the transient extras.  rc key -> {pod name: deadline}.
        self._pending_creates: dict[str, dict[str, float]] = {}
        self._pending_deletes: dict[str, dict[str, float]] = {}
        self._expectation_ttl = max(5.0, 5 * sync_period)

    def run(self) -> "ReplicationManager":
        import functools
        for kind in ("replicationcontrollers", "replicasets"):
            r = Reflector(self.store, kind,
                          functools.partial(self._on_rc, kind))
            self._reflectors.append(r)
            r.run()
        r = Reflector(self.store, "pods", self._on_pod)
        self._reflectors.append(r)
        r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._sync_loop, daemon=True,
                             name="rc-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_rc(self, kind: str, etype: str, obj: dict) -> None:
        # Keyed by kind too: an RC and an RS may share a ns/name.
        key = f"{kind}:{MemStore.object_key(obj)}"
        with self._lock:
            if etype == "DELETED":
                self._rcs.pop(key, None)
                self._pending_creates.pop(key, None)
                self._pending_deletes.pop(key, None)
                self._dirty.discard(key)
            else:
                self._rcs[key] = obj
                self._dirty.add(key)

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        ns = (obj.get("metadata") or {}).get("namespace", "default")
        with self._lock:
            ns_pods = self._pods_by_ns.setdefault(ns, {})
            if etype == "DELETED":
                ns_pods.pop(key, None)
            else:
                ns_pods[key] = obj
            # Mark every controller in the pod's namespace (not just
            # selector matches: a label EDIT can detach a pod from a
            # controller we'd miss by matching only the new labels, and
            # controllers-per-namespace is small).
            for rc_key, rc in self._rcs.items():
                if (rc.get("metadata") or {}).get(
                        "namespace", "default") == ns:
                    self._dirty.add(rc_key)

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                now = time.time()
                if now - self._last_full >= self._full_resync_period:
                    self._last_full = now
                    self.sync_all()
                else:
                    self.sync_dirty()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("rc sync crashed; continuing")

    def sync_all(self) -> None:
        """Full resync: every controller, regardless of dirtiness."""
        with self._lock:
            rcs = list(self._rcs.items())
            self._dirty.clear()
        self._sync_keys(rcs)

    def sync_dirty(self) -> None:
        """Sync only controllers whose object or namespace pods changed
        since the last pass.  An expectation that expires without its
        watch event (a failed create) re-dirties on the full resync."""
        with self._lock:
            if not self._dirty:
                # Controllers with outstanding expectations still need a
                # look: an expired pending create must be retried even if
                # no new event arrives.
                keys = {k for k, v in self._pending_creates.items() if v}
                keys |= {k for k, v in self._pending_deletes.items() if v}
            else:
                keys = set(self._dirty)
                self._dirty.clear()
                keys |= {k for k, v in self._pending_creates.items() if v}
                keys |= {k for k, v in self._pending_deletes.items() if v}
            rcs = [(k, self._rcs[k]) for k in keys if k in self._rcs]
        self._sync_keys(rcs)

    def _sync_keys(self, rcs: list[tuple[str, dict]]) -> None:
        for key, rc in rcs:
            ns = (rc.get("metadata") or {}).get("namespace", "default")
            with self._lock:
                pods = list(self._pods_by_ns.get(ns, {}).values())
            self._sync_one(rc, pods, rc_key=key)

    def _sync_one(self, rc: dict, pods: list[dict],
                  rc_key: str | None = None) -> None:
        meta = rc.get("metadata") or {}
        spec = rc.get("spec") or {}
        ns = meta.get("namespace", "default")
        selector = spec.get("selector") or {}
        empty = not selector or (
            _is_label_selector(selector)
            and not (selector.get("matchLabels")
                     or selector.get("matchExpressions")))
        if empty:
            # The reference defaults an absent selector from the template's
            # labels; with neither, the RC can never adopt its own pods and
            # syncing it would create replicas forever.
            selector = dict(((spec.get("template") or {}).get("metadata")
                             or {}).get("labels") or {})
            if not selector:
                log.warning("rc %s/%s has no selector and no template "
                            "labels; skipping", ns, meta.get("name"))
                return
        want = int(spec.get("replicas", 1))
        mine = [p for p in pods
                if (p.get("metadata") or {}).get("namespace", "default")
                == ns and _matches(selector, p) and _alive(p)]
        # Settle expectations against the cache before diffing: a pending
        # create is fulfilled once its pod shows up (or expires — the
        # create may have failed); a pending delete is fulfilled once the
        # pod is gone from the cache.
        # The ledger key carries the kind (like the _rcs cache key): an RC
        # and an RS sharing a ns/name must not read each other's
        # expectations.
        if rc_key is None:
            rc_key = f"?:{ns}/{meta.get('name', '')}"
        now = time.time()
        cache_names = {(p.get("metadata") or {}).get("name", "")
                       for p in mine}
        with self._lock:
            # Ledger access under the reflector lock, and only for a
            # still-live controller: a DELETED event racing this sync
            # must not have its cleanup undone by a setdefault here (the
            # resurrected entry would leak, and a re-created same-name RC
            # within the TTL would inherit stale expectations).  Direct
            # callers (rc_key "?:...") always get a ledger.
            if rc_key in self._rcs or rc_key.startswith("?:"):
                creates = self._pending_creates.setdefault(rc_key, {})
                deletes = self._pending_deletes.setdefault(rc_key, {})
            else:
                creates, deletes = {}, {}
            for n in list(creates):
                if n in cache_names or now > creates[n]:
                    creates.pop(n, None)
            for n in list(deletes):
                if n not in cache_names or now > deletes[n]:
                    deletes.pop(n, None)
            have = len(mine) + len(creates) - len(deletes)
        if have < want:
            for _ in range(want - have):
                name = self._create_replica(rc, ns, selector)
                if name:
                    creates[name] = now + self._expectation_ttl
        elif have > want:
            # Prefer deleting unassigned pods first (the reference ranks
            # not-running pods for deletion first); never re-delete a pod
            # whose delete is already in flight.
            mine.sort(key=lambda p: bool(
                (p.get("spec") or {}).get("nodeName")))
            victims = [p for p in mine
                       if (p.get("metadata") or {}).get("name", "")
                       not in deletes]
            for p in victims[: have - want]:
                pmeta = p.get("metadata") or {}
                pname = pmeta.get("name", "")
                try:
                    self.store.delete("pods", f"{ns}/{pname}")
                    deletes[pname] = now + self._expectation_ttl
                except Exception:  # noqa: BLE001 — already gone
                    pass

    def _create_replica(self, rc: dict, ns: str,
                        selector: dict) -> str | None:
        """Create one stamped replica; returns its name on success (for
        the expectations ledger) or None."""
        meta = rc.get("metadata") or {}
        template = (rc.get("spec") or {}).get("template") or {}
        suffix = "".join(self._rand.choices(string.ascii_lowercase +
                                            string.digits, k=5))
        tmeta = dict(template.get("metadata") or {})
        labels = dict(tmeta.get("labels") or {})
        labels.update(_selector_labels(selector))  # replicas must match
        pod = {
            "metadata": {
                "name": f"{meta.get('name', 'rc')}-{suffix}",
                "namespace": ns,
                "labels": labels,
                "annotations": dict(tmeta.get("annotations") or {}),
            },
            "spec": dict(template.get("spec") or
                         {"containers": [{"name": "c"}]}),
        }
        if not _matches(selector, pod):
            # A replica that can't match its own selector (e.g. a
            # matchExpressions requirement the template labels don't
            # satisfy) would never be adopted — creating it would mint
            # `replicas` orphans per sync forever.  The reference rejects
            # such RCs at validation; this controller refuses to act.
            log.warning("rc %s/%s: stamped replica would not match its "
                        "selector; refusing to create", ns,
                        meta.get("name"))
            return None
        try:
            self.store.create("pods", pod)
            log.info("rc %s/%s created pod %s", ns, meta.get("name"),
                     pod["metadata"]["name"])
            return pod["metadata"]["name"]
        except Exception:  # noqa: BLE001 — retried next sync
            log.debug("replica create failed; will retry", exc_info=True)
            return None

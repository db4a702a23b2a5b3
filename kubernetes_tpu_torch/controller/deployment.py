"""Deployment controller: declarative rolling updates over ReplicaSets.

The reference's flagship workload controller
(pkg/controller/deployment/deployment_controller.go; RollingUpdate entry
at :537 with rolling.go, recreate.go, rollback.go):

* each distinct pod template gets its own ReplicaSet, named
  ``{deployment}-{template-hash}`` and labeled/selected with
  ``pod-template-hash`` so replicas of different revisions never mix;
* RollingUpdate scales the new RS up and old RSs down in steps bounded by
  maxSurge (total may exceed spec.replicas by at most this) and
  maxUnavailable (available pods may dip below spec.replicas by at most
  this) — deployment_controller.go:537, rolling.go;
* Recreate kills every old replica before the first new one starts;
* each RS carries a revision annotation; ``spec.rollbackTo.revision``
  copies that RS's template back into the deployment (rollback.go) and
  the rolling machinery walks it forward again;
* status reports replicas/updatedReplicas/availableReplicas and
  observedGeneration.

The controller only manages ReplicaSet objects; the replication manager
(controller/replication.py) turns those into pods — the same split the
reference has between the deployment controller and the RS controller.

A copy of ``kubernetes_tpu/controller/deployment.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from typing import Optional, Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("deployment-controller")

SYNC_PERIOD = 1.0
HASH_LABEL = "pod-template-hash"
REVISION_ANN = "deployment.kubernetes.io/revision"


def template_hash(template: dict) -> str:
    """Stable hash of a pod template (md5 of canonical JSON, excluding any
    pod-template-hash label a previous stamping added)."""
    t = json.loads(json.dumps(template))  # deep copy
    labels = ((t.get("metadata") or {}).get("labels") or {})
    labels.pop(HASH_LABEL, None)
    canon = json.dumps(t, sort_keys=True, separators=(",", ":"))
    return hashlib.md5(canon.encode()).hexdigest()[:10]


def _bound(value, replicas: int, round_up: bool) -> int:
    """Resolve an int-or-percent maxSurge/maxUnavailable (surge rounds up,
    unavailable rounds down — the reference's intstr resolution)."""
    if isinstance(value, str) and value.endswith("%"):
        frac = float(value[:-1]) / 100.0 * replicas
        return int(math.ceil(frac) if round_up else math.floor(frac))
    try:
        return int(value)
    except (TypeError, ValueError):
        return 1


def _alive(pod: dict) -> bool:
    status = pod.get("status") or {}
    return status.get("phase") not in ("Failed", "Succeeded") and \
        not (pod.get("metadata") or {}).get("deletionTimestamp")


def _running(pod: dict) -> bool:
    return _alive(pod) and \
        (pod.get("status") or {}).get("phase") == "Running"


class DeploymentController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.sync_period = sync_period
        self._deployments: dict[str, dict] = {}
        self._rss: dict[str, dict] = {}
        self._pods: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflectors: list[Reflector] = []

    def run(self) -> "DeploymentController":
        for kind, handler in (("deployments", self._on_deployment),
                              ("replicasets", self._on_rs),
                              ("pods", self._on_pod)):
            r = Reflector(self.store, kind, handler)
            self._reflectors.append(r)
            r.run()
        for r in self._reflectors:
            r.wait_for_sync()
        t = threading.Thread(target=self._sync_loop, daemon=True,
                             name="deployment-sync")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()

    def _on_deployment(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._deployments.pop(key, None)
            else:
                self._deployments[key] = obj

    def _on_rs(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._rss.pop(key, None)
            else:
                self._rss[key] = obj

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        with self._lock:
            if etype == "DELETED":
                self._pods.pop(key, None)
            else:
                self._pods[key] = obj

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("deployment sync crashed; continuing")

    def sync_all(self) -> None:
        with self._lock:
            deps = list(self._deployments.values())
            rss = list(self._rss.values())
            pods = list(self._pods.values())
        for dep in deps:
            try:
                self._sync_one(dep, rss, pods)
            except Exception:  # noqa: BLE001 — next sync retries
                log.exception("sync of deployment %s failed",
                              MemStore.object_key(dep))

    # -- core ------------------------------------------------------------

    def _owned_rss(self, dep: dict, rss: list[dict]) -> list[dict]:
        """RSs selected by the deployment's selector in its namespace
        (getReplicaSetsForDeployment — ownership by label selection)."""
        meta = dep.get("metadata") or {}
        ns = meta.get("namespace", "default")
        sel = ((dep.get("spec") or {}).get("selector") or {})
        match = sel.get("matchLabels") or sel or {}
        if not match:
            match = dict(((dep.get("spec") or {}).get("template") or {})
                         .get("metadata", {}).get("labels") or {})
        out = []
        for rs in rss:
            rmeta = rs.get("metadata") or {}
            if rmeta.get("namespace", "default") != ns:
                continue
            labels = rmeta.get("labels") or {}
            if match and all(labels.get(k) == v for k, v in match.items()):
                out.append(rs)
        return out

    def _rs_pods(self, rs: dict, pods: list[dict]) -> list[dict]:
        rmeta = rs.get("metadata") or {}
        ns = rmeta.get("namespace", "default")
        sel = ((rs.get("spec") or {}).get("selector") or {})
        match = sel.get("matchLabels") or {}
        return [p for p in pods
                if (p.get("metadata") or {}).get("namespace", "default")
                == ns and match and all(
                    ((p.get("metadata") or {}).get("labels") or {})
                    .get(k) == v for k, v in match.items())]

    def _sync_one(self, dep: dict, rss: list[dict],
                  pods: list[dict]) -> None:
        meta = dep.get("metadata") or {}
        spec = dep.get("spec") or {}
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        replicas = int(spec.get("replicas", 1))
        template = spec.get("template") or {}
        if not template:
            return

        # Rollback first (rollback.go): rewrite the template, clear the
        # directive, and let the ordinary rolling path walk it forward.
        if spec.get("rollbackTo") is not None:
            if self._rollback(dep, rss):
                return  # deployment updated; next watch event re-syncs

        owned = self._owned_rss(dep, rss)
        thash = template_hash(template)
        new_rs = next((rs for rs in owned
                       if ((rs.get("metadata") or {}).get("labels") or {})
                       .get(HASH_LABEL) == thash), None)
        old_rss = [rs for rs in owned if rs is not new_rs]

        if new_rs is None:
            revision = 1 + max(
                (int(((rs.get("metadata") or {}).get("annotations") or {})
                     .get(REVISION_ANN, "0")) for rs in owned), default=0)
            new_rs = self._create_rs(dep, ns, name, template, thash,
                                     revision)
            if new_rs is None:
                return  # create failed / conflict: next sync retries
            # Keep the deployment's revision annotation current.
            self._annotate_revision(dep, revision)

        strategy = (spec.get("strategy") or {})
        stype = strategy.get("type", "RollingUpdate")
        if stype == "Recreate":
            self._recreate(dep, new_rs, old_rss, pods, replicas)
        else:
            ru = strategy.get("rollingUpdate") or {}
            surge = _bound(ru.get("maxSurge", 1), replicas, round_up=True)
            unavail = _bound(ru.get("maxUnavailable", 1), replicas,
                             round_up=False)
            if surge == 0 and unavail == 0:
                unavail = 1  # both zero would deadlock; reference rejects
            self._rolling(dep, new_rs, old_rss, pods, replicas, surge,
                          unavail)
        self._update_status(dep, new_rs, old_rss, pods, replicas)

    def _create_rs(self, dep: dict, ns: str, name: str, template: dict,
                   thash: str, revision: int) -> Optional[dict]:
        tmeta = dict((template.get("metadata") or {}))
        labels = dict(tmeta.get("labels") or {})
        labels[HASH_LABEL] = thash
        sel = ((dep.get("spec") or {}).get("selector") or {})
        match = dict(sel.get("matchLabels") or sel or {})
        match[HASH_LABEL] = thash
        rs = {
            "metadata": {
                "name": f"{name}-{thash}",
                "namespace": ns,
                "labels": labels,
                "annotations": {REVISION_ANN: str(revision)},
            },
            "spec": {
                "replicas": 0,
                "selector": {"matchLabels": match},
                "template": {
                    "metadata": {**tmeta, "labels": labels},
                    "spec": dict(template.get("spec") or {}),
                },
            },
        }
        try:
            created = self.store.create("replicasets", rs)
            log.info("deployment %s/%s created rs %s (revision %d)", ns,
                     name, rs["metadata"]["name"], revision)
            with self._lock:  # visible to this sync pass immediately
                self._rss[MemStore.object_key(created)] = created
            return created
        except Exception:  # noqa: BLE001 — conflict: next sync adopts
            log.debug("rs create failed; will retry", exc_info=True)
            return None

    def _scale_rs(self, rs: dict, replicas: int) -> None:
        key = MemStore.object_key(rs)
        fresh = self.store.get("replicasets", key)
        if fresh is None:
            return
        if int((fresh.get("spec") or {}).get("replicas", 0)) == replicas:
            return
        fresh.setdefault("spec", {})["replicas"] = replicas
        try:
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "replicasets", fresh)
            log.info("scaled rs %s to %d", key, replicas)
            with self._lock:
                self._rss[key] = fresh
        except Exception:  # noqa: BLE001 — CAS race: next sync retries
            pass

    def _rolling(self, dep: dict, new_rs: dict, old_rss: list[dict],
                 pods: list[dict], replicas: int, surge: int,
                 unavail: int) -> None:
        """One reconciliation step of rolling.go: grow the new RS within
        the surge budget, shrink old RSs within the availability budget."""
        new_spec = int((new_rs.get("spec") or {}).get("replicas", 0))
        old_spec = sum(int((rs.get("spec") or {}).get("replicas", 0))
                       for rs in old_rss)
        total = new_spec + old_spec
        # A deployment scaled DOWN after (or during) a rollout: the new RS
        # itself must shrink to spec.replicas — the old-RS loop below only
        # ever shrinks old revisions.
        if new_spec > replicas:
            self._scale_rs(new_rs, replicas)
            new_spec = replicas
        # Scale up: the total may exceed `replicas` by at most maxSurge.
        if new_spec < replicas:
            grow = min(replicas - new_spec, replicas + surge - total)
            if grow > 0:
                self._scale_rs(new_rs, new_spec + grow)
        # Scale down: available pods may dip below `replicas` by at most
        # maxUnavailable; count Running pods across all owned RSs.
        available = sum(1 for rs in [new_rs] + old_rss
                        for p in self._rs_pods(rs, pods) if _running(p))
        removable = available - (replicas - unavail)
        if removable > 0 and old_spec > 0:
            for rs in sorted(old_rss, key=lambda r: -int(
                    (r.get("spec") or {}).get("replicas", 0))):
                if removable <= 0:
                    break
                cur = int((rs.get("spec") or {}).get("replicas", 0))
                if cur == 0:
                    continue
                shrink = min(cur, removable)
                self._scale_rs(rs, cur - shrink)
                removable -= shrink

    def _recreate(self, dep: dict, new_rs: dict, old_rss: list[dict],
                  pods: list[dict], replicas: int) -> None:
        """recreate.go: all old replicas terminate before any new start."""
        live_old = 0
        for rs in old_rss:
            if int((rs.get("spec") or {}).get("replicas", 0)) > 0:
                self._scale_rs(rs, 0)
            live_old += sum(1 for p in self._rs_pods(rs, pods)
                            if _alive(p))
        if live_old == 0:
            self._scale_rs(new_rs, replicas)

    def _rollback(self, dep: dict, rss: list[dict]) -> bool:
        """rollback.go: copy the target revision's template back into the
        deployment spec and clear rollbackTo.  Returns True when the
        deployment object was rewritten."""
        meta = dep.get("metadata") or {}
        key = MemStore.object_key(dep)
        target_rev = int((dep["spec"].get("rollbackTo") or {})
                         .get("revision", 0))
        owned = self._owned_rss(dep, rss)
        if not owned:
            return self._clear_rollback(key)
        revs = {int(((rs.get("metadata") or {}).get("annotations") or {})
                    .get(REVISION_ANN, "0")): rs for rs in owned}
        if target_rev == 0:
            # Revision 0 = the previous revision (rollback.go:85).
            order = sorted(revs)
            if len(order) < 2:
                return self._clear_rollback(key)
            target_rev = order[-2]
        rs = revs.get(target_rev)
        if rs is None:
            log.warning("deployment %s: rollback revision %d not found",
                        key, target_rev)
            return self._clear_rollback(key)
        template = json.loads(json.dumps(
            (rs.get("spec") or {}).get("template") or {}))
        labels = ((template.get("metadata") or {}).get("labels") or {})
        labels.pop(HASH_LABEL, None)
        fresh = self.store.get("deployments", key)
        if fresh is None:
            return True
        fresh.setdefault("spec", {})["template"] = template
        fresh["spec"]["rollbackTo"] = None
        try:
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "deployments", fresh)
            log.info("deployment %s rolled back to revision %d", key,
                     target_rev)
            with self._lock:
                self._deployments[key] = fresh
            return True
        except Exception:  # noqa: BLE001 — CAS race: next sync retries
            return True

    def _clear_rollback(self, key: str) -> bool:
        fresh = self.store.get("deployments", key)
        if fresh is None:
            return True
        fresh.setdefault("spec", {})["rollbackTo"] = None
        try:
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "deployments", fresh)
        except Exception:  # noqa: BLE001
            pass
        return True

    def _annotate_revision(self, dep: dict, revision: int) -> None:
        key = MemStore.object_key(dep)
        fresh = self.store.get("deployments", key)
        if fresh is None:
            return
        anns = fresh.setdefault("metadata", {}).setdefault(
            "annotations", {})
        if anns.get(REVISION_ANN) == str(revision):
            return
        anns[REVISION_ANN] = str(revision)
        try:
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "deployments", fresh)
        except Exception:  # noqa: BLE001 — cosmetic; next sync retries
            pass

    def _update_status(self, dep: dict, new_rs: dict,
                       old_rss: list[dict], pods: list[dict],
                       replicas: int) -> None:
        key = MemStore.object_key(dep)
        new_pods = self._rs_pods(new_rs, pods)
        all_pods = list(new_pods)
        for rs in old_rss:
            all_pods.extend(self._rs_pods(rs, pods))
        status = {
            "replicas": sum(1 for p in all_pods if _alive(p)),
            "updatedReplicas": sum(1 for p in new_pods if _alive(p)),
            "availableReplicas": sum(1 for p in all_pods if _running(p)),
            "observedGeneration": int((dep.get("metadata") or {})
                                      .get("generation", 0)),
        }
        if (dep.get("status") or {}) == status:
            return
        fresh = self.store.get("deployments", key)
        if fresh is None:
            return
        if (fresh.get("status") or {}) == status:
            return
        fresh["status"] = status
        try:
            from kubernetes_tpu_torch.client import cas_update
            cas_update(self.store, "deployments", fresh)
            with self._lock:
                self._deployments[key] = fresh
        except Exception:  # noqa: BLE001 — next sync retries
            pass

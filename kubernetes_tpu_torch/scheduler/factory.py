"""Config factory: wire the scheduler daemon to an apiserver
(factory.go:100-227, 387-469) — the standalone watch -> solve -> bind loop.

Counterpart of ``kubernetes_tpu/scheduler/factory.py`` over the port's
engine.  Two FIELDED pod reflectors and one node reflector feed the
daemon, the reference's informer layout (factory.go:128-149, 466-469):

* ``spec.nodeName=`` (server-side field selector) -> the scheduling
  FIFO; a pod leaving the set on bind arrives as a synthesized DELETED;
* ``spec.nodeName!=`` -> the scheduler cache (confirming assumed pods);
* nodes -> the scheduler cache;

plus services/PV/PVC/RC/RS listers kept fresh from the same source, the
CAS binder, and the 1 s assumed-pod TTL sweep (cache.go:31).

The apiserver source is an in-process ``MemStore`` or an HTTP base URL
(or a ready ``APIClient``) — the real process boundary: every
list/watch/bind/status write then goes over the wire through a
QPS/Burst rate-limited client (factory.go:77-91), binds ride the batch
bindings subresource and events a batch sink.  What later slices bring
each raises ``NotImplementedError`` naming its slice when it is asked
for, and each is off by default: a shared ``solver_service`` and
``KT_TENANTS`` (the tenancy slice), ``KT_HA_SHARDS > 0`` (the HA slice),
``KT_DEFRAG`` (the defrag slice) and ``KT_VERIFY_PERIOD > 0`` (the
verifier slice).
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import Policy
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.cache.scheduler_cache import CLEANUP_PERIOD
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.engine.generic_scheduler import (GenericScheduler,
                                                           Listers,
                                                           not_ported)
from kubernetes_tpu_torch.scheduler.binder import APIClientBinder
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import knobs, threadreg
from kubernetes_tpu_torch.utils.events import EventRecorder, async_sink
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("factory")


class MemStoreBinder:
    """Binder against the in-memory apiserver's binding subresource."""

    def __init__(self, store: MemStore):
        self.store = store

    def bind(self, pod: api.Pod, node_name: str) -> None:
        self.store.bind(pod.namespace, pod.name, node_name)

    def evict(self, pod: api.Pod) -> None:
        """Preemption eviction: delete the victim pod from the store."""
        try:
            self.store.delete("pods", pod.key)
        except KeyError:
            pass  # already gone (watch raced the eviction)


def make_event_sink(source: Union[MemStore, APIClient]):
    """An EventRecorder sink that posts Events as API objects
    (pkg/client/record event.go: events are created on the apiserver)."""
    counter = [0]

    def _event_json(ev) -> dict:
        counter[0] += 1
        ns, _, name = ev.object_key.partition("/")
        return {
            "metadata": {"name": f"{name or ns}.{counter[0]}",
                         "namespace": ns if name else "default"},
            "involvedObject": {"kind": "Pod", "namespace": ns,
                               "name": name or ns},
            "type": ev.event_type, "reason": ev.reason,
            "message": ev.message}

    def sink(ev) -> None:
        try:
            source.create("events", _event_json(ev))
        except Exception:  # noqa: BLE001 — event loss is non-fatal
            pass
    sink.event_json = _event_json
    return sink


def make_event_batch_sink(client: APIClient, qps: float, burst: int):
    """Batch wire sink: one POST per drained queue (broadcaster-style
    drop beyond the rate bucket, then a single batch create)."""
    from kubernetes_tpu_torch.utils.flowcontrol import TokenBucketRateLimiter
    single = make_event_sink(client)
    bucket = TokenBucketRateLimiter(qps, burst)

    def batch_sink(evs) -> None:
        allowed = [ev for ev in evs if bucket.try_accept()]
        if not allowed:
            return
        client.create_list("events",
                           [single.event_json(ev) for ev in allowed])
    return batch_sink


def _is_terminated(obj: dict) -> bool:
    phase = (obj.get("status") or {}).get("phase", "")
    return phase in ("Succeeded", "Failed")


class ConfigFactory:
    """NewConfigFactory + CreateFromProvider/CreateFromConfig
    (factory.go:100, :251-344).

    ``store`` is the apiserver source: a MemStore (in-process) or an HTTP
    base URL string / APIClient (separate-process control plane).  QPS and
    burst rate-limit the main client's verbs; events ride a second,
    unthrottled client gated by a drop-on-saturation bucket, the
    broadcaster's behavior under pressure (record/event.go).  ``device``
    is the engine's device (``"cuda"`` by default; ``"cpu"`` must be
    asked for)."""

    def __init__(self, store: Union[MemStore, APIClient, str],
                 policy: Optional[Policy] = None,
                 scheduler_name: str = api.DEFAULT_SCHEDULER_NAME,
                 batched: bool = True,
                 qps: float = 50.0, burst: int = 100, token: str = "",
                 tls=None, device: "str | torch.device | None" = "cuda",
                 ha_shards: Optional[int] = None,
                 solver_service=None):
        if solver_service is not None:
            raise not_ported("the solver-service client mode", "tenancy")
        if (knobs.get_int("KT_HA_SHARDS") if ha_shards is None
                else ha_shards) > 0:
            raise not_ported("active-active HA (KT_HA_SHARDS > 0)", "HA")
        if knobs.get("KT_TENANTS"):
            raise not_ported("the multi-tenant solver service "
                             "(KT_TENANTS)", "tenancy")
        if isinstance(store, str):
            store = APIClient(store, qps=qps, burst=burst, token=token,
                              tls=tls)
        self.store = store
        self.listers = Listers()
        self.algorithm = GenericScheduler(policy=policy,
                                          listers=self.listers,
                                          device=device)
        if isinstance(store, APIClient):
            binder = APIClientBinder(store)
            events_client = store.clone(qps=0)
            # The batch sink carries its own rate bucket (broadcaster-
            # style drop beyond qps/burst, then one batch POST per drain).
            recorder = EventRecorder(sink=async_sink(
                None, batch_sink=make_event_batch_sink(events_client, qps,
                                                       burst)))
        else:
            binder = MemStoreBinder(store)
            recorder = EventRecorder(sink=None)
        self.daemon = Scheduler(SchedulerConfig(
            algorithm=self.algorithm, binder=binder,
            # Async binds, like the reference's per-bind goroutine
            # (scheduler.go:122-153): over a real wire a chunk's ~4k bind
            # POSTs take seconds, and the card must be scanning the next
            # chunk meanwhile, not idling behind them.
            scheduler_name=scheduler_name, async_bind=True,
            recorder=recorder,
            condition_updater=self._update_pod_condition))
        self.batched = batched
        self._reflectors: list[Reflector] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # Startup reconciliation report (scheduler/recovery.py), served
        # on /debug/vars; None until run() completes the pass.
        self.last_recovery: Optional[dict] = None
        # Decision-latency SLO burn monitor (scheduler/slo.py); started
        # by run() at KT_SLO_PERIOD cadence, reported on /debug/vars.
        from kubernetes_tpu_torch.scheduler.slo import SLOMonitor
        self.slo = SLOMonitor()

    # -- reflector handlers (factory.go:128-227) -------------------------

    def _on_assigned_pod(self, etype: str, obj: dict,
                         pod: Optional[api.Pod] = None) -> None:
        """addPodToCache / updatePodInCache / deletePodFromCache
        (factory.go:154-200); ADDED confirms an assumed pod."""
        pod = pod if pod is not None else api.pod_from_json(obj)
        cache = self.algorithm.cache
        if etype == "DELETED":
            cache.remove_pod(pod)
        elif etype == "ADDED":
            cache.add_pod(pod)
        else:
            cache.update_pod(pod, pod)

    def _on_unassigned_pod(self, etype: str, obj: dict) -> None:
        """The queue-side FIELDED informer (factory.go:466-469: the
        reference's unassigned informer lists/watches
        ``spec.nodeName=``).  The server applies set-transition
        semantics, so a pod leaving the set on bind arrives here as
        DELETED — assigned-pod churn never crosses this stream."""
        meta = obj.get("metadata") or {}
        if etype == "DELETED":
            # Deleted outright, or bound and thus out of the unassigned
            # set: either way it no longer belongs on the queue.
            ns = meta.get("namespace")
            key = f"{ns}/{meta.get('name')}" if ns else meta.get("name", "")
            self.daemon.queue.delete(key)
            return
        pod = api.pod_from_json(obj)
        if _is_terminated(obj):
            self.daemon.queue.delete(pod.key)
            return
        self.daemon.enqueue(pod)

    def _on_assigned_pod_watch(self, etype: str, obj: dict) -> None:
        """The cache-side FIELDED informer (``spec.nodeName!=``,
        factory.go:128-149): a freshly bound pod enters this set as
        ADDED and confirms its assumed cache entry."""
        meta = obj.get("metadata") or {}
        node = (obj.get("spec") or {}).get("nodeName") or ""
        if etype != "DELETED" and node and not _is_terminated(obj):
            # Bind-confirmation fast path: at density rates the confirm
            # stream is one event per scheduled pod, and the full
            # parse + detach/attach per event is reflector-thread GIL
            # time stolen from the solve.
            ns = meta.get("namespace")
            key = f"{ns}/{meta.get('name')}" if ns else meta.get("name", "")
            if self.algorithm.cache.confirm_assumed(key, node):
                return
        pod = api.pod_from_json(obj)
        if etype == "DELETED" or _is_terminated(obj):
            # A set-transition DELETED (the pod left the bound set on an
            # unbind) carries the NEW object, whose nodeName is already
            # empty: remove whatever the cache actually tracks under the
            # key, not the carried object, or a ghost entry stays.
            cached = self.algorithm.cache.get_pod(pod.key)
            if cached is not None:
                self.algorithm.cache.remove_pod(cached)
            elif pod.node_name:
                self.algorithm.cache.remove_pod(pod)
            return
        self._on_assigned_pod(etype, obj, pod=pod)

    def _on_node(self, etype: str, obj: dict) -> None:
        node = api.node_from_json(obj)
        cache = self.algorithm.cache
        if etype == "DELETED":
            cache.remove_node(node.name)
        else:
            cache.add_node(node) if etype == "ADDED" else \
                cache.update_node(node)

    def _on_service(self, etype: str, obj: dict) -> None:
        meta = obj.get("metadata") or {}
        svc = api.Service(name=meta.get("name", ""),
                          namespace=meta.get("namespace", "default"),
                          selector=dict((obj.get("spec") or {})
                                        .get("selector") or {}))
        self.listers.services = [
            s for s in self.listers.services
            if (s.namespace, s.name) != (svc.namespace, svc.name)]
        if etype != "DELETED":
            self.listers.services.append(svc)

    # The remaining lister feeds (factory.go:387-416 caches PVs, PVCs,
    # controllers, and replica sets with dedicated reflectors): replace-
    # by-identity into the Listers the engine's volume/spread predicates
    # and priorities read.

    @staticmethod
    def _replace(items: list, obj, ident) -> list:
        return [x for x in items if ident(x) != ident(obj)]

    def _on_pv(self, etype: str, obj: dict) -> None:
        pv = api.pv_from_json(obj)
        self.listers.pvs = self._replace(self.listers.pvs, pv,
                                         lambda x: x.name)
        if etype != "DELETED":
            self.listers.pvs.append(pv)

    def _on_pvc(self, etype: str, obj: dict) -> None:
        pvc = api.pvc_from_json(obj)
        self.listers.pvcs = self._replace(
            self.listers.pvcs, pvc, lambda x: (x.namespace, x.name))
        if etype != "DELETED":
            self.listers.pvcs.append(pvc)

    def _on_rc(self, etype: str, obj: dict) -> None:
        rc = api.rc_from_json(obj)
        self.listers.controllers = self._replace(
            self.listers.controllers, rc, lambda x: (x.namespace, x.name))
        if etype != "DELETED":
            self.listers.controllers.append(rc)

    def _on_rs(self, etype: str, obj: dict) -> None:
        rs = api.rs_from_json(obj)
        self.listers.replica_sets = self._replace(
            self.listers.replica_sets, rs, lambda x: (x.namespace, x.name))
        if etype != "DELETED":
            self.listers.replica_sets.append(rs)

    def _update_pod_condition(self, pod: api.Pod, reason: str,
                              message: str) -> None:
        """podConditionUpdater (factory.go:589-600): PodScheduled=False."""
        key = pod.key
        try:
            obj = self.store.get("pods", key)
        except Exception:  # noqa: BLE001 — best-effort: an unreachable
            return         # apiserver must not kill the error path
        if obj is None:
            return
        conds = obj.setdefault("status", {}).setdefault("conditions", [])
        conds[:] = [c for c in conds if c.get("type") != "PodScheduled"]
        conds.append({"type": "PodScheduled", "status": "False",
                      "reason": reason, "message": message})
        try:
            if isinstance(self.store, MemStore):
                # CAS on the version this update read: a condition write
                # racing a concurrent bind (e.g. a replacement scheduler
                # after this one was killed) must lose the CAS rather
                # than clobber the bound spec.  Over HTTP the PUT handler
                # applies the same precondition from the body's
                # resourceVersion.
                self.store.update(
                    "pods", obj,
                    expected_rv=(obj.get("metadata") or {})
                    .get("resourceVersion"))
            else:
                self.store.update("pods", obj)
        except Exception:  # noqa: BLE001 — condition update is best-effort
            pass

    # -- lifecycle -------------------------------------------------------

    def run(self) -> "ConfigFactory":
        """f.Run (factory.go:387-416) + scheduler.Run: the reflectors,
        then (in order) the prewarm under KT_PREWARM, the startup
        reconciliation, the SLO monitor, the daemon loop and the
        assume-TTL sweep."""
        if knobs.get_float("KT_VERIFY_PERIOD") > 0:
            raise not_ported("the resident-state verifier "
                             "(KT_VERIFY_PERIOD > 0)", "verifier")
        if knobs.get_bool("KT_DEFRAG"):
            raise not_ported("background defragmentation (KT_DEFRAG)",
                             "defrag")
        specs = [
            # The reference's two fielded pod informers (factory.go:
            # 128-149, 466-469): the queue side never sees assigned-pod
            # churn, the cache side never sees pending churn — filtered
            # SERVER-side on both list and watch.
            ("pods", self._on_unassigned_pod, None, "spec.nodeName="),
            ("pods", self._on_assigned_pod_watch, None, "spec.nodeName!="),
            ("nodes", self._on_node, None, ""),
            ("services", self._on_service, None, ""),
            ("persistentvolumes", self._on_pv, None, ""),
            ("persistentvolumeclaims", self._on_pvc, None, ""),
            ("replicationcontrollers", self._on_rc, None, ""),
            ("replicasets", self._on_rs, None, ""),
        ]
        for kind, handler, selector, field_selector in specs:
            r = Reflector(self.store, kind, handler, selector,
                          field_selector=field_selector)
            self._reflectors.append(r)
            self._threads.append(r.run())
        for r in self._reflectors:
            r.wait_for_sync()
        log.info("reflectors synced (%d nodes cached); starting loop",
                 len(self.algorithm.cache.nodes()))
        if knobs.get_bool("KT_PREWARM"):
            # Build the kernels and launch each at every ladder bucket
            # before the queue opens (opt-in: interactive rigs keep their
            # startup latency).
            self.daemon.prewarm()
        if knobs.get_bool("KT_RECOVERY"):
            # Crash-safe restart: reconcile cache + queue against one
            # store relist (re-adopt bound pods, requeue orphans, expire
            # stale assumes, re-seed the resident tensors) BEFORE the
            # drain loop resumes — see scheduler/recovery.py.
            from kubernetes_tpu_torch.scheduler import recovery
            self.last_recovery = recovery.reconcile(
                self.daemon, self.store,
                scheduler_name=self.daemon.config.scheduler_name)
        slo_period = knobs.get_float("KT_SLO_PERIOD")
        if slo_period > 0:
            self._threads.append(self.slo.run(period=slo_period))
        self._threads.append(self.daemon.run(batched=self.batched))

        def ttl_sweep():  # cleanupAssumedPods (cache.go:309-330)
            while not self._stop.wait(CLEANUP_PERIOD):
                self.algorithm.cache.cleanup_expired()
        self._threads.append(threadreg.spawn(ttl_sweep,
                                             name="assume-ttl-sweep"))
        return self

    def stop(self) -> None:
        self._stop.set()
        for r in self._reflectors:
            r.stop()
        self.slo.stop()
        self.daemon.stop()
        sink = getattr(self.daemon.config.recorder, "_sink", None)
        close = getattr(sink, "close", None)
        if close is not None:
            close()

    def abandon(self) -> None:
        """SIGKILL-style teardown for the restart scenarios: reflectors
        and the drain loop stop, but NOTHING is drained or joined — the
        pipeline's in-flight window is abandoned exactly as a kill -9
        would leave it.  The next incarnation's startup reconciliation
        cleans up (scheduler/recovery.py)."""
        self._stop.set()
        for r in self._reflectors:
            r.stop()
        self.slo.stop()
        self.daemon.abandon()

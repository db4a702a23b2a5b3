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
bindings subresource and events a batch sink.  Four deployment modes,
each off by default, are wired as the JAX package wires them:
``KT_HA_SHARDS > 0`` (active-active HA, ``scheduler/shards.py``),
``KT_TENANTS`` or a shared ``solver_service`` (the multi-tenant solver
service, ``tenancy/``), ``KT_DEFRAG`` (``scheduler/defrag.py``) and
``KT_VERIFY_PERIOD > 0`` (``cache/verifier.py``).
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import TYPE_CHECKING, Optional, Union

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.api.policy import Policy
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.cache.scheduler_cache import CLEANUP_PERIOD
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.engine.generic_scheduler import (GenericScheduler,
                                                           Listers)
from kubernetes_tpu_torch.scheduler.binder import APIClientBinder
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import knobs, threadreg
from kubernetes_tpu_torch.utils.events import EventRecorder, async_sink
from kubernetes_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:  # annotations only: the engine owns the device
    import torch

log = get_logger("factory")

# While shard leases run (run() to stop()), the interpreter is set for
# the lease thread, which holds the leases only while it gets the
# interpreter lock in time (numbers from chip_smoke.py 19b, 30,000 pods,
# on the H100 host):
# * generation-2 collections are deferred: one walks every object made
#   since the startup freeze with the lock held, 0.60-0.91 s, longer
#   than a lease's renew deadline;
# * the switch interval is LEASE_SWITCH_INTERVAL_S: the lease thread
#   waits for the lock after every socket operation, and behind the
#   drain's busy threads one lease round trip took up to 0.28 s at the
#   default 5 ms.
# Both are process-wide: the first holder saves them, the last one to
# stop restores them.
LEASE_SWITCH_INTERVAL_S = 0.001
_LEASE_MU = threading.Lock()
_LEASE_HOLDERS: list = [0, None]   # holders, the settings to restore
# An idle HA daemon still collects its cyclic garbage, at most this
# often (queue empty at two sweeps in a row).
GC_IDLE_PERIOD_S = 30.0


def enter_lease_mode() -> None:
    with _LEASE_MU:
        if _LEASE_HOLDERS[0] == 0:
            saved = (gc.get_threshold(), sys.getswitchinterval())
            _LEASE_HOLDERS[1] = saved
            t0, t1, _t2 = saved[0]
            gc.set_threshold(t0, t1, 2 ** 31 - 1)
            sys.setswitchinterval(LEASE_SWITCH_INTERVAL_S)
        _LEASE_HOLDERS[0] += 1


def leave_lease_mode() -> None:
    with _LEASE_MU:
        _LEASE_HOLDERS[0] -= 1
        if _LEASE_HOLDERS[0] == 0:
            thresholds, interval = _LEASE_HOLDERS[1]
            gc.set_threshold(*thresholds)
            sys.setswitchinterval(interval)


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

    def unbind(self, pod: api.Pod) -> None:
        """Defrag eviction-to-pending (scheduler/defrag.py): clear
        spec.nodeName under CAS — the pod stays alive and the
        unassigned reflector's set-transition requeues it."""
        obj = self.store.get("pods", pod.key)
        if obj is None:
            raise KeyError(f"pods {pod.key} not found")
        obj.setdefault("spec", {})["nodeName"] = ""
        self.store.update("pods", obj,
                          expected_rv=(obj.get("metadata") or {})
                          .get("resourceVersion"))


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
    asked for); a solver-service client (``solver_service=``) owns no
    engine and ignores it."""

    def __init__(self, store: Union[MemStore, APIClient, str],
                 policy: Optional[Policy] = None,
                 scheduler_name: str = api.DEFAULT_SCHEDULER_NAME,
                 batched: bool = True,
                 qps: float = 50.0, burst: int = 100, token: str = "",
                 tls=None, device: "str | torch.device | None" = "cuda",
                 ha_shards: Optional[int] = None,
                 incarnation: str = "", solver_service=None,
                 tenant: str = ""):
        if isinstance(store, str):
            store = APIClient(store, qps=qps, burst=burst, token=token,
                              tls=tls)
        self.store = store
        self.listers = Listers()
        if solver_service is not None:
            # Solver-service CLIENT mode: this daemon owns no device —
            # its solve verbs submit to a shared SolverService (or a
            # SolverClient speaking the HTTP /solve surface), tagged
            # with this daemon's tenant; cache feeding, assume/bind,
            # and failure handling stay local (tenancy/service.py).
            from kubernetes_tpu_torch.tenancy.service import ServiceEngine
            self.algorithm = ServiceEngine(solver_service, tenant=tenant,
                                           listers=self.listers)
        else:
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
        # Resident-state invariant checker (cache/verifier.py) and the
        # continuous rebalancing loop (scheduler/defrag.py); constructed
        # by run() behind KT_VERIFY_PERIOD and KT_DEFRAG.
        self.verifier = None
        self.defrag = None
        # Decision-latency SLO burn monitor (scheduler/slo.py); started
        # by run() at KT_SLO_PERIOD cadence, reported on /debug/vars.
        from kubernetes_tpu_torch.scheduler.slo import SLOMonitor
        self.slo = SLOMonitor()
        # Active-active HA (scheduler/shards.py): KT_HA_SHARDS > 0 runs
        # this incarnation as one of several over the same apiserver,
        # scheduling only pods in shards whose lease it holds.  0 (the
        # default) is the single-scheduler mode.
        import uuid

        if ha_shards is None:
            ha_shards = knobs.get_int("KT_HA_SHARDS")
        self.shards = None
        self._lease_mode = False
        # Bounded log of shard-takeover reconciles (served on
        # /debug/vars next to lastRecovery).
        self.shard_recoveries: list[dict] = []
        # shard -> (the acquisition stamp its last takeover reconcile
        # covered, that reconcile's report).
        self._shards_reconciled: dict[int, tuple] = {}
        # Multi-tenant solver service (KT_TENANTS, tenancy/): this
        # daemon's engine becomes a shared service — the pipeline packs
        # cross-tenant batches under weighted fairness, attributes
        # faults per tenant (per-tenant breakers; a tripped tenant's
        # pods requeue until its probe succeeds), and the bind path
        # records {tenant=}-labeled SLO metrics.  Unset = single-owner
        # engine.
        from kubernetes_tpu_torch import tenancy as tenancy_mod
        self.tenancy = None
        if solver_service is None and tenancy_mod.enabled():
            from kubernetes_tpu_torch.tenancy.service import SolverService
            self.tenancy = SolverService(
                engine=self.algorithm,
                ladder_fn=self.daemon.effective_ladder,
                urgent_s_fn=lambda:
                    self.daemon.pipeline.former.deadline_s)
            self.daemon.tenancy_service = self.tenancy
        if ha_shards > 0:
            from kubernetes_tpu_torch.scheduler.shards import ShardManager
            incarnation = incarnation or \
                knobs.get("KT_INCARNATION") or \
                f"scheduler-{uuid.uuid4().hex[:8]}"
            lease_s = knobs.get_float("KT_HA_LEASE_S")
            # Lease clients must not compete with the drain loop for the
            # main client's rate budget: a QPS-starved renew loses a
            # healthy incarnation its shards mid-storm.
            lease_client = store.clone(qps=0) \
                if isinstance(store, APIClient) else store
            self.shards = ShardManager(
                lease_client, incarnation=incarnation,
                n_shards=ha_shards,
                lease_duration=lease_s,
                renew_deadline=knobs.get_float(
                    "KT_HA_RENEW_S", default=lease_s * 2 / 3),
                retry_period=knobs.get_float(
                    "KT_HA_RETRY_S", default=lease_s / 6),
                on_acquired=self._on_shard_acquired,
                on_lost=self._on_shard_lost)
            self.daemon.owns_pod = self.shards.owns_pod

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
        if self.shards is not None and not _is_terminated(obj) and \
                not self.shards.owns_namespace(
                    meta.get("namespace", "default")):
            # Another incarnation's shard: enqueue() would drop the pod,
            # so skip the parse (two thirds of the pending stream with
            # three incarnations, all of it reflector time the shard
            # leases' thread competes with).
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

    # -- active-active HA (scheduler/shards.py) ---------------------------

    def _shard_ns_test(self, shard: int):
        from kubernetes_tpu_torch.scheduler.shards import shard_of
        n = self.shards.n_shards
        return lambda ns: shard_of(ns, n) == shard

    def _on_shard_acquired(self, shard: int, handoff: bool) -> None:
        """Takeover reconcile BEFORE draining the shard: relist, adopt
        the dead incarnation's landed binds, requeue its orphans (see
        recovery.reconcile_shard for the safety argument).  Runs on the
        shard manager's callback thread.  Every shard acquired and not
        yet reconciled rides the same relist, each with its own
        acquisition cutoff: a dead peer's k shards cost one decode of
        the pending pods, not k, each with the interpreter lock held
        (19b on the H100 host: a survivor that took 4 shards spent the
        takeover window in them).  Retried on failure — a chaos cut (or
        a flaky apiserver) killing THIS relist would otherwise strand
        the shard's backlog until the periodic sweep; the sweep is the
        backstop, not the plan."""
        from kubernetes_tpu_torch.scheduler import recovery
        from kubernetes_tpu_torch.scheduler.shards import shard_of
        done = self._shards_reconciled
        stamps = {s: self.shards.acquired_at(s)
                  for s in self.shards.owned() | {shard}}
        due = {s: at for s, at in stamps.items()
               if at is not None and done.get(s, (None,))[0] != at}
        if not due:
            # An earlier callback's relist covered this acquisition.
            report = done.get(shard, (None, None))[1]
            if report is not None:
                report["handoff"] = handoff
            return
        n = self.shards.n_shards
        last_err = None
        for attempt in range(3):
            try:
                # Listed after every due shard became ours.
                buckets: dict[int, list] = {s: [] for s in due}
                for obj in recovery.list_pending(self.store):
                    s = shard_of((obj.get("metadata") or {}).get(
                        "namespace") or "", n)
                    if s in buckets:
                        buckets[s].append(obj)
                reports = {s: recovery.reconcile_shard(
                    self.daemon, self.store, s, self._shard_ns_test(s),
                    scheduler_name=self.daemon.config.scheduler_name,
                    # Assumes minted since we won this lease are the
                    # live drain loop (the queue gate opened with the
                    # ownership flip, before this callback ran) — only
                    # pre-acquisition leftovers are stale.  The cutoff
                    # and the clock it is compared under must share a
                    # base, so both come from the shard manager.
                    assumed_before=at, now=self.shards.now,
                    listed=buckets[s]) for s, at in sorted(due.items())}
                break
            except Exception as err:  # noqa: BLE001 — retry the relist
                last_err = err
                time.sleep(0.2 * (attempt + 1))
        else:
            log.warning("shard(s) %s takeover reconcile failed after "
                        "retries (%s); the periodic ownership sweep "
                        "will converge it", sorted(due), last_err)
            return
        for s, report in reports.items():
            report["handoff"] = handoff if s == shard else None
            done[s] = (due[s], report)
            self.shard_recoveries.append(report)
        del self.shard_recoveries[:-32]

    def _shard_sweep_loop(self, period: float,
                          stale_assume_s: float) -> None:
        """The convergence backstop: periodically re-derive every OWNED
        shard's backlog from one relist.  Any pod a race dropped — an
        event delivered while the shard was unowned, a takeover relist
        lost to chaos, a backoff requeue shed mid-handoff — is picked
        up here at the latest; the enqueue path dedupes (a pod already
        queued, bound, or freshly assumed is skipped), so the sweep is
        idempotent."""
        from kubernetes_tpu_torch.scheduler import recovery
        while not self._stop.wait(period):
            if self.shards is None or not self.shards.owned():
                continue
            try:
                report = recovery.reconcile_shard(
                    self.daemon, self.store, -1,
                    self.shards.owns_namespace,
                    scheduler_name=self.daemon.config.scheduler_name,
                    # Shards we are actively draining: a YOUNG assume
                    # is a live in-flight bind (leave it alone); one
                    # older than any healthy bind round-trip is a leak
                    # to repair (forget + requeue — the CAS keeps a
                    # still-racing duplicate safe).
                    min_assume_age_s=stale_assume_s)
                if report["requeued"] or report["expired"]:
                    log.info("ownership sweep repaired state: %s",
                             report)
            except Exception:  # noqa: BLE001 — next sweep retries
                log.exception("ownership sweep failed; retrying next "
                              "period")

    def _on_shard_lost(self, shard: int) -> None:
        """Shed a lost shard: drop its queued pods (the new owner's
        takeover relist covers them) and forget our optimistic assumes
        there, releasing the phantom capacity.  In-flight binds are NOT
        chased — the apiserver CAS settles those races."""
        in_shard = self._shard_ns_test(shard)
        dropped = self.daemon.queue.delete_matching(
            lambda pod: in_shard(pod.namespace))
        forgotten = self.algorithm.cache.forget_pods_matching(
            lambda pod: in_shard(pod.namespace))
        if dropped or forgotten:
            log.info("shard %d lost: dropped %d queued pod(s), forgot "
                     "%d assume(s)", shard, dropped, len(forgotten))

    # -- lifecycle -------------------------------------------------------

    def run(self) -> "ConfigFactory":
        """f.Run (factory.go:387-416) + scheduler.Run: the reflectors,
        then (in order) the prewarm under KT_PREWARM, the startup
        reconciliation, the SLO monitor, the verifier, the defragmenter,
        the shard leases with their ownership sweep, the daemon loop and
        the assume-TTL sweep."""
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
            # startup latency).  With tenancy on, the warm batches span
            # the tenant namespaces: the selector-spread group axis is
            # per-namespace, so the first cross-tenant packed batch
            # would otherwise grow that capacity past what the
            # single-namespace warmup ran.
            samples = None
            if self.tenancy is not None:
                samples = [api.Pod(name=f"__warm-tenant-{i}",
                                   namespace=t)
                           for i, t in enumerate(self.tenancy.tenants)]
            self.daemon.prewarm(sample_pods=samples)
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
        verify_period = knobs.get_float("KT_VERIFY_PERIOD")
        if verify_period > 0:
            # Resident-state invariant checker (cache/verifier.py): a
            # low-frequency background cross-check of cache aggregates vs
            # the device-resident tensors vs apiserver truth, self-healing
            # by full re-snapshot on mismatch.
            from kubernetes_tpu_torch.cache.verifier import Verifier
            pod_reflectors = [r for r in self._reflectors
                              if r.kind == "pods"]

            def pod_streams():
                tokens = tuple(r.stream_token() for r in pod_reflectors)
                return None if None in tokens else tokens
            self.verifier = Verifier(
                self.algorithm.cache, resident=self.algorithm.resident,
                truth=lambda: self.store.list("pods")[0],
                streams=pod_streams)
            self._threads.append(self.verifier.run(period=verify_period))
        if knobs.get_bool("KT_DEFRAG"):
            # Always-on defragmentation (scheduler/defrag.py): dry joint
            # solves over the bound state propose bounded, PDB-vetoed
            # migration batches.  With tenancy on the probe rides the
            # SolverService's low-priority background lane (the joint
            # solve on the card) so defrag never steals device time from
            # live drains; without it the controller's host-side
            # feasibility walk stands in.
            from kubernetes_tpu_torch.scheduler.defrag import \
                DefragController
            probe = None
            if self.tenancy is not None:
                probe = lambda pods: self.tenancy.submit_background(  # noqa: E731
                    pods, joint=True)
            self.defrag = DefragController(self.daemon, self.store,
                                           probe=probe,
                                           verifier=self.verifier)
            self._threads.append(self.defrag.run())
        if self.shards is not None:
            # Shard leases start AFTER reflectors sync and the full
            # startup reconcile: each acquisition's takeover relist then
            # lands on a warm cache, and the drain loop below only ever
            # sees pods in shards this incarnation actually holds.
            self.shards.run()
            self._threads.extend(self.shards.threads)
            sweep_s = knobs.get_float("KT_HA_SWEEP_S")
            stale_assume_s = knobs.get_float("KT_HA_STALE_ASSUME_S")
            if sweep_s > 0:
                self._threads.append(threadreg.spawn(
                    self._shard_sweep_loop,
                    args=(sweep_s, stale_assume_s),
                    name="shard-ownership-sweep"))
        # Freeze the startup heap (torch and this package's modules, the
        # synced cache) out of the cyclic collector's reach, as the
        # extender does: every generation-2 collection would otherwise
        # walk it and stall an in-flight drain for 100-200 ms, the tail
        # of a trickle pod's bind latency.  Objects created while
        # serving are collected as before; stop() and abandon() unfreeze
        # (a process that runs several daemons gets their cycles back).
        t_gc = time.perf_counter()
        gc.collect()
        gc.freeze()
        log.info("froze the startup heap (%d objects) in %.3f s",
                 gc.get_freeze_count(), time.perf_counter() - t_gc)
        if self.shards is not None:
            enter_lease_mode()
            self._lease_mode = True
        self._threads.append(self.daemon.run(batched=self.batched))

        def ttl_sweep():  # cleanupAssumedPods (cache.go:309-330)
            idle, collected = False, time.monotonic()
            while not self._stop.wait(CLEANUP_PERIOD):
                self.algorithm.cache.cleanup_expired()
                if not self._lease_mode:
                    continue
                # The deferred generation-2 collection, once idle.
                was_idle, idle = idle, len(self.daemon.queue) == 0
                if was_idle and idle and \
                        time.monotonic() - collected >= GC_IDLE_PERIOD_S:
                    gc.collect()
                    collected = time.monotonic()
        self._threads.append(threadreg.spawn(ttl_sweep,
                                             name="assume-ttl-sweep"))
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.shards is not None:
            # Release the leases FIRST so peers take over within a
            # retry period instead of waiting out the lease duration.
            self.shards.stop()
        for r in self._reflectors:
            r.stop()
        self.slo.stop()
        if self.verifier is not None:
            self.verifier.stop()
        if self.defrag is not None:
            self.defrag.stop()
        self.daemon.stop()
        self._restore_gc()
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
        if self.shards is not None:
            # No lease release: a kill -9 leaves the shard leases to
            # expire on their own — the survivors' takeover clock.
            self.shards.abandon()
        for r in self._reflectors:
            r.stop()
        self.slo.stop()
        if self.verifier is not None:
            self.verifier.stop()
        if self.defrag is not None:
            # Thread stops, but in-flight migration intents stay on the
            # store exactly as a kill -9 leaves them — the next
            # incarnation's reconcile requeues or clears them.
            self.defrag.stop()
        self.daemon.abandon()
        self._restore_gc()

    def _restore_gc(self) -> None:
        gc.unfreeze()
        if self._lease_mode:
            self._lease_mode = False
            leave_lease_mode()

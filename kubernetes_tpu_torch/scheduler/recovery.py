"""Crash-safe restart reconciliation.

A scheduler killed mid-drain (SIGKILL between solve and bind, a node
dying under the daemon) leaves three classes of orphan behind:

* pods the dead incarnation ASSUMED but whose binds never reached the
  apiserver — unbound at relist; they must requeue, not strand Pending;
* pods whose binds DID land but whose watch confirmations the dead
  incarnation never processed — bound at relist; they must be re-adopted
  into the cache as confirmed capacity, not double-scheduled;
* cache entries with no apiserver record at all (the pod was deleted
  while the scheduler was down) — stale assumes that must expire.

The reflectors converge on all of this EVENTUALLY (relist Replace
semantics); this module turns "eventually" into a verified startup step:
one list against the apiserver, cross-checked against the cache and the
queue, every discrepancy repaired and counted
(``scheduler_restart_reconcile_total{action=}``), and the device-resident
tensors re-seeded from the rebuilt cache (epoch bump → full re-upload)
before the drain loop resumes.  Safety against the in-flight window the
kill abandoned rests on the apiserver's bind CAS: a zombie bind from the
dead incarnation either landed before the list (the pod shows bound and
is adopted) or lands after and loses the CAS to nothing — the pod is on
the queue, gets re-solved, and the zombie's 409 is absorbed by the
normal forget+requeue path.  A pod can therefore never double-bind or
strand across a restart.

``ConfigFactory.run()`` calls :func:`reconcile` after the reflectors
sync and before the drain loop starts (``KT_RECOVERY=0`` opts out).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("recovery")


def _migration_intent(obj: dict) -> Optional[dict]:
    """The defrag migration-intent annotation (scheduler/defrag.py) on a
    pod dict, parsed, or None.  An unparseable value still counts as an
    intent (it must be cleared) but carries no source node."""
    raw = ((obj.get("metadata") or {}).get("annotations") or {}).get(
        api.DEFRAG_MIGRATION_ANNOTATION_KEY)
    if raw is None:
        return None
    try:
        parsed = json.loads(raw)
        return parsed if isinstance(parsed, dict) else {}
    except ValueError:
        return {}


def _clear_migration_intent(store, obj: dict) -> bool:
    """Drop the intent annotation under CAS.  A lost CAS is fine — the
    live defragmenter's settle pass (or the next restart) retires it."""
    from kubernetes_tpu_torch.client import cas_update
    meta = obj.setdefault("metadata", {})
    ann = dict(meta.get("annotations") or {})
    if ann.pop(api.DEFRAG_MIGRATION_ANNOTATION_KEY, None) is None:
        return False
    meta["annotations"] = ann
    try:
        cas_update(store, "pods", obj)
    except Exception:  # noqa: BLE001 — CAS race: someone else owns it now
        return False
    return True


def reconcile(daemon, store, scheduler_name: Optional[str] = None) -> dict:
    """Reconcile the daemon's cache and queue against one apiserver
    relist; returns the action report (also stored by the factory as
    ``last_recovery`` and served on ``/debug/vars``).

    ``daemon`` is the scheduler (queue + algorithm.cache + resident
    mirror); ``store`` anything with ``list(kind)`` — a MemStore or an
    APIClient.  ``scheduler_name`` filters requeues to pods this daemon
    is responsible for (multi-scheduler dispatch)."""
    t0 = time.perf_counter()
    cache = daemon.config.algorithm.cache
    items, _rv = store.list("pods")
    report = {"readopted": 0, "requeued": 0, "expired": 0, "removed": 0,
              "confirmed": 0, "pods_listed": len(items),
              "migrations_recovered": 0, "migration_intents_cleared": 0}
    seen: set[str] = set()
    for obj in items:
        key = api.key_from_json(obj)
        seen.add(key)
        if api.is_terminated_json(obj):
            continue
        node = (obj.get("spec") or {}).get("nodeName") or ""
        intent = _migration_intent(obj)
        if node:
            if intent is not None:
                # A SIGKILL landed between the defragmenter's intent
                # stamp and its evict (or after the pod already rebound):
                # the pod is bound, so the stale intent just clears.
                if _clear_migration_intent(store, obj):
                    report["migration_intents_cleared"] += 1
                    metrics.DEFRAG_RECOVERED.labels(
                        action="cleared").inc()
            # Bound at the apiserver.  An assumed entry agreeing on the
            # node just flips to confirmed; anything else (unknown pod,
            # or one tracked on a DIFFERENT node) re-adopts through the
            # full add path — add_pod replaces the stale attachment, so
            # the capacity stops being charged to the wrong node.
            if cache.confirm_assumed(key, node):
                report["confirmed"] += 1
            else:
                tracked = cache.get_pod(key)
                if tracked is None or tracked.node_name != node:
                    cache.add_pod(api.pod_from_json(obj))
                    report["readopted"] += 1
            daemon.queue.delete(key)
        else:
            # Unbound: the dead incarnation may have assumed it (bind
            # never landed) — forget the stale assume and requeue.
            if cache.is_assumed(key):
                pod = cache.get_pod(key)
                if pod is not None:
                    cache.forget_pod(pod)
                    pod.node_name = ""
                report["expired"] += 1
            if key not in daemon.queue:
                pod = api.pod_from_json(obj)
                if scheduler_name is None or \
                        pod.scheduler_name == scheduler_name:
                    daemon.enqueue(pod)
                    if key in daemon.queue:
                        report["requeued"] += 1
            if intent is not None:
                # A SIGKILL landed between the defragmenter's evict and
                # the pod's re-bind: the migrant is pending and (by the
                # requeue above, or the reflector sync before this pass)
                # back on the queue — requeued, not stranded.  Clear the
                # intent so nothing mistakes it for an in-flight move.
                if _clear_migration_intent(store, obj):
                    report["migrations_recovered"] += 1
                    metrics.DEFRAG_RECOVERED.labels(
                        action="requeued").inc()
                    fr = daemon.config.flight_recorder
                    if fr is not None:
                        fr.record_defrag(key, "crash-recovered",
                                         from_node=str(
                                             intent.get("from", "")))
    # Cache entries with no apiserver record: ghosts from the previous
    # incarnation (pod deleted while the scheduler was down).
    for key, _node, assumed in cache.tracked_pods():
        if key in seen:
            continue
        pod = cache.get_pod(key)
        if pod is not None:
            cache.remove_pod(pod)
            report["expired" if assumed else "removed"] += 1
    # Re-seed the device-resident tensors from the reconciled cache: the
    # epoch bump forces the next drain's sync to upload everything, so
    # no pre-crash device state survives into post-restart decisions.
    cache.force_resnapshot()
    daemon.config.algorithm.resident.invalidate()
    for action in ("readopted", "requeued", "expired", "removed",
                   "confirmed"):
        if report[action]:
            metrics.RESTART_RECONCILE.labels(action=action).inc(
                report[action])
    report["duration_s"] = round(time.perf_counter() - t0, 4)
    if any(report[a] for a in ("readopted", "requeued", "expired",
                               "removed")):
        log.info("restart reconciliation repaired state: %s", report)
    return report


def list_pending(store) -> list[dict]:
    """The relist :func:`reconcile_shard` works from: the pending pods
    (``spec.nodeName=`` server-side where the store supports field
    selectors, else every pod)."""
    try:
        items, _rv = store.list("pods", field_selector="spec.nodeName=")
    except TypeError:  # raw MemStore: no field selectors; filter here
        items, _rv = store.list("pods")
    return items


def reconcile_shard(daemon, store, shard: int, owns,
                    scheduler_name: Optional[str] = None,
                    min_assume_age_s: float = 0.0,
                    assumed_before: Optional[float] = None,
                    now: Callable[[], float] = time.monotonic,
                    listed: Optional[list] = None) -> dict:
    """Shard-takeover reconciliation (active-active HA,
    scheduler/shards.py): the survivor that just won shard ``shard``'s
    orphaned lease re-derives that shard's backlog from one apiserver
    relist BEFORE draining it.

    The dead incarnation's in-flight window decomposes exactly like a
    restart, restricted to the shard:

    * pods it ASSUMED whose binds never landed are unbound at the
      relist — they belong on OUR queue now (the dead daemon's assume
      lived only in its process memory, so there is nothing to forget
      here; our own stale assumes from a previous ownership spell ARE
      forgotten);
    * pods whose binds DID land show bound — our cache either confirmed
      them from the watch already or adopts them here;
    * a ZOMBIE bind still in the dead daemon's pipe either landed
      before the list (adopted above) or lands after and meets the
      apiserver's nodeName CAS: if we re-bound the pod first the zombie
      409s into nothing; if the zombie wins first, OUR bind 409s and
      the ordinary forget+requeue path absorbs it.  Either way the pod
      binds exactly once — the safety argument is the CAS, the lease
      only minimizes how often it is needed.

    ``owns(namespace) -> bool`` is the membership test for the pods
    this takeover covers — the factory passes the single-shard test
    ``shard_of(ns) == shard`` so a takeover never re-walks shards
    already held.  Returns the action report.

    Only the PENDING set is listed (``spec.nodeName=`` server-side,
    where the store supports field selectors): bound pods are already
    live-synced into every incarnation's cache by its assigned-pod
    reflector, so re-walking them here would make each takeover an
    O(all-pods) JSON parse — measured in the HA soak, exactly the load
    spike that starved the renew loop into a handoff death spiral.

    ``assumed_before`` / ``min_assume_age_s`` distinguish the two
    callers' stale-assume tests.  A TAKEOVER passes ``assumed_before``
    = the shard's lease-acquisition timestamp (``time.monotonic``
    base): an assume MINTED BEFORE we won the lease is a leftover of an
    earlier ownership spell (losing the shard forgot our assumes, so
    anything older than the acquisition predates the handoff) and is
    forgotten, while one minted SINCE is our own live in-flight bind —
    the queue gate opens the moment the tick thread flips ownership,
    so the drain loop can legitimately assume pods in the seconds
    before this reconcile runs, and forgetting those would free their
    nodes' capacity while the binds land anyway (transient overcommit
    plus a duplicate 409).  Age alone cannot make that call: a
    pre-handoff leftover can be merely milliseconds older than a
    post-acquisition live assume.  The periodic ownership SWEEP has no
    acquisition edge to anchor on — it runs over shards we are
    steadily draining — so it uses the age threshold instead: a YOUNG
    assume is usually a live in-flight bind, but an OLD one is a leak
    (a bind result lost to chaos) that would otherwise strand its pod
    until the cache TTL; the sweep passes a threshold above any
    healthy bind round-trip (KT_HA_STALE_ASSUME_S, default 3 s),
    forgetting only assumes older than that.  The bind CAS keeps a
    still-racing duplicate safe under either test.

    ``listed`` is a :func:`list_pending` the caller made after this
    shard became ours (several takeovers then share one relist); None
    lists here."""
    t0 = time.perf_counter()
    cache = daemon.config.algorithm.cache
    items = list_pending(store) if listed is None else listed
    report = {"shard": shard, "readopted": 0, "requeued": 0,
              "expired": 0, "confirmed": 0, "pods_in_shard": 0}
    for obj in items:
        key = api.key_from_json(obj)
        if api.is_terminated_json(obj):
            continue
        if not owns((obj.get("metadata") or {}).get("namespace") or ""):
            continue
        report["pods_in_shard"] += 1
        node = (obj.get("spec") or {}).get("nodeName") or ""
        if node:
            if cache.confirm_assumed(key, node):
                report["confirmed"] += 1
            else:
                tracked = cache.get_pod(key)
                if tracked is None or tracked.node_name != node:
                    cache.add_pod(api.pod_from_json(obj))
                    report["readopted"] += 1
            daemon.queue.delete(key)
        else:
            if cache.is_assumed(key):
                age = cache.assumed_age(key)
                if assumed_before is not None:
                    # ``now`` must share the cutoff's clock base (the
                    # factory passes the shard manager's clock together
                    # with its acquisition stamp; cache ages are
                    # durations, transferable between bases ticking at
                    # wall rate).
                    birth = now() - age if age is not None else None
                    if birth is None or birth >= assumed_before:
                        continue  # minted under OUR ownership: live
                elif min_assume_age_s > 0.0 and \
                        (age is None or age < min_assume_age_s):
                    continue  # live in-flight bind; not ours to undo
                pod = cache.get_pod(key)
                if pod is None:
                    continue  # confirmed/forgotten under us: not ours
                try:
                    cache.forget_pod(pod)
                except ValueError:
                    # A live bind thread confirmed or forgot this
                    # assume between our is_assumed read and here (the
                    # race scheduler._forget_quietly also tolerates) —
                    # the pod is no longer ours to expire, and one
                    # contested pod must not abort the rest of the
                    # pass (nor count as a phantom repair).
                    continue
                pod.node_name = ""
                report["expired"] += 1
            if key not in daemon.queue:
                pod = api.pod_from_json(obj)
                if scheduler_name is None or \
                        pod.scheduler_name == scheduler_name:
                    daemon.enqueue(pod)
                    if key in daemon.queue:
                        report["requeued"] += 1
    for action in ("readopted", "requeued", "expired", "confirmed"):
        if report[action]:
            metrics.RESTART_RECONCILE.labels(action=action).inc(
                report[action])
    report["duration_s"] = round(time.perf_counter() - t0, 4)
    if report["requeued"] or report["expired"] or report["readopted"]:
        log.info("shard %d takeover reconciled: %s", shard, report)
    return report

"""Continuous rebalancing: the joint solver as an always-on defragmenter.

The joint solve beats greedy placement by ~13 % but only fires on a
pending-pod avalanche; a cluster that merely survives churn still decays
— biased churn (small pods deleted, large ones created) leaves every
node a little bit full, and gangs and large pods strand Pending with no
defense.  This controller is the background duty that reverses the
decay:

1. **Settle** — retire in-flight migrations (rebound pods get their
   intent annotation cleared and arm the verifier's ``defrag``
   reconciliation kind), and credit previously-blocked pods now bound
   (``scheduler_defrag_unblocked_total`` — the soak's ``defrag_gain``
   numerator).
2. **Probe** — dry-solve the pending set.  With a SolverService
   attached the probe rides ``submit_background`` — a low-priority
   tenant that only takes the engine when no live submit is pending, so
   defrag solves never steal device time from live drains; without one
   the host-side feasibility walk below stands in (same blocked-set
   answer, no device).  Pods the solve cannot place are the BLOCKED set.
3. **Plan** — a pure host-side rebalance over apiserver truth: per
   blocked pod, the node needing the fewest movable victims evicted
   such that (a) the blocked pod then fits and (b) every victim re-fits
   on some other node's simulated free space.  Gang-aware twice over:
   gang-member victims are never evicted (migrating one strands its
   gang), and a blocked gang is planned all-or-nothing.
4. **Gate** — the plan is trimmed to ``KT_DEFRAG_MAX_MIGRATIONS``, then
   vetoed wholesale if projected gain per migration falls below
   ``KT_DEFRAG_MIN_GAIN`` or in-flight migrations would exceed
   ``KT_DEFRAG_BUDGET`` (both recorded ``vetoed_budget``); every victim
   is additionally vetoed by the PDB status the DisruptionController
   publishes (``vetoed_pdb`` — a victim whose PDB has no headroom is
   simply not movable).
5. **Execute** — each migration is a crash-safe two-phase record:
   first the intent annotation (``DEFRAG_MIGRATION_ANNOTATION_KEY`` =
   ``{"from": node, "round": n}``) lands under CAS, then the evict-to-
   pending (spec.nodeName cleared under CAS via the binder's
   ``unbind``).  The unassigned reflector's set-transition then requeues
   the pod through the completely ordinary enqueue -> solve -> bind
   path.  A SIGKILL between the phases leaves either a bound pod with a
   stale intent (startup reconcile clears it) or an unbound pod with an
   intent (startup reconcile requeues it and clears the intent) — never
   a stranded pod; see ``scheduler/recovery.py``.

Every decision — executed, vetoed-by-budget, vetoed-by-PDB, CAS-lost,
completed, crash-recovered — is metered
(``scheduler_defrag_migrations_total{result=}``) and flight-recorded
(``FlightRecorder.record_defrag``), so ``kubectl explain pod`` answers
"why did the rebalancer move my pod".

Host-side only by design: no torch import, no
cache mutation beyond the eviction's ``remove_pod`` (the same call the
preemption path makes).  Knobs are read once at construction.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client import cas_update
from kubernetes_tpu_torch.controller.replication import _matches
from kubernetes_tpu_torch.utils import knobs, locktrace, metrics, threadreg
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("defrag")

# Resource dimensions a plan is simulated over: (milli_cpu, memory,
# pod slots) — the exact triple MemStore._pod_requests / _node_alloc
# budget binds against, so the plan and the server's capacity check can
# never disagree about whether a move fits.
DIMS = 3


def _node_capacity(obj: dict) -> Optional[list[int]]:
    """status.allocatable of a node JSON as [milli_cpu, memory, pods],
    or None for a node the rebalancer must leave alone (not ready)."""
    node = api.node_from_json(obj)
    if not node.is_ready():
        return None
    return [node.allocatable_milli_cpu, node.allocatable_memory,
            node.allocatable_pods]


def _fits(req: tuple, free: list) -> bool:
    return all(req[i] <= free[i] for i in range(DIMS))


class DefragController:
    """The background rebalancing loop.  ``daemon`` is the scheduler
    (cache + queue + binder + recorder), ``store`` the apiserver source
    (MemStore or APIClient), ``probe`` an optional dry-solve callable
    (pods -> placements | None-when-busy; the factory wires the
    SolverService's low-priority lane), ``verifier`` the cache
    invariant checker whose ``defrag`` reconciliation kind each settled
    migration arms."""

    def __init__(self, daemon, store, probe: Optional[Callable] = None,
                 verifier=None):
        self.daemon = daemon
        self.store = store
        self.probe = probe
        self.verifier = verifier
        self.period_s = knobs.get_float("KT_DEFRAG_PERIOD_S")
        self.max_migrations = knobs.get_int("KT_DEFRAG_MAX_MIGRATIONS")
        self.min_gain = knobs.get_float("KT_DEFRAG_MIN_GAIN")
        self.budget = knobs.get_int("KT_DEFRAG_BUDGET")
        self._lock = locktrace.make_lock("scheduler.DefragController")
        self._stop = threading.Event()
        # In-flight two-phase migrations: pod key -> source node.  An
        # entry lives from the executed evict until the settle pass sees
        # the pod rebound (or deleted).
        self._inflight: dict[str, str] = {}
        # Blocked-set memory for gain attribution: a key seen blocked by
        # a probe and later observed bound was unblocked by the moves.
        self._blocked_prev: set[str] = set()
        self._round = 0
        self.stats = {"rounds": 0, "probes": 0, "probe_skipped": 0,
                      "blocked_peak": 0, "migrations_executed": 0,
                      "migrations_completed": 0, "vetoed_budget": 0,
                      "vetoed_pdb": 0, "cas_conflict": 0, "unblocked": 0,
                      "max_batch": 0}

    # -- plumbing ---------------------------------------------------------

    def _flight(self, pod_key: str, decision: str, from_node: str = "",
                to_node: str = "", target: str = "") -> None:
        fr = self.daemon.config.flight_recorder
        if fr is not None:
            fr.record_defrag(pod_key, decision, from_node=from_node,
                             to_node=to_node, target=target)

    def _clear_intent(self, obj: dict) -> bool:
        """Drop the migration-intent annotation under CAS.  A lost CAS
        is left for the next settle pass (or the startup reconciler)."""
        meta = obj.setdefault("metadata", {})
        ann = dict(meta.get("annotations") or {})
        if ann.pop(api.DEFRAG_MIGRATION_ANNOTATION_KEY, None) is None:
            return False
        meta["annotations"] = ann
        try:
            cas_update(self.store, "pods", obj)
        except Exception:  # noqa: BLE001 — retried next settle
            return False
        return True

    # -- 1. settle --------------------------------------------------------

    def _settle(self, by_key: dict[str, dict]) -> None:
        """Retire in-flight migrations against one truth snapshot and
        credit unblocked pods."""
        with self._lock:
            inflight = dict(self._inflight)
            blocked_prev = set(self._blocked_prev)
        for key, from_node in inflight.items():
            obj = by_key.get(key)
            if obj is None:
                # Deleted mid-migration (churn): nothing left to rebind.
                with self._lock:
                    self._inflight.pop(key, None)
                continue
            node = (obj.get("spec") or {}).get("nodeName") or ""
            if not node:
                # Still pending: the live drain owns it — but nudge it
                # back onto the queue anyway.  The enqueue is idempotent
                # (keyed), and it guarantees a migrant can never strand
                # on a lost or reordered watch delivery: the settle
                # cadence re-offers it until it lands somewhere.
                try:
                    self.daemon.enqueue(api.pod_from_json(obj))
                except Exception:  # noqa: BLE001 — next settle retries
                    pass
                continue
            self._clear_intent(obj)
            self._flight(key, "completed", from_node=from_node,
                         to_node=node)
            self.stats["migrations_completed"] += 1
            if self.verifier is not None:
                self.verifier.note_defrag([key])
            with self._lock:
                self._inflight.pop(key, None)
        unblocked = {k for k in blocked_prev
                     if ((by_key.get(k) or {}).get("spec") or {})
                     .get("nodeName")}
        gone = {k for k in blocked_prev if k not in by_key}
        if unblocked:
            metrics.DEFRAG_UNBLOCKED.inc(len(unblocked))
            self.stats["unblocked"] += len(unblocked)
        with self._lock:
            self._blocked_prev -= unblocked | gone
            metrics.DEFRAG_INFLIGHT.set(len(self._inflight))

    # -- 2. probe ---------------------------------------------------------

    def _blocked_set(self, pend_pods: list,
                     free: dict[str, list]) -> Optional[list]:
        """Pods the dry solve cannot place, or None when the engine
        stayed busy (skip the round — live drains have priority)."""
        if self.probe is not None:
            self.stats["probes"] += 1
            placements = self.probe(pend_pods)
            if placements is None:
                self.stats["probe_skipped"] += 1
                return None
            return [p for p, dest in zip(pend_pods, placements)
                    if dest is None]
        # Host fallback (no SolverService lane): a pod that fits whole
        # on no node's current free space is blocked.  Conservative —
        # it cannot see multi-pod interactions the joint solve can, but
        # it never claims a schedulable pod is blocked.
        out = []
        for p in pend_pods:
            req = MemStore._pod_requests(api.pod_to_json(p))
            if not any(_fits(req, f) for f in free.values()):
                out.append(p)
        return out

    # -- 3/4. plan + gates -----------------------------------------------

    def _pdb_guard(self) -> Callable[[dict], bool]:
        """A per-round veto closure over the PDB status the
        DisruptionController publishes: ``veto(pod_json)`` is True when
        evicting the pod would break any matching budget.  Headroom
        (currentHealthy - desiredHealthy) is consumed per allowed
        eviction, so one batch can never spend a PDB twice; a PDB with
        no published status vetoes conservatively."""
        try:
            pdbs, _ = self.store.list("poddisruptionbudgets")
        except Exception:  # noqa: BLE001 — no PDB state, nothing vetoes
            pdbs = []
        entries = []
        for pdb in pdbs:
            meta = pdb.get("metadata") or {}
            status = pdb.get("status") or {}
            if status.get("disruptionAllowed"):
                left = max(int(status.get("currentHealthy", 0)) -
                           int(status.get("desiredHealthy", 0)), 0)
            else:
                left = 0
            entries.append({"ns": meta.get("namespace", "default"),
                            "sel": (pdb.get("spec") or {})
                            .get("selector") or {}, "left": left})

        def veto(pod_obj: dict) -> bool:
            ns = (pod_obj.get("metadata") or {}).get("namespace",
                                                     "default")
            matching = [e for e in entries
                        if e["ns"] == ns and _matches(e["sel"], pod_obj)]
            if not matching:
                return False
            if any(e["left"] <= 0 for e in matching):
                return True
            for e in matching:
                e["left"] -= 1
            return False
        return veto

    def _plan(self, blocked: list, free: dict[str, list],
              bound_by_node: dict[str, list], pdb_veto) -> list[dict]:
        """Greedy rebalance plan: per blocked pod (gangs as a unit,
        largest first), the node whose deficit the fewest movable
        victims cover, each victim re-fitting on simulated free space
        elsewhere.  Returns subplans
        ``{"for": pod_key, "node": n, "victims": [(key, from_node)]}``;
        records ``vetoed_pdb`` for victims a budget made immovable."""
        taken: set[str] = set()       # victims already claimed
        pdb_vetoed: set[str] = set()  # recorded once per round
        with self._lock:
            unmovable = set(self._inflight)
        plans: list[dict] = []

        def movable(vkey: str, vobj: dict) -> bool:
            if vkey in taken or vkey in unmovable:
                return False
            ann = (vobj.get("metadata") or {}).get("annotations") or {}
            if ann.get(api.GANG_ANNOTATION_KEY):
                return False  # never strand a gang by moving one member
            if api.DEFRAG_MIGRATION_ANNOTATION_KEY in ann:
                return False  # already mid-migration
            if pdb_veto(vobj):
                if vkey not in pdb_vetoed:
                    pdb_vetoed.add(vkey)
                    self.stats["vetoed_pdb"] += 1
                    metrics.DEFRAG_MIGRATIONS.labels(
                        result="vetoed_pdb").inc()
                    self._flight(vkey, "vetoed_pdb")
                return False
            return True

        def plan_one(pod) -> Optional[dict]:
            """One blocked pod's cheapest subplan, committed into the
            simulated free space; None when no node can be cleared."""
            req = MemStore._pod_requests(api.pod_to_json(pod))
            best = None  # (n_victims, node, victims, relocations)
            for node, f in free.items():
                if _fits(req, f):
                    # Schedulable after earlier subplans (or plain
                    # churn): the live drain will place it — no moves.
                    free[node] = [f[i] - req[i] for i in range(DIMS)]
                    return {"for": pod.key, "node": node, "victims": []}
                deficit = [max(req[i] - f[i], 0) for i in range(DIMS)]
                victims: list[tuple[str, str]] = []
                relocations: list[tuple[str, tuple, str]] = []
                # The simulated free space: ``free`` with this node's
                # relocations applied, copied only where one lands (the
                # JAX package copies every node's row for every node
                # tried, O(N^2) per blocked pod; the choices are the
                # same, scanned in the same node order).
                sim: dict[str, list] = {}
                cands = sorted(
                    (c for c in bound_by_node.get(node, ())
                     if movable(c[0], c[1])),
                    key=lambda c: c[2][0], reverse=True)
                for vkey, vobj, vreq in cands:
                    if all(d <= 0 for d in deficit):
                        break
                    # The victim must re-fit somewhere else, in sim.
                    dest = next((n for n in free if n != node and
                                 _fits(vreq, sim.get(n, free[n]))), None)
                    if dest is None:
                        continue
                    row = sim.setdefault(dest, list(free[dest]))
                    for i in range(DIMS):
                        row[i] -= vreq[i]
                        deficit[i] = max(deficit[i] - vreq[i], 0)
                    victims.append((vkey, node))
                    relocations.append((vkey, vreq, dest))
                if any(d > 0 for d in deficit) or not victims:
                    continue
                if best is None or len(victims) < best[0]:
                    best = (len(victims), node, victims, relocations)
            if best is None:
                return None
            _, node, victims, relocations = best
            # Commit into the shared sim: victims leave their node, land
            # on their relocation target, the blocked pod takes the gap.
            for vkey, vreq, dest in relocations:
                for i in range(DIMS):
                    free[node][i] += vreq[i]
                    free[dest][i] -= vreq[i]
                taken.add(vkey)
            for i in range(DIMS):
                free[node][i] -= req[i]
            bound_by_node[node] = [c for c in bound_by_node.get(node, ())
                                   if c[0] not in taken]
            return {"for": pod.key, "node": node, "victims": victims}

        # Gangs group together and plan all-or-nothing (a half-unblocked
        # gang still cannot start); singles plan largest-request first.
        groups: dict[str, list] = {}
        singles: list = []
        for pod in blocked:
            (groups.setdefault(pod.gang, []) if pod.gang
             else singles).append(pod)
        singles.sort(key=lambda p: MemStore._pod_requests(
            api.pod_to_json(p))[0], reverse=True)
        for pod in singles:
            sub = plan_one(pod)
            if sub is not None:
                plans.append(sub)
        for gang, members in groups.items():
            snap_free = {n: list(v) for n, v in free.items()}
            snap_taken = set(taken)
            subs = []
            for pod in members:
                sub = plan_one(pod)
                if sub is None:
                    break
                subs.append(sub)
            if len(subs) == len(members):
                plans.extend(subs)
            else:
                # Roll the gang's partial moves back out of the sim.
                free.clear()
                free.update(snap_free)
                taken.clear()
                taken.update(snap_taken)
        return plans

    # -- 5. execute -------------------------------------------------------

    def _execute(self, plans: list[dict]) -> int:
        """Run the gated batch: per victim, stamp the intent (phase 1,
        CAS), evict to pending (phase 2, CAS via the binder's unbind),
        drop the cache attachment.  Any lost CAS skips that victim."""
        cache = self.daemon.config.algorithm.cache
        unbind = getattr(self.daemon.config.binder, "unbind", None)
        executed = 0
        for sub in plans:
            for vkey, vnode in sub["victims"]:
                obj = self.store.get("pods", vkey)
                if obj is None or not ((obj.get("spec") or {})
                                       .get("nodeName") or ""):
                    continue  # deleted or already pending: no move left
                ann = (obj.setdefault("metadata", {})
                       .setdefault("annotations", {}))
                ann[api.DEFRAG_MIGRATION_ANNOTATION_KEY] = json.dumps(
                    {"from": vnode, "round": self._round})
                try:
                    obj = cas_update(self.store, "pods", obj)
                except Exception:  # noqa: BLE001 — racing writer won
                    self.stats["cas_conflict"] += 1
                    metrics.DEFRAG_MIGRATIONS.labels(
                        result="cas_conflict").inc()
                    self._flight(vkey, "cas_conflict", from_node=vnode)
                    continue
                pod = api.pod_from_json(obj)
                try:
                    if unbind is not None:
                        unbind(pod)
                    else:
                        obj.setdefault("spec", {})["nodeName"] = ""
                        cas_update(self.store, "pods", obj)
                except Exception:  # noqa: BLE001 — evict lost its CAS
                    self.stats["cas_conflict"] += 1
                    metrics.DEFRAG_MIGRATIONS.labels(
                        result="cas_conflict").inc()
                    self._flight(vkey, "cas_conflict", from_node=vnode)
                    cur = self.store.get("pods", vkey)
                    if cur is not None:
                        self._clear_intent(cur)  # back out phase 1
                    continue
                cached = cache.get_pod(vkey)
                if cached is not None:
                    cache.remove_pod(cached)
                with self._lock:
                    self._inflight[vkey] = vnode
                executed += 1
                self.stats["migrations_executed"] += 1
                metrics.DEFRAG_MIGRATIONS.labels(result="executed").inc()
                self._flight(vkey, "executed", from_node=vnode,
                             target=sub["for"])
                self.daemon.config.recorder.eventf(
                    vkey, "Normal", "DefragMigration",
                    f"Evicted from {vnode} by the defragmenter to "
                    f"unblock {sub['for']}")
        with self._lock:
            metrics.DEFRAG_INFLIGHT.set(len(self._inflight))
        self.stats["max_batch"] = max(self.stats["max_batch"], executed)
        if executed:
            # Requeue each subplan's anchor NOW, in-process.  The anchor
            # is typically parked in the backoff heap (it failed to fit
            # for many cycles), so without this the evicted victim's
            # watch event re-solves the victim ALONE — and the most-free
            # node is the one it just vacated: a ping-pong.  An eager
            # enqueue puts the anchor at the head of the race for the
            # freed space.
            for sub in plans:
                obj = self.store.get("pods", sub["for"])
                if obj is None or ((obj.get("spec") or {})
                                   .get("nodeName") or ""):
                    continue
                try:
                    self.daemon.enqueue(api.pod_from_json(obj))
                except Exception:  # noqa: BLE001 — watch path still runs
                    pass
        return executed

    # -- a round ----------------------------------------------------------

    def run_once(self) -> dict:
        """One settle -> probe -> plan -> gate -> execute round.  Returns
        the round report (tests and /debug consumers read it)."""
        self._round += 1
        self.stats["rounds"] += 1
        metrics.DEFRAG_ROUNDS.inc()
        report = {"round": self._round, "blocked": 0, "planned": 0,
                  "migrations": 0, "executed": 0, "veto": ""}
        items, _rv = self.store.list("pods")
        by_key = {api.key_from_json(o): o for o in items}
        self._settle(by_key)
        sched = self.daemon.config.scheduler_name
        pend_pods = []
        with self._lock:
            inflight = set(self._inflight)
        for key, obj in by_key.items():
            if key in inflight or api.is_terminated_json(obj):
                continue
            if (obj.get("spec") or {}).get("nodeName"):
                continue
            pod = api.pod_from_json(obj)
            if sched is None or pod.scheduler_name == sched:
                pend_pods.append(pod)
        if not pend_pods:
            return report
        nodes, _ = self.store.list("nodes")
        free: dict[str, list] = {}
        for n in nodes:
            cap = _node_capacity(n)
            if cap is not None:
                free[api.key_from_json(n)] = cap
        bound_by_node: dict[str, list] = {}
        for key, obj in by_key.items():
            if api.is_terminated_json(obj):
                continue
            node = (obj.get("spec") or {}).get("nodeName") or ""
            if not node or node not in free:
                continue
            req = MemStore._pod_requests(obj)
            f = free[node]
            for i in range(DIMS):
                f[i] -= req[i]
            bound_by_node.setdefault(node, []).append((key, obj, req))
        blocked = self._blocked_set(
            pend_pods, {n: list(v) for n, v in free.items()})
        if blocked is None:
            report["veto"] = "engine_busy"
            return report
        report["blocked"] = len(blocked)
        with self._lock:
            self._blocked_prev |= {p.key for p in blocked}
        self.stats["blocked_peak"] = max(self.stats["blocked_peak"],
                                         len(blocked))
        if not blocked:
            return report
        plans = self._plan(blocked, free, bound_by_node,
                           self._pdb_guard())
        plans = [p for p in plans if p["victims"]]
        report["planned"] = len(plans)
        if not plans:
            return report
        # Trim whole subplans to the per-round migration cap — never a
        # partial eviction set that frees space for nobody.
        trimmed: list[dict] = []
        n_migrations = 0
        for sub in plans:
            if n_migrations + len(sub["victims"]) > self.max_migrations:
                continue
            trimmed.append(sub)
            n_migrations += len(sub["victims"])
        plans = trimmed
        report["migrations"] = n_migrations
        if not plans:
            report["veto"] = "vetoed_budget"
            return report
        for key, reason, count in self._gate(plans, n_migrations):
            self.stats["vetoed_budget"] += count
            metrics.DEFRAG_MIGRATIONS.labels(result=reason).inc(count)
            self._flight(key, reason)
            report["veto"] = reason
        if report["veto"]:
            return report
        for sub in plans:
            self._flight(sub["for"], "proposed", to_node=sub["node"])
        report["executed"] = self._execute(plans)
        if report["executed"]:
            log.info("defrag round %d: %d blocked, %d migration(s) "
                     "executed for %d subplan(s)", self._round,
                     len(blocked), report["executed"], len(plans))
        return report

    def _gate(self, plans: list[dict], n_migrations: int) -> list[tuple]:
        """The cost-model gates over a trimmed plan.  Returns veto
        records ``(anchor_key, reason, migration_count)`` — empty means
        the batch executes."""
        anchor = plans[0]["for"]
        with self._lock:
            in_flight = len(self._inflight)
        if in_flight + n_migrations > self.budget:
            return [(anchor, "vetoed_budget", n_migrations)]
        gain = len(plans)  # blocked pods this batch unblocks
        if n_migrations > 0 and gain / n_migrations < self.min_gain:
            return [(anchor, "vetoed_budget", n_migrations)]
        return []

    # -- lifecycle --------------------------------------------------------

    def report(self) -> dict:
        """Stats + live in-flight view (the soak artifact's source)."""
        with self._lock:
            out = dict(self.stats)
            out["inflight"] = len(self._inflight)
        return out

    def run(self, period: Optional[float] = None) -> threading.Thread:
        if period is None:
            period = self.period_s

        def loop():
            while not self._stop.wait(period):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 — the rebalancer must
                    log.exception(  # never take the daemon down with it
                        "defrag round crashed; continuing")
        return threadreg.spawn(loop, name="defrag")

    def stop(self) -> None:
        self._stop.set()

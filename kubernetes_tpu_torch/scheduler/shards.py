"""Active-active HA: sharded scheduler incarnations over one shared state.

One scheduler daemon is a single point of stall: a SIGKILL parks every
pending pod until the recovery reconciler (scheduler/recovery.py) brings
a fresh incarnation up.  Production runs SEVERAL incarnations against the
same apiserver, Omega-style — shared state, optimistic concurrency — and
this module is the partition layer that keeps the steady state conflict-
free while the bind CAS stays the safety net:

* the namespace keyspace is split into ``n_shards`` SHARDS by a hash
  that is deterministic ACROSS PROCESSES (crc32 — ``hash()`` is salted
  per interpreter and two incarnations disagreeing on the shard map
  would both schedule, or neither);
* each shard is one renewable LEASE — an ``APIResourceLock`` on its own
  apiserver object (``kube-scheduler-shard-<i>``), CAS'd exactly like
  the controller-manager's election lock, with per-shard
  ``LeaderElector`` record/expiry semantics reused wholesale;
* an incarnation schedules ONLY pods whose namespace hashes into a
  shard it holds; everything else is dropped at the queue feed and
  picked up by that shard's owner;
* when an incarnation dies, its leases expire within ``lease_duration``
  and the survivors steal them — each acquisition fires
  ``on_acquired(shard)``, whose factory callback runs the shard-scoped
  takeover reconcile (relist, forget stale assumes, requeue the
  orphans) before the survivor drains the shard;
* during the handoff window two incarnations can briefly cover one
  shard (the old holder's in-flight drain + the thief).  That is SAFE,
  not merely tolerated: the apiserver binds ``spec.nodeName`` by CAS,
  so one bind lands and the loser 409s into the ordinary
  forget-and-requeue path (counted as
  ``scheduler_cross_shard_bind_conflicts_total``).

Acquisition is POLITE: before trying a free shard, an incarnation backs
off proportionally to the shards it already holds, so a lightly-loaded
peer wins the race and the shard map stays roughly balanced without any
central assignment.  Politeness only delays, never blocks — a lone
survivor still ends up holding everything.

Politeness alone cannot help a LATE JOINER: every lease is held and
renewed, so a freshly started incarnation (or one recovering after a
crash) would starve.  Incarnations therefore heartbeat a shared
PRESENCE object (``kube-scheduler-incarnations``, annotation-CAS like
the locks), and a holder that sees a stably-live peer stuck below its
fair share RELEASES one surplus shard (gracefully — the record is
zeroed, politeness hands it to the hungry peer).  Liveness is judged by
OBSERVED CHANGE, never by comparing foreign timestamps to the local
clock: a peer is live while its heartbeat value keeps changing, exactly
the cross-process-safe rule the lease expiry itself uses — and a dead
peer's stale presence therefore never triggers a release, which keeps
the takeover window churn-free.
"""

from __future__ import annotations

import json
import random
import threading
import time
import zlib
from typing import Callable, Optional

from kubernetes_tpu_torch.utils import locktrace, metrics, threadreg
from kubernetes_tpu_torch.utils.leaderelection import (APIResourceLock,
                                                 LeaderElector)
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("shards")

SHARD_LOCK_PREFIX = "kube-scheduler-shard"

# Soak/e2e rigs compress these; production defaults keep lease traffic
# far below the apiserver's noise floor while bounding takeover at a
# few seconds.
DEFAULT_LEASE_DURATION = 3.0
DEFAULT_RENEW_DEADLINE = 2.0
DEFAULT_RETRY_PERIOD = 0.5


def shard_of(namespace: str, n_shards: int) -> int:
    """The cross-process-deterministic shard of a namespace (crc32, NOT
    the salted builtin ``hash``)."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(namespace.encode("utf-8")) % n_shards


def shard_lock_name(shard: int) -> str:
    return f"{SHARD_LOCK_PREFIX}-{shard}"


class ShardManager:
    """Per-incarnation shard-lease loop: one ``LeaderElector`` per shard
    over one client, driven by a single tick thread (per-shard threads
    would be N blocking acquire loops fighting for the GIL).

    ``on_acquired(shard, handoff)`` / ``on_lost(shard)`` fire on a
    dedicated callback thread, so a slow takeover reconcile (a full pod
    relist) can never stall the renew loop into missing its own
    deadlines — exactly the failure mode that would cascade one slow
    apiserver call into a full shard-map reshuffle."""

    def __init__(self, client, incarnation: str, n_shards: int,
                 lease_duration: float = DEFAULT_LEASE_DURATION,
                 renew_deadline: float = DEFAULT_RENEW_DEADLINE,
                 retry_period: float = DEFAULT_RETRY_PERIOD,
                 jitter: float = 0.2,
                 on_acquired: Optional[Callable[[int, bool], None]] = None,
                 on_lost: Optional[Callable[[int], None]] = None,
                 now: Callable[[], float] = time.monotonic,
                 lock_factory: Optional[Callable[[int], object]] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.incarnation = incarnation
        self.n_shards = n_shards
        self.retry_period = retry_period
        self.renew_deadline = renew_deadline
        self.jitter = jitter
        self.on_acquired = on_acquired
        self.on_lost = on_lost
        self.now = now
        if lock_factory is None:
            def lock_factory(shard: int):
                name = shard_lock_name(shard) if shard >= 0 \
                    else "kube-scheduler-incarnations"
                return APIResourceLock(client, name=name)
        # The presence object (lock_factory(-1)): identity -> heartbeat
        # counter, CAS'd like the leases; rebalancing reads it to see
        # peers that hold nothing and would otherwise be invisible.
        self._presence_lock = lock_factory(-1)
        self._hb_counter = 0
        self._hb_at = -1e18
        # identity -> (last value, local time the value last CHANGED,
        # local time first seen) — observed-change liveness.
        self._peers: dict[str, tuple[int, float, float]] = {}
        self._electors = [
            LeaderElector(lock=lock_factory(i), identity=incarnation,
                          lease_duration=lease_duration,
                          renew_deadline=renew_deadline,
                          retry_period=retry_period, jitter=jitter,
                          now=now)
            for i in range(n_shards)]
        self._owned: set[int] = set()
        # shard -> local acquisition time: rebalancing never releases a
        # freshly-taken shard (a takeover must not bounce straight back
        # out).
        self._acquired_at: dict[int, float] = {}
        self.lease_duration = lease_duration
        self._mu = locktrace.make_lock("scheduler.ShardManager")
        # Per-shard renew-success stamp: a holder that cannot CAS for
        # renew_deadline gives the shard up LOCALLY (stops scheduling it)
        # even before the lease expires for everyone else — the reference
        # elector's renew-deadline semantics, per shard.
        self._renewed_at: dict[int, float] = {}
        # Per-shard foreign-lease probe stamp (one GET per renew
        # deadline while someone else holds it).
        self._probed_at: dict[int, float] = {}
        # Politeness gate: no acquisition attempts before this stamp;
        # pushed out by retry_period * len(owned) on every acquisition.
        self._acquire_after = 0.0
        # Rebalance dampener: at most one surplus release per lease
        # period, so a transient liveness misread cannot shed the map.
        self._rebalanced_at = -1e18
        self.handoffs = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._callbacks: list[tuple] = []
        self._cb_cv = threading.Condition()
        metrics.INCARNATION_INFO.labels(incarnation=incarnation).set(1)
        self._publish()

    # -- ownership queries (the queue feed's hot path) --------------------

    def owned(self) -> frozenset[int]:
        with self._mu:
            return frozenset(self._owned)

    def owns_shard(self, shard: int) -> bool:
        with self._mu:
            return shard in self._owned

    def owns_namespace(self, namespace: str) -> bool:
        return self.owns_shard(shard_of(namespace, self.n_shards))

    def owns_pod(self, pod) -> bool:
        return self.owns_namespace(pod.namespace)

    def acquired_at(self, shard: int) -> Optional[float]:
        """The clock reading (``now()`` base, ``time.monotonic`` by
        default) at which this incarnation last acquired ``shard``'s
        lease; None when it never has.  The takeover reconcile uses it
        as the stale-assume cutoff: an assume minted before the
        acquisition is a leftover of an earlier spell, one minted since
        is the live drain loop at work."""
        return self._acquired_at.get(shard)

    def report(self) -> dict:
        with self._mu:
            return {"incarnation": self.incarnation,
                    "nShards": self.n_shards,
                    "shardsOwned": sorted(self._owned),
                    "leaseHandoffs": self.handoffs}

    def _publish(self) -> None:
        metrics.SHARDS_OWNED.labels(incarnation=self.incarnation).set(
            len(self._owned))

    # -- the tick loop -----------------------------------------------------

    def run(self) -> "ShardManager":
        t = threadreg.spawn(
            self._loop, name=f"shard-manager-{self.incarnation}")
        cb = threadreg.spawn(
            self._callback_loop,
            name=f"shard-callbacks-{self.incarnation}")
        self._threads = [t, cb]
        return self

    @property
    def threads(self) -> list[threading.Thread]:
        """The manager's worker threads (tick + callbacks) for the
        embedding daemon's liveness tracking; empty before run()."""
        return list(self._threads)

    def stop(self, release: bool = True) -> None:
        """Graceful stop; ``release=False`` is the SIGKILL simulation —
        the leases are simply abandoned and expire on their own, exactly
        what a kill -9 leaves behind for the survivors to steal."""
        self._stop.set()
        with self._cb_cv:
            self._cb_cv.notify_all()
        # Join the tick loop BEFORE zeroing any lease: a tick already
        # in flight when the stop flag went up could otherwise observe
        # a just-released record as a dead foreign lease and CAS this
        # dying incarnation straight back in as holder — leaving the
        # lease live after exit, so peers wait out the full
        # lease_duration instead of taking over within a retry period.
        for t in self._threads[:1]:
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=5.0)
        if release:
            for shard in sorted(self.owned()):
                self._release(shard)
        with self._mu:
            lost = sorted(self._owned)
            self._owned.clear()
            self._publish()
        if release and self.on_lost is not None:
            for shard in lost:
                try:
                    self.on_lost(shard)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    log.exception("on_lost(%d) crashed during stop", shard)

    def abandon(self) -> None:
        self.stop(release=False)

    def _release(self, shard: int) -> None:
        """Zero out the lease record so peers can take over immediately
        instead of waiting out lease_duration (leaderelection.go's
        ReleaseOnCancel).  The holder check parses the freshly-fetched
        record, NOT the elector's cached observation: if a peer stole
        the lease since we last looked, a stale-observation check would
        pass and we would zero the PEER's live lease (the CAS version
        from the same get still guards the write, but the check must
        match the data the version belongs to)."""
        from kubernetes_tpu_torch.utils.leaderelection import \
            LeaderElectionRecord
        el = self._electors[shard]
        try:
            raw, version = el.lock.get()
            if raw:
                rec = LeaderElectionRecord.from_json(raw)
                if rec.holder_identity == self.incarnation:
                    rec.renew_time = rec.acquire_time = 0.0
                    rec.lease_duration_seconds = 0.0
                    el.lock.update(rec.to_json(), version)
        except Exception:  # noqa: BLE001 — release is best-effort
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self._tick_sleep()):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("shard tick crashed; continuing")

    def _tick_sleep(self) -> float:
        # Jitter the tick itself: the electors' per-sleep jitter never
        # runs here (tick() calls try_acquire_or_renew directly, not
        # LeaderElector.run), so without this N incarnations configured
        # with identical retry periods would phase-lock into
        # simultaneous CAS herds against the lease objects.
        if self.jitter <= 0.0:
            return self.retry_period
        return self.retry_period * (1.0 + self.jitter * random.random())

    def _try_lease(self, shard: int, el) -> bool:
        """``try_acquire_or_renew`` with the lease I/O fault isolated to
        THIS shard: one lease object's apiserver error (timeout, 5xx, a
        chaos rule aimed at that path) must not abort the tick for every
        later shard — nor skip the heartbeat and rebalance behind them.
        Returning False feeds the ordinary renew-deadline machinery, so
        a shard whose lease I/O stays broken is still given up on time."""
        try:
            return el.try_acquire_or_renew()
        except Exception:  # noqa: BLE001 — lease I/O; next tick retries
            log.warning("shard %d lease CAS round failed; next tick "
                        "retries", shard, exc_info=True)
            return False

    def tick(self) -> None:
        """One pass over every shard: renew what we hold, politely try
        what looks free.  Factored out of the loop so clock-injected
        tests can drive it deterministically."""
        now = self.now()
        # Renew on a cadence (a third of the deadline: three CAS
        # attempts before the deadline can pass), not every tick — N
        # held shards at a fast tick would otherwise be N×20 CAS/s of
        # pure lease traffic.
        renew_period = self.renew_deadline / 3.0
        for shard, el in enumerate(self._electors):
            held = self.owns_shard(shard)
            if held:
                last = self._renewed_at.get(shard, 0.0)
                if now - last < renew_period:
                    continue
                if self._try_lease(shard, el):
                    self._renewed_at[shard] = now
                elif not el.is_leader() or \
                        now - self._renewed_at.get(shard, now) >= \
                        self.renew_deadline:
                    # Someone stole the lease (the failed CAS round
                    # observed a foreign record), or we couldn't renew
                    # within the deadline (apiserver gone): stop
                    # scheduling this shard NOW rather than discovering
                    # it at bind time.
                    self._transition(shard, owned=False)
            else:
                holder = el.observed_holder()
                # Politeness: the more we hold, the longer we let
                # lighter peers win the race for a free lease.  EXCEPT
                # for an expired FOREIGN lease — a dead peer's orphan
                # is a takeover, and every second of politeness there
                # is a second of that shard's pods going unscheduled
                # (the CAS settles any survivor-vs-survivor race; a
                # lease we released ourselves keeps the gate, so a
                # rebalance hand-off cannot boomerang).
                urgent = bool(holder) and holder != self.incarnation \
                    and el.lease_dead()
                if not urgent and now < self._acquire_after:
                    continue
                remaining = el.lease_remaining()
                if remaining > 0.0 and \
                        el.observed_holder() != self.incarnation:
                    # Live foreign lease: probe (one GET) on a cadence,
                    # not every tick.  Far from expiry one observation
                    # per renew deadline suffices (and is what notices a
                    # gracefully RELEASED lease early); inside the last
                    # renew-deadline window tighten to the retry period,
                    # so a SIGKILLed holder's shard is stolen ~one tick
                    # after its lease dies instead of up to a full renew
                    # deadline later — the probe tax only ramps when a
                    # takeover is plausibly imminent.
                    probe_period = self.retry_period \
                        if remaining <= self.renew_deadline \
                        else self.renew_deadline
                    if now - self._probed_at.get(shard, -1e18) < \
                            probe_period:
                        continue
                self._probed_at[shard] = now
                prev_holder = el.observed_holder()
                if self._try_lease(shard, el):
                    self._renewed_at[shard] = now
                    self._acquired_at[shard] = now
                    handoff = bool(prev_holder) and \
                        prev_holder != self.incarnation
                    self._transition(shard, owned=True, handoff=handoff)
                    with self._mu:
                        held_n = len(self._owned)
                    self._acquire_after = now + \
                        self.retry_period * held_n
        self._heartbeat(now)
        self._rebalance(now)

    # -- presence + rebalancing -------------------------------------------

    def _heartbeat(self, now: float) -> None:
        """Bump our counter in the shared presence object and fold the
        read-back table into the observed-change liveness view."""
        if now - self._hb_at < self.renew_deadline / 3.0:
            return
        self._hb_at = now
        try:
            raw, version = self._presence_lock.get()
            table = json.loads(raw) if raw else {}
            if not isinstance(table, dict):
                table = {}
        except Exception:  # noqa: BLE001 — presence is advisory
            return
        for ident, val in table.items():
            if ident == self.incarnation:
                continue
            prev = self._peers.get(ident)
            if prev is None:
                self._peers[ident] = (val, now, now)
            elif prev[0] != val:
                self._peers[ident] = (val, now, prev[2])
        # Garbage-collect long-dead identities while we hold the
        # freshest read: the default incarnation id is minted per
        # process start, so a crash-looping fleet adds a new entry on
        # every boot — and the table is re-read and re-CAS'd IN FULL
        # every heartbeat by every incarnation, so without pruning the
        # payload (and the local peer view) grows for the deployment's
        # lifetime.  Dead is judged by OUR clock observing THEIR
        # counter stop changing — the same foreign-timestamp-free rule
        # liveness uses — at 10 lease durations, far beyond the 2 the
        # liveness window tolerates, so a slow peer is never collected
        # (and a wrongly collected one re-inserts itself at its next
        # heartbeat anyway).
        prune_after = 10.0 * self.lease_duration
        for ident in [i for i, (_v, changed, _first)
                      in self._peers.items()
                      if now - changed >= prune_after]:
            table.pop(ident, None)
            del self._peers[ident]
        self._hb_counter += 1
        table[self.incarnation] = self._hb_counter
        # Best-effort CAS: a lost race just means the next cadence
        # writes a fresher counter.
        self._presence_lock.update(
            json.dumps(table, sort_keys=True), version)

    def _live_peers(self, now: float) -> set[str]:
        """Identities whose heartbeat value changed within two lease
        durations — by OUR clock observing THEIR changes, so no foreign
        timestamp is ever compared to a local clock."""
        window = 2.0 * self.lease_duration
        return {ident for ident, (_v, changed, _first)
                in self._peers.items() if now - changed < window}

    def _rebalance(self, now: float) -> None:
        """Release one surplus shard when a STABLY-live peer sits below
        its fair share (the late-joiner/recovery path politeness cannot
        serve: every lease is held and renewed, so without this a fresh
        incarnation would starve forever).  A dead peer's presence
        entry stops changing and thus never triggers a release — the
        takeover window stays churn-free."""
        if now - self._rebalanced_at < self.lease_duration:
            return
        held = sorted(self.owned())
        live = self._live_peers(now)
        live.add(self.incarnation)
        fair = -(-self.n_shards // len(live))  # ceil
        if len(held) <= fair:
            return
        # Shard -> holder, from our own electors' observations.
        holder_counts: dict[str, int] = {}
        for el in self._electors:
            h = el.observed_holder()
            if h and not el.lease_dead():
                holder_counts[h] = holder_counts.get(h, 0) + 1
        stable = 2.0 * self.lease_duration
        hungry = [p for p in live
                  if p != self.incarnation
                  and holder_counts.get(p, 0) < fair
                  and now - self._peers[p][2] >= stable]
        if not hungry:
            return
        # Never bounce a freshly-taken shard; release the newest
        # eligible one (oldest shards keep their warmed-up backlog
        # affinity).
        eligible = [s for s in held
                    if now - self._acquired_at.get(s, now) >= stable]
        if not eligible:
            return
        victim = eligible[-1]
        self._rebalanced_at = now
        self._release(victim)
        self._transition(victim, owned=False)
        self._acquire_after = max(self._acquire_after,
                                  now + self.lease_duration)
        log.info("incarnation %s released shard %d to rebalance "
                 "(fair %d, hungry %s)", self.incarnation, victim,
                 fair, hungry)

    def _transition(self, shard: int, owned: bool,
                    handoff: bool = False) -> None:
        with self._mu:
            if owned:
                self._owned.add(shard)
                if handoff:
                    self.handoffs += 1
                    metrics.SHARD_LEASE_HANDOFFS.labels(
                        incarnation=self.incarnation).inc()
            else:
                self._owned.discard(shard)
            self._publish()
        log.info("incarnation %s %s shard %d (now owns %s)",
                 self.incarnation,
                 "acquired" + (" [handoff]" if handoff else "")
                 if owned else "lost", shard, sorted(self._owned))
        cb = self.on_acquired if owned else self.on_lost
        if cb is None:
            return
        with self._cb_cv:
            self._callbacks.append(
                (cb, (shard, handoff) if owned else (shard,)))
            self._cb_cv.notify()

    def _callback_loop(self) -> None:
        while True:
            with self._cb_cv:
                while not self._callbacks and not self._stop.is_set():
                    self._cb_cv.wait(timeout=0.5)
                if not self._callbacks:
                    if self._stop.is_set():
                        return
                    continue
                cb, args = self._callbacks.pop(0)
            try:
                cb(*args)
            except Exception:  # noqa: BLE001 — a crashing takeover
                # reconcile must not kill the callback thread; the
                # reflector stream still converges the shard eventually.
                log.exception("shard callback %s%s crashed", cb, args)

    def drain_callbacks(self, timeout: float = 5.0) -> bool:
        """Wait until every queued ownership callback has run (tests and
        the takeover-settle measurement)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cb_cv:
                if not self._callbacks:
                    return True
            time.sleep(0.01)
        return False

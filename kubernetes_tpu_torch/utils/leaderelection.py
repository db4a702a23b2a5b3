"""Leader election by annotation-CAS lease (pkg/client/leaderelection/
leaderelection.go:99-340): candidates race to CAS a LeaderElectionRecord
into an object annotation (``control-plane.alpha.kubernetes.io/leader``);
the holder renews within RenewDeadline or standbys take over after
LeaseDuration.  The scheduler defaults LeaderElect=true
(options/options.go:46) and runs its loop only while leading
(app/server.go:142-159).

The lock backend is pluggable; ``InMemoryLock`` stands in for the Endpoints
object (tests/HA-in-one-process), an HTTP apiserver-backed lock drops in for
a real control plane."""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol

LEADER_ANNOTATION_KEY = "control-plane.alpha.kubernetes.io/leader"
DEFAULT_LEASE_DURATION = 15.0   # leaderelection.go:75
DEFAULT_RENEW_DEADLINE = 10.0   # :76
DEFAULT_RETRY_PERIOD = 2.0      # :77


@dataclass
class LeaderElectionRecord:
    """leaderelection.go:151-158."""

    holder_identity: str = ""
    lease_duration_seconds: float = DEFAULT_LEASE_DURATION
    acquire_time: float = 0.0
    renew_time: float = 0.0
    leader_transitions: int = 0

    def to_json(self) -> str:
        return json.dumps({
            "holderIdentity": self.holder_identity,
            "leaseDurationSeconds": self.lease_duration_seconds,
            "acquireTime": self.acquire_time,
            "renewTime": self.renew_time,
            "leaderTransitions": self.leader_transitions})

    @classmethod
    def from_json(cls, text: str) -> "LeaderElectionRecord":
        d = json.loads(text)
        return cls(holder_identity=d.get("holderIdentity", ""),
                   lease_duration_seconds=d.get("leaseDurationSeconds",
                                                DEFAULT_LEASE_DURATION),
                   acquire_time=d.get("acquireTime", 0.0),
                   renew_time=d.get("renewTime", 0.0),
                   leader_transitions=d.get("leaderTransitions", 0))


class ResourceLock(Protocol):
    """Annotation-CAS object access (the Endpoints object stand-in)."""

    def get(self) -> tuple[Optional[str], int]:
        """(annotation value or None, resource version)."""

    def update(self, value: str, expected_version: int) -> bool:
        """CAS write; False on version conflict."""


class InMemoryLock:
    def __init__(self) -> None:
        self._value: Optional[str] = None
        self._version = 0
        self._mu = threading.Lock()

    def get(self) -> tuple[Optional[str], int]:
        with self._mu:
            return self._value, self._version

    def update(self, value: str, expected_version: int) -> bool:
        with self._mu:
            if self._version != expected_version:
                return False
            self._value = value
            self._version += 1
            return True


class APIResourceLock:
    """Annotation-CAS lock on an apiserver object — the reference's
    EndpointsLock (leaderelection.go:99-148): the LeaderElectionRecord lives
    in the ``control-plane.alpha.kubernetes.io/leader`` annotation of an
    Endpoints object, CAS'd on resourceVersion."""

    def __init__(self, client: object, kind: str = "endpoints",
                 name: str = "kube-scheduler",
                 namespace: str = "kube-system"):
        # Endpoints is a namespaced kind: the lock object lives at
        # kube-system/kube-scheduler like the reference's EndpointsLock
        # (server.go:147 uses the kube-system namespace).
        self.client = client
        self.kind = kind
        # Probe ONCE whether the client's update takes the explicit CAS
        # precondition kwarg (a raw MemStore does; APIClient derives the
        # same precondition server-side from the body's
        # resourceVersion).  A per-call try/except TypeError would both
        # pay a raised exception on every CAS round AND mistake a
        # TypeError escaping from INSIDE a capable client's update for
        # "kwarg unsupported", silently retrying as a blind non-CAS
        # overwrite — the exact two-winners split-brain this
        # precondition exists to close.
        try:
            import inspect
            self._cas_kwarg = "expected_rv" in \
                inspect.signature(client.update).parameters
        except (TypeError, ValueError):  # uninspectable callable
            self._cas_kwarg = False
        self.name = name
        self.namespace = namespace

    @property
    def _key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def _ensure(self) -> dict:
        obj = self.client.get(self.kind, self._key)
        if obj is None:
            try:
                self.client.create(self.kind, {
                    "metadata": {"name": self.name,
                                 "namespace": self.namespace}})
            except Exception:  # noqa: BLE001 — lost the create race
                pass
            obj = self.client.get(self.kind, self._key) or \
                {"metadata": {"name": self.name,
                              "namespace": self.namespace}}
        return obj

    def get(self) -> tuple[Optional[str], int]:
        obj = self._ensure()
        meta = obj.get("metadata") or {}
        ann = (meta.get("annotations") or {}).get(LEADER_ANNOTATION_KEY)
        return ann, int(meta.get("resourceVersion", "0") or "0")

    def update(self, value: str, expected_version: int) -> bool:
        obj = {"metadata": {"name": self.name,
                            "namespace": self.namespace,
                            "resourceVersion": str(expected_version),
                            "annotations": {LEADER_ANNOTATION_KEY: value}}}
        try:
            # A raw MemStore only CASes when the precondition is passed
            # EXPLICITLY (its ``expected_rv`` kwarg); without it two
            # racing acquirers both "win" the same version and both
            # believe they lead.  Over HTTP the PUT handler derives the
            # same precondition from the body's resourceVersion, so the
            # plain call stays a CAS.  Capability probed once at
            # construction (see __init__).
            if self._cas_kwarg:
                self.client.update(self.kind, obj,
                                   expected_rv=str(expected_version))
            else:
                self.client.update(self.kind, obj)
            return True
        except Exception:  # noqa: BLE001 — CAS conflict or apiserver error
            return False


@dataclass
class LeaderElector:
    """leaderelection.go:174-340: acquire -> renew loop; on_started_leading
    runs in a thread while the lease holds; on_stopped_leading fires when
    the lease is lost."""

    lock: ResourceLock
    identity: str
    lease_duration: float = DEFAULT_LEASE_DURATION
    renew_deadline: float = DEFAULT_RENEW_DEADLINE
    retry_period: float = DEFAULT_RETRY_PERIOD
    # Fractional jitter on every retry/renew sleep (0.2 = up to +20 %):
    # N electors renewing N leases against one apiserver must not phase-
    # lock into a thundering herd of simultaneous CAS rounds — the
    # multi-lease shard manager runs one elector per shard.
    jitter: float = 0.0
    on_started_leading: Optional[Callable[[], None]] = None
    on_stopped_leading: Optional[Callable[[], None]] = None
    now: Callable[[], float] = time.monotonic
    _observed: Optional[LeaderElectionRecord] = None
    _observed_at: float = 0.0
    _stop: threading.Event = field(default_factory=threading.Event)

    def is_leader(self) -> bool:
        return self._observed is not None and \
            self._observed.holder_identity == self.identity

    def observed_holder(self) -> str:
        """Identity of the last observed lease holder ("" when the lease
        has never been observed held)."""
        return self._observed.holder_identity if self._observed else ""

    def lease_dead(self) -> bool:
        """True when the last observed record's lease has expired by
        this elector's clock (or no record was ever observed) — the
        precondition under which ``try_acquire_or_renew`` would attempt
        a steal rather than bounce off a live holder."""
        return self.lease_remaining() <= 0.0

    def lease_remaining(self) -> float:
        """Seconds until the last observed record's lease expires by
        this elector's clock (<= 0 = expired; -inf when nothing was
        ever observed).  Observers use this to tighten their probe
        cadence as a foreign lease nears death, so a crashed holder is
        noticed ~one retry period after expiry, not one renew deadline."""
        if self._observed is None:
            return float("-inf")
        return self._observed_at + \
            self._observed.lease_duration_seconds - self.now()

    def _sleep(self) -> float:
        """The jittered retry period (never less than retry_period)."""
        if self.jitter <= 0.0:
            return self.retry_period
        return self.retry_period * (1.0 + self.jitter * random.random())

    def try_acquire_or_renew(self) -> bool:
        """One CAS round (leaderelection.go:244-330)."""
        now = self.now()
        raw, version = self.lock.get()
        old = LeaderElectionRecord.from_json(raw) if raw else None
        if old is not None:
            if self._observed is None or \
                    self._observed.to_json() != old.to_json():
                self._observed = old
                self._observed_at = now
            lease_alive = self._observed_at + old.lease_duration_seconds > now
            if old.holder_identity != self.identity and lease_alive:
                return False  # someone else holds an unexpired lease
        record = LeaderElectionRecord(
            holder_identity=self.identity,
            lease_duration_seconds=self.lease_duration,
            acquire_time=(old.acquire_time
                          if old and old.holder_identity == self.identity
                          else now),
            renew_time=now,
            leader_transitions=(old.leader_transitions + 1
                                if old and old.holder_identity != self.identity
                                else (old.leader_transitions if old else 0)))
        if not self.lock.update(record.to_json(), version):
            # Lost the CAS.  Re-observe IMMEDIATELY: without this, a
            # holder whose lease was stolen between its get and its
            # update keeps ``_observed`` pointing at its own old record
            # and ``is_leader()`` stays True until the next round —
            # exactly the split-brain belief window the 409 exists to
            # close.  A transient conflict that re-reads our own record
            # (an unrelated rv bump) changes nothing, so the reference's
            # keep-leading-until-renew-deadline behavior is preserved.
            try:
                raw2, _ = self.lock.get()
            except Exception:  # noqa: BLE001 — observe is best-effort
                return False
            new = LeaderElectionRecord.from_json(raw2) if raw2 else None
            if new is not None and (
                    self._observed is None or
                    self._observed.to_json() != new.to_json()):
                self._observed = new
                self._observed_at = self.now()
            return False
        self._observed = record
        self._observed_at = now
        return True

    def run(self) -> threading.Thread:
        """Acquire, then renew until the lease is lost or stop() is called."""
        def loop():
            while not self._stop.is_set():
                # Acquire phase.
                while not self._stop.is_set() and \
                        not self.try_acquire_or_renew():
                    self._stop.wait(self._sleep())
                if self._stop.is_set():
                    return
                if self.on_started_leading is not None:
                    self.on_started_leading()
                # Renew phase.
                while not self._stop.is_set():
                    deadline = self.now() + self.renew_deadline
                    renewed = False
                    while self.now() < deadline and not self._stop.is_set():
                        if self.try_acquire_or_renew():
                            renewed = True
                            break
                        self._stop.wait(self._sleep())
                    if not renewed:
                        break
                    self._stop.wait(self._sleep())
                if self.on_stopped_leading is not None:
                    self.on_stopped_leading()
        t = threading.Thread(target=loop, daemon=True, name="leader-elector")
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()

"""Versioned in-memory object store with watch — the apiserver analogue.

Collapses the reference's storage stack (``storage.Interface`` over etcd,
``pkg/storage/etcd_helper.go``; the ``Cacher`` watch window,
``pkg/storage/cacher.go:129``; and the registry REST semantics) into one
in-process component with the same observable contract the scheduler
depends on:

* monotonically increasing cluster-wide resourceVersion on every write;
* List returns (items, rv) — the snapshot a Reflector lists at;
* Watch(from_rv) replays buffered events after from_rv, then streams live
  events; a from_rv older than the buffer window raises ``TooOldError``
  (410 Gone), forcing the client to relist — exactly the reflector's
  relist-on-staleness path (reflector.go ListAndWatch);
* CAS binding: ``bind`` sets ``spec.nodeName`` only while empty
  (BindingREST.Create -> setPodHostAndAnnotations,
  pkg/registry/pod/etcd/etcd.go:286-330) — the scheduler's optimistic
  concurrency backstop;
* ``GuaranteedUpdate``-style CAS on resourceVersion for generic updates.

Objects are stored as plain dicts keyed by "namespace/name" (or name for
nodes); copies go in and out so callers can't mutate store state.
"""

from __future__ import annotations

import copy
import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

WATCH_WINDOW = 1024  # Cacher event window (cacher.go's watchCache capacity)
# WAL appends between snapshot rotations (a snapshot is one json.dump of
# the whole object set; 4096 amortizes it to noise at control-plane rates).
SNAPSHOT_EVERY = 4096


def _now_rfc3339() -> str:
    import time as _time
    return _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime())


class TooOldError(Exception):
    """HTTP 410 Gone: requested watch RV fell out of the event window."""


class ConflictError(Exception):
    """CAS failure (resourceVersion conflict or bind on a bound pod)."""


@dataclass(frozen=True)
class Event:
    type: str       # ADDED | MODIFIED | DELETED
    kind: str       # pods | nodes | services | ...
    key: str
    object: dict
    rv: int
    # The object's state BEFORE this write (None for creates).  Fielded
    # watchers need it to classify set transitions: a pod leaving the
    # ``spec.nodeName=`` set on bind is a DELETED to that watcher even
    # though the store event is MODIFIED (pkg/storage/cacher's
    # watchCache computes event types against prevObject the same way).
    prev: Optional[dict] = None

    def _obj_json(self) -> bytes:
        """The object serialized once, shared between the event's own
        wire line and any re-typed (fielded-watch) lines — at density
        rates every bind synthesizes a DELETED for the scheduler's
        unassigned watch, and re-serializing the identical pod per
        rewrite was GIL time in the watch-serving threads."""
        cached = self.__dict__.get("_oj")
        if cached is None:
            cached = json.dumps(self.object,
                                separators=(",", ":")).encode()
            object.__setattr__(self, "_oj", cached)
        return cached

    def wire_json(self) -> bytes:
        """The bare ``{"type":...,"object":...}`` envelope (no trailing
        newline) — the unit the framed watch encoding joins into one
        length-prefixed ``{"items":[...]}`` batch."""
        cached = self.__dict__.get("_env")
        if cached is None:
            cached = (b'{"type":"' + self.type.encode() +
                      b'","object":' + self._obj_json() + b'}')
            object.__setattr__(self, "_env", cached)
        return cached

    def wire_line(self) -> bytes:
        """The NDJSON watch-wire form, serialized once and shared by every
        HTTP watch stream carrying this event (the same Event instance is
        delivered to all watchers) — at density rates the per-stream
        re-serialization was a measurable slice of apiserver GIL time."""
        cached = self.__dict__.get("_wire")
        if cached is None:
            cached = self.wire_json() + b"\n"
            object.__setattr__(self, "_wire", cached)
        return cached

    def as_type(self, etype: str) -> "Event":
        """This event re-typed for a fielded watcher: shares the object
        AND its cached serialization; only the tiny envelope differs.
        Re-typed instances are memoized per target type, so N watchers
        sharing a field selector (HA shards) also share the re-typed
        event's serialized envelope — the watch-cache leg that kept
        each stream re-serializing the same DELETED at density rates."""
        memo = self.__dict__.get("_retyped")
        if memo is None:
            memo = {}
            object.__setattr__(self, "_retyped", memo)
        ev = memo.get(etype)
        if ev is None:
            ev = Event(etype, self.kind, self.key, self.object, self.rv,
                       self.prev)
            oj = self.__dict__.get("_oj")
            if oj is not None:
                object.__setattr__(ev, "_oj", oj)
            memo[etype] = ev
        return ev


_DROP = object()  # classification-cache sentinel: "not for this set"


class Watcher:
    def __init__(self, store: "MemStore", kinds: tuple[str, ...],
                 selector=None, selector_key: Optional[str] = None):
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._store = store
        self.kinds = kinds
        self.selector = selector  # fielded watch predicate (or None)
        # Watch-cache key: watchers opened with the same field-selector
        # STRING share one set-transition classification per event (N
        # HA shards watching ``spec.nodeName=`` classify once, not N
        # times).  None = uncacheable local callable.
        self.selector_key = selector_key

    def _classify(self, ev: Event) -> "Event | None":
        """The set-transition classification (cacher.go watchCache):

        * entered the set  -> ADDED
        * stayed in        -> event as-is
        * left the set     -> DELETED (carrying the new object state)
        * never in         -> None (dropped)
        """
        sel = self.selector
        m_new = sel(ev.object)
        m_prev = ev.prev is not None and sel(ev.prev)
        if ev.type == "DELETED":
            return ev if (m_prev or m_new) else None
        if ev.type == "ADDED":
            return ev if m_new else None
        if m_new:
            return ev if m_prev else ev.as_type("ADDED")
        if m_prev:
            return ev.as_type("DELETED")
        return None

    def _deliver(self, ev: Event) -> None:
        """Called under the store lock.  An unfielded watcher forwards
        the shared event; a fielded one classifies the set transition —
        through the per-event memo when the selector has a cache key."""
        if self.selector is None:
            self._q.put(ev)
            return
        if self.selector_key is not None:
            memo = ev.__dict__.get("_cls")
            if memo is None:
                memo = {}
                object.__setattr__(ev, "_cls", memo)
            out = memo.get(self.selector_key)
            if out is None:
                out = self._classify(ev)
                memo[self.selector_key] = _DROP if out is None else out
            if out is not _DROP and out is not None:
                self._q.put(out)
            return
        out = self._classify(ev)
        if out is not None:
            self._q.put(out)

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._store._drop_watcher(self)
        self._q.put(None)


class MemStore:
    def __init__(self, share_events: bool = False,
                 storage_dir: Optional[str] = None,
                 fsync: bool = False) -> None:
        """``share_events=True`` lets events reference stored objects
        directly instead of deep-copying a snapshot per write.  Safe ONLY
        when every consumer is read-only — the standalone apiserver binary
        qualifies (its watchers just serialize events to sockets, and no
        store code mutates a stored object in place: bind is
        copy-on-write).  In-process rigs keep the default: their reflector
        handlers receive the event dicts and may mutate them.

        ``storage_dir`` makes the store durable — the one contract the
        pure-memory store broke vs the reference (an apiserver restart
        lost the cluster; etcd never does, pkg/storage/etcd3/store.go):
        every write appends one JSON line to ``wal.jsonl``, a full
        ``snapshot.json`` is rotated every SNAPSHOT_EVERY appends, and a
        fresh store on the same directory replays snapshot + WAL,
        preserving objects AND the resourceVersion counter (so reflectors
        resume their watches without a 410 storm).  ``fsync=True`` forces
        the WAL line to disk per write (etcd's default); off, durability
        is to the OS page cache (survives process crash, not power loss)."""
        self._lock = threading.Lock()
        self._objects: dict[str, dict[str, dict]] = {}   # kind -> key -> obj
        self._rv = 0
        self._events: list[Event] = []                   # ring window
        self._watchers: list[Watcher] = []
        self._share_events = share_events
        self._fsync = fsync
        self._dir = storage_dir
        self._wal = None
        self._wal_count = 0
        # Server-side capacity validation at bind (KT_BIND_CAPACITY,
        # default on): per-node used-capacity accounting, maintained
        # incrementally on bind/create/update/delete so the check is
        # O(containers) per bind, never a walk over the pod set.  A
        # bind that would overcommit the target node's allocatable is
        # rejected with the 409 the scheduler already absorbs via
        # forget + requeue — watch-lagged schedulers can no longer land
        # transient overcommit in the store.
        from kubernetes_tpu_torch.utils import knobs
        self._capacity_check = knobs.get_bool("KT_BIND_CAPACITY")
        self._node_used: dict[str, list] = {}  # node -> [milli, mem, pods]
        if storage_dir is not None:
            os.makedirs(storage_dir, exist_ok=True)
            self._recover(storage_dir)
            self._recompute_node_used()
            self._wal = open(os.path.join(storage_dir, "wal.jsonl"),
                             "a", encoding="utf-8")

    # -- durability ------------------------------------------------------

    def _recover(self, d: str) -> None:
        snap = os.path.join(d, "snapshot.json")
        if os.path.exists(snap):
            with open(snap, encoding="utf-8") as f:
                data = json.load(f)
            self._objects = data["objects"]
            self._rv = data["rv"]
        wal = os.path.join(d, "wal.jsonl")
        if os.path.exists(wal):
            good_end = 0
            with open(wal, "rb") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        # Extract EVERY field before counting the record
                        # good: a tear can land exactly on a line
                        # boundary and leave valid JSON that is not a
                        # complete record (e.g. '{"t": "ADDED"}' from a
                        # truncated buffer flush) — replaying it would
                        # crash recovery, and counting it would weld
                        # later appends onto a half-record.
                        etype, kind, key = rec["t"], rec["k"], rec["key"]
                        rv, obj = int(rec["rv"]), rec["o"]
                    except (ValueError, KeyError, TypeError):
                        break  # torn/partial final record: stop replay
                    good_end += len(line)
                    self._wal_count += 1
                    bucket = self._objects.setdefault(kind, {})
                    if etype == "DELETED":
                        bucket.pop(key, None)
                    else:
                        bucket[key] = obj
                    # Monotonic: the RV counter never regresses across a
                    # crash — resumed watches and CAS preconditions rely
                    # on it.
                    self._rv = max(self._rv, rv)
            if good_end < os.path.getsize(wal):
                # Drop the torn tail NOW: appending after it would weld
                # the next record onto the fragment, and the restart after
                # that would abort replay at the weld — silently losing
                # every acknowledged write from this incarnation.
                with open(wal, "rb+") as f:
                    f.truncate(good_end)

    def _append_wal(self, etype: str, kind: str, key: str,
                    obj: dict, rv: int) -> None:
        """Called under the store lock (from _emit)."""
        rec = {"t": etype, "k": kind, "key": key, "rv": rv,
               "o": None if etype == "DELETED" else obj}
        self._wal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal.flush()
        if self._fsync:
            os.fsync(self._wal.fileno())
        self._wal_count += 1
        if self._wal_count >= SNAPSHOT_EVERY:
            self._rotate_snapshot()

    def _rotate_snapshot(self) -> None:
        """Write a full snapshot atomically, then truncate the WAL.  Under
        the lock — a brief stall every SNAPSHOT_EVERY writes, the price of
        never replaying an unbounded log."""
        tmp = os.path.join(self._dir, "snapshot.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"rv": self._rv, "objects": self._objects}, f,
                      separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, "snapshot.json"))
        self._wal.close()
        self._wal = open(os.path.join(self._dir, "wal.jsonl"),
                         "w", encoding="utf-8")
        self._wal_count = 0

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                self._wal.close()
                self._wal = None

    # -- server-side bind capacity accounting -----------------------------

    @staticmethod
    def _pod_requests(obj: dict) -> tuple[int, int, int]:
        """(milli_cpu, memory_bytes, 1) summed over a pod JSON's
        container requests; malformed quantities count as zero (the
        check must never 500 a bind over a typo'd request)."""
        from kubernetes_tpu_torch.api.quantity import milli_value, value
        milli = mem = 0
        for c in (obj.get("spec") or {}).get("containers") or []:
            req = ((c.get("resources") or {}).get("requests") or {})
            try:
                if "cpu" in req:
                    milli += milli_value(str(req["cpu"]))
                if "memory" in req:
                    mem += value(str(req["memory"]))
            except (ValueError, ZeroDivisionError):
                continue
        return milli, mem, 1

    def _node_alloc(self, node_name: str):
        """(milli_cpu, memory, pods) allocatable of a stored node, None
        per missing field (nothing to validate there), or None when the
        node object itself is unknown to the store."""
        from kubernetes_tpu_torch.api.quantity import milli_value, value
        node = self._objects.get("nodes", {}).get(node_name)
        if node is None:
            return None
        alloc = (node.get("status") or {}).get("allocatable") or {}
        out = []
        for field_name, parse in (("cpu", milli_value), ("memory", value),
                                  ("pods", value)):
            raw = alloc.get(field_name)
            if raw is None:
                out.append(None)
                continue
            try:
                out.append(parse(str(raw)))
            except (ValueError, ZeroDivisionError):
                out.append(None)
        return out

    def _account_pod(self, obj: dict, sign: int) -> None:
        """Add (+1) or remove (-1) a bound pod's requests from its
        node's used-capacity row.  Caller holds the lock.  A no-op when
        the capacity check is off — KT_BIND_CAPACITY=0 must restore the
        old write path byte-for-byte, not keep paying the quantity
        parsing on every pod write."""
        if not self._capacity_check:
            return
        node_name = (obj.get("spec") or {}).get("nodeName") or ""
        if not node_name:
            return
        req = self._pod_requests(obj)
        used = self._node_used.setdefault(node_name, [0, 0, 0])
        for i in range(3):
            used[i] = max(used[i] + sign * req[i], 0)

    def _recompute_node_used(self) -> None:
        self._node_used = {}
        for obj in self._objects.get("pods", {}).values():
            self._account_pod(obj, +1)

    def _check_bind_capacity(self, key: str, pod: dict,
                             node_name: str) -> None:
        """Reject a bind that would overcommit the target node
        (near-capacity fleets could transiently overcommit a node during
        watch lag — pod double-binds were already impossible; node
        overcommit now is too).  Unknown nodes
        and absent allocatable fields validate nothing (the server
        cannot invent capacity it was never told about)."""
        alloc = self._node_alloc(node_name)
        if alloc is None:
            return
        req = self._pod_requests(pod)
        used = self._node_used.get(node_name, [0, 0, 0])
        dims = ("cpu", "memory", "pods")
        for i, dim in enumerate(dims):
            if alloc[i] is None:
                continue
            if used[i] + req[i] > alloc[i]:
                from kubernetes_tpu_torch.utils import metrics
                metrics.BIND_CAPACITY_REJECTS.inc()
                raise ConflictError(
                    f"binding pod {key} to node {node_name} would "
                    f"overcommit {dim} (used {used[i]} + requested "
                    f"{req[i]} > allocatable {alloc[i]})")

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def object_key(obj: dict) -> str:
        meta = obj.get("metadata") or {}
        ns = meta.get("namespace")
        return f"{ns}/{meta['name']}" if ns else meta["name"]

    def _emit(self, etype: str, kind: str, key: str, obj: dict,
              prev: Optional[dict] = None) -> Event:
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        if self._wal is not None:
            self._append_wal(etype, kind, key, obj, self._rv)
        snapshot = obj if self._share_events else copy.deepcopy(obj)
        # prev is read only by fielded-watch predicates (never handed to
        # handlers), so it can reference the retired stored dict directly.
        ev = Event(etype, kind, key, snapshot, self._rv, prev)
        self._events.append(ev)
        if len(self._events) > WATCH_WINDOW:
            self._events = self._events[-WATCH_WINDOW:]
        for w in self._watchers:
            if kind in w.kinds:
                w._deliver(ev)
        return ev

    # -- REST verbs ------------------------------------------------------

    def create(self, kind: str, obj: dict, owned: bool = False) -> dict:
        """``owned=True``: the caller transfers ownership of ``obj`` (the
        HTTP handlers own their freshly parsed bodies) — the store keeps
        it directly and returns the event's snapshot, skipping two of the
        three deepcopies a defensive create pays.  Default semantics are
        unchanged for in-process callers that may keep mutating theirs."""
        with self._lock:
            key = self.object_key(obj)
            bucket = self._objects.setdefault(kind, {})
            if key in bucket:
                raise ConflictError(f"{kind} {key} already exists")
            if not owned:
                obj = copy.deepcopy(obj)
            meta = obj.setdefault("metadata", {})
            meta.setdefault("generation", 1)
            # RFC3339 creation stamp (ObjectMeta.CreationTimestamp): age
            # ordering for pod GC, and the scheduled-job controller's
            # earliest-possible-start when lastScheduleTime is unset.
            meta.setdefault("creationTimestamp", _now_rfc3339())
            bucket[key] = obj
            if kind == "pods":
                self._account_pod(obj, +1)
            ev = self._emit("ADDED", kind, key, obj)
            # The event snapshot is already shared read-only with every
            # watcher; handing it to an owned caller (which serializes it
            # and moves on) adds no new aliasing.
            return ev.object if owned else copy.deepcopy(obj)

    def update(self, kind: str, obj: dict,
               expected_rv: Optional[str] = None,
               owned: bool = False) -> dict:
        with self._lock:
            key = self.object_key(obj)
            bucket = self._objects.setdefault(kind, {})
            current = bucket.get(key)
            if current is None:
                raise KeyError(f"{kind} {key} not found")
            if expected_rv is not None and \
                    current["metadata"].get("resourceVersion") != expected_rv:
                raise ConflictError(f"{kind} {key} resourceVersion conflict")
            if not owned:
                obj = copy.deepcopy(obj)
            # metadata.generation increments on spec changes (the
            # reference registries' PrepareForUpdate): controllers gate
            # "have I reconciled the latest spec?" on it —
            # status.observedGeneration >= metadata.generation.
            meta = obj.setdefault("metadata", {})
            old_gen = int((current.get("metadata") or {})
                          .get("generation", 1) or 1)
            if current.get("spec") != obj.get("spec"):
                meta["generation"] = old_gen + 1
            else:
                meta["generation"] = old_gen
            bucket[key] = obj
            if kind == "pods":
                # Re-account (a direct update can move or resize a
                # bound pod — the bind subresource is just the common
                # path).
                self._account_pod(current, -1)
                self._account_pod(obj, +1)
            ev = self._emit("MODIFIED", kind, key, obj, prev=current)
            return ev.object if owned else copy.deepcopy(obj)

    def delete(self, kind: str, key: str) -> None:
        with self._lock:
            bucket = self._objects.setdefault(kind, {})
            obj = bucket.pop(key, None)
            if obj is None:
                raise KeyError(f"{kind} {key} not found")
            if kind == "pods":
                self._account_pod(obj, -1)
            # COW before the rv stamp: the popped dict may still be
            # referenced by earlier in-flight events (share_events mode).
            prev = obj
            obj = dict(obj)
            obj["metadata"] = dict(obj.get("metadata") or {})
            self._emit("DELETED", kind, key, obj, prev=prev)

    def get(self, kind: str, key: str) -> Optional[dict]:
        with self._lock:
            obj = self._objects.get(kind, {}).get(key)
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, kind: str,
             selector: Optional[Callable[[dict], bool]] = None
             ) -> tuple[list[dict], int]:
        with self._lock:
            items = [copy.deepcopy(o) for o in
                     self._objects.get(kind, {}).values()
                     if selector is None or selector(o)]
            return items, self._rv

    # -- watch -----------------------------------------------------------

    def watch(self, kinds: Iterable[str], from_rv: int,
              selector=None, selector_key: Optional[str] = None) -> Watcher:
        """``selector``: a fielded-watch predicate (api.fieldsel.matcher)
        applied server-side with set-transition semantics — see
        Watcher._deliver.  ``selector_key`` (the selector's source
        string) lets watchers sharing one selector share the per-event
        classification (the watch cache)."""
        with self._lock:
            if self._events and from_rv < self._events[0].rv - 1 and \
                    from_rv < self._rv - len(self._events):
                raise TooOldError(f"rv {from_rv} too old")
            w = Watcher(self, tuple(kinds), selector=selector,
                        selector_key=selector_key)
            for ev in self._events:
                if ev.rv > from_rv and ev.kind in w.kinds:
                    w._deliver(ev)
            self._watchers.append(w)
            return w

    def _drop_watcher(self, w: Watcher) -> None:
        with self._lock:
            if w in self._watchers:
                self._watchers.remove(w)

    # -- the binding subresource ----------------------------------------

    def bind(self, namespace: str, pod_name: str, node_name: str) -> None:
        """BindingREST.Create (etcd.go:286-330): CAS spec.nodeName while
        empty; MODIFIED event on success, ConflictError otherwise."""
        with self._lock:
            self._bind_locked(namespace, pod_name, node_name)

    def _bind_locked(self, namespace: str, pod_name: str,
                     node_name: str) -> None:
        key = f"{namespace}/{pod_name}"
        pod = self._objects.get("pods", {}).get(key)
        if pod is None:
            raise KeyError(f"pod {key} not found")
        if (pod.get("spec") or {}).get("nodeName"):
            raise ConflictError(
                f"pod {key} is already assigned to node "
                f"{pod['spec']['nodeName']}")
        if self._capacity_check:
            # Server-side capacity validation: the 409 the scheduler
            # absorbs via forget + requeue, so watch lag can never land
            # an overcommitting bind.
            self._check_bind_capacity(key, pod, node_name)
        # Copy-on-write (pod + the two sub-dicts this write touches): the
        # previous version may still be referenced by in-flight events, so
        # no stored object is ever mutated in place.
        prev = pod
        pod = dict(pod)
        pod["spec"] = dict(pod.get("spec") or {})
        pod["metadata"] = dict(pod.get("metadata") or {})
        pod["spec"]["nodeName"] = node_name
        self._objects["pods"][key] = pod
        self._account_pod(pod, +1)
        self._emit("MODIFIED", "pods", key, pod, prev=prev)

    def bind_many(self, bindings: list[tuple[str, str, str]]
                  ) -> list[Optional[str]]:
        """Per-pod CAS under ONE lock acquisition: each (namespace, pod,
        node) binds independently — a conflict on one never blocks the
        rest, exactly as N sequential BindingREST.Create calls would
        behave.  Returns a per-item error string (None = bound)."""
        results: list[Optional[str]] = []
        with self._lock:
            for namespace, pod_name, node_name in bindings:
                try:
                    self._bind_locked(namespace, pod_name, node_name)
                    results.append(None)
                except (KeyError, ConflictError) as err:
                    results.append(str(err))
        return results

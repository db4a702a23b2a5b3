"""Double-bind referee: a store-watch monitor classifying nodeName
transitions.

Born as the soak harness's post-run reconciliation detector and promoted
to a reusable helper: every chaos/e2e rig that races binds (409 storms,
mid-drain kills, multiple active-active incarnations) wants the same
referee.  A BIND is ``"" -> node``; a DOUBLE BIND — the invariant a kill
between solve and bind, or two incarnations racing one shard, must never
break — is ``node -> different node`` on the same live pod object.
Delivery is synchronous under the store lock into an unbounded queue, so
no event is ever missed; a DELETED pod's slate is wiped (rolling updates
recreate names, which is a fresh bind, not a double one).

Defrag migrations (scheduler/defrag.py) add a second invariant: an
evicted-but-not-yet-rebound migrant must read as PENDING, never as
capacity on two nodes at once.  The monitor tracks the migration window
— a ``node -> ""`` unbind on a pod carrying the migration-intent
annotation opens it, the re-bind closes it — and counts any
``node -> different node`` transition that skipped the pending hop on a
migrating pod as DOUBLE CAPACITY (``assert_clean`` fails on either
counter).

A copy of ``kubernetes_tpu/chaos/bindmonitor.py`` with its import
pointed at this package.
"""

from __future__ import annotations

import threading

from kubernetes_tpu_torch.api.types import DEFRAG_MIGRATION_ANNOTATION_KEY


class BindMonitor:
    """Watch ``store``'s pod stream in-process and count binds,
    double-binds, and migration-window violations.  ``store`` is a
    MemStore (the watch rides the store lock, so the count is exact,
    not sampled)."""

    def __init__(self, store):
        self.binds = 0
        self.unbinds = 0
        self.double_binds = 0
        # pod key -> node of the offending transition, for assertion
        # messages that name the actual victim.
        self.double_bind_keys: list[tuple[str, str, str]] = []
        # Migration accounting: windows opened (evict-to-pending with
        # the intent annotation), closed (the migrant rebound), and the
        # double-capacity violations (a migrating pod seen on two nodes
        # without passing through pending).
        self.migrations_started = 0
        self.migrations_completed = 0
        self.double_capacity = 0
        self.double_capacity_keys: list[tuple[str, str, str]] = []
        self._migrating: set[str] = set()
        self._nodes: dict[str, str] = {}
        self._stopped = threading.Event()
        # Watch from the CURRENT rv: fleet registration that ran before
        # this monitor can exceed the server's replay window, and no pod
        # events predate it anyway.
        self._watcher = store.watch(["pods"],
                                    from_rv=store.list("pods")[1])
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="bind-monitor")
        self._thread.start()

    def _pump(self) -> None:
        while not self._stopped.is_set():
            ev = self._watcher.next(timeout=0.5)
            if ev is None:
                continue  # timeout (or the stop sentinel; flag decides)
            if ev.type == "DELETED":
                self._nodes.pop(ev.key, None)
                self._migrating.discard(ev.key)
                continue
            node = (ev.object.get("spec") or {}).get("nodeName") or ""
            prev = self._nodes.get(ev.key, "")
            migrating = DEFRAG_MIGRATION_ANNOTATION_KEY in \
                ((ev.object.get("metadata") or {}).get("annotations")
                 or {})
            if node and not prev:
                self.binds += 1
                if ev.key in self._migrating:
                    self.migrations_completed += 1
                    self._migrating.discard(ev.key)
            elif prev and not node:
                self.unbinds += 1
                if migrating:
                    self.migrations_started += 1
                    self._migrating.add(ev.key)
            elif node and prev and node != prev:
                self.double_binds += 1
                self.double_bind_keys.append((ev.key, prev, node))
                if migrating or ev.key in self._migrating:
                    # A migrating pod observed bound on two nodes with
                    # no pending hop in between: it was counted as
                    # capacity twice.
                    self.double_capacity += 1
                    self.double_capacity_keys.append(
                        (ev.key, prev, node))
            self._nodes[ev.key] = node

    def stop(self) -> None:
        self._stopped.set()
        self._watcher.stop()

    def assert_clean(self) -> None:
        """Raise with the offending transitions if any double bind — or
        any migration-window double capacity — was seen: the one-line
        acceptance check for e2e scenarios."""
        assert self.double_binds == 0, \
            f"double binds detected: {self.double_bind_keys}"
        assert self.double_capacity == 0, \
            f"migration double-capacity detected: " \
            f"{self.double_capacity_keys}"

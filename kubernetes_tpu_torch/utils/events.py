"""Event recording (pkg/client/record): every scheduling success/failure is
posted as an event (scheduler.go:102,143,152).  Sinks are pluggable; the
default keeps a bounded in-memory ring like the apiserver's event window."""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True)
class Event:
    object_key: str   # "namespace/name"
    event_type: str   # "Normal" | "Warning"
    reason: str       # "Scheduled" | "FailedScheduling" | ...
    message: str
    timestamp: float


class EventRecorder:
    def __init__(self, max_events: int = 4096,
                 sink: Optional[Callable] = None):
        self._events: collections.deque[Event] = collections.deque(
            maxlen=max_events)
        self._lock = threading.Lock()
        self._sink = sink

    def eventf(self, object_key: str, event_type: str, reason: str,
               message: str) -> None:
        ev = Event(object_key, event_type, reason, message, time.time())
        with self._lock:
            self._events.append(ev)
        if self._sink is not None:
            self._sink(ev)

    def eventf_many(self, items: list[tuple[str, str, str, str]]) -> None:
        """Bulk eventf: one timestamp + one lock acquisition for a solved
        batch.  With no sink attached, only the ring's capacity worth of
        events is materialized (the ring would drop the rest anyway — the
        reference's broadcaster also drops under load, record/event.go)."""
        if self._sink is None and len(items) > self._events.maxlen:
            items = items[-self._events.maxlen:]
        now = time.time()
        evs = [Event(k, t, r, m, now) for k, t, r, m in items]
        with self._lock:
            self._events.extend(evs)
        if self._sink is not None:
            for ev in evs:
                self._sink(ev)

    def events(self, object_key: str | None = None) -> list[Event]:
        with self._lock:
            evs = list(self._events)
        if object_key is not None:
            evs = [e for e in evs if e.object_key == object_key]
        return evs


_SINK_CLOSED = object()


def async_sink(sink: Optional[Callable], max_pending: int = 8192,
               batch_sink: Optional[Callable] = None) -> Callable:
    """Wrap a sink so posting never blocks the scheduling loop: events go
    through a bounded queue drained by one background thread, and overflow
    is DROPPED — the reference's event broadcaster behaves exactly this
    way (record/event.go buffered channel; a full buffer drops).  At wire
    bind rates a synchronous sink serializes ~0.5 ms per event into the
    drain loop; 30k binds would cost ~15 s of scheduling stall.

    ``batch_sink(list[Event])``, when given, receives everything queued at
    drain time in one call (the wire sink turns that into ONE batch POST;
    single event POSTs measured ~100 ms each against a loaded apiserver).

    The returned callable carries ``.close()`` (StopEventWatcher analogue)
    so owners can terminate the pump thread."""
    q: "_queue.Queue" = _queue.Queue(maxsize=max_pending)

    def pump():
        while True:
            ev = q.get()
            if ev is _SINK_CLOSED:
                return
            batch = [ev]
            if batch_sink is not None:
                while len(batch) < 1024:
                    try:
                        nxt = q.get_nowait()
                    except _queue.Empty:
                        break
                    if nxt is _SINK_CLOSED:
                        try:
                            batch_sink(batch)
                        except Exception:  # noqa: BLE001
                            pass
                        return
                    batch.append(nxt)
                try:
                    batch_sink(batch)
                except Exception:  # noqa: BLE001 — event loss is non-fatal
                    pass
                continue
            try:
                sink(ev)
            except Exception:  # noqa: BLE001 — event loss is non-fatal
                pass

    threading.Thread(target=pump, daemon=True,
                     name="event-sink-pump").start()

    def enqueue(ev) -> None:
        try:
            q.put_nowait(ev)
        except _queue.Full:
            pass  # drop under pressure (broadcaster semantics)

    def close() -> None:
        q.put(_SINK_CLOSED)

    enqueue.close = close
    return enqueue

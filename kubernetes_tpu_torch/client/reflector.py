"""Reflector: list+watch mirroring into handlers (pkg/client/cache/
reflector.go:56 ListAndWatch).

The contract the scheduler's factory relies on (factory.go:128-149,
387-416): list at a resourceVersion, deliver every object as an ADDED
handler call, then stream watch events from that version; on a 410-Gone
(window fell behind), a watch error, or stream EOF, relist from scratch.
Handlers receive (event_type, object_dict).

Transport-agnostic: ``source`` may be the in-process MemStore or an HTTP
``client.http.APIClient`` — both expose list(kind, selector) and a watcher
with next()/stop(); the HTTP watcher additionally emits a typed ERROR event
when the chunked stream dies, which triggers the relist path."""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.api import fieldsel
from kubernetes_tpu_torch.apiserver.memstore import MemStore, TooOldError
from kubernetes_tpu_torch.utils import metrics, threadreg

Handler = Callable[[str, dict], None]

# Relist backoff (PodBackoff-style doubling, factory.go:602-688 shape):
# the first failure retries quickly, a persistently dead apiserver is
# probed at the cap instead of hammered in a tight loop.
RELIST_BACKOFF_INITIAL = 0.2
RELIST_BACKOFF_MAX = 30.0
# A stream must survive this long for the backoff to reset: a server that
# lists fine but kills every stream instantly (mid-event cuts, a flapping
# LB) must not relist the whole kind at full rate.
STREAM_MIN_HEALTHY = 1.0


def _failure_delay(err: Exception, backoff: float) -> float:
    """The wait before the next relist attempt after ``err``.

    A 429 from a shedding server (flow control) carries an honest
    Retry-After: honor it — the server computed when capacity frees, and
    a generic jittered doubling would either hammer early or idle long
    past it.  Small jitter ABOVE the hint keeps a reflector fleet from
    returning in lockstep.  Everything else (transport faults, 5xx) keeps
    the jittered doubling.  Duck-typed on status/retry_after so the
    transport-agnostic reflector never imports the HTTP client."""
    retry_after = getattr(err, "retry_after", None)
    if getattr(err, "status", None) == 429 and retry_after is not None:
        return min(retry_after * random.uniform(1.0, 1.25),
                   RELIST_BACKOFF_MAX)
    return backoff * random.uniform(0.5, 1.5)


class Reflector:
    def __init__(self, source, kind: str, handler: Handler,
                 selector: Optional[Callable[[dict], bool]] = None,
                 field_selector: str = ""):
        """``field_selector`` (e.g. ``spec.nodeName=``) filters
        SERVER-side on both list and watch — the reference's fielded
        informers (factory.go:466-469).  ``selector`` remains a local
        predicate for conditions field selectors can't express."""
        self.source = source
        self.kind = kind
        self.handler = handler
        self.selector = selector
        self.field_selector = field_selector
        # Against a MemStore there is no server process; the compiled
        # matcher IS the server-side filter (list + fielded watch).
        self._fs_match = fieldsel.matcher(field_selector) \
            if field_selector else None
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._known: dict[str, dict] = {}  # key -> last delivered object
        # The watch streams opened so far, and whether one is open now
        # (stream_token).
        self._stream_epoch = 0
        self._streaming = False
        # Dispatch accounting children resolved once (kt-prof wire
        # attribution): handler nanoseconds accumulate locally and flush
        # per batch — relist delivery, idle tick, or every
        # _DISPATCH_FLUSH_EVERY events — never per event.
        self._m_handler_s = metrics.HANDLER_SECONDS.labels(handler=kind)
        self._m_handler_n = metrics.HANDLER_EVENTS.labels(handler=kind)

    _DISPATCH_FLUSH_EVERY = 256

    # Back-compat alias (round-1 callers constructed with store=).
    @property
    def store(self):
        return self.source

    def _open_watch(self, rv: int):
        if isinstance(self.source, MemStore):
            # selector_key joins the store's watch cache: reflectors
            # sharing one field-selector string (HA shards) share the
            # per-event set-transition classification.
            return self.source.watch(
                [self.kind], rv, selector=self._fs_match,
                selector_key=self.field_selector or None)
        return self.source.watch(self.kind, rv,
                                 field_selector=self.field_selector)

    def _list(self) -> int:
        """Replace semantics (cache.Store.Replace): objects that vanished
        while the watch was down are surfaced as DELETED on relist."""
        if isinstance(self.source, MemStore):
            sel = self.selector
            if self._fs_match is not None:
                fs = self._fs_match
                sel = fs if sel is None else \
                    (lambda o, _s=sel, _f=fs: _f(o) and _s(o))
            items, rv = self.source.list(self.kind, sel)
        else:
            items, rv = self.source.list(
                self.kind, self.selector,
                field_selector=self.field_selector)
        fresh = {MemStore.object_key(obj): obj for obj in items}
        t0 = time.perf_counter_ns()
        n = 0
        for key, obj in list(self._known.items()):
            if key not in fresh:
                self.handler("DELETED", obj)
                del self._known[key]
                n += 1
        for key, obj in fresh.items():
            self.handler("ADDED", obj)
            self._known[key] = obj
            n += 1
        # One flush for the whole relist delivery.
        self._m_handler_s.inc((time.perf_counter_ns() - t0) / 1e9)
        if n:
            self._m_handler_n.inc(n)
        self._synced.set()
        return rv

    def stream_token(self) -> Optional[int]:
        """The number of the watch stream now open, or None between a
        stream's end and the next list + watch: a reader that sees the
        same token before and after a wait knows every event of that
        window was delivered by one live stream."""
        return self._stream_epoch if self._streaming else None

    def run(self) -> threading.Thread:
        def loop():
            backoff = RELIST_BACKOFF_INITIAL
            first = True
            while not self._stop.is_set():
                if not first:
                    metrics.REFLECTOR_RELISTS.labels(kind=self.kind).inc()
                first = False
                try:
                    rv = self._list()
                    watcher = self._open_watch(rv)
                except TooOldError:
                    # 410 Gone: the watch window fell behind — relist
                    # immediately once, but back off if the server keeps
                    # answering Gone (a tight relist loop IS the storm).
                    self._stop.wait(backoff * random.uniform(0.5, 1.0)
                                    if backoff > RELIST_BACKOFF_INITIAL
                                    else 0.0)
                    backoff = min(backoff * 2, RELIST_BACKOFF_MAX)
                    continue
                except Exception as err:  # noqa: BLE001 — down: retry
                    # Jittered doubling instead of the old fixed 1 s loop
                    # (a fleet of reflectors against a flapping apiserver
                    # must not relist in lockstep) — except a shedding
                    # server's 429, whose Retry-After is honored exactly.
                    self._stop.wait(_failure_delay(err, backoff))
                    backoff = min(backoff * 2, RELIST_BACKOFF_MAX)
                    continue
                stream_started = time.monotonic()
                self._stream_epoch += 1
                self._streaming = True
                # Handler nanoseconds accumulate here and flush per
                # batch boundary (idle tick / flush threshold / stream
                # end), so the steady-state event path pays two clock
                # reads and no metric update.
                acc_ns = acc_n = 0
                perf_ns = time.perf_counter_ns

                def flush():
                    nonlocal acc_ns, acc_n
                    if acc_n:
                        self._m_handler_s.inc(acc_ns / 1e9)
                        self._m_handler_n.inc(acc_n)
                        acc_ns = acc_n = 0

                try:
                    while not self._stop.is_set():
                        ev = watcher.next(timeout=0.1)
                        if ev is None:
                            flush()
                            continue
                        if ev.type == "ERROR":
                            break  # stream died: relist (reflector.go:232)
                        if ev.type == "DELETED" or (
                                self.selector is not None
                                and not self.selector(ev.object)):
                            # Deleted, or left the selected set: surface as
                            # a delete so stores drop it (the fielded watch
                            # the reference gets server-side).
                            self._known.pop(ev.key, None)
                            t0 = perf_ns()
                            self.handler("DELETED", ev.object)
                            acc_ns += perf_ns() - t0
                            acc_n += 1
                            continue
                        self._known[ev.key] = ev.object
                        t0 = perf_ns()
                        self.handler(ev.type, ev.object)
                        acc_ns += perf_ns() - t0
                        acc_n += 1
                        if acc_n >= self._DISPATCH_FLUSH_EVERY:
                            flush()
                finally:
                    self._streaming = False
                    flush()
                    watcher.stop()
                # Reset the backoff only when the stream actually lived:
                # list + watch-open + a healthy stream means the server
                # recovered.  Streams dying at birth back off like any
                # other failure — instant relists ARE the storm.
                if time.monotonic() - stream_started >= STREAM_MIN_HEALTHY:
                    backoff = RELIST_BACKOFF_INITIAL
                elif not self._stop.is_set():
                    self._stop.wait(backoff * random.uniform(0.5, 1.5))
                    backoff = min(backoff * 2, RELIST_BACKOFF_MAX)
        return threadreg.spawn(loop, name=f"reflector-{self.kind}")

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()

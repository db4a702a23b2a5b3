"""Span tracer + the reference's 20 ms step-logger.

Grown from ``pkg/util/trace.go`` (the step tracer the scheduler wraps every
Schedule call in, generic_scheduler.go:79-85 uses a 20 ms threshold) into a
full span tracer for the batched control plane:

* ``span(name, **attrs)`` opens a span with attributes; spans nest via a
  thread-local context and link to their parent.  Completed spans land in a
  bounded in-process ring buffer (allocated lazily on the first recorded
  span) that every daemon serves at ``/debug/traces`` as Chrome trace-event
  JSON — load it in Perfetto (or chrome://tracing) and the batched
  ``queue -> solve -> assume -> bind`` pipeline is visible per batch.
* The trace id propagates over HTTP in a ``traceparent``-style header
  (W3C shape: ``00-{trace}-{span}-01``): the scheduler's bind calls carry
  it to the apiserver, extender calls carry it to the extender, and each
  server records its request span under the caller's trace id.
* ``stage(name)`` is a span *and* a labeled histogram observation
  (``scheduler_batch_stage_latency_microseconds{stage=...}``) — the hot
  loop's named stages feed both the trace view and /metrics.
* The off path costs one branch: ``KT_TRACE=0`` disables span recording
  entirely (``span()`` checks one module bool and yields), and
  ``KT_TRACE_SAMPLE`` (0.0-1.0) samples at trace granularity — the
  decision is made once at the root span and children follow it.

``Trace`` (the original step logger) remains API-compatible and now also
records slow traces as spans: a batch that crosses the 20 ms threshold both
logs its step breakdown and lands in the ring with the steps as attributes.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import threading
import time
from typing import Iterator
from collections import deque

logger = logging.getLogger("kubernetes_tpu_torch.trace")

TRACE_THRESHOLD_S = 0.020

# Ring capacity in spans.  A batch emits ~10 spans, so the default holds
# the last several hundred batches; the buffer is allocated only when the
# first span is recorded (a tracing-disabled daemon never pays for it).
from kubernetes_tpu_torch.utils import knobs

RING_CAPACITY = knobs.get_int("KT_TRACE_RING")

_enabled = knobs.get_bool("KT_TRACE")
_sample = max(0.0, min(1.0, knobs.get_float("KT_TRACE_SAMPLE")))

_ring: deque | None = None   # lazily allocated; deque append is atomic
_ring_lock = threading.Lock()
_tls = threading.local()


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def set_sample(fraction: float) -> None:
    """Trace-granularity sampling (the KT_TRACE_SAMPLE flag): the decision
    is made once per root span; a non-sampled trace records nothing."""
    global _sample
    _sample = max(0.0, min(1.0, float(fraction)))


def ring_allocated() -> bool:
    """For the overhead guard: the ring must stay unallocated until the
    first span is actually recorded."""
    return _ring is not None


def reset() -> None:
    """Drop all recorded spans (tests)."""
    global _ring
    with _ring_lock:
        _ring = None


def _record(name: str, trace_id: str, span_id: str, parent_id: str,
            ts_us: float, dur_us: float, attrs: dict | None) -> None:
    global _ring
    ring = _ring
    if ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = deque(maxlen=RING_CAPACITY)
            ring = _ring
    ring.append((name, trace_id, span_id, parent_id, ts_us, dur_us,
                 threading.get_ident(), attrs))


# -- context ---------------------------------------------------------------
#
# The thread-local context is (trace_id, span_id, sampled).  ``sampled``
# rides in the context so an unsampled root silences its whole subtree
# without per-span coin flips.

def current_context() -> tuple[str, str, bool] | None:
    """The active (trace_id, span_id, sampled) triple, or None.  Capture
    this before handing work to another thread and restore it there with
    ``use_context`` — the async bind fan-out stays on the batch's trace."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_context(ctx: tuple[str, str, bool] | None) -> Iterator[None]:
    """Install a captured context in this thread (cross-thread parenting)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def current_trace_id() -> str | None:
    """The active SAMPLED trace id, or None — the exemplar the metric
    histograms attach to observations so a p99 bucket links back to a
    retrievable trace."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or not ctx[2]:
        return None
    return ctx[0]


def traceparent() -> str | None:
    """The active context as a ``traceparent`` header value, or None.
    Callers attach it to outbound HTTP so the server's request span lands
    under this trace."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or not ctx[2]:
        return None
    return f"00-{ctx[0]}-{ctx[1]}-01"


def parse_traceparent(header: str) -> tuple[str, str, bool] | None:
    """``00-{trace}-{span}-{flags}`` -> context triple (None if garbled).
    A propagated context is always treated as sampled: the caller made the
    sampling decision."""
    parts = header.strip().split("-")
    if len(parts) < 3:
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return (trace_id, span_id, True)


# -- spans -----------------------------------------------------------------

class _SpanHandle:
    """An open span; ``end()`` records it and restores the parent context.
    ``attrs`` may be amended while the span is open."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_ts", "_t0", "_prev", "_done")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, attrs: dict,
                 prev: tuple[str, str, bool] | None, t0: float):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._ts = time.time() * 1e6
        self._t0 = t0
        self._prev = prev
        self._done = False

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        _tls.ctx = self._prev
        if attrs:
            self.attrs.update(attrs)
        _record(self.name, self.trace_id, self.span_id, self.parent_id,
                self._ts, (time.perf_counter() - self._t0) * 1e6,
                self.attrs or None)


class _NoopSpan:
    __slots__ = ()

    def end(self, **attrs) -> None:
        pass

    @property
    def trace_id(self) -> str:  # uniform access for callers stashing ids
        return ""


_NOOP = _NoopSpan()


class _UnsampledSpan:
    """An unsampled ROOT: records nothing, but installs an unsampled
    context so the whole subtree follows one sampling decision instead of
    every child re-flipping the coin and recording as an orphan root."""

    __slots__ = ("_prev",)
    trace_id = ""

    def __init__(self, prev: tuple[str, str, bool] | None):
        self._prev = prev

    def end(self, **attrs) -> None:
        _tls.ctx = self._prev


def begin_span(name: str, start: float | None = None,
               parent: tuple[str, str, bool] | None = None,
               **attrs) -> _SpanHandle | _NoopSpan:
    """Open a span explicitly (the contextmanager form is ``span()``).
    ``start`` backdates the span to an earlier ``time.perf_counter()``
    reading (the drain's queue-wait started before the batch existed);
    ``parent`` overrides the thread-local context (server spans adopt the
    propagated traceparent)."""
    if not _enabled:
        return _NOOP
    ctx = parent if parent is not None else getattr(_tls, "ctx", None)
    if ctx is None:
        if not (_sample >= 1.0 or random.random() < _sample):
            # Unsampled root: install an unsampled context so children
            # skip without re-sampling (one decision per trace).
            prev = getattr(_tls, "ctx", None)
            _tls.ctx = (f"{random.getrandbits(128):032x}",
                        f"{random.getrandbits(64):016x}", False)
            return _UnsampledSpan(prev)
        trace_id = f"{random.getrandbits(128):032x}"
        parent_id = ""
    else:
        trace_id, parent_id, sampled = ctx
        if not sampled:
            return _NOOP
    span_id = f"{random.getrandbits(64):016x}"
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (trace_id, span_id, True)
    t0 = time.perf_counter()
    h = _SpanHandle(name, trace_id, span_id, parent_id, attrs, prev, t0)
    if start is not None:
        h._t0 = start
        h._ts -= (t0 - start) * 1e6
    return h


@contextlib.contextmanager
def span(name: str, **attrs: object) -> Iterator[object]:
    """Record a span around the body.  One branch when tracing is off."""
    if not _enabled:
        yield _NOOP
        return
    h = begin_span(name, **attrs)
    try:
        yield h
    finally:
        h.end()


def record_server_span(name: str, traceparent_header: str,
                       dur_s: float, **attrs) -> None:
    """Record a completed server-side request span that just finished
    (its start is backdated by ``dur_s``).  With a propagated
    ``traceparent`` the span joins the caller's trace; without one it is
    a root span subject to local sampling."""
    if not _enabled:
        return
    ctx = parse_traceparent(traceparent_header) if traceparent_header \
        else None
    if ctx is None:
        if not (_sample >= 1.0 or random.random() < _sample):
            return
        trace_id = f"{random.getrandbits(128):032x}"
        parent_id = ""
    else:
        trace_id, parent_id, _ = ctx
    _record(name, trace_id, f"{random.getrandbits(64):016x}", parent_id,
            time.time() * 1e6 - dur_s * 1e6, dur_s * 1e6, attrs or None)


# -- hot-loop stages -------------------------------------------------------

@contextlib.contextmanager
def stage(name: str, **attrs: object) -> Iterator[object]:
    """A named pipeline stage: a span (when tracing is on) AND an
    observation in the per-stage labeled histogram (always — metrics are
    the cheap, always-on layer; spans are the sampled, detailed one).
    The span's trace id rides the observation as an OpenMetrics
    exemplar, so a slow histogram bucket links to its trace."""
    t0 = time.perf_counter()
    if _enabled:
        h = begin_span(name, **attrs)
        try:
            yield h
        finally:
            h.end()
            _observe_stage(name, (time.perf_counter() - t0) * 1e6,
                           h.trace_id or None)
    else:
        yield _NOOP
        _observe_stage(name, (time.perf_counter() - t0) * 1e6, None)


def record_stage(name: str, start: float, end: float | None = None,
                 **attrs) -> None:
    """Record a stage whose interval was measured by the caller
    (``start``/``end`` are ``time.perf_counter()`` readings) — for stages
    that begin before their span parent exists (queue wait)."""
    end = time.perf_counter() if end is None else end
    tid = None
    if _enabled:
        h = begin_span(name, start=start, **attrs)
        h.end()
        tid = h.trace_id or None
    _observe_stage(name, (end - start) * 1e6, tid)


def _observe_stage(name: str, us: float, trace_id: str | None = None
                   ) -> None:
    from kubernetes_tpu_torch.utils import metrics
    metrics.STAGE_LATENCY.labels(stage=name).observe(us,
                                                     exemplar=trace_id)


# -- export ----------------------------------------------------------------

def snapshot() -> list[dict]:
    """Completed spans, oldest first, as dicts."""
    ring = _ring
    if ring is None:
        return []
    out = []
    for (name, trace_id, span_id, parent_id, ts_us, dur_us, tid,
         attrs) in list(ring):
        d = {"name": name, "trace_id": trace_id, "span_id": span_id,
             "parent_id": parent_id, "ts_us": ts_us, "dur_us": dur_us,
             "thread": tid}
        if attrs:
            d["attrs"] = attrs
        out.append(d)
    return out


def to_chrome_trace() -> str:
    """The ring as Chrome trace-event JSON (complete 'X' events) —
    loadable in Perfetto / chrome://tracing."""
    pid = os.getpid()
    events = []
    for s in snapshot():
        args = dict(s.get("attrs") or {})
        args["trace_id"] = s["trace_id"]
        args["span_id"] = s["span_id"]
        if s["parent_id"]:
            args["parent_id"] = s["parent_id"]
        events.append({
            "name": s["name"], "ph": "X", "cat": "kubernetes_tpu_torch",
            "ts": s["ts_us"], "dur": s["dur_us"],
            "pid": pid, "tid": s["thread"], "args": args})
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})


# -- the original step tracer (pkg/util/trace.go:38-71) --------------------

class Trace:
    """Step tracer: the scheduler wraps Schedule calls and logs step
    timings when the total exceeds 20 ms (generic_scheduler.go:79-85).
    Slow traces now ALSO record as a span with the step breakdown in
    attributes, so they show up at /debug/traces next to the stage spans."""

    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()
        self.steps: list[tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((time.perf_counter(), msg))

    def total_s(self) -> float:
        return time.perf_counter() - self.start

    def log_if_long(self, threshold_s: float = TRACE_THRESHOLD_S) -> None:
        total = self.total_s()
        if total < threshold_s:
            return
        lines = [f'Trace "{self.name}" (total {total * 1e3:.1f}ms):']
        attrs: dict = {}
        last = self.start
        for t, msg in self.steps:
            lines.append(f'  [{(t - self.start) * 1e3:.1f}ms] '
                         f'(+{(t - last) * 1e3:.1f}ms) {msg}')
            attrs[msg] = round((t - last) * 1e3, 3)
            last = t
        logger.info("\n".join(lines))
        if _enabled:
            begin_span("slow_trace", start=self.start,
                       trace_name=self.name, **attrs).end()

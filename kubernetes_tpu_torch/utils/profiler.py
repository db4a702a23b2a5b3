"""kt-prof: continuous in-process CPU attribution.

Counterpart of ``kubernetes_tpu/utils/profiler.py`` (host Python only;
its path rules name this package's modules).  The device side has its
own trace hook (``utils/profiling.py``) and the stages their spans; this
module says where HOST CPU goes between the stages — the question the
wire path's arrival time turns on.  It is a production continuous
profiler in miniature (the Google-Wide-Profiling shape: always-on,
sampling, low single-digit-percent overhead):

* a ``threadreg``-spawned sampler thread wakes at up to ``KT_PROF_HZ``
  (a deliberately off-beat ~19 Hz so the sample clock never phase-locks
  with 10/20/100 Hz periodic work), reads every thread's cumulative CPU
  time, and walks ``sys._current_frames()`` once per tick; the rate is
  a ceiling, not a promise — ticks cost O(live threads), so the loop
  self-paces to keep its own CPU under 2 % of wall clock, and above
  ``_PROC_THREAD_CAP`` threads the per-thread CPU reads (the dominant
  tick cost) shut off in favor of the process-wide fallback;
* each thread's CPU **delta** since the previous tick is attributed to
  the component its current stack classifies to — CPU-delta weighting is
  what makes wall-clock sampling honest in a process where most threads
  are parked in ``wait()`` (a stack sampled in an idle thread carries
  zero weight);
* the module-prefix -> component classifier folds stacks into the fixed
  taxonomy ``watch_decode`` / ``handler_dispatch`` / ``feature_build`` /
  ``serialize`` / ``apiserver`` / ``solve_host`` / ``commit_bind`` /
  ``other`` — the component names of the bench's ``profile`` section
  (``perf/harness.py:profile_section``);
* results export three ways: ``process_cpu_fraction{component=}`` /
  ``process_thread_cpu_seconds_total{thread=}`` into the default metrics
  registry (and through it the telemetry ring + dashboard), a bounded
  folded-stack table served as collapsed-stack text or speedscope JSON
  at ``/debug/profile`` on every status mux, and a ``snapshot()`` API
  the perf harness diffs around its timed windows.

Off path: ``KT_PROF=0`` makes :func:`ensure_started` one branch and the
``/debug/profile`` routes answer 404 — no thread, no ring, no samples.

Per-thread CPU comes from each thread's CPU clock: ``clock_gettime`` on
the clock id Linux derives from a thread id (``_thread_clock``), one
system call and no file I/O; where that clock cannot be read it comes
from ``/proc/self/task/<tid>/stat`` (utime+stime), as in the JAX
package.  The clock is this package's choice: on a sandboxed Linux
host of an NVIDIA H100 (its kernel reports 4.4.0) a ``/proc/self/task``
stat read took ~40 ms of wall, so a 32-thread tick took ~1.1 s and the
2 % pacing stretched the sampler to one tick every ~8.5 s; a clock read
takes microseconds.  ``time.thread_time`` only measures the *calling*
thread, so the sampler uses it for exactly one thing: its own
self-cost, exported like any other thread's so the overhead claim
("< 2 %") is itself measured, not asserted.  Off-Linux the sampler
degrades to process-wide ``time.process_time`` deltas attributed through
whichever sampled stacks are runnable-looking (not parked in a known
idle frame).

Knobs are read ONCE at construction and the sampler is spawned via
``threadreg.spawn``.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from types import FrameType
from typing import Optional, Union

from kubernetes_tpu_torch.utils import knobs, locktrace, threadreg

# Module-load read, never per-call.  KT_PROF=0 turns the whole
# plane off; every public entrypoint then costs one branch.
_ENABLED = knobs.get_bool("KT_PROF")

COMPONENTS = ("watch_decode", "handler_dispatch", "feature_build",
              "serialize", "apiserver", "solve_host", "commit_bind",
              "other")

# Known-idle innermost functions: a thread parked here is waiting, not
# working — only consulted on the no-/proc fallback path, where CPU
# deltas are process-wide and must be split across runnable stacks.
_IDLE_FUNCS = frozenset((
    "wait", "get", "accept", "recv", "recv_into", "read", "read1",
    "readline", "select", "poll", "sleep", "epoll", "readinto",
    "_recv_into", "settimeout",
))

# Overhead governors.  A tick costs O(live threads) — the per-thread
# CPU reads dominate (with /proc stat reads ~17 ms for 1,000 threads,
# i.e. ~30 % of a core at a fixed 19 Hz: enough to stall a kubemark
# fleet on a 1-core rig).  Two defenses: above _PROC_THREAD_CAP threads the
# sampler drops the per-thread reads and degrades to the same
# process-wide split it uses off-Linux; and the loop self-paces,
# stretching each sleep so sampler CPU stays under _SELF_BUDGET of wall
# clock no matter what a tick cost (KT_PROF_HZ is a ceiling, not a
# promise).
_PROC_THREAD_CAP = 256
_SELF_BUDGET = 0.02
_MAX_INTERVAL = 10.0

# Function-gated rules: (filename suffix -> {function -> component}).
# These fire before the path-prefix table because the same module hosts
# more than one component: client/http.py is the watch pump AND the
# binder's POST path; the apiservers' _send_* helpers are where C-level
# json.dumps hides (the C encoder leaves no Python frame of its own, so
# the serializing CALLER is the only sample the wall clock can land on).
_FN_RULES: tuple[tuple[str, dict[str, str]], ...] = (
    # The binder's POST path of this package's client/http.py runs on
    # the client's bind-list pool, where no binder frame sits above it:
    # its chunk functions are commit_bind by name (the JAX package's rule
    # names only the pump, so it files these POSTs under other).
    ("kubernetes_tpu_torch/client/http.py", {
        "_pump": "watch_decode", "bind_list": "commit_bind",
        "one_chunk": "commit_bind", "_bind_list_chunk": "commit_bind"}),
    ("client/http.py", {"_pump": "watch_decode"}),
    ("apiserver/server.py", {"_send_json": "serialize",
                             "_send_raw": "serialize",
                             "_send_json_bytes": "serialize",
                             "_send_text": "serialize"}),
    # Pure-python json: dumps is serialize; loads stays unmatched so the
    # decode attributes to whoever called it (_pump -> watch_decode).
    ("json/__init__.py", {"dumps": "serialize", "dump": "serialize"}),
    # The drain pipeline hosts BOTH halves of a batch: the solve pump
    # (dispatch + readback waits) and the post-solve commit chunk.
    ("scheduler/pipeline.py", {"_commit_chunk": "commit_bind",
                               "_solve": "solve_host",
                               "_solve_oneshot": "solve_host",
                               "_solve_stream": "solve_host",
                               "_solve_tenants": "solve_host",
                               "_solve_tenant_groups": "solve_host",
                               "_dispatch": "solve_host"}),
    # The batch assume/bind path lives in scheduler.py, not binder.py —
    # the rest of the module (drain loop, queue pops) stays unmatched.
    ("scheduler/scheduler.py", {"_assume_and_bind_batch": "commit_bind",
                                "_assume_and_bind": "commit_bind",
                                "_bind_assumed": "commit_bind",
                                "_bind_assumed_batch": "commit_bind",
                                "_bind_assumed_batch_inner": "commit_bind",
                                "_record_batch_decisions": "commit_bind"}),
)

# Module-prefix table, first match wins, checked innermost frame first
# then outward — so a torch/numpy leaf attributes to the package caller
# that dispatched it.  The prefixes name this package: the JAX package's
# "kubernetes_tpu/engine/" is not a substring of
# "kubernetes_tpu_torch/engine/".  engine/ covers the port's own solve
# modules too (scan.py, kernels.py, convert.py).
_PATH_RULES: tuple[tuple[str, str], ...] = (
    ("/json/encoder.py", "serialize"),
    ("/json/decoder.py", "watch_decode"),
    ("kubernetes_tpu_torch/client/reflector", "handler_dispatch"),
    ("kubernetes_tpu_torch/features/", "feature_build"),
    ("kubernetes_tpu_torch/apiserver/", "apiserver"),
    ("kubernetes_tpu_torch/engine/", "solve_host"),
    ("kubernetes_tpu_torch/ops/", "solve_host"),
    ("kubernetes_tpu_torch/parallel/", "solve_host"),
    ("kubernetes_tpu_torch/scheduler/binder", "commit_bind"),
    # Event emission and decision recording both happen at commit time.
    # The JAX package's rule names scheduler/events, a module neither
    # package has; the event recorder and its sink pump live in
    # utils/events.py, which this package's rule also names.
    ("kubernetes_tpu_torch/scheduler/events", "commit_bind"),
    ("kubernetes_tpu_torch/utils/events", "commit_bind"),
    ("kubernetes_tpu_torch/scheduler/flightrecorder", "commit_bind"),
    ("kubernetes_tpu_torch/cache/scheduler_cache", "commit_bind"),
)

# Thread-role rules: a pool whose threads run one component's work and
# nothing else.  A per-thread CPU delta is charged to the stack sampled
# at the tick; for these threads that stack is often the idle worker
# loop (concurrent/futures/thread.py:_worker, between two work items) or
# the thread's exit (threading.py:_delete), which no path rule names,
# while the CPU since the last tick went to their one kind of work.
# Consulted only when the stack classifies as other.  (The JAX package
# has no thread rules.)
_THREAD_RULES: tuple[tuple[str, str], ...] = (
    # DrainPipeline's commit pool: only _commit_chunk work items.
    ("chunk-commit", "commit_bind"),
    # APIClient.bind_list's pool: only bind-list chunks.
    ("bind-list", "commit_bind"),
    # Scheduler's async binders: one _bind_assumed_batch each.
    ("bind-batch", "commit_bind"),
)

_MAX_STACK_DEPTH = 48
_MAX_THREAD_LABELS = 24

# Collapse per-instance numeric suffixes ("bind-worker-17") so thread
# label cardinality stays bounded by ROLE, not by instance count.
_NUM_SUFFIX = re.compile(r"[-_]?\d+$")


def classify_frame(filename: str, func: str) -> Optional[str]:
    """Component for ONE frame, or None (caller walks outward)."""
    f = filename.replace("\\", "/")
    for suffix, funcs in _FN_RULES:
        if f.endswith(suffix):
            return funcs.get(func)
    for prefix, comp in _PATH_RULES:
        if prefix in f:
            return comp
    return None


def classify_thread(name: str) -> Optional[str]:
    """Component of a thread whose role is one component's work (by
    its name's prefix), or None."""
    for prefix, comp in _THREAD_RULES:
        if name.startswith(prefix):
            return comp
    return None


def classify_stack(frame: Optional[FrameType]) -> str:
    """Walk innermost -> outward; first classified frame wins."""
    depth = 0
    while frame is not None and depth < _MAX_STACK_DEPTH:
        code = frame.f_code
        comp = classify_frame(code.co_filename, code.co_name)
        if comp is not None:
            return comp
        frame = frame.f_back
        depth += 1
    return "other"


def _frame_name(code) -> str:
    """'pkg/mod.py:func' with noise prefixes stripped — what the
    collapsed / speedscope frame tables show."""
    f = code.co_filename.replace("\\", "/")
    for marker in ("site-packages/", "kubernetes_tpu_torch/",
                   "lib/python"):
        i = f.rfind(marker)
        if i >= 0:
            f = ("kubernetes_tpu_torch/" + f[i + len(marker):]
                 if marker == "kubernetes_tpu_torch/" else f[i:])
            break
    else:
        f = "/".join(f.rsplit("/", 2)[-2:])
    return f"{f}:{code.co_name}"


def fold_stack(frame: FrameType) -> str:
    """Brendan-Gregg collapsed form: root;...;leaf."""
    names: list[str] = []
    depth = 0
    while frame is not None and depth < _MAX_STACK_DEPTH:
        names.append(_frame_name(frame.f_code))
        frame = frame.f_back
        depth += 1
    names.reverse()
    return ";".join(names)


def _looks_idle(frame) -> bool:
    return frame is not None and frame.f_code.co_name in _IDLE_FUNCS


def _thread_clock(native_id: int) -> int:
    """The CPU-clock id of kernel thread ``native_id`` (Linux's
    MAKE_THREAD_CPUCLOCK(tid, CPUCLOCK_SCHED))."""
    return (~native_id << 3) | 6


class _ProcReader:
    """Per-thread cumulative CPU seconds (Linux): the thread's CPU clock,
    else /proc/self/task/<tid>/stat.

    utime+stime are fields 14/15 of .../stat, counted AFTER the ')' that
    closes the comm field (comm may itself contain spaces)."""

    def __init__(self):
        self._tick = float(os.sysconf("SC_CLK_TCK")) \
            if hasattr(os, "sysconf") else 100.0
        try:
            time.clock_gettime(_thread_clock(threading.get_native_id()))
            self.clock = True
        except (AttributeError, OSError, OverflowError, ValueError):
            self.clock = False
        self.available = self.clock or os.path.isdir("/proc/self/task")

    def cpu_seconds(self, native_id: int) -> Optional[float]:
        if self.clock:
            try:
                return time.clock_gettime(_thread_clock(native_id))
            except (OSError, OverflowError):
                return None
        try:
            with open(f"/proc/self/task/{native_id}/stat", "rb") as f:
                raw = f.read()
        except OSError:
            return None
        try:
            fields = raw[raw.rindex(b")") + 2:].split()
            return (int(fields[11]) + int(fields[12])) / self._tick
        except (ValueError, IndexError):
            return None


class Profiler:
    """The sampler + aggregation state.  One per process."""

    def __init__(self):
        # Both knobs read here, once, never in the loop.
        self.hz = max(0.1, min(250.0, knobs.get_float("KT_PROF_HZ")))
        self.ring = max(16, knobs.get_int("KT_PROF_RING"))
        self._lock = locktrace.make_lock("profiler.Profiler")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._proc = _ProcReader()
        self._started_at = time.monotonic()
        self._last_wall: Optional[float] = None
        self._last_cpu: dict[int, float] = {}      # ident -> cpu seconds
        self._last_process_cpu = 0.0
        self._samples = 0
        self._comp_cpu = {c: 0.0 for c in COMPONENTS}  # cumulative
        self._comp_frac = {c: 0.0 for c in COMPONENTS}  # EWMA of window
        self._thread_cpu: dict[str, float] = {}
        self._stacks: dict[str, float] = {}        # folded -> cpu seconds
        self._stacks_truncated = 0.0
        self._self_cpu = 0.0                       # sampler's own cost

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Profiler":
        if self._thread is None:
            self._thread = threadreg.spawn(
                self._loop, name="kt-prof-sampler")
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def _loop(self) -> None:
        delay = 1.0 / self.hz
        while not self._stop.wait(delay):
            t0 = time.thread_time()
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the profiler must never
                pass           # take a daemon down
            cost = time.thread_time() - t0
            self._self_cpu += cost
            delay = self._next_delay(cost)

    def _next_delay(self, cost: float) -> float:
        """GWP-style pacing: whatever the last tick cost, sleep long
        enough that the sampler's own CPU stays under _SELF_BUDGET of
        wall clock.  Tick cost is O(live threads), so a fixed interval
        would make thread-heavy phases (kubemark fleets) pay the most
        overhead exactly when they can least afford it."""
        return min(max(1.0 / self.hz, cost / _SELF_BUDGET),
                   _MAX_INTERVAL)

    # -- sampling --------------------------------------------------------

    def sample_once(self) -> None:
        """One tick: per-thread CPU deltas attributed through current
        stacks.  Public so tests (and the harness prewarm) can force a
        sample without waiting out the interval."""
        now = time.monotonic()
        frames = sys._current_frames()
        me = threading.get_ident()
        threads = {t.ident: t for t in threading.enumerate()
                   if t.ident is not None}
        per_thread: dict[int, float] = {}
        if self._proc.available and len(threads) <= _PROC_THREAD_CAP:
            for ident, t in threads.items():
                nid = getattr(t, "native_id", None)
                if nid is None:
                    continue
                cpu = self._proc.cpu_seconds(nid)
                if cpu is not None:
                    per_thread[ident] = cpu
        with self._lock:
            self._tick_locked(now, frames, threads, per_thread, me)

    def _tick_locked(self, now, frames, threads, per_thread, me) -> None:
        wall = (now - self._last_wall) if self._last_wall is not None \
            else None
        self._last_wall = now
        self._samples += 1
        deltas: dict[int, float] = {}
        # Process CPU is tracked on EVERY tick so flipping between the
        # per-thread and fallback modes (the _PROC_THREAD_CAP boundary)
        # never produces a delta spanning the other mode's reign.
        pc = time.process_time()
        dp = pc - self._last_process_cpu
        self._last_process_cpu = pc
        if per_thread:
            for ident, cpu in per_thread.items():
                prev = self._last_cpu.get(ident)
                if prev is not None and cpu > prev:
                    deltas[ident] = cpu - prev
            self._last_cpu = per_thread
        else:
            # Fallback (no /proc, or over the thread cap): split the
            # process-wide CPU delta evenly across threads whose stack
            # isn't parked idle.
            if self._last_cpu:
                self._last_cpu = {}   # stale per-thread baselines would
                # double-count this window when the cap is re-crossed
            busy = [i for i in threads
                    if i != me and not _looks_idle(frames.get(i))]
            if busy and dp > 0:
                share = dp / len(busy)
                deltas = {i: share for i in busy}
        window = {c: 0.0 for c in COMPONENTS}
        for ident, dcpu in deltas.items():
            if ident == me:
                continue   # sampler self-cost tracked via thread_time
            frame = frames.get(ident)
            comp = classify_stack(frame) if frame is not None else "other"
            t = threads.get(ident)
            if comp == "other" and t is not None:
                comp = classify_thread(t.name) or comp
            self._comp_cpu[comp] += dcpu
            window[comp] += dcpu
            if t is not None:
                self._note_thread_locked(t.name, dcpu)
            if frame is not None:
                self._note_stack_locked(fold_stack(frame), dcpu)
        if wall and wall > 0:
            # EWMA over ~1 s of ticks: fast enough for the dashboard,
            # smooth enough to read.
            alpha = min(1.0, wall * 2.0)
            for c in COMPONENTS:
                self._comp_frac[c] += alpha * (window[c] / wall
                                               - self._comp_frac[c])
        self._export_locked()

    def _note_thread_locked(self, name: str, dcpu: float) -> None:
        label = _NUM_SUFFIX.sub("", name) or name
        if label not in self._thread_cpu and \
                len(self._thread_cpu) >= _MAX_THREAD_LABELS:
            label = "other"
            self._thread_cpu.setdefault(label, 0.0)
        self._thread_cpu[label] = self._thread_cpu.get(label, 0.0) + dcpu

    def _note_stack_locked(self, folded: str, dcpu: float) -> None:
        if folded not in self._stacks and len(self._stacks) >= self.ring:
            self._stacks_truncated += dcpu
            return
        self._stacks[folded] = self._stacks.get(folded, 0.0) + dcpu

    def _export_locked(self) -> None:
        from kubernetes_tpu_torch.utils import metrics as m
        for c, frac in self._comp_frac.items():
            m.PROCESS_CPU_FRACTION.labels(component=c).set(round(frac, 4))
        for name, cpu in self._thread_cpu.items():
            child = m.PROCESS_THREAD_CPU.labels(thread=name)
            # Counters only move forward: publish the cumulative value
            # by incrementing the shortfall.
            short = cpu - child.value
            if short > 0:
                child.inc(short)
        sampler = m.PROCESS_THREAD_CPU.labels(thread="kt-prof-sampler")
        short = self._self_cpu - sampler.value
        if short > 0:
            sampler.inc(short)

    # -- read side -------------------------------------------------------

    def snapshot(self) -> dict:
        """Cumulative attribution state — the harness diffs two of these
        around a timed window."""
        with self._lock:
            total = sum(self._comp_cpu.values())
            return {
                "uptime_s": round(time.monotonic() - self._started_at, 3),
                "samples": self._samples,
                "hz": self.hz,
                "cpu_seconds": {c: round(v, 6)
                                for c, v in self._comp_cpu.items()},
                "fraction": {c: round(v, 4)
                             for c, v in self._comp_frac.items()},
                "unclassified_fraction": round(
                    self._comp_cpu["other"] / total, 4) if total else 0.0,
                "threads": {n: round(v, 6)
                            for n, v in sorted(self._thread_cpu.items())},
                "sampler_self_cpu_s": round(self._self_cpu, 6),
            }

    def collapsed(self) -> str:
        """Folded stacks, one per line, weight in integer microseconds
        (flamegraph.pl / speedscope both ingest this form)."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            lines = [f"{stack} {int(cpu * 1e6)}"
                     for stack, cpu in items if cpu > 0]
            if self._stacks_truncated > 0:
                lines.append(f"(ring-truncated) "
                             f"{int(self._stacks_truncated * 1e6)}")
        return "\n".join(lines) + "\n"

    def speedscope(self) -> dict:
        """The profile as a speedscope 'sampled' document: each distinct
        folded stack becomes one weighted sample."""
        with self._lock:
            stacks = [(s, w) for s, w in self._stacks.items() if w > 0]
        frame_ix: dict[str, int] = {}
        frames: list[dict] = []
        samples: list[list[int]] = []
        weights: list[float] = []
        for folded, cpu in stacks:
            sample = []
            for name in folded.split(";"):
                i = frame_ix.get(name)
                if i is None:
                    i = frame_ix[name] = len(frames)
                    frames.append({"name": name})
                sample.append(i)
            samples.append(sample)
            weights.append(round(cpu, 6))
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "exporter": "kt-prof",
            "name": "kt-prof CPU profile",
            "activeProfileIndex": 0,
            "shared": {"frames": frames},
            "profiles": [{
                "type": "sampled",
                "name": "cpu (weighted by per-thread CPU deltas)",
                "unit": "seconds",
                "startValue": 0,
                "endValue": round(total, 6),
                "samples": samples,
                "weights": weights,
            }],
        }


# -- module surface (what daemons and muxes call) -------------------------

_CELL: list[Profiler] = []
_CELL_LOCK = threading.Lock()


def enabled() -> bool:
    """The off-path check hot sites use: one attribute read + return."""
    return _ENABLED


def get() -> Optional[Profiler]:
    return _CELL[0] if _CELL else None


def ensure_started() -> Optional[Profiler]:
    """Start (once) and return the process profiler; None when KT_PROF=0
    — that refusal is the entire disabled code path."""
    if not _ENABLED:
        return None
    if _CELL:
        return _CELL[0]
    with _CELL_LOCK:
        if not _CELL:
            _CELL.append(Profiler().start())
    return _CELL[0]


def render(query: Union[str, dict, None] = None) \
        -> Optional[tuple[bytes, str]]:
    """(body, content_type) for /debug/profile, or None when disabled
    (every mux maps None to 404-not-500).  ``?format=collapsed`` selects
    the folded text form; the default is speedscope JSON.  ``query``
    accepts a raw query string (debugmux) or a parse_qs dict (the
    apiserver's dispatch)."""
    prof = ensure_started()
    if prof is None:
        return None
    if isinstance(query, str):
        fmt = "collapsed" if "format=collapsed" in query else ""
    elif query:
        v = query.get("format", [""])
        fmt = v[0] if isinstance(v, list) else str(v)
    else:
        fmt = ""
    if fmt == "collapsed":
        return prof.collapsed().encode(), "text/plain"
    return (json.dumps(prof.speedscope()).encode(),
            "application/json")

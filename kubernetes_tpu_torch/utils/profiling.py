"""Profiling hooks: device traces of the solves, and the thread dump.

Counterpart of ``kubernetes_tpu/utils/profiling.py`` on
``torch.profiler``.  Every reference daemon serves /debug/pprof
(app/server.go:96-100) and the perf rig collects cpu/mem/block profiles
(test/component/scheduler/perf/test-performance.sh).  Here the device
side is CUDA, so the equivalent is a ``torch.profiler`` trace around each
device solve — flag-gated by ``--profile-dir`` / ``KT_PROFILE_DIR`` —
exported as one Chrome trace per solve (viewable in Perfetto or
``chrome://tracing``) with the kernels the solve launched; the host side
is the /debug/pprof thread dump (the goroutine-dump analogue).

``device_trace(label)`` is a no-op without a directory.  With one, it
runs ``torch.profiler.profile`` over the CPU (and CUDA, when a card is
present) with a ``record_function(label)`` around the solve, waits for
the card so the solve's kernels land in the trace, and writes
``<dir>/<label>-<pid>-<n>.pt.trace.json`` (``n`` counts traces in this
process, so files never overwrite each other).

A ``torch.profiler`` session is process-wide and sessions cannot nest.
Two solves can overlap — the stream pipeline solves on the drain thread
while another daemon in the process (or a test's second thread) solves
too — so traced solves are SERIALISED: a solve that finds another
thread's session open waits for it to end, then opens its own (each
solve still gets its own trace; ``stats()["waited"]`` counts the waits).
A traced solve nested inside another in the SAME thread adds its label
to the open session instead of opening a second one.  A session opened
by someone else (a caller's own ``torch.profiler.profile``) makes
``device_trace`` raise: a traced solve never carries on untraced.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import sys
import threading
import time
import traceback
from typing import Iterator

from kubernetes_tpu_torch.utils import knobs

_PROFILE_DIR = [knobs.get("KT_PROFILE_DIR")]

# One torch.profiler session at a time, process-wide.
_session = threading.Lock()
_tls = threading.local()        # .active: this thread holds the session
_seq = itertools.count()
_stats = {"traces": 0, "waited": 0, "wait_s": 0.0, "nested": 0}
_stats_lock = threading.Lock()
_UNSAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def set_profile_dir(path: str) -> None:
    _PROFILE_DIR[0] = path or ""


def stats() -> dict:
    """Traces written, solves that waited for another thread's session
    (and the seconds they waited), and same-thread nested labels."""
    with _stats_lock:
        return dict(_stats)


def _bump(key: str, by: float = 1) -> None:
    with _stats_lock:
        _stats[key] += by


@contextlib.contextmanager
def device_trace(label: str) -> Iterator[None]:
    """A ``torch.profiler`` trace around a device solve when profiling is
    enabled (no-op — one branch — otherwise)."""
    directory = _PROFILE_DIR[0]
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if getattr(_tls, "active", False):
        # Nested in this thread's traced solve: the label rides along.
        _bump("nested")
        with record_function(label):
            yield
        return
    t0 = time.perf_counter()
    if not _session.acquire(blocking=False):
        _session.acquire()
        _bump("waited")
        _bump("wait_s", time.perf_counter() - t0)
    try:
        if _session_open(torch):
            # torch would start a second session and end the caller's
            # with it: refuse rather than trace wrongly or not at all.
            raise RuntimeError(
                f"device_trace({label!r}): a torch.profiler session is "
                f"already open in this process; close it or unset the "
                f"profile directory")
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        _tls.active = True
        try:
            with profile(activities=activities) as prof:
                with record_function(label):
                    yield
                if cuda:
                    # The launches are asynchronous: wait for them so the
                    # solve's kernels are inside the session.
                    torch.cuda.synchronize()
        finally:
            _tls.active = False
        os.makedirs(directory, exist_ok=True)
        name = f"{_UNSAFE.sub('_', label)}-{os.getpid()}-{next(_seq):05d}"
        prof.export_chrome_trace(
            os.path.join(directory, f"{name}.pt.trace.json"))
        _bump("traces")
    finally:
        _session.release()


def _session_open(torch) -> bool:
    """Whether a profiler session is open (anyone's)."""
    probe = getattr(torch._C._autograd, "_profiler_enabled", None)
    if probe is not None:
        return bool(probe())
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


def thread_stacks() -> str:
    """All live thread stacks as text — /debug/pprof/goroutine?debug=2."""
    frames = sys._current_frames()
    out = []
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        out.append(f"thread {t.name} (daemon={t.daemon}, "
                   f"alive={t.is_alive()}):")
        if frame is not None:
            out.extend("  " + ln for ln in
                       traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)

"""The port's sampling CPU profiler (``kubernetes_tpu_torch/utils/
profiler.py``) against the JAX package's ``tests/test_profiler.py``
cases: the classifier, the render surfaces and the governors.

The path rules name this package: a frame of
``kubernetes_tpu_torch/engine/`` is ``solve_host`` here, where the JAX
package's rules (``"kubernetes_tpu/engine/"``, not a substring of it)
file it under ``other`` — checked on a real frame of the port's engine
sampled mid-drain.  The JAX package's timing-share checks (the sampler
under 2 % of a window, 100k off-path calls under a second, the wire
accounting under 5 % of a decode budget) are unsteady under parallel
test workers; their counterparts here assert counts (samples, ticks,
events), not a wall-clock share."""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import pytest

from kubernetes_tpu.utils import profiler as ref_profiler
from kubernetes_tpu_torch.utils import profiler

PORT = "/r/kubernetes_tpu_torch"


# -- classifier --------------------------------------------------------------

def test_classify_frame_path_rules():
    cf = profiler.classify_frame
    assert cf(f"{PORT}/engine/solver.py", "solve") == "solve_host"
    assert cf(f"{PORT}/ops/scatter.py", "go") == "solve_host"
    assert cf(f"{PORT}/features/nodeinfo.py", "build") == "feature_build"
    assert cf(f"{PORT}/client/reflector.py", "loop") == "handler_dispatch"
    assert cf(f"{PORT}/apiserver/memstore.py", "list") == "apiserver"
    assert cf(f"{PORT}/scheduler/binder.py", "bind") == "commit_bind"
    assert cf(f"{PORT}/cache/scheduler_cache.py", "add") == "commit_bind"
    assert cf("/usr/lib/python3.11/json/encoder.py", "iterencode") == \
        "serialize"
    assert cf("/usr/lib/python3.11/json/decoder.py", "raw_decode") == \
        "watch_decode"
    # The port's own solve modules.
    for mod in ("scan.py", "kernels.py", "convert.py", "fused.py"):
        assert cf(f"{PORT}/engine/{mod}", "f") == "solve_host", mod


def test_the_path_trap_on_a_real_engine_frame():
    """A frame of the port's engine, sampled from a thread mid-drain,
    classifies as solve_host under the port's rules; the JAX package's
    rules see no prefix of theirs in the same file name."""
    from kubernetes_tpu_torch.engine import solver
    assert profiler.classify_frame(solver.__file__, "solve") == "solve_host"
    assert ref_profiler.classify_frame(solver.__file__, "solve") is None

    from kubernetes_tpu_torch.perf import synth
    eng, pods = synth.make_rig(32, 256, device="cpu")
    done = threading.Event()
    seen: list[str] = []

    def drain():
        try:
            while not done.is_set():
                list(eng.schedule_batch_stream(pods, chunk_size=64))
        finally:
            done.set()

    t = threading.Thread(target=drain, name="drain", daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and "solve_host" not in seen:
            frame = sys._current_frames().get(t.ident)
            if frame is not None:
                seen.append(profiler.classify_stack(frame))
            time.sleep(0.005)
    finally:
        done.set()
        t.join(60)
    assert "solve_host" in seen


def test_classify_frame_function_gated_rules():
    cf = profiler.classify_frame
    assert cf(f"{PORT}/client/http.py", "_pump") == "watch_decode"
    assert cf(f"{PORT}/client/http.py", "request") is None
    assert cf(f"{PORT}/apiserver/server.py", "_send_json") == "serialize"
    assert cf("/usr/lib/python3.11/json/__init__.py", "dumps") == \
        "serialize"
    assert cf("/usr/lib/python3.11/json/__init__.py", "loads") is None
    assert cf("/home/x/app.py", "main") is None
    pl = f"{PORT}/scheduler/pipeline.py"
    assert cf(pl, "_solve_stream") == "solve_host"
    assert cf(pl, "_commit_chunk") == "commit_bind"
    assert cf(pl, "drain") is None
    sc = f"{PORT}/scheduler/scheduler.py"
    assert cf(sc, "_bind_assumed_batch_inner") == "commit_bind"
    assert cf(sc, "_assume_and_bind_batch") == "commit_bind"
    assert cf(sc, "run") is None
    assert cf(f"{PORT}/scheduler/events.py", "eventf_many") == \
        "commit_bind"
    assert cf(f"{PORT}/scheduler/flightrecorder.py", "record_batch") == \
        "commit_bind"
    # The event recorder's sink pump (event POSTs at commit time) lives in
    # utils/events.py here and in the JAX package alike.
    assert cf(f"{PORT}/utils/events.py", "pump") == "commit_bind"


def test_the_bind_list_pool_is_commit_bind():
    """The binder's POST path of the port's client/http.py (its bind-list
    pool's chunk functions) is commit_bind; the shared request helpers
    walk outward; the JAX package's own file path stays outside the
    port's rules, and the JAX rules leave the chunks in other."""
    cf = profiler.classify_frame
    http = f"{PORT}/client/http.py"
    for fn in ("bind_list", "one_chunk", "_bind_list_chunk"):
        assert cf(http, fn) == "commit_bind", fn
        assert cf("/r/kubernetes_tpu/client/http.py", fn) is None
        assert ref_profiler.classify_frame(
            "/r/kubernetes_tpu/client/http.py", fn) is None
    assert cf(http, "_send_once") is None and cf(http, "_request") is None
    assert cf(http, "_pump") == "watch_decode"


def test_thread_role_rules():
    ct = profiler.classify_thread
    assert ct("chunk-commit_0") == "commit_bind"
    assert ct("bind-list_3") == "commit_bind"
    assert ct("bind-batch") == "commit_bind"
    for name in ("scheduler-loop", "MainThread", "reflector-pods",
                 "scheduler-status-http", "Thread-7 (create)"):
        assert ct(name) is None, name


def _idle_loop(stop: threading.Event) -> None:
    """A pool worker's shape: its own frames name no component."""
    x = 0
    while not stop.is_set():
        x += 1


@pytest.mark.parametrize("name,component", [
    ("chunk-commit_0", "commit_bind"), ("bind-list_1", "commit_bind"),
    ("bind-batch", "commit_bind"), ("some-pool_0", "other")])
def test_a_role_thread_cpu_lands_in_its_component(name, component):
    stop = threading.Event()
    t = threading.Thread(target=_idle_loop, args=(stop,), name=name,
                         daemon=True)
    t.start()
    p = profiler.Profiler()
    try:
        p.sample_once()
        deadline = time.time() + 10.0
        while time.time() < deadline:
            time.sleep(0.05)
            p.sample_once()
            if p.snapshot()["cpu_seconds"][component] > 0.02:
                break
    finally:
        stop.set()
        t.join()
    cpu = p.snapshot()["cpu_seconds"]
    assert cpu[component] > 0.02, cpu


def test_the_classifier_equals_the_reference_on_mapped_paths():
    """Every rule of the JAX package, on its own path and the port's
    counterpart path, gives the same component."""
    cases = [(f"/r/kubernetes_tpu/{sub}", fn) for sub, fn in (
        ("engine/solver.py", "solve"), ("ops/x.py", "f"),
        ("parallel/mesh.py", "f"), ("features/batch.py", "f"),
        ("client/reflector.py", "f"), ("client/http.py", "_pump"),
        ("client/http.py", "list"), ("apiserver/server.py", "_send_raw"),
        ("apiserver/server.py", "handle"), ("scheduler/binder.py", "b"),
        ("scheduler/pipeline.py", "_dispatch"),
        ("scheduler/scheduler.py", "_bind_assumed"),
        ("scheduler/queue.py", "pop"), ("utils/trace.py", "f"))]
    for path, fn in cases:
        port_path = path.replace("/kubernetes_tpu/",
                                 "/kubernetes_tpu_torch/")
        assert profiler.classify_frame(port_path, fn) == \
            ref_profiler.classify_frame(path, fn), (path, fn)


def test_frame_names_strip_to_the_package():
    class Code:
        co_filename = "/x/y/repo/kubernetes_tpu_torch/engine/scan.py"
        co_name = "scan_chunk"
    assert profiler._frame_name(Code) == \
        "kubernetes_tpu_torch/engine/scan.py:scan_chunk"


def test_classify_stack_walks_outward_and_defaults_to_other():
    def leaf():
        return profiler.classify_stack(
            sys._current_frames()[threading.get_ident()])

    assert leaf() == "other"
    assert profiler.classify_stack(None) == "other"


def test_thread_label_suffix_collapses_and_caps():
    p = profiler.Profiler()
    p._note_thread_locked("bind-worker-17", 0.5)
    p._note_thread_locked("bind-worker-3", 0.25)
    assert p._thread_cpu == {"bind-worker": 0.75}
    for i in range(profiler._MAX_THREAD_LABELS + 10):
        p._note_thread_locked(f"role{i}x", 0.01)
    assert len(p._thread_cpu) <= profiler._MAX_THREAD_LABELS + 1
    assert "other" in p._thread_cpu


def test_stack_ring_bounds_and_truncation_bucket():
    p = profiler.Profiler()
    p.ring = 16
    for i in range(40):
        p._note_stack_locked(f"a.py:f{i}", 0.001)
    assert len(p._stacks) <= 16
    assert p._stacks_truncated > 0
    assert "(ring-truncated)" in p.collapsed()


# -- sampling + render surfaces ----------------------------------------------

def _burn(stop: threading.Event) -> None:
    x = 0
    while not stop.is_set():
        x += 1


def test_sampler_attributes_busy_thread_cpu_and_renders():
    stop = threading.Event()
    t = threading.Thread(target=_burn, args=(stop,), name="burner-7",
                         daemon=True)
    t.start()
    p = profiler.Profiler()
    try:
        p.sample_once()
        deadline = time.time() + 5.0
        while time.time() < deadline:
            time.sleep(0.05)
            p.sample_once()
            if sum(p.snapshot()["cpu_seconds"].values()) > 0.05:
                break
    finally:
        stop.set()
        t.join()
    snap = p.snapshot()
    assert snap["samples"] >= 2
    assert snap["threads"].get("burner", 0) > 0
    assert sum(snap["cpu_seconds"].values()) > 0
    assert snap["unclassified_fraction"] > 0
    lines = [ln for ln in p.collapsed().strip().splitlines() if ln]
    assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
    doc = p.speedscope()
    assert doc["$schema"].startswith("https://www.speedscope.app/")
    prof = doc["profiles"][0]
    assert prof["type"] == "sampled"
    assert len(prof["samples"]) == len(prof["weights"])
    assert all(isinstance(s, list) and s for s in prof["samples"])
    nframes = len(doc["shared"]["frames"])
    assert all(i < nframes for s in prof["samples"] for i in s)
    json.loads(json.dumps(doc))


def test_render_formats_and_disabled_path(monkeypatch):
    body, ctype = profiler.render()
    assert ctype == "application/json"
    doc = json.loads(body)
    assert doc["profiles"][0]["unit"] == "seconds"
    body, ctype = profiler.render("format=collapsed")
    assert ctype == "text/plain"
    body2, ctype2 = profiler.render({"format": ["collapsed"]})
    assert ctype2 == "text/plain"
    monkeypatch.setattr(profiler, "_ENABLED", False)
    assert profiler.render() is None
    assert profiler.ensure_started() is None


def test_render_matches_the_reference_document_shape():
    port_doc = json.loads(profiler.render()[0])
    ref_doc = json.loads(ref_profiler.render()[0])
    assert set(port_doc) == set(ref_doc)
    assert set(port_doc["profiles"][0]) == set(ref_doc["profiles"][0])
    assert port_doc["exporter"] == ref_doc["exporter"]


# -- governors (counts, not wall-clock shares) -------------------------------

def test_disabled_path_starts_nothing(monkeypatch):
    """KT_PROF=0: the public entry points return None and no sampler
    thread, ring or sample comes to exist."""
    monkeypatch.setattr(profiler, "_ENABLED", False)
    monkeypatch.setattr(profiler, "_CELL", [])
    threads0 = {t.name for t in threading.enumerate()}
    for _ in range(10_000):
        assert profiler.enabled() is False
        assert profiler.ensure_started() is None
    assert profiler._CELL == [] and profiler.get() is None
    assert {t.name for t in threading.enumerate()} - threads0 == set()


def test_sampler_self_cost_is_measured_and_exported():
    """The sampler's own CPU (time.thread_time across ticks) is recorded
    per tick and exported as the kt-prof-sampler thread row."""
    from kubernetes_tpu_torch.utils import metrics as m
    p = profiler.Profiler()
    ticks = 20
    for _ in range(ticks):
        c0 = time.thread_time()
        p.sample_once()
        p._self_cpu += time.thread_time() - c0
    snap = p.snapshot()
    assert snap["samples"] == ticks
    assert snap["sampler_self_cpu_s"] == round(p._self_cpu, 6)
    p.sample_once()
    assert m.PROCESS_THREAD_CPU.labels(
        thread="kt-prof-sampler").value >= p._self_cpu - 1e-9


def test_sampler_paces_itself_to_budget():
    p = profiler.Profiler()
    assert p._next_delay(0.0) == 1.0 / p.hz
    assert p._next_delay(0.017) >= 0.017 / profiler._SELF_BUDGET
    assert p._next_delay(999.0) == profiler._MAX_INTERVAL


def test_thread_cpu_clock_agrees_with_proc():
    """The port reads each thread's CPU clock where the JAX package reads
    /proc/self/task/<tid>/stat: the two agree on a busy thread (to the
    stat file's clock-tick resolution plus the time between the reads)."""
    reader = profiler._ProcReader()
    if not reader.clock or not os.path.isdir("/proc/self/task"):
        pytest.skip("needs Linux thread CPU clocks and /proc")
    stop = threading.Event()
    t = threading.Thread(target=_burn, args=(stop,), daemon=True)
    t.start()
    try:
        time.sleep(0.3)
        via_clock = reader.cpu_seconds(t.native_id)
        raw = open(f"/proc/self/task/{t.native_id}/stat", "rb").read()
        fields = raw[raw.rindex(b")") + 2:].split()
        via_proc = (int(fields[11]) + int(fields[12])) / reader._tick
    finally:
        stop.set()
        t.join()
    assert via_clock > 0.0
    assert abs(via_clock - via_proc) < 0.1
    assert reader.cpu_seconds(threading.get_native_id()) == \
        pytest.approx(time.thread_time(), abs=0.05)


def test_proc_reads_capped_by_thread_count(monkeypatch):
    p = profiler.Profiler()
    calls = []
    monkeypatch.setattr(p._proc, "cpu_seconds",
                        lambda nid: calls.append(nid) or 0.0)
    monkeypatch.setattr(profiler, "_PROC_THREAD_CAP", 0)
    p.sample_once()
    assert calls == []
    assert p.snapshot()["samples"] == 1
    monkeypatch.setattr(profiler, "_PROC_THREAD_CAP", 10_000)
    if p._proc.available:
        p.sample_once()
        assert calls


def test_wire_accounting_counts_every_flush():
    """The per-chunk wire accounting (two clock reads, two cached-child
    increments) over 10k flushes: the event counter advances by exactly
    10k and the seconds counter by the sum of the measured spans."""
    from kubernetes_tpu_torch.utils.metrics import (WATCH_DECODE_EVENTS,
                                                    WATCH_DECODE_SECONDS)
    m_s = WATCH_DECODE_SECONDS.labels(kind="overhead-test")
    m_n = WATCH_DECODE_EVENTS.labels(kind="overhead-test")
    n0, s0 = m_n.value, m_s.value
    perf_ns = time.perf_counter_ns
    total = 0.0
    for _ in range(10_000):
        t_chunk = perf_ns()
        d = (perf_ns() - t_chunk) / 1e9
        total += d
        m_s.inc(d)
        m_n.inc(1)
    assert m_n.value - n0 == 10_000
    assert abs((m_s.value - s0) - total) < 1e-6


def test_density_smoke_profiles_without_builds():
    """The sampler live during a density run on the CPU: zero kernel
    builds after the warm-up, and an enabled profile section whose
    component split uses the reference's component names."""
    from kubernetes_tpu_torch.perf.harness import density
    r = density(20, 100, quiet=True, device="cpu")
    assert r.device["post_prewarm_compiles"] == 0
    assert r.profile is not None
    assert r.profile["enabled"] is True
    assert r.profile["samples"] >= 1
    assert set(r.profile.get("cpu_fraction", {})) <= \
        set(profiler.COMPONENTS)
    assert profiler.COMPONENTS == ref_profiler.COMPONENTS


def test_wire_profile_classifies_folded_stacks_with_their_threads():
    """perf/wire_profile.py reads the profiler's rules on folded stacks
    whose first name is the thread: a pool thread's idle loop is its
    role's component, the harness's poll loop stays other."""
    from kubernetes_tpu_torch.perf import wire_profile as wp
    pool = ("[chunk-commit];lib/python3.12/threading.py:run;"
            "lib/python3.12/concurrent/futures/thread.py:_worker")
    main = "[MainThread];kubernetes_tpu_torch/perf/harness.py:density_wire"
    bind = ("[bind-list];kubernetes_tpu_torch/client/http.py:one_chunk;"
            "kubernetes_tpu_torch/client/http.py:_send_once")
    assert wp.classify_folded(pool) == "commit_bind"
    assert wp.classify_folded(bind) == "commit_bind"
    assert wp.classify_folded(main) == "other"
    rec = wp.other_frames({pool: 0.5, main: 1.0, bind: 0.25})
    assert rec["other_cpu_s"] == 1.0 and rec["all_cpu_s"] == 1.75
    assert rec["by_leaf"] == [{
        "frame": "kubernetes_tpu_torch/perf/harness.py:density_wire",
        "thread": "MainThread", "cpu_s": 1.0,
        "share_of_all": round(1.0 / 1.75, 6)}]

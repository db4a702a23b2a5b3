"""The port's device-trace hook (``kubernetes_tpu_torch/utils/profiling.py``)
on ``torch.profiler``, on the CPU.

``device_trace`` writes one Chrome trace per traced solve under a CPU
profiler, named by label and a counter, with the label's
``record_function`` range in it; the three solve sites of
``GenericScheduler`` (sequential, joint, stream chunk) each write theirs.
Overlapping traced solves in two threads are serialised (never nested,
never untraced), a nested solve in one thread joins the open session, a
session opened by someone else makes it raise, and the no-op path writes
nothing.  ``thread_stacks`` is the /debug/pprof thread dump, the JAX
package's text format.  The bench's ``--profile-dir`` arms the hook."""

from __future__ import annotations

import json
import threading
import time

import pytest
import torch

from kubernetes_tpu_torch.utils import profiling


@pytest.fixture
def trace_dir(tmp_path):
    profiling.set_profile_dir(str(tmp_path))
    try:
        yield tmp_path
    finally:
        profiling.set_profile_dir("")


def _events(path) -> list[dict]:
    return json.loads(path.read_text())["traceEvents"]


def _labels(path) -> set:
    return {e.get("name") for e in _events(path)}


def test_noop_path_writes_nothing(tmp_path):
    profiling.set_profile_dir("")
    before = profiling.stats()
    for _ in range(1000):
        with profiling.device_trace("solve"):
            pass
    assert profiling.stats() == before
    assert list(tmp_path.iterdir()) == []


def test_a_trace_per_solve_with_its_label(trace_dir):
    before = profiling.stats()["traces"]
    for _ in range(2):
        with profiling.device_trace("solve/odd label"):
            torch.ones(64).cumsum(0)
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 2 and files[0] != files[1]
    assert all(f.name.startswith("solve_odd_label-") for f in files)
    assert all("solve/odd label" in _labels(f) for f in files)
    assert profiling.stats()["traces"] - before == 2


def test_the_three_solve_sites_write_their_traces(trace_dir):
    from kubernetes_tpu_torch.perf import synth
    eng, pods = synth.make_rig(16, 40, device="cpu")
    eng.schedule_batch(pods[:20])
    list(eng.schedule_batch_stream(pods, chunk_size=16))
    eng.schedule_batch(pods[:8], joint=True)
    names = sorted(f.name.split("-")[0]
                   for f in trace_dir.glob("*.pt.trace.json"))
    assert names == ["solve_joint", "solve_sequential",
                     "solve_stream_chunk", "solve_stream_chunk",
                     "solve_stream_chunk"]
    for f in trace_dir.glob("*.pt.trace.json"):
        assert f.name.split("-")[0] in _labels(f)


def test_overlapping_solves_are_serialised(trace_dir):
    """Two threads enter ``device_trace`` at once: the second waits for
    the first's session to end, then traces its own solve."""
    spans: dict[str, tuple[float, float]] = {}
    entered = threading.Event()
    before = profiling.stats()

    def solve(label: str, hold: float) -> None:
        with profiling.device_trace(label):
            t0 = time.perf_counter()
            entered.set()
            time.sleep(hold)
            torch.ones(16).sum()
            spans[label] = (t0, time.perf_counter())

    first = threading.Thread(target=solve, args=("first", 0.3))
    first.start()
    assert entered.wait(30)
    second = threading.Thread(target=solve, args=("second", 0.0))
    second.start()
    first.join(60)
    second.join(60)
    after = profiling.stats()
    assert after["traces"] - before["traces"] == 2
    assert after["waited"] - before["waited"] == 1
    assert spans["second"][0] >= spans["first"][1]
    by_label = {f.name.split("-")[0]: f
                for f in trace_dir.glob("*.pt.trace.json")}
    assert set(by_label) == {"first", "second"}
    assert "second" not in _labels(by_label["first"])


def test_a_nested_solve_joins_the_open_session(trace_dir):
    before = profiling.stats()
    with profiling.device_trace("outer"):
        with profiling.device_trace("inner"):
            torch.ones(8).sum()
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert {"outer", "inner"} <= _labels(files[0])
    assert profiling.stats()["nested"] - before["nested"] == 1


def test_a_foreign_session_makes_it_raise(trace_dir):
    ran = []
    with torch.profiler.profile():
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.device_trace("solve"):
                ran.append(1)
    assert ran == []
    # The lock was released: the next traced solve runs.
    with profiling.device_trace("after"):
        pass
    assert [f.name.split("-")[0]
            for f in trace_dir.glob("*.pt.trace.json")] == ["after"]


def test_thread_stacks_lists_live_threads_as_the_reference_does():
    from kubernetes_tpu.utils import profiling as ref_profiling
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="parked-worker",
                         daemon=True)
    t.start()
    try:
        text = profiling.thread_stacks()
        ref = ref_profiling.thread_stacks()
    finally:
        stop.set()
        t.join()
    assert "thread parked-worker (daemon=True, alive=True):" in text
    assert "thread MainThread" in text

    def heads(s):
        return sorted(ln for ln in s.splitlines() if ln.startswith("thread "))
    assert heads(text) == heads(ref)


def test_the_bench_flag_arms_the_profile_dir(tmp_path, monkeypatch):
    from kubernetes_tpu_torch.perf import bench
    opts = bench.build_parser().parse_args(["--profile-dir", str(tmp_path)])
    assert opts.profile_dir == str(tmp_path)
    profiling.set_profile_dir(opts.profile_dir)
    try:
        assert profiling._PROFILE_DIR[0] == str(tmp_path)
    finally:
        profiling.set_profile_dir("")
    monkeypatch.setenv("KT_PROFILE_DIR", str(tmp_path))
    from kubernetes_tpu_torch.utils import knobs
    assert knobs.get("KT_PROFILE_DIR") == str(tmp_path)

"""The PyTorch port's device guard (``kubernetes_tpu_torch.engine.guard``)
on the CPU.

Pins the CUDA fault taxonomy (``torch.cuda.OutOfMemoryError`` and the
CUDA error texts, built here without a card), the chaos injector's
cadences, the recovery ladder — OOM evicts and bisects onto pre-warmed
ladder buckets only; repeated or ``lost`` faults open the breaker and
surface, so the batch requeues and no mode ever reads ``host`` — the
post-solve sanity gate, and the same policy decisions as the JAX guard
wherever the JAX guard takes no host rung."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from helpers import make_node, make_pod
from kubernetes_tpu.chaos import device as r_chaos
from kubernetes_tpu.engine import guard as r_guard
from kubernetes_tpu_torch.chaos import device as chaos_device
from kubernetes_tpu_torch.chaos.device import (DeviceChaos, DeviceRule,
                                               SimulatedDeviceError,
                                               parse_spec)
from kubernetes_tpu_torch.engine import devicestats
from kubernetes_tpu_torch.engine import guard as guard_mod
from kubernetes_tpu_torch.engine.generic_scheduler import GenericScheduler
from kubernetes_tpu_torch.engine.guard import (DeviceFault, DeviceGuard,
                                               classify)
from kubernetes_tpu_torch.scheduler.backoff import PodBackoff
from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                      SchedulerConfig)
from kubernetes_tpu_torch.utils import metrics
from torch_parity import to_port


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos_device._reset_for_tests()
    r_chaos._reset_for_tests()
    yield
    chaos_device._reset_for_tests()
    r_chaos._reset_for_tests()


def _rig(n_nodes: int = 12, milli_cpu: int = 4000, floor: int = 4,
         chunk: int = 8):
    algo = GenericScheduler(device="cpu")
    for i in range(n_nodes):
        algo.cache.add_node(to_port(make_node(f"gn{i}",
                                              milli_cpu=milli_cpu)))
    daemon = Scheduler(SchedulerConfig(algorithm=algo,
                                       binder=InMemoryBinder(),
                                       async_bind=False))
    daemon.STREAM_THRESHOLD = chunk
    daemon.stream_chunk = chunk
    daemon.stream_min_bucket = floor
    daemon.backoff = PodBackoff(default_duration=0.01, max_duration=0.05)
    modes: list[str] = []
    real = algo.guard.solve_mode

    def spy():
        mode = real()
        modes.append(mode)
        return mode
    algo.guard.solve_mode = spy
    daemon.modes = modes
    return daemon


def _drain_all(daemon, n: int, prefix: str, seconds: float = 20.0) -> None:
    """Enqueue n pods and drain (re-draining backoff requeues) until every
    one is bound; fails at the deadline."""
    before = daemon.config.binder.count()
    for i in range(n):
        daemon.enqueue(to_port(make_pod(f"{prefix}{i}", cpu="50m")))
    deadline = time.monotonic() + seconds
    while daemon.config.binder.count() - before < n:
        if time.monotonic() > deadline:
            pytest.fail(f"only {daemon.config.binder.count() - before}/{n} "
                        f"pods bound within {seconds} s")
        daemon.schedule_pending(wait_first=False, timeout=0.02)
        daemon.wait_for_binds()
        time.sleep(0.01)


def _faults() -> dict:
    return {k[0]: v.value for k, v in metrics.DEVICE_FAULTS.children().items()}


# -- classification -----------------------------------------------------------

OOM_TEXT = ("CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a "
            "total capacity of 79.19 GiB of which 3.12 GiB is free.")

CASES = {
    "torch_oom": (lambda: torch.cuda.OutOfMemoryError(OOM_TEXT), "oom"),
    "oom_text": (lambda: RuntimeError("CUDA error: out of memory"), "oom"),
    "illegal_address": (lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"), "lost"),
    "device_assert": (lambda: RuntimeError(
        "CUDA error: device-side assert triggered"), "lost"),
    "launch_failure": (lambda: RuntimeError(
        "CUDA error: unspecified launch failure"), "lost"),
    "scan_wrapper": (lambda: RuntimeError(
        "scan_chunk: kernel launch failed (cudaError 700)"), "lost"),
    "select_wrapper": (lambda: RuntimeError(
        "select_rows: kernel launch failed (cudaError 719)"), "lost"),
    "nvcc": (lambda: RuntimeError(
        "nvcc failed (1): nvcc -gencode arch=compute_90a,code=sm_90a ..."),
        "compile"),
    "accelerator_error": (
        lambda: getattr(torch, "AcceleratorError", RuntimeError)(
            "CUDA error: misaligned address"), "lost"),
    "simulated_oom": (lambda: SimulatedDeviceError(
        chaos_device._MESSAGES["oom"]), "oom"),
    "simulated_compile": (lambda: SimulatedDeviceError(
        chaos_device._MESSAGES["compile"]), "compile"),
    "simulated_lost": (lambda: SimulatedDeviceError(
        chaos_device._MESSAGES["lost"]), "lost"),
    "simulated_unknown": (lambda: SimulatedDeviceError("gremlins"), "lost"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_faults_classify(case):
    make, want = CASES[case]
    assert classify(make()) == want


@pytest.mark.parametrize("exc", [
    ValueError("CUDA error: an illegal memory access"),
    RuntimeError("some python bug"),
    KeyError("x"),
    ZeroDivisionError("division by zero"),
])
def test_non_device_exceptions_pass_through(exc):
    assert classify(exc) is None


def test_device_fault_keeps_its_kind():
    assert classify(DeviceFault("oom", "stream", RuntimeError("x"))) == "oom"
    assert classify(guard_mod.ScoreGateError()) == "corrupt"


def test_watch_reraises_classified_as_device_fault():
    g = DeviceGuard()
    with pytest.raises(DeviceFault) as ei:
        with g.watch("oneshot"):
            raise torch.cuda.OutOfMemoryError(OOM_TEXT)
    assert ei.value.kind == "oom" and ei.value.path == "oneshot"


def test_watch_leaves_real_bugs_alone():
    g = DeviceGuard()
    with pytest.raises(ZeroDivisionError):
        with g.watch("oneshot"):
            1 / 0


# -- the chaos injector -------------------------------------------------------


class TestDeviceChaos:
    def test_parse_spec(self):
        rules = parse_spec("oom@7,lost@50:1,corrupt@9/stream")
        assert [(r.fault, r.every_nth, r.count, r.path) for r in rules] \
            == [("oom", 7, -1, ""), ("lost", 50, 1, ""),
                ("corrupt", 9, -1, "stream")]

    def test_every_nth_cadence_is_deterministic(self):
        chaos = DeviceChaos([DeviceRule(fault="oom", every_nth=3)])
        fired = []
        for _ in range(9):
            try:
                chaos.maybe_fail("stream")
                fired.append(False)
            except SimulatedDeviceError:
                fired.append(True)
        assert fired == [False, False, True] * 3

    def test_count_bounds_fires(self):
        chaos = DeviceChaos([DeviceRule(fault="lost", every_nth=1,
                                        count=2)])
        hits = 0
        for _ in range(5):
            try:
                chaos.maybe_fail("oneshot")
            except SimulatedDeviceError:
                hits += 1
        assert hits == 2

    def test_path_filter(self):
        chaos = DeviceChaos([DeviceRule(fault="oom", every_nth=1,
                                        path="stream")])
        chaos.maybe_fail("oneshot")
        with pytest.raises(SimulatedDeviceError):
            chaos.maybe_fail("stream")

    def test_corrupt_poisons_readback(self):
        chaos = DeviceChaos([DeviceRule(fault="corrupt", every_nth=1)])
        bad = chaos.maybe_corrupt("stream", np.arange(8, dtype=np.int32))
        assert bad.dtype.kind == "f" and np.isnan(bad).any()
        assert (bad[np.isfinite(bad)] >= 2 ** 30).any()

    def test_corrupt_and_launch_cadences_are_separate(self):
        chaos = DeviceChaos([DeviceRule(fault="corrupt", every_nth=1),
                             DeviceRule(fault="oom", every_nth=2)])
        chaos.maybe_fail("s")
        assert np.isnan(chaos.maybe_corrupt("s", np.zeros(2, np.int32))).any()

    def test_env_spec_installs_lazily(self, monkeypatch):
        monkeypatch.setenv("KT_CHAOS_DEVICE", "oom@2:1/stream")
        chaos = chaos_device.active()
        assert [(r["fault"], r["every_nth"], r["count"], r["path"])
                for r in chaos.stats()["rules"]] == [("oom", 2, 1, "stream")]


# -- guard policy -------------------------------------------------------------


def _guard(ladder):
    g = DeviceGuard()
    g.ladder_fn = lambda: ladder
    g._evictions = []
    g.evict_fn = lambda: g._evictions.append(1)
    return g


class TestGuardPolicy:
    def test_oom_evicts_and_walks_the_ladder_down(self):
        g = _guard([4, 8, 16])
        f = DeviceFault("oom", "stream")
        assert g.recover(f) == guard_mod.ACT_BISECT
        assert g.bucket_cap() == 8 and g._evictions == [1]
        assert g.recover(f) == guard_mod.ACT_BISECT
        assert g.bucket_cap() == 4
        g.breaker_threshold = 99
        assert g.recover(f) == guard_mod.ACT_RETRY
        assert g.bucket_cap() == 4

    def test_repeated_faults_open_the_breaker_and_surface(self):
        g = _guard([4, 8])
        g.breaker_threshold = 3
        f = DeviceFault("compile", "stream")
        assert g.recover(f) == guard_mod.ACT_RETRY
        assert g.recover(f) == guard_mod.ACT_RETRY
        assert g.recover(f) == guard_mod.ACT_SURFACE
        assert g.mode == "open"
        assert g.report()["breakerOpen"]

    def test_device_lost_opens_immediately(self):
        g = _guard([4])
        assert g.recover(DeviceFault("lost", "oneshot")) == \
            guard_mod.ACT_SURFACE
        assert g.mode == "open"

    def test_open_breaker_surfaces_until_a_probe_closes_it(self):
        g = _guard([4])
        g.probe_period_s = 1e9
        g.recover(DeviceFault("lost", "stream"))
        assert g.solve_mode() == "open"
        fault = g.breaker_fault()
        assert fault.kind == "lost" and fault.path == "breaker"
        g._last_probe = -1e9
        assert g.solve_mode() == "probe"
        g.note_success(probe=True)
        assert g.mode == "device" and g.solve_mode() == "device"

    def test_failed_probe_stays_open(self):
        g = _guard([4])
        g.probe_period_s = 1e9
        g.recover(DeviceFault("lost", "stream"))
        g._last_probe = -1e9
        assert g.solve_mode() == "probe"
        assert g.recover(DeviceFault("oom", "stream")) == \
            guard_mod.ACT_SURFACE
        assert g.solve_mode() == "open"

    def test_bucket_cap_lifts_after_healthy_streak(self):
        g = _guard([4, 8])
        g.cap_reset_streak = 2
        g.recover(DeviceFault("oom", "stream"))
        assert g.bucket_cap() == 4
        g.note_success()
        assert g.bucket_cap() == 4
        g.note_success()
        assert g.bucket_cap() is None

    def test_disabled_guard_passes_everything_through(self, monkeypatch):
        monkeypatch.setenv("KT_GUARD", "0")
        g = DeviceGuard()
        assert not g.enabled
        chaos_device.install(DeviceChaos([DeviceRule(fault="oom",
                                                     every_nth=1)]))
        with g.watch("stream"):
            pass

    def test_watermark_caps_buckets_at_the_floor(self, monkeypatch):
        g = _guard([4, 8, 16])
        g.hbm_watermark = 1
        monkeypatch.setattr(devicestats, "hbm_live_bytes", lambda: 10)
        trips = metrics.HBM_WATERMARK_TRIPS.value
        assert g.bucket_cap() == 4 and g._evictions == [1]
        assert g.bucket_cap() == 4
        assert metrics.HBM_WATERMARK_TRIPS.value == trips + 1
        monkeypatch.setattr(devicestats, "hbm_live_bytes", lambda: 0)
        assert g.bucket_cap() is None

    def test_device_memory_reads_zero_on_a_cpu_device(self):
        GenericScheduler(device="cpu")
        assert devicestats.hbm_live_bytes() == 0
        assert devicestats.hbm_peak_bytes() == 0


# The same fault sequence through both guards: identical actions, with the
# reference's host rung read as the port's surfacing.
SEQUENCES = {
    "oom_ladder": ["oom", "oom", "oom"],
    "compile_threshold": ["compile", "compile", "compile", "compile"],
    "mixed": ["oom", "corrupt", "compile", "oom", "corrupt"],
    "lost_first": ["lost", "oom"],
    "corrupt_run": ["corrupt", "corrupt", "oom", "corrupt"],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_recover_decisions_match_the_reference_guard(seq):
    ladder = [4, 8, 16, 32]
    ref = r_guard.DeviceGuard(ladder_fn=lambda: ladder,
                              evict_fn=lambda: None)
    port = DeviceGuard(ladder_fn=lambda: ladder, evict_fn=lambda: None)
    ref.probe_period_s = port.probe_period_s = 1e9
    for kind in SEQUENCES[seq]:
        want = ref.recover(r_guard.DeviceFault(kind, "stream"))
        got = port.recover(DeviceFault(kind, "stream"))
        assert got == (guard_mod.ACT_SURFACE if want == r_guard.ACT_HOST
                       else want), kind
        assert port.bucket_cap() == ref.bucket_cap()
        assert (port.mode == "open") == (ref.mode == "host")


# -- the post-solve sanity gate -----------------------------------------------


class TestSanityGate:
    def test_nan_rejected(self):
        with pytest.raises(DeviceFault) as ei:
            _guard([4]).checked_readback("stream",
                                         np.array([0.0, np.nan, 1.0]), 4)
        assert ei.value.kind == "corrupt"

    def test_out_of_range_rejected(self):
        g = _guard([4])
        with pytest.raises(DeviceFault):
            g.checked_readback("stream", np.array([0, 7], np.int32), 4)
        with pytest.raises(DeviceFault):
            g.checked_readback("stream", np.array([0, -3], np.int32), 4)

    def test_dead_row_placement_rejected(self):
        g = _guard([4])
        live = np.array([True, False])
        with pytest.raises(DeviceFault):
            g.checked_readback("stream", np.array([0, 2], np.int32), 4,
                               live=live)
        assert g.checked_readback("stream", np.array([0, -1], np.int32), 4,
                                  live=live).tolist() == [0, -1]

    def test_capacity_spot_check_rejected(self):
        alloc = np.array([[1000, 2 ** 30, 0, 110]], np.int64)
        req = np.array([[4000, 0, 0, 1]], np.int64)
        with pytest.raises(DeviceFault):
            _guard([4]).checked_readback("oneshot",
                                         np.array([0], np.int32), 1,
                                         alloc=alloc, requests=req)

    def test_valid_readback_passes_as_int32(self):
        alloc = np.array([[4000, 2 ** 30, 0, 110]] * 3, np.int64)
        req = np.array([[100, 0, 0, 1]] * 2, np.int64)
        out = _guard([4]).checked_readback(
            "oneshot", np.array([2, -1], np.int64), 3, alloc=alloc,
            requests=req)
        assert out.dtype == np.int32 and out.tolist() == [2, -1]

    def test_rejected_keys_remembered_until_clean_solve(self):
        g = _guard([4])
        keys = ["default/a", "default/b"]
        with pytest.raises(DeviceFault):
            g.checked_readback("stream", np.array([np.nan]), 4,
                               keys_fn=lambda: keys)
        assert g.has_rejections()

        class P:
            def __init__(self, key):
                self.key = key
        before = metrics.GATE_REJECTED_BINDS.value
        clean, refused = g.filter_rejected([(P("default/a"), "n1"),
                                            (P("default/c"), "n2")])
        assert [p.key for p, _ in refused] == ["default/a"]
        assert [p.key for p, _ in clean] == ["default/c"]
        assert metrics.GATE_REJECTED_BINDS.value == before + 1
        g.checked_readback("stream", np.array([0, 1], np.int32), 4,
                           keys_fn=lambda: keys)
        assert not g.has_rejections()

    def test_score_gate_raises_guard_on_or_off(self, monkeypatch):
        with pytest.raises(guard_mod.ScoreGateError):
            _guard([4]).checked_scores("single_pod", False)
        monkeypatch.setenv("KT_GUARD", "0")
        with pytest.raises(guard_mod.ScoreGateError):
            DeviceGuard().checked_scores("single_pod", False)
        DeviceGuard().checked_scores("single_pod", True)


# -- the recovery ladder end to end ------------------------------------------


class TestRecoveryLadder:
    def test_oom_bisects_onto_warmed_buckets_only(self):
        daemon = _rig(floor=4, chunk=8)
        try:
            algo = daemon.config.algorithm
            ladder = set(daemon.effective_ladder())
            assert len(ladder) >= 2
            sizes: list[int] = []
            real = algo.schedule_batch_stream

            def spying(pods, chunk_size=2048, **kw):
                sizes.append(chunk_size)
                return real(pods, chunk_size=chunk_size, **kw)

            algo.schedule_batch_stream = spying
            chaos_device.install(DeviceChaos([DeviceRule(
                fault="oom", every_nth=2, count=2)]))
            _drain_all(daemon, 24, "ob")
            assert sizes and set(sizes) <= ladder, sizes
            assert min(sizes) < max(sizes)
            assert algo.guard.mode == "device"
            assert "host" not in daemon.modes
        finally:
            daemon.stop()

    def test_device_lost_surfaces_requeues_and_a_probe_recovers(self):
        daemon = _rig()
        try:
            algo = daemon.config.algorithm
            algo.guard.probe_period_s = 0.05
            chaos_device.install(DeviceChaos([DeviceRule(
                fault="lost", every_nth=1, count=1)]))
            before = _faults().get("lost", 0)
            _drain_all(daemon, 10, "dl")
            assert _faults().get("lost", 0) == before + 1
            assert "probe" in daemon.modes
            assert set(daemon.modes) <= {"device", "probe", "open"}
            assert algo.guard.mode == "device"
            names = {f"gn{i}" for i in range(12)}
            assert all(n in names
                       for n in daemon.config.binder._bound.values())
        finally:
            daemon.stop()

    def test_permanent_device_loss_binds_nothing_and_drops_nothing(self):
        """With the device dead for good there is nothing to decide on:
        every pod stays queued (or in backoff), none binds, none is
        dropped, and the breaker reads open — never host."""
        daemon = _rig(n_nodes=6)
        try:
            algo = daemon.config.algorithm
            algo.guard.probe_period_s = 0.0
            chaos_device.install(DeviceChaos([DeviceRule(fault="lost",
                                                         every_nth=1)]))
            for i in range(8):
                daemon.enqueue(to_port(make_pod(f"pk{i}", cpu="50m")))
            for _ in range(5):
                daemon.schedule_pending(wait_first=False, timeout=0.02)
                time.sleep(0.06)
            assert daemon.config.binder.count() == 0
            assert algo.guard.mode == "open"
            assert "host" not in daemon.modes
            with daemon._requeue_cv:
                waiting = {p.key for _, _, p in daemon._requeue_heap}
            waiting |= {p.key for p in daemon.queue.pop_all()}
            assert waiting == {f"default/pk{i}" for i in range(8)}
        finally:
            daemon.stop()

    def test_corrupt_readback_requeues_then_converges(self):
        daemon = _rig()
        try:
            algo = daemon.config.algorithm
            rejects = metrics.GATE_REJECTS.value
            chaos_device.install(DeviceChaos([DeviceRule(
                fault="corrupt", every_nth=1, count=1)]))
            _drain_all(daemon, 12, "cr")
            assert metrics.GATE_REJECTS.value > rejects
            assert algo.guard.gate_rejects >= 1
            names = {f"gn{i}" for i in range(12)}
            assert all(n in names
                       for n in daemon.config.binder._bound.values())
        finally:
            daemon.stop()

    def test_single_pod_fault_requeues_the_pod(self):
        daemon = _rig()
        try:
            chaos_device.install(DeviceChaos([DeviceRule(
                fault="compile", every_nth=1, count=1,
                path="single_pod")]))
            before = _faults().get("compile", 0)
            daemon.enqueue(to_port(make_pod("sp0", cpu="50m")))
            assert daemon.schedule_one(timeout=0.1)
            assert daemon.config.binder.count() == 0
            evs = daemon.config.recorder.events("default/sp0")
            assert evs[-1].reason == "SchedulingError"
            assert _faults().get("compile", 0) == before + 1
            deadline = time.monotonic() + 10
            while daemon.config.binder.count() < 1:
                assert time.monotonic() < deadline, "requeue never bound"
                daemon.schedule_one(timeout=0.05)
        finally:
            daemon.stop()

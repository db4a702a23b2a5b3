"""Churn soak at kubemark scale, with chaos on, on the card.

Every bench before this one schedules a single avalanche; a production
fleet sees cluster LIFECYCLE — rolling updates, node drains/failures and
re-adds, scale-up storms, and scheduler restarts mid-drain — and that
sustained-churn regime is exactly where the device-residency
optimizations (dirty-row scatter, ``tensor_epoch``, the overlapped
solve/commit pipeline) can silently drift from apiserver truth.  This
module is the deterministic scenario driver that composes those
lifecycle events against a real rig:

    MemStore -> HTTP apiserver (own thread) -> ChaosProxy -> the full
    scheduler daemon (ConfigFactory over the proxy, its engine on the
    card)

with the composable chaos rules active (bind-409 cadence, watch cuts on
relist, heartbeat drops — chaos/proxy.py helpers), device chaos (an OOM
cadence through the storm, then one device loss), the resident-state
invariant checker running throughout (cache/verifier.py), the bounded
queue's high watermark set low enough that the scale-up storm exercises
degraded draining, and a SIGKILL-style scheduler restart
(``ConfigFactory.abandon``) injected mid-drain and recovered by the
startup reconciler (scheduler/recovery.py).

The record reports settle time, steady-state pods/s, queue-depth/stage
histograms, the invariant-violation count, a post-soak
apiserver-vs-oracle reconciliation (double-binds, stranded pods,
orphaned assumes — all must be 0), and the restarted scheduler's
sampled decision parity vs the pure-Python oracle.  ``violations(rec)``
names every bar a record misses (the JAX package's
``tools/check_bench.py`` bars that need no predecessor); [] passes.

The waves beside it (each its own function, each on its own rig): the
active-active HA wave (three sharded ``python -m
kubernetes_tpu_torch.scheduler`` incarnations, one SIGKILLed
mid-drain), the near-capacity wave (server-side capacity 409s), the
tenancy poison wave, the apiserver-kill wave (a ``python -m
kubernetes_tpu_torch.apiserver --storage-dir`` SIGKILLed
mid-avalanche), the overload wave (APF shedding with a shard-lease
plane) and the defrag wave (a scheduler SIGKILL mid-migration).

Every function takes ``device=`` (``"cuda"`` by default: it raises
without a card before it starts anything; ``device="cpu"`` must be
asked for).

A copy of ``kubernetes_tpu/perf/soak.py`` with its imports pointed at
this package, with two adaptations.  Where the JAX guard decides a
drain's pods on its host engine once its breaker opens, this package's
guard requeues them with backoff until a probe closes the breaker
(``engine/guard.py``).  So the record reads ``requeued_pods`` and
``breaker_open_seconds`` from ``guard.report()`` in place of
``solve_fallbacks`` and ``host_mode_seconds``, and the device-lost wave
reports ``tripped`` (the breaker opened) in place of
``tripped_to_host``; the record's ``differences`` names these fields.
In the tenancy poison wave the tripped tenant's pods are requeued until
its probe re-promotes it (``tenancy/service.py``).  And the overload
wave runs its scheduler and its storm's clients as processes of their
own (``run_overload_wave`` says why).

Run: ``python -m kubernetes_tpu_torch.perf.soak [--device cpu] [--out
build/SOAK_cuda.json]`` (the JAX package's defaults: >= 60 s, 2,000
nodes, the HA wave); it exits non-zero when ``violations`` is not empty.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.chaos import (BindMonitor, ChaosProxy, DeviceChaos,
                                  DeviceRule, bind_conflict_storm,
                                  heartbeat_drop, watch_cut_on_relist)
from kubernetes_tpu_torch.chaos import device as chaos_device
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.scheduler.backoff import PodBackoff
from kubernetes_tpu_torch.utils import knobs, locktrace, metrics

# The renamed fields of the breaker adaptation (module docstring): the
# port's name, the JAX record's name, and why.
DIFFERENCES = [
    {"field": "requeued_pods", "reference": "solve_fallbacks",
     "why": "an open breaker requeues the drain's pods with backoff; "
            "there is no host engine to fall back to"},
    {"field": "breaker_open_seconds", "reference": "host_mode_seconds",
     "why": "seconds with the breaker open (guard.report()'s "
            "breakerOpenSeconds), not seconds on a host engine"},
    {"field": "device_lost_wave.tripped",
     "reference": "device_lost_wave.tripped_to_host",
     "why": "the breaker opened; the wave's pods requeued until a probe "
            "re-promoted the card"},
]


def _labeled_snapshot(counter) -> dict[str, int]:
    """{label: value} for a single-label counter family."""
    return {key[0]: int(child.value)
            for key, child in counter.children().items()}


def _labeled_delta(counter, before: dict[str, int]) -> dict[str, int]:
    now = _labeled_snapshot(counter)
    out = {k: v - before.get(k, 0) for k, v in now.items()}
    return {k: v for k, v in out.items() if v}

# The fleet bench this soak is scaled against (perf/harness.fleet_metrics:
# 500 hollow nodes drive 2,000 replicas to Running once).
FLEET_BENCH_REPLICAS = 2000


def _node_json(name: str, milli_cpu: int = 16000,
               memory: int = 64 * 1024 ** 3, pods: int = 110,
               unschedulable: bool = False) -> dict:
    obj = {"metadata": {"name": name,
                        "labels": {api.HOSTNAME_LABEL: name}},
           "status": {"allocatable": {"cpu": f"{milli_cpu}m",
                                      "memory": str(memory),
                                      "pods": str(pods)},
                      "conditions": [{"type": "Ready", "status": "True"}]}}
    if unschedulable:
        obj["spec"] = {"unschedulable": True}
    return obj


def _is_pending(obj: dict) -> bool:
    """A pod the scheduler still owes a node: unbound and not finished."""
    return not (obj.get("spec") or {}).get("nodeName") and \
        (obj.get("status") or {}).get("phase", "") not in ("Succeeded",
                                                            "Failed")


def _pod_json(name: str, cpu: str = "50m") -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": cpu, "memory": "64Mi"}}}]}}


# The double-bind referee, extracted to chaos/bindmonitor.py so the
# chaos e2e suites share one implementation; the old private name stays
# importable for rigs written against it.
_BindMonitor = BindMonitor


class _QueueSampler:
    """Samples the daemon's queue depth + degraded flag on a fixed
    cadence; the soak's bounded-queue evidence."""

    def __init__(self, period: float = 0.1):
        self.period = period
        self.samples: list[tuple[float, int, bool]] = []
        self._daemon = None
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="soak-queue-sampler")
        self._thread.start()

    def attach(self, daemon) -> None:
        self._daemon = daemon

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            d = self._daemon
            if d is None:
                continue
            self.samples.append((time.monotonic() - self._t0,
                                 len(d.queue), d.queue.degraded()))

    def stop(self) -> None:
        self._stop.set()

    def summary(self, steady_window_s: float = 10.0) -> dict:
        if not self.samples:
            return {"samples": 0, "max_depth": 0, "final_depth": 0,
                    "monotonic_growth": False, "degraded_s": 0.0}
        t_end = self.samples[-1][0]
        depths = [d for _, d, _ in self.samples]
        window = [(t, d) for t, d, _ in self.samples
                  if t >= t_end - steady_window_s]
        slope = 0.0
        if len(window) >= 4:
            ts = np.array([t for t, _ in window])
            ds = np.array([d for _, d in window], dtype=float)
            slope = float(np.polyfit(ts, ds, 1)[0])
        # Monotonic growth = the steady window trends up AND never
        # touches empty — a queue that drains to zero each cycle is
        # bounded no matter how spiky the storms were.
        monotonic = slope > 1.0 and min(d for _, d in window) > 0
        return {"samples": len(self.samples),
                "max_depth": max(depths),
                "final_depth": depths[-1],
                "steady_window_s": steady_window_s,
                "steady_window_slope_pods_per_s": round(slope, 3),
                "monotonic_growth": bool(monotonic),
                "degraded_s": round(sum(
                    1 for _, _, dg in self.samples if dg) *
                    self.period, 2)}


def _device(device) -> str:
    """``device`` resolved before a wave starts anything: raises without
    a card unless the caller asked for the CPU."""
    from kubernetes_tpu_torch.utils import device as device_mod
    return str(device_mod.resolve(device))


def _make_factory(proxy_url: str, stream_chunk: int, hwm: int,
                  device: str = "cuda"):
    """A soak daemon over the proxy: compressed backoff (convergence
    under fault in scenario time), every drain through the pre-warmed
    stream ladder (a soak's arrival races must never mint a compile on
    the clock), and the degradation watermark at the scenario's
    threshold."""
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    factory = ConfigFactory(proxy_url, qps=5000, burst=5000,
                            device=device)
    daemon = factory.daemon
    daemon.backoff = PodBackoff(default_duration=0.1, max_duration=2.0)
    daemon.STREAM_THRESHOLD = stream_chunk
    daemon.stream_chunk = stream_chunk
    daemon.queue.high_watermark = hwm
    return factory


def run_soak(n_nodes: int = 2000, duration_s: float = 60.0,
             seed_pods: int = 4000, storm_pods: int = 8000,
             rolling_waves: int = 4, wave_size: int = 1000,
             drain_nodes: int = 40, kill_burst: int = 3000,
             restart: bool = True, chaos: bool = True,
             device_chaos: bool = True, device_oom_nth: int = 6,
             high_watermark: int = 3000, stream_chunk: int = 4096,
             heartbeat_period: float = 1.0, verify_period: float = 2.0,
             settle_timeout: float = 300.0, parity_samples: int = 50,
             quiet: bool = False, device: str = "cuda") -> dict:
    """Run the composed churn scenario; returns the artifact payload."""
    device = _device(device)
    t_start = time.monotonic()
    store = MemStore()
    from kubernetes_tpu_torch.apiserver.server import serve
    api_srv = serve(store)
    api_url = f"http://127.0.0.1:{api_srv.server_address[1]}"
    proxy = ChaosProxy(api_url).start()
    direct = APIClient(api_url, qps=0)  # driver ops bypass the chaos

    def log(msg: str) -> None:
        if not quiet:
            print(f"soak[{time.monotonic() - t_start:6.1f}s] {msg}",
                  file=sys.stderr)

    violations_before = metrics.CACHE_INVARIANT_VIOLATIONS.value
    degraded_before = metrics.DEGRADED_DRAINS.value
    from kubernetes_tpu_torch.perf.harness import _stage_snapshot, \
        stage_breakdown
    stages_before = _stage_snapshot()

    # -- fleet registration ------------------------------------------------
    node_objs: dict[str, dict] = {}
    for i in range(n_nodes):
        node_objs[f"sn-{i:05d}"] = _node_json(f"sn-{i:05d}")
    for i in range(0, n_nodes, 1000):
        batch = list(node_objs.values())[i:i + 1000]
        direct.create_list("nodes", batch)
    log(f"registered {n_nodes} nodes")

    monitor = _BindMonitor(store)
    sampler = _QueueSampler()
    saved_env = {k: os.environ.get(k)
                 for k in ("KT_PREWARM", "KT_VERIFY_PERIOD",
                           "KT_RECOVERY", "KT_GUARD_PROBE_S",
                           "KT_LOCKTRACE")}
    os.environ["KT_PREWARM"] = "1"
    os.environ["KT_VERIFY_PERIOD"] = str(verify_period)
    os.environ["KT_RECOVERY"] = "1"
    # Every chaos run doubles as a race/deadlock detector: the daemon's
    # graph-tracked locks (cache, tenancy, shards, SLO, rings) are
    # minted traced, and the artifact's locktrace columns are ratcheted
    # to zero by check_soak.
    os.environ["KT_LOCKTRACE"] = "1"
    locktrace.set_enabled(True)
    lock_counts0 = locktrace.report()
    # Fast device probes: the device-lost wave must demonstrate the
    # full breaker arc (breaker open, pods requeued -> probe ->
    # re-promotion) inside the scenario window.
    os.environ["KT_GUARD_PROBE_S"] = "1.0"
    device_chaos = device_chaos and chaos
    dev_faults_before = _labeled_snapshot(metrics.DEVICE_FAULTS)
    # Every incarnation's guard, for the requeued-pod total.
    guards: list = []
    gate_rejects_before = metrics.GATE_REJECTS.value
    rejected_binds_before = metrics.GATE_REJECTED_BINDS.value
    factory = None
    pod_seq = [0]
    created_total = [0]

    def create_pods(n: int, prefix: str, cpu: str = "50m") -> list[str]:
        names = []
        for _ in range(n):
            pod_seq[0] += 1
            names.append(f"{prefix}-{pod_seq[0]:06d}")
        for i in range(0, n, 1000):
            direct.create_list("pods", [_pod_json(nm, cpu=cpu)
                                        for nm in names[i:i + 1000]])
        created_total[0] += n
        return names

    def pending_count() -> int:
        # The store filters before it copies: a poll every 0.25 s that
        # deep-copied all ~20,000 pods held the store's lock (and so the
        # apiserver's binds) for a large share of the run.
        items, _ = store.list("pods", _is_pending)
        return len(items)

    def wait_settled(timeout: float) -> float:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if pending_count() == 0:
                return time.monotonic() - t0
            time.sleep(0.25)
        return -1.0

    # Driver-side heartbeat loop: rotating slices of the fleet PUT their
    # status THROUGH the proxy, so the heartbeat_drop rules bite and the
    # scheduler's node reflector sees a production-shaped update stream
    # feeding the dirty-row scatter path.
    hb_client = APIClient(proxy.base_url, qps=0)
    hb_stop = threading.Event()
    hb_sent = [0]

    def heartbeat_loop() -> None:
        names = sorted(node_objs)
        slice_n = max(len(names) // 10, 1)
        at = 0
        while not hb_stop.wait(heartbeat_period):
            for name in names[at:at + slice_n]:
                obj = node_objs.get(name)
                if obj is None:
                    continue
                obj["status"]["conditions"][0]["lastHeartbeatTime"] = \
                    time.time()
                try:
                    hb_client.update("nodes", obj)
                    hb_sent[0] += 1
                except Exception:  # noqa: BLE001 — drops are the point
                    pass
            at = (at + slice_n) % max(len(names), 1)

    hb_thread = threading.Thread(target=heartbeat_loop, daemon=True,
                                 name="soak-heartbeats")

    report: dict = {
        "harness": "kubernetes_tpu_torch/perf/soak.py (churn soak: "
                   "rolling updates + node drain/fail/re-add + scale-up "
                   "storm + mid-drain scheduler kill, over HTTP through "
                   "the chaos proxy)",
        # Wall-clock rows (settle_s) compare only within one device.
        "backend": device.split(":")[0],
        "scale": {"n_nodes": n_nodes},
        "chaos": {"enabled": chaos},
        "differences": DIFFERENCES,
    }
    try:
        factory = _make_factory(proxy.base_url, stream_chunk,
                                high_watermark, device)
        guards.append(factory.algorithm.guard)
        sampler.attach(factory.daemon)
        factory.run()
        log("scheduler running (prewarmed, verifier on)")

        # Phase 1: seed workload — the initial settle the ratchet pins.
        t0 = time.monotonic()
        create_pods(seed_pods, "seed")
        settle_s = wait_settled(settle_timeout)
        if settle_s < 0:
            raise RuntimeError("seed workload never settled")
        report["settle_s"] = round(settle_s, 2)
        log(f"seeded {seed_pods} pods, settle {settle_s:.1f}s")

        # Chaos on for the whole churn window.
        rules = []
        if chaos:
            rules = (bind_conflict_storm(every_nth=7) +
                     watch_cut_on_relist("pods", every_nth=3, count=8) +
                     heartbeat_drop(every_nth=5))
            proxy.add_rules(rules)
            report["chaos"]["rules"] = [r.to_json() for r in rules]
        hb_thread.start()
        churn_t0 = time.monotonic()
        churn_binds0 = monitor.binds

        # Phase 2: scale-up storm — crosses the high watermark, so the
        # daemon must shed load (largest-bucket drains) instead of
        # building one storm-sized batch.  With device chaos on, the
        # storm doubles as the OOM burst: every Nth device solve throws
        # a CUDA out-of-memory error mid-storm, and the guard must bisect
        # down the pre-warmed ladder (or requeue behind its breaker)
        # while the bind-409 storm rages — without a single dropped pod.
        if device_chaos:
            chaos_device.install(DeviceChaos([DeviceRule(
                fault="oom", every_nth=device_oom_nth)]))
            report["chaos"]["device_oom_every_nth"] = device_oom_nth
            log(f"device chaos ON: OOM every {device_oom_nth}th solve")
        create_pods(storm_pods, "storm")
        log(f"storm of {storm_pods} pods injected "
            f"(watermark {high_watermark})")
        if wait_settled(settle_timeout) < 0:
            raise RuntimeError("storm never settled")
        if device_chaos:
            chaos_device.install(None)
            log("device chaos OFF (OOM burst survived)")

        # Phase 3: rolling updates — delete/recreate in waves.
        items, _ = store.list("pods")
        bound_names = [o["metadata"]["name"] for o in items
                       if (o.get("spec") or {}).get("nodeName")]
        rng = np.random.RandomState(7)
        for w in range(rolling_waves):
            victims = rng.choice(len(bound_names),
                                 size=min(wave_size, len(bound_names)),
                                 replace=False)
            for vi in victims.tolist():
                try:
                    direct.delete("pods", f"default/{bound_names[vi]}")
                except Exception:  # noqa: BLE001 — already rolled
                    pass
            bound_names = [nm for i, nm in enumerate(bound_names)
                           if i not in set(victims.tolist())]
            create_pods(len(victims), f"roll{w}")
            log(f"rolling wave {w + 1}/{rolling_waves} "
                f"({len(victims)} pods)")
        if wait_settled(settle_timeout) < 0:
            raise RuntimeError("rolling updates never settled")

        # Phase 4: node lifecycle — drain (cordon + evict), fail
        # (delete), re-add with DIFFERENT capacity: the same-name/
        # different-shape edge the tensor_epoch protocol must catch.
        drained = sorted(node_objs)[:drain_nodes]
        evicted = 0
        for name in drained:
            node_objs[name] = _node_json(name, unschedulable=True)
            direct.update("nodes", node_objs[name])
        items, _ = store.list("pods")
        for o in items:
            if (o.get("spec") or {}).get("nodeName") in set(drained):
                try:
                    direct.delete(
                        "pods", f"default/{o['metadata']['name']}")
                    evicted += 1
                except Exception:  # noqa: BLE001
                    pass
        create_pods(evicted, "redrain")
        log(f"drained {len(drained)} nodes, rescheduling {evicted} pods")
        for name in drained:
            direct.delete("nodes", name)
            node_objs.pop(name, None)
        time.sleep(1.0)
        for name in drained:  # re-add, twice the capacity
            node_objs[name] = _node_json(name, milli_cpu=32000)
            direct.create("nodes", node_objs[name])
        if wait_settled(settle_timeout) < 0:
            raise RuntimeError("node lifecycle phase never settled")
        report["node_lifecycle"] = {"drained": len(drained),
                                    "evicted_pods": evicted,
                                    "readded_with_new_capacity":
                                        len(drained)}

        # Phase 5: SIGKILL mid-drain + crash-safe restart.
        if restart:
            create_pods(kill_burst, "kill")
            # Kill while the drain is demonstrably mid-flight: backlog
            # present and binds landing.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and \
                    len(factory.daemon.queue) == 0:
                time.sleep(0.01)
            queue_at_kill = len(factory.daemon.queue)
            peak_before_kill = factory.daemon.queue.peak_depth
            factory.abandon()
            log(f"KILLED scheduler mid-drain (queue depth "
                f"{queue_at_kill}, {pending_count()} pending at "
                f"apiserver)")
            time.sleep(0.5)  # zombie binds from the dead pipeline land
            t_re = time.monotonic()
            factory = _make_factory(proxy.base_url, stream_chunk,
                                    high_watermark, device)
            guards.append(factory.algorithm.guard)
            sampler.attach(factory.daemon)
            factory.run()
            resettle_s = wait_settled(settle_timeout)
            if resettle_s < 0:
                raise RuntimeError("post-restart drain never settled")
            report["restart"] = {
                "killed_mid_drain": True,
                "queue_at_kill": queue_at_kill,
                "peak_before_kill": peak_before_kill,
                "recovery": factory.last_recovery,
                "restart_to_settle_s": round(
                    time.monotonic() - t_re, 2),
            }
            log(f"restarted + recovered in "
                f"{time.monotonic() - t_re:.1f}s "
                f"(recovery: {factory.last_recovery})")

        # Phase 5.5: device-lost wave — the breaker arc end to end.
        # One device loss opens the (possibly freshly restarted)
        # scheduler's breaker; the wave's pods requeue with backoff
        # until a probe drain finds the card answering again and closes
        # it, and then the wave must still schedule fully.
        if device_chaos:
            guard = factory.algorithm.guard
            chaos_device.install(DeviceChaos([DeviceRule(
                fault="lost", every_nth=1, count=1)]))
            create_pods(min(wave_size, 500), "devlost")
            if wait_settled(settle_timeout) < 0:
                raise RuntimeError("device-lost wave never settled")
            chaos_device.install(None)
            open_spell_s = guard.report()["breakerOpenSeconds"]
            log(f"device-lost wave settled (mode {guard.mode}, "
                f"{open_spell_s:.1f}s with the breaker open so far)")
            # The device answers again: the next drains probe and
            # re-promote.  Drive small waves until the breaker closes.
            deadline = time.monotonic() + 30
            w_probe = 0
            while guard.mode != "device" and time.monotonic() < deadline:
                create_pods(50, f"probe{w_probe}")
                w_probe += 1
                if wait_settled(settle_timeout) < 0:
                    raise RuntimeError("probe wave never settled")
                time.sleep(0.3)
            report["device_lost_wave"] = {
                "tripped": open_spell_s > 0 or guard.mode == "open",
                "repromoted": guard.mode == "device",
            }
            log(f"breaker arc complete: engine mode {guard.mode}")

        # Sustain small churn waves until the duration floor.
        w = 0
        while time.monotonic() - t_start < duration_s:
            create_pods(min(wave_size // 2, 500), f"sustain{w}")
            w += 1
            if wait_settled(settle_timeout) < 0:
                raise RuntimeError("sustain wave never settled")
            time.sleep(0.5)

        churn_s = time.monotonic() - churn_t0
        churn_binds = monitor.binds - churn_binds0
        report["steady_state_pods_per_s"] = round(churn_binds /
                                                  max(churn_s, 1e-9), 1)
        report["churn_window_s"] = round(churn_s, 1)

        # Final settle + quiesce so confirms drain, then reconcile.
        if wait_settled(settle_timeout) < 0:
            raise RuntimeError("final settle failed")
        time.sleep(max(verify_period, 2.0))  # a final verifier pass
        report.update(_reconcile(store, factory, monitor))
        report["restart_parity"] = _restart_parity(
            store, factory, samples=parity_samples) \
            if restart else None

        # Verifier + violation accounting across both incarnations.
        report["invariant_violations"] = \
            metrics.CACHE_INVARIANT_VIOLATIONS.value - violations_before
        report["verifier_passes"] = \
            factory.verifier.passes if factory.verifier else 0
        report["queue_depth"] = sampler.summary()
        # Peak across BOTH incarnations: the storm's peak belongs to the
        # pre-kill daemon, whose FIFO the restart replaced.
        report["queue_peak_depth"] = max(
            factory.daemon.queue.peak_depth,
            report.get("restart", {}).get("peak_before_kill", 0))
        report["degraded_drains"] = \
            metrics.DEGRADED_DRAINS.value - degraded_before
        # Device-fault plane columns (violations(): any rejected bind,
        # or a run that ends with the breaker open, fails).
        guard = factory.algorithm.guard
        report["device_faults"] = _labeled_delta(metrics.DEVICE_FAULTS,
                                                 dev_faults_before)
        report["requeued_pods"] = sum(g.report()["requeuedPods"]
                                      for g in guards)
        report["breaker_open_seconds"] = \
            guard.report()["breakerOpenSeconds"]
        report["engine_mode_final"] = guard.mode
        report["sanity_gate"] = {
            "rejects": int(metrics.GATE_REJECTS.value -
                           gate_rejects_before),
            "rejected_binds": int(metrics.GATE_REJECTED_BINDS.value -
                                  rejected_binds_before),
        }
        report["stages"] = stage_breakdown(stages_before,
                                           _stage_snapshot())
        report["chaos"]["injected"] = proxy.stats()["injected"]
        report["heartbeats_sent"] = hb_sent[0]
        lock_rep = locktrace.report()
        report["locktrace"] = {
            "lock_inversions": lock_rep["lock_inversions"] -
            lock_counts0["lock_inversions"],
            "long_holds": lock_rep["long_holds"] -
            lock_counts0["long_holds"],
            "acquires": lock_rep["acquires"] - lock_counts0["acquires"],
            "inversion_detail": lock_rep["inversion_detail"],
            "long_hold_detail": lock_rep["long_hold_detail"],
        }
        report["duration_s"] = round(time.monotonic() - t_start, 1)
        report["scale"].update({
            "pods_created_total": created_total[0],
            "pods_scheduled_total": monitor.binds,
            "fleet_bench_multiple": round(
                monitor.binds / FLEET_BENCH_REPLICAS, 1)})
        log(f"done: {monitor.binds} binds, "
            f"{report['invariant_violations']} violations, "
            f"{report['reconciliation']}")
        return report
    finally:
        chaos_device.install(None)
        hb_stop.set()
        sampler.stop()
        monitor.stop()
        if factory is not None:
            try:
                factory.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        proxy.stop()
        api_srv.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        locktrace.set_enabled(knobs.get_bool("KT_LOCKTRACE"))


def run_ha_wave(n_nodes: int = 800, n_shards: int = 8,
                n_incarnations: int = 3, n_namespaces: int = 12,
                seed_pods: int = 3000, storm_waves: int = 5,
                wave_pods: int = 1500, kill_wave_pods: int = 3000,
                lease_s: float = 0.45, chaos: bool = True,
                stream_chunk: int = 2048, settle_timeout: float = 240.0,
                processes: bool = True, quiet: bool = False,
                device: str = "cuda") -> dict:
    """The active-active HA wave (scheduler/shards.py): scheduler
    incarnations over ONE apiserver, sharded by namespace hash with
    lease-based ownership, under a bind-409 + watch-cut chaos storm.
    One incarnation is SIGKILLed mid-drain; the survivors must steal
    its shards in under a second, reconcile and drain them, and the
    wave must end with zero double-binds and an aggregate steady-state
    rate at or above the wave's own single-scheduler baseline — phase 0
    runs the SAME storm (same rig, same chaos, same scale) against one
    incarnation holding every shard, so the comparison isolates exactly
    the variable under test: the number of schedulers.

    ``processes=True`` (the artifact mode) runs each incarnation as a
    REAL ``python -m kubernetes_tpu_torch.scheduler --device DEVICE``
    process — true parallelism (three interpreters, three GILs) and a
    true ``kill -9``; the driver observes ownership through the shard
    LEASE RECORDS themselves and scrapes each survivor's /metrics.
    ``processes=False`` is the in-process variant (seconds, no
    subprocess start-ups).

    Returns the ``ha`` section of the SOAK record; ``violations`` holds
    it to its invariants."""
    import signal
    import socket
    import subprocess
    import tempfile

    device = _device(device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    log_dir = tempfile.mkdtemp(prefix="kt-soak-ha-")
    t_start = time.monotonic()
    store = MemStore()
    from kubernetes_tpu_torch.apiserver.server import serve
    api_srv = serve(store)
    api_url = f"http://127.0.0.1:{api_srv.server_address[1]}"
    proxy = ChaosProxy(api_url).start()
    # Generous driver timeout: bulk creates can sit behind seconds of
    # server-side fan-out while every incarnation drains.
    direct = APIClient(api_url, qps=0, timeout=60.0)

    def log(msg: str) -> None:
        if not quiet:
            print(f"ha[{time.monotonic() - t_start:6.1f}s] {msg}",
                  file=sys.stderr)

    ha_env = {
        "KT_PREWARM": "1", "KT_RECOVERY": "1",
        "KT_HA_SHARDS": str(n_shards),
        "KT_HA_LEASE_S": str(lease_s),
        "KT_HA_RENEW_S": str(lease_s * 0.75),
        "KT_HA_RETRY_S": str(lease_s / 8),
        # The ownership sweep is the convergence backstop under the
        # chaos storm (a takeover relist the proxy kills must not
        # strand a shard) — compressed to scenario time, but not so
        # far the sweeps become their own load source.
        "KT_HA_SWEEP_S": "8",
        # Deadline micro-batching + compressed failure backoff: each
        # incarnation sees its shards' slice of every wave as a watch
        # trickle and must amortize per-drain fixed costs over real
        # batches; a 409-storm victim must retry in scenario time.
        "KT_BATCH_DEADLINE_MS": "100",
        "KT_POD_BACKOFF_S": "0.1", "KT_POD_BACKOFF_MAX_S": "2",
        "KT_STREAM_CHUNK": str(stream_chunk),
        # Race/deadlock detection rides the storm: every incarnation's
        # graph-tracked locks are traced, and the wave's inversion/
        # long-hold counts (scraped from the survivors' /metrics) land
        # in the artifact's locktrace columns, ratcheted to zero.
        "KT_LOCKTRACE": "1",
    }
    conflicts_before = metrics.CROSS_SHARD_CONFLICTS.value
    handoffs_before = metrics.SHARD_LEASE_HANDOFFS.value
    violations_before = metrics.CACHE_INVARIANT_VIOLATIONS.value
    lock_counts0 = locktrace.report()

    for i in range(0, n_nodes, 1000):
        direct.create_list("nodes", [
            _node_json(f"ha-{j:05d}")
            for j in range(i, min(i + 1000, n_nodes))])
    monitor = BindMonitor(store)
    namespaces = [f"ha-ns-{i}" for i in range(n_namespaces)]
    pod_seq = [0]
    created = [0]

    def create_pods(n: int, prefix: str) -> None:
        objs = []
        for k in range(n):
            pod_seq[0] += 1
            obj = _pod_json(f"{prefix}-{pod_seq[0]:06d}")
            obj["metadata"]["namespace"] = \
                namespaces[k % len(namespaces)]
            objs.append(obj)
        # Modest chunks: one huge POST fans out thousands of watch
        # deliveries under the store lock while every incarnation
        # drains — smaller bulks keep the server responsive.
        for i in range(0, n, 250):
            direct.create_list("pods", objs[i:i + 250])
        created[0] += n

    def wait_settled(timeout: float) -> float:
        # Settle by the monitor's bind count, not a store relist: the
        # driver polling a full deepcopied pod list every 100 ms is
        # GIL/CPU time stolen from the daemons it is measuring (no pod
        # is ever deleted in this wave, so created == bound is exact;
        # the final stranded check below does one real list).
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if monitor.binds >= created[0]:
                return time.monotonic() - t0
            time.sleep(0.1)
        return -1.0

    # -- ownership, observed through the lease records themselves ------
    from kubernetes_tpu_torch.scheduler.shards import shard_lock_name
    from kubernetes_tpu_torch.utils.leaderelection import (
        LEADER_ANNOTATION_KEY, LeaderElectionRecord)

    def shard_holders() -> dict[int, str]:
        """shard -> holder identity, straight off the CAS'd lease
        records (works identically for in-process and subprocess
        incarnations — the records ARE the coordination)."""
        out: dict[int, str] = {}
        for s in range(n_shards):
            obj = store.get("endpoints",
                            f"kube-system/{shard_lock_name(s)}")
            ann = ((obj or {}).get("metadata") or {}) \
                .get("annotations") or {}
            raw = ann.get(LEADER_ANNOTATION_KEY)
            if not raw:
                out[s] = ""
                continue
            rec = LeaderElectionRecord.from_json(raw)
            # A zeroed (released) record is nobody's.
            out[s] = rec.holder_identity \
                if rec.lease_duration_seconds > 0 else ""
        return out

    incarnations = [f"inc-{i}" for i in range(n_incarnations)]

    def coverage(idents: set[str]) -> bool:
        holders = shard_holders()
        return all(h in idents for h in holders.values()) and \
            len(holders) == n_shards

    def balanced(idents: set[str]) -> bool:
        holders = shard_holders()
        per = {i: 0 for i in idents}
        for h in holders.values():
            if h not in per:
                return False
            per[h] += 1
        return all(v > 0 for v in per.values())

    def _scrape(port: int, path: str) -> str:
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.read().decode()

    def _metric_sum(text: str, name: str) -> float:
        total = 0.0
        for line in text.splitlines():
            if line.startswith(name) and not line.startswith("#"):
                try:
                    total += float(line.rsplit(None, 1)[-1])
                except ValueError:
                    pass
        return total

    def _free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    report: dict = {"n_shards": n_shards,
                    "n_incarnations": n_incarnations,
                    "n_namespaces": n_namespaces,
                    "n_nodes": n_nodes,
                    "lease_duration_s": lease_s,
                    "chaos": chaos,
                    "processes": processes,
                    # The scale-out inequality (aggregate >= the phase-0
                    # single-scheduler baseline) is only physically
                    # reachable when the rig can actually run the
                    # incarnations concurrently; check_ha arms it off
                    # this column (cpus > n_incarnations) and falls back
                    # to the committed-predecessor ratchet on a
                    # serialized rig, where N schedulers timesharing one
                    # core pay N× the watch fan-out for 1× the compute.
                    "cpus": os.cpu_count()}
    factories: list = []
    children: list = []   # (name, Popen, status_port, log_path)
    saved_env: dict = {}

    def start_incarnations(names: list[str]) -> None:
        if processes:
            started = []
            for name in names:
                port = _free_port()
                log_path = os.path.join(log_dir, f"{name}.log")
                env = dict(os.environ, PYTHONPATH=repo)
                env.update(ha_env)
                env["KT_INCARNATION"] = name
                log_f = open(log_path, "w")
                try:
                    child = subprocess.Popen(
                        [sys.executable, "-m",
                         "kubernetes_tpu_torch.scheduler",
                         "--api-server", proxy.base_url,
                         "--port", str(port),
                         "--device", device,
                         "--kube-api-qps", "5000",
                         "--kube-api-burst", "5000"],
                        env=env, cwd=repo, stdout=log_f,
                        stderr=subprocess.STDOUT)
                finally:
                    # The child holds its own dup of the fd; ours would
                    # otherwise leak one handle per incarnation per wave.
                    log_f.close()
                rec = [name, child, port, log_path]
                children.append(rec)
                started.append(rec)
            # Readiness: the status mux answers once factory.run()
            # (reflector sync + prewarm + recovery) completed.
            deadline = time.monotonic() + 300
            for name, child, port, log_path in started:
                while time.monotonic() < deadline:
                    if child.poll() is not None:
                        raise RuntimeError(
                            f"incarnation {name} died at startup; see "
                            f"{log_path}")
                    try:
                        _scrape(port, "/healthz")
                        break
                    except Exception:  # noqa: BLE001 — not up yet
                        time.sleep(0.25)
                else:
                    raise RuntimeError(f"{name} never became ready")
            log(f"scheduler processes up: {names} (pids "
                f"{[c[1].pid for c in started]})")
        else:
            from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
            for name in names:
                f = ConfigFactory(proxy.base_url, qps=5000, burst=5000,
                                  ha_shards=n_shards, incarnation=name,
                                  device=device)
                f.daemon.STREAM_THRESHOLD = stream_chunk
                f.daemon.stream_chunk = stream_chunk
                factories.append(f)
                f.run()

    def storm(waves: int, prefix: str) -> tuple[float, float]:
        """Sustained multi-namespace waves; returns (pods/s, window s)."""
        t0 = time.monotonic()
        binds0 = monitor.binds
        for w in range(waves):
            create_pods(wave_pods, f"{prefix}{w}")
            if wait_settled(settle_timeout) < 0:
                raise RuntimeError(
                    f"HA {prefix} wave {w} never settled")
        window = time.monotonic() - t0
        return ((monitor.binds - binds0) / max(window, 1e-9), window)

    try:
        if not processes:
            saved_env = {k: os.environ.get(k) for k in ha_env}
            os.environ.update(ha_env)
            locktrace.set_enabled(True)

        # -- Phase 0: ONE incarnation, the whole keyspace — the same-
        # rig, same-chaos single-scheduler control that the aggregate
        # rate is ratcheted against (a cross-artifact comparison would
        # confound machine + scale; this one holds everything constant
        # except the number of schedulers).
        start_incarnations(incarnations[:1])
        solo = {incarnations[0]}
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if coverage(solo):
                break
            time.sleep(0.05)
        assert coverage(solo), \
            f"solo incarnation never took every shard: {shard_holders()}"
        create_pods(seed_pods, "seed")
        settle_s = wait_settled(settle_timeout)
        if settle_s < 0:
            raise RuntimeError("HA seed wave never settled")
        report["seed_settle_s"] = round(settle_s, 2)
        log(f"seeded {seed_pods} pods across {n_namespaces} "
            f"namespaces, settle {settle_s:.1f}s "
            f"(solo {incarnations[0]})")
        if chaos:
            rules = (bind_conflict_storm(every_nth=7) +
                     watch_cut_on_relist("pods", every_nth=3, count=8))
            proxy.add_rules(rules)
            report["chaos_rules"] = [r.to_json() for r in rules]
        base_rate, base_window = storm(max(2, storm_waves // 2),
                                       "base")
        report["single_scheduler_pods_per_s"] = round(base_rate, 1)
        report["baseline_window_s"] = round(base_window, 1)
        log(f"single-scheduler baseline: {base_rate:.1f} pods/s over "
            f"{base_window:.1f}s under chaos")

        # -- Phase 1: the late joiners arrive live.  All shards must
        # keep an owner — and every incarnation must end up holding at
        # least one (the first starter holds everything until presence-
        # driven rebalancing feeds the joiners) — before the aggregate
        # storm begins.
        start_incarnations(incarnations[1:])
        deadline = time.monotonic() + 120
        idents = set(incarnations)
        while time.monotonic() < deadline:
            if coverage(idents) and balanced(idents):
                break
            time.sleep(0.05)
        shard_map: dict[str, list[int]] = {i: [] for i in incarnations}
        for s, h in shard_holders().items():
            if h in shard_map:
                shard_map[h].append(s)
        report["initial_shard_map"] = {k: sorted(v)
                                       for k, v in shard_map.items()}
        assert coverage(idents), \
            f"shards unowned at start: {shard_holders()}"
        assert all(shard_map[i] for i in incarnations), \
            f"an incarnation never got a shard: {shard_map}"
        log(f"shard map after rebalance {report['initial_shard_map']}")

        # -- Phase 2: steady-state storm, every incarnation draining
        # its shards concurrently.
        agg_rate, storm_s = storm(storm_waves, "storm")
        report["aggregate_steady_pods_per_s"] = round(agg_rate, 1)
        report["storm_window_s"] = round(storm_s, 1)
        log(f"storm: {agg_rate:.1f} pods/s aggregate over "
            f"{storm_s:.1f}s (baseline {base_rate:.1f})")

        # SIGKILL one incarnation mid-drain: inject a wave, wait until
        # its queue is demonstrably busy, kill -9 (leases NOT released
        # — they expire; the survivors' takeover clock starts here).
        victim_name = incarnations[0]
        victim_shards = sorted(
            s for s, h in shard_holders().items() if h == victim_name)
        create_pods(kill_wave_pods, "kill")
        queue_at_kill = -1
        deadline = time.monotonic() + 30
        if processes:
            vname, vchild, vport, _vlog = children[0]
            while time.monotonic() < deadline:
                try:
                    import json as _json
                    depth = _json.loads(
                        _scrape(vport, "/debug/vars"))["queueDepth"]
                except Exception:  # noqa: BLE001 — busy; try again
                    depth = 0
                if depth > 0:
                    queue_at_kill = depth
                    break
                time.sleep(0.01)
            t_kill = time.monotonic()
            vchild.send_signal(signal.SIGKILL)
            vchild.wait(timeout=10)
        else:
            victim = factories[0]
            while time.monotonic() < deadline and \
                    len(victim.daemon.queue) == 0:
                time.sleep(0.005)
            queue_at_kill = len(victim.daemon.queue)
            t_kill = time.monotonic()
            victim.abandon()
        log(f"KILLED {victim_name} mid-drain (held shards "
            f"{victim_shards}, queue {queue_at_kill})")

        survivors = set(incarnations) - {victim_name}
        while not coverage(survivors) and \
                time.monotonic() - t_kill < 30:
            time.sleep(0.005)
        takeover_settle_s = time.monotonic() - t_kill
        report["takeover"] = {
            "victim": victim_name,
            "victim_shards": victim_shards,
            "queue_at_kill": queue_at_kill,
            "takeover_settle_s": round(takeover_settle_s, 3),
            "survivor_shard_map": {},
        }
        for s, h in shard_holders().items():
            report["takeover"]["survivor_shard_map"] \
                .setdefault(h, []).append(s)
        log(f"survivors own all {n_shards} shards "
            f"{takeover_settle_s * 1e3:.0f}ms after the kill")
        kill_drain_s = wait_settled(settle_timeout)
        if kill_drain_s < 0:
            raise RuntimeError("post-kill backlog never drained")
        report["takeover"]["kill_wave_drain_s"] = round(
            time.monotonic() - t_kill, 2)
        log(f"kill wave fully drained "
            f"{time.monotonic() - t_kill:.1f}s after the kill")

        # One more storm wave on the survivors, then reconcile.
        create_pods(wave_pods, "post")
        if wait_settled(settle_timeout) < 0:
            raise RuntimeError("post-kill wave never settled")
        time.sleep(max(lease_s, 0.5))  # confirms + late 409s drain
        items, _ = store.list("pods")
        stranded = sum(1 for o in items
                       if not (o.get("spec") or {}).get("nodeName"))
        if processes:
            conflicts = handoffs = violations = 0.0
            lock_inversions = long_holds = 0.0
            recoveries = []
            for name, child, port, _lp in children[1:]:
                try:
                    import json as _json
                    text = _scrape(port, "/metrics")
                    conflicts += _metric_sum(
                        text, "scheduler_cross_shard_bind_conflicts_"
                              "total")
                    handoffs += _metric_sum(
                        text, "scheduler_shard_lease_handoffs_total")
                    violations += _metric_sum(
                        text, "scheduler_cache_invariant_violations_"
                              "total")
                    lock_inversions += _metric_sum(
                        text, "scheduler_lock_inversions_total")
                    long_holds += _metric_sum(
                        text, "scheduler_lock_long_holds_total")
                    dv = _json.loads(_scrape(port, "/debug/vars"))
                    recoveries += [r for r in
                                   dv.get("shardRecoveries") or []
                                   if r.get("handoff")]
                except Exception:  # noqa: BLE001 — stats best-effort
                    pass
            report["takeover"]["shard_recoveries"] = recoveries[-12:]
        else:
            conflicts = metrics.CROSS_SHARD_CONFLICTS.value - \
                conflicts_before
            handoffs = metrics.SHARD_LEASE_HANDOFFS.value - \
                handoffs_before
            violations = metrics.CACHE_INVARIANT_VIOLATIONS.value - \
                violations_before
            lock_rep = locktrace.report()
            lock_inversions = lock_rep["lock_inversions"] - \
                lock_counts0["lock_inversions"]
            long_holds = lock_rep["long_holds"] - \
                lock_counts0["long_holds"]
            report["takeover"]["shard_recoveries"] = [
                r for f in factories[1:] for r in f.shard_recoveries
                if r.get("handoff")][-12:]
        report["locktrace"] = {
            "lock_inversions": int(lock_inversions),
            "long_holds": int(long_holds),
        }
        report.update({
            "pods_created": created[0],
            "pods_bound": monitor.binds,
            "double_binds": monitor.double_binds,
            "stranded_pending": stranded,
            "cross_shard_conflicts": int(conflicts),
            "lease_handoffs": int(handoffs),
            "invariant_violations": int(violations),
            "chaos_injected": proxy.stats()["injected"],
            "duration_s": round(time.monotonic() - t_start, 1),
        })
        log(f"done: {monitor.binds} binds, "
            f"{monitor.double_binds} double binds, takeover "
            f"{report['takeover']['takeover_settle_s']}s")
        return report
    finally:
        monitor.stop()
        for f in factories:
            try:
                f.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for name, child, port, _lp in children:
            if child.poll() is None:
                child.terminate()
        for name, child, port, _lp in children:
            if child.poll() is None:
                try:
                    child.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    child.kill()
        proxy.stop()
        api_srv.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if saved_env:
            locktrace.set_enabled(knobs.get_bool("KT_LOCKTRACE"))


def run_capacity_wave(n_nodes: int = 16, pods_per_node: int = 10,
                      quiet: bool = False, device: str = "cuda") -> dict:
    """The near-capacity wave (the apiserver's server-side bind capacity
    validation): a fleet offered
    pods up to ~94 % of its absolute slot capacity, plus deliberate
    overcommitting bind probes against already-full nodes — the shape a
    watch-lagged (or buggy) scheduler would produce.  The probes must
    bounce off the server's 409 (``apiserver_bind_capacity_rejects_
    total``), the real scheduler must absorb its own rejects via
    forget + requeue and still converge, and the post-wave audit must
    find ZERO overcommitted nodes — the zero-overcommit bar of
    ``violations``."""
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    device = _device(device)
    capacity = n_nodes * pods_per_node
    offered = int(capacity * 0.94)
    store = MemStore()
    api_srv = serve(store)
    api_url = f"http://127.0.0.1:{api_srv.server_address[1]}"
    direct = APIClient(api_url, qps=0)
    direct.create_list("nodes", [
        _node_json(f"cap-{i:03d}", milli_cpu=pods_per_node * 100,
                   pods=pods_per_node) for i in range(n_nodes)])
    rejects0 = metrics.BIND_CAPACITY_REJECTS.value
    factory = ConfigFactory(api_url, qps=5000, burst=5000, device=device)
    factory.daemon.backoff = PodBackoff(default_duration=0.1,
                                        max_duration=1.0)
    factory.run()
    probe_rejects = 0
    try:
        direct.create_list("pods", [_pod_json(f"cw-{i:05d}", cpu="100m")
                                    for i in range(offered)])
        deadline = time.time() + 60
        while time.time() < deadline:
            bound = sum(1 for o in store.list("pods")[0]
                        if (o.get("spec") or {}).get("nodeName"))
            if bound >= offered:
                break
            time.sleep(0.1)
        # Overcommitting probes: bind fresh pods straight at the FULL
        # nodes (bypassing the scheduler — the lagged-peer shape).  The
        # server must 409 every one.
        per_node: dict[str, int] = {}
        for o in store.list("pods")[0]:
            nd = (o.get("spec") or {}).get("nodeName")
            if nd:
                per_node[nd] = per_node.get(nd, 0) + 1
        full = [n for n, c in per_node.items() if c >= pods_per_node]
        probes = []
        # The probe pods become ordinary pending pods afterwards, so
        # they must still FIT the fleet's remaining slots or the wave
        # would manufacture stranded pods at toy scales.
        probe_budget = min(4, capacity - offered)
        for i, node in enumerate(full[:probe_budget]):
            name = f"cw-probe-{i}"
            direct.create("pods", _pod_json(name, cpu="100m"))
            probes.append(name)
            try:
                direct.bind("default", name, node)
            except Exception:  # noqa: BLE001 — the expected 409
                probe_rejects += 1
        # The probe pods are now ordinary pending pods; the scheduler
        # converges them onto the remaining free slots.
        deadline = time.time() + 30
        while time.time() < deadline:
            unbound = sum(1 for o in store.list("pods")[0]
                          if not (o.get("spec") or {}).get("nodeName"))
            if unbound == 0:
                break
            time.sleep(0.1)
    finally:
        try:
            factory.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        api_srv.shutdown()
    # Zero-overcommit audit against the store's own truth.
    pods_final, _ = store.list("pods")
    used: dict[str, list] = {}
    for o in pods_final:
        nd = (o.get("spec") or {}).get("nodeName")
        if not nd:
            continue
        row = used.setdefault(nd, [0, 0])
        milli, _, _ = MemStore._pod_requests(o)
        row[0] += milli
        row[1] += 1
    overcommitted = 0
    for i in range(n_nodes):
        row = used.get(f"cap-{i:03d}", [0, 0])
        if row[0] > pods_per_node * 100 or row[1] > pods_per_node:
            overcommitted += 1
    stranded = sum(1 for o in pods_final
                   if not (o.get("spec") or {}).get("nodeName"))
    out = {
        "nodes": n_nodes,
        "capacity_slots": capacity,
        "offered": offered + len(
            [p for p in pods_final
             if p["metadata"]["name"].startswith("cw-probe-")]),
        "bound": len(pods_final) - stranded,
        "stranded_pending": stranded,
        "overcommit_probes": probe_rejects,
        "bind_capacity_rejects":
            metrics.BIND_CAPACITY_REJECTS.value - rejects0,
        "overcommitted_nodes": overcommitted,
    }
    if not quiet:
        print(f"capacity wave: {out['bound']}/{out['offered']} bound, "
              f"{out['bind_capacity_rejects']} server-side capacity "
              f"rejects, {overcommitted} overcommitted nodes",
              file=sys.stderr)
    return out


def run_tenancy_poison_wave(n_nodes: int = 60, pods_per_tenant: int = 150,
                            quiet: bool = False,
                            device: str = "cuda") -> dict:
    """The tenancy poison wave under KT_LOCKTRACE=1: an embedded
    multi-tenant SolverService (packed submits racing the daemon's own
    drain across the engine_lock / pending / state locks, the
    hairiest concurrency surface of tenancy) while an adversarial
    tenant's poison batches trip its per-tenant breaker — exactly the
    interleavings a lock-order bug would need.  The wave asserts the
    tenant isolation contract still converges and returns locktrace's
    inversion/long-hold counts for the record's zero-bar columns.
    The poisoned tenant's breaker opens and its pods requeue with
    backoff until its probe re-promotes it (this package has no host
    engine to decide them on)."""
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    device = _device(device)
    tenants = ("lt-a", "lt-b", "lt-c")
    saved_env = {k: os.environ.get(k)
                 for k in ("KT_TENANTS", "KT_TENANT_WEIGHTS",
                           "KT_TENANT_BREAKER", "KT_TENANT_PROBE_S",
                           "KT_LOCKTRACE", "KT_POD_BACKOFF_S",
                           "KT_POD_BACKOFF_MAX_S")}
    os.environ.update({
        "KT_TENANTS": ",".join(tenants),
        "KT_TENANT_WEIGHTS": "lt-a:2,lt-b:1,lt-c:1",
        "KT_TENANT_BREAKER": "2",
        "KT_TENANT_PROBE_S": "0.5",
        "KT_LOCKTRACE": "1",
        "KT_POD_BACKOFF_S": "0.1",
        "KT_POD_BACKOFF_MAX_S": "1",
    })
    locktrace.set_enabled(True)
    lock_counts0 = locktrace.report()
    store = MemStore()
    api_srv = serve(store)
    api_url = f"http://127.0.0.1:{api_srv.server_address[1]}"
    direct = APIClient(api_url, qps=0)
    direct.create_list("nodes", [_node_json(f"lt-{i:03d}")
                                 for i in range(n_nodes)])
    chaos = DeviceChaos([DeviceRule(fault="corrupt", every_nth=1,
                                    count=3, tenant="lt-c")])
    factory = None
    try:
        chaos_device.install(chaos)
        factory = ConfigFactory(api_url, qps=5000, burst=5000,
                                device=device)
        factory.run()
        svc = factory.tenancy
        offered = 0
        for tenant in tenants:
            objs = []
            for i in range(pods_per_tenant):
                obj = _pod_json(f"lp-{tenant}-{i:04d}")
                obj["metadata"]["namespace"] = tenant
                objs.append(obj)
            direct.create_list("pods", objs)
            offered += len(objs)
        deadline = time.time() + 120
        bound = 0
        while time.time() < deadline:
            bound = sum(1 for o in store.list("pods")[0]
                        if (o.get("spec") or {}).get("nodeName"))
            if bound >= offered:
                break
            time.sleep(0.1)
        # Poison exhausted (count=3): drive probe traffic until the
        # poisoned tenant re-promotes to the device.
        chaos_device.install(None)
        probe_i = 0
        deadline = time.time() + 30
        while time.time() < deadline and \
                svc is not None and svc.tenant_mode("lt-c") != "device":
            obj = _pod_json(f"lp-probe-{probe_i:03d}")
            obj["metadata"]["namespace"] = "lt-c"
            direct.create("pods", obj)
            probe_i += 1
            time.sleep(0.4)
        lock_rep = locktrace.report()
        out = {
            "tenants": list(tenants),
            "offered": offered,
            "bound": bound,
            "poisoned_tenant": "lt-c",
            "repromoted": svc is not None and
            svc.tenant_mode("lt-c") == "device",
            "lock_inversions": lock_rep["lock_inversions"] -
            lock_counts0["lock_inversions"],
            "long_holds": lock_rep["long_holds"] -
            lock_counts0["long_holds"],
            "acquires": lock_rep["acquires"] -
            lock_counts0["acquires"],
        }
        if not quiet:
            print(f"tenancy poison wave: {bound}/{offered} bound, "
                  f"repromoted={out['repromoted']}, "
                  f"{out['lock_inversions']} inversions / "
                  f"{out['long_holds']} long holds over "
                  f"{out['acquires']} traced acquires", file=sys.stderr)
        return out
    finally:
        chaos_device.install(None)
        if factory is not None:
            try:
                factory.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        api_srv.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        locktrace.set_enabled(knobs.get_bool("KT_LOCKTRACE"))


def _audit_wal_double_binds(storage_dir: str) -> tuple[int, int]:
    """Replay the apiserver's durable record (snapshot + WAL) and count
    pods whose ``spec.nodeName`` moved from one non-empty node to a
    DIFFERENT non-empty node — the double-bind shape the bind CAS must
    make impossible even across a SIGKILL.  Returns (double_binds,
    records_audited).  The audit reads the server's own truth, not the
    driver's bookkeeping: a zombie bind that landed between the kill and
    the restart shows up here and nowhere else."""
    node_of: dict[str, str] = {}
    audited = 0
    snap = os.path.join(storage_dir, "snapshot.json")
    if os.path.exists(snap):
        with open(snap, encoding="utf-8") as f:
            objects = (json.load(f).get("objects") or {})
        for key, obj in (objects.get("pods") or {}).items():
            node_of[key] = ((obj.get("spec") or {})
                            .get("nodeName") or "")
    double = 0
    wal = os.path.join(storage_dir, "wal.jsonl")
    if os.path.exists(wal):
        with open(wal, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    etype, kind, key = rec["t"], rec["k"], rec["key"]
                    obj = rec["o"]
                except (ValueError, KeyError, TypeError):
                    break  # torn tail: recovery truncates it too
                audited += 1
                if kind != "pods":
                    continue
                if etype == "DELETED":
                    node_of.pop(key, None)
                    continue
                new_node = (((obj or {}).get("spec") or {})
                            .get("nodeName") or "")
                prev = node_of.get(key, "")
                if prev and new_node and new_node != prev:
                    double += 1
                node_of[key] = new_node
    return double, audited


def run_apiserver_kill_wave(n_nodes: int = 60, avalanche_pods: int = 800,
                            kill_at_bound: int = 150,
                            settle_timeout: float = 180.0,
                            quiet: bool = False,
                            device: str = "cuda") -> dict:
    """The apiserver-kill wave: a REAL ``python -m
    kubernetes_tpu_torch.apiserver --storage-dir`` process is SIGKILLed
    mid-avalanche — binds landing, backlog pending — and restarted on
    the same port and storage dir.  The full scheduler rides through
    the outage on its own machinery (client retries, reflector relist,
    bind-conflict absorption); the wave then audits the three
    crash-consistency invariants the ratchet pins:

    * ZERO acknowledged-write loss — every create the driver got a 201
      for before the kill is present after the restart (WAL replay);
    * ZERO double-binds — replaying the server's own snapshot + WAL
      finds no pod whose nodeName moved between non-empty nodes;
    * ZERO stranded pods — the post-restart scheduler converges the
      full avalanche (410/watch-break -> relist -> reschedule).
    """
    import signal
    import socket
    import subprocess
    import tempfile
    import urllib.request

    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory

    device = _device(device)
    t_start = time.monotonic()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    storage_dir = tempfile.mkdtemp(prefix="kt-soak-kill-")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    api_url = f"http://127.0.0.1:{port}"

    def log(msg: str) -> None:
        if not quiet:
            print(f"kill[{time.monotonic() - t_start:6.1f}s] {msg}",
                  file=sys.stderr)

    def start_apiserver():
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.apiserver",
             "--port", str(port), "--storage-dir", storage_dir],
            env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError("apiserver died at startup")
            try:
                urllib.request.urlopen(f"{api_url}/healthz", timeout=2)
                return proc
            except OSError:
                time.sleep(0.05)
        proc.kill()
        raise RuntimeError("apiserver never became ready")

    direct = APIClient(api_url, qps=0, timeout=30.0)

    def counts() -> tuple[int, int]:
        items, _ = direct.list("pods")
        bound = sum(1 for o in items
                    if (o.get("spec") or {}).get("nodeName"))
        return bound, len(items) - bound

    proc = start_apiserver()
    factory = None
    # The scheduler rides through a ChaosProxy that adds a small
    # per-bind latency: the wire path otherwise drains a whole chunk
    # faster than one driver-side LIST can observe, and the kill MUST
    # land while binds are demonstrably in flight.  The proxy dials the
    # upstream per request, so it spans the apiserver restart; the
    # driver's own polls go straight to the real server.
    from kubernetes_tpu_torch.chaos.proxy import FAULT_LATENCY, Rule
    proxy = ChaosProxy(api_url).start()
    proxy.add_rules([Rule(fault=FAULT_LATENCY, method="POST",
                          path=r"/bindings", delay_s=0.05,
                          every_nth=1)])
    acked: list[str] = []
    relists0 = metrics.REFLECTOR_RELISTS.value
    try:
        direct.create_list("nodes", [_node_json(f"kw-{i:04d}")
                                     for i in range(n_nodes)])
        factory = ConfigFactory(proxy.base_url, qps=5000, burst=5000,
                                device=device)
        # A 4096-binding frame clears the proxy in ONE delayed POST —
        # near-atomic from the driver's LIST.  Small chunks turn the
        # drain into a stream of delayed POSTs riding the AIMD-gated
        # pipeline, so "mid-flight" is a real, observable window.
        factory.store.BIND_CHUNK = 8
        factory.daemon.backoff = PodBackoff(default_duration=0.1,
                                            max_duration=2.0)
        factory.run()
        log(f"scheduler up against the real apiserver (pid {proc.pid})")

        # The avalanche, acked chunk by chunk: a create_list that
        # returned is the server's 201 — from that moment the write is
        # covered by the durability contract.  The kill is interleaved
        # WITH the avalanche: the moment binds are landing (>= the
        # threshold) while acked pods are still pending, SIGKILL — the
        # drain is then provably mid-flight, not quiesced (the wire
        # path binds fast enough that polling after the fact would
        # only ever see a drained cluster).
        names = [f"kw-av-{i:06d}" for i in range(avalanche_pods)]
        chunks = [names[i:i + 100]
                  for i in range(0, avalanche_pods, 100)]
        bound_at_kill = pending_at_kill = 0
        downtime_s = 0.0
        killed = False
        at = 0
        while at < len(chunks):
            chunk = chunks[at]
            direct.create_list("pods", [_pod_json(nm) for nm in chunk])
            acked.extend(chunk)
            at += 1
            if killed:
                continue
            bound, pending = counts()
            if bound >= kill_at_bound and pending > 0:
                bound_at_kill, pending_at_kill = bound, pending
                t_kill = time.monotonic()
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=10)
                killed = True
                log(f"SIGKILLed the apiserver mid-avalanche "
                    f"({bound_at_kill} bound, {pending_at_kill} "
                    f"pending, {len(acked)}/{avalanche_pods} acked)")
                time.sleep(0.5)  # in-flight binds hit the void
                proc = start_apiserver()
                downtime_s = time.monotonic() - t_kill
                log(f"apiserver restarted on the recovered WAL "
                    f"({downtime_s:.2f}s down); resuming the "
                    f"avalanche")
        if not killed:
            # All chunks acked before the trigger fired — the bind
            # latency keeps the drain in flight for seconds yet, so
            # keep polling for the mid-flight window.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                bound, pending = counts()
                if bound >= kill_at_bound and pending > 0:
                    bound_at_kill, pending_at_kill = bound, pending
                    break
                time.sleep(0.02)
            t_kill = time.monotonic()
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
            killed = True
            log(f"SIGKILLed the apiserver mid-avalanche "
                f"({bound_at_kill} bound, {pending_at_kill} pending, "
                f"all {len(acked)} acked)")
            time.sleep(0.5)
            proc = start_apiserver()
            downtime_s = time.monotonic() - t_kill
            log(f"apiserver restarted on the recovered WAL "
                f"({downtime_s:.2f}s down)")

        # The scheduler must converge the whole avalanche on its own:
        # watch streams broke (relist), in-flight binds errored
        # (requeue), pre-kill acked binds resurface as 409s (absorb).
        t_settle = time.monotonic()
        deadline = time.monotonic() + settle_timeout
        stranded = -1
        while time.monotonic() < deadline:
            bound, pending = counts()
            if pending == 0 and bound >= len(acked):
                stranded = 0
                break
            time.sleep(0.25)
        if stranded < 0:
            _, stranded = counts()
        restart_settle_s = time.monotonic() - t_settle

        items, _ = direct.list("pods")
        present = {o["metadata"]["name"] for o in items}
        lost = [nm for nm in acked if nm not in present]
        double_binds, audited = _audit_wal_double_binds(storage_dir)
        relists = int(metrics.REFLECTOR_RELISTS.value - relists0)
        out = {
            "n_nodes": n_nodes,
            "acked_creates": len(acked),
            "acked_writes_lost": len(lost),
            "lost_sample": lost[:10],
            "double_binds": double_binds,
            "wal_records_audited": audited,
            "stranded_pending": stranded,
            "killed_mid_avalanche": bound_at_kill > 0 and
            pending_at_kill > 0,
            "bound_at_kill": bound_at_kill,
            "pending_at_kill": pending_at_kill,
            "downtime_s": round(downtime_s, 2),
            "relists": relists,
            "restart_settle_s": round(restart_settle_s, 2),
            "duration_s": round(time.monotonic() - t_start, 1),
        }
        log(f"done: {out['acked_writes_lost']} acked writes lost, "
            f"{double_binds} double-binds over {audited} WAL records, "
            f"{stranded} stranded, {relists} relists")
        return out
    finally:
        if factory is not None:
            try:
                factory.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        proxy.stop()
        if proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


# Storm clients per child process of the overload wave.
STORM_CLIENTS_PER_PROCESS = 24


def storm_clients(api_url: str, first: int, n_clients: int,
                  attempts: int) -> None:
    """The overload storm's clients in one process (``python -m
    kubernetes_tpu_torch.perf.soak --storm-clients URL FIRST N
    ATTEMPTS``): each best-effort client offers its attempts without
    retries — every 10th a LIST of all pods, the rest creates — once a
    line arrives on standard input.  Prints "ready" before that, and
    the per-client tallies (JSON) when all are done."""
    tallies = [{"offered": 0, "acked": 0, "listed": 0, "shed": 0}
               for _ in range(n_clients)]
    go = threading.Event()

    def storm_worker(k: int) -> None:
        cl = APIClient(api_url, qps=0, max_retries=0, timeout=30.0)
        tally, w = tallies[k], first + k
        go.wait()
        for i in range(attempts):
            tally["offered"] += 1
            try:
                if i % 10 == 9:
                    cl.list("pods")  # the LIST face of the storm
                    tally["listed"] += 1
                else:
                    cl.create("pods", _pod_json(
                        f"ov-storm-{w:02d}-{i:05d}"))
                    tally["acked"] += 1
            except Exception as err:  # noqa: BLE001
                if getattr(err, "status", None) == 429:
                    tally["shed"] += 1

    threads = [threading.Thread(target=storm_worker, args=(k,),
                                name=f"ov-storm-{first + k}")
               for k in range(n_clients)]
    for t in threads:
        t.start()
    print("ready", flush=True)
    sys.stdin.readline()
    go.set()
    for t in threads:
        t.join()
    print(json.dumps(tallies), flush=True)


def run_overload_wave(n_nodes: int = 200, calibration_pods: int = 900,
                      storm_threads: int = 192,
                      attempts_per_thread: int = 40,
                      settle_timeout: float = 240.0,
                      quiet: bool = False, device: str = "cuda") -> dict:
    """The overload wave: the apiserver runs with a
    deliberately small flow-control envelope, a ShardManager keeps the
    shard-lease plane alive through it, and a best-effort create/LIST
    storm offers a large multiple of what that envelope admits.  The
    envelope IS the system's declared capacity — max-inflight is the
    operator's statement of how much concurrent work the server may
    carry — so the ratcheted overload depth (``offered_multiple``) is
    offered rate over admitted rate, both measured inside the storm
    window.  The un-stormed calibration drain is kept as context
    (``calibration_pods_per_s``, ``offered_vs_calibrated``): on a
    one-core rig the storm clients timeshare the GIL with the server,
    so raw offered rate can never outrun the unconstrained batch
    pipeline — the envelope is what a storm genuinely oversubscribes.
    The ratchet (check_bench.check_overload) pins the APF contract:

    * the storm actually trips the controller (shed 429s > 0) and
      offers >= 3x what the envelope admits;
    * the system lane never sheds and NO shard lease expires — the
      protected lease plane holds under saturation;
    * queue depth stays inside the configured bound (scraped live from
      the apiserver's exempt /debug/vars, which must keep answering);
    * goodput degrades gracefully, never to zero, and every acked pod
      still binds (stranded == 0).

    The scheduler and the storm's clients run as processes of their own,
    as they do in a deployment (``python -m kubernetes_tpu_torch.scheduler
    --device DEVICE``, and ``STORM_CLIENTS_PER_PROCESS`` clients to a
    ``python -m kubernetes_tpu_torch.perf.soak --storm-clients``), where
    the JAX wave runs both in this process beside the apiserver.  On the
    H100's host, with 192 client threads here, the interpreter lock
    starved the rest: every torch op of a drain gives it up and waits to
    take it back, so a drain of a few pods outlasted the storm (0.1
    pods/s in 3 of 5 runs; 0.0 on the CPU), and the ``/debug/vars``
    sampler timed out in 8 of 11 runs.  The record adds the scheduler's
    kernel launches (``daemon_launches``, from its ``/debug/vars``).
    """
    import signal
    import socket
    import subprocess
    import tempfile
    import urllib.request

    from kubernetes_tpu_torch.apiserver import flowcontrol as apf
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.scheduler.factory import (enter_lease_mode,
                                                        leave_lease_mode)
    from kubernetes_tpu_torch.scheduler.shards import ShardManager

    device = _device(device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    t_start = time.monotonic()
    queue_limit = 16
    flow = apf.FlowController(system_inflight=8, workload_inflight=16,
                              besteffort_inflight=4, watch_inflight=64,
                              queue_limit=queue_limit, queue_wait_s=0.05,
                              retry_floor=0.05)
    store = MemStore()
    api_srv = serve(store, flow=flow)
    port = api_srv.server_address[1]
    api_url = f"http://127.0.0.1:{port}"
    direct = APIClient(api_url, qps=0, timeout=60.0)

    def log(msg: str) -> None:
        if not quiet:
            print(f"overload[{time.monotonic() - t_start:6.1f}s] {msg}",
                  file=sys.stderr)

    direct.create_list("nodes", [_node_json(f"ov-{i:04d}")
                                 for i in range(n_nodes)])
    monitor = BindMonitor(store)
    lost_leases: list[int] = []
    mgr = ShardManager(APIClient(api_url, qps=0), incarnation="soak-ov",
                       n_shards=4, lease_duration=1.0,
                       renew_deadline=0.7, retry_period=0.1, jitter=0.0,
                       on_lost=lost_leases.append)
    daemon = None
    lease_mode = False
    storm_procs: list = []
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        daemon_port = sock.getsockname()[1]
    daemon_log = tempfile.NamedTemporaryFile(
        "w", prefix="kt-soak-overload-", suffix=".log", delete=False)
    sampler_stop = threading.Event()
    depth_samples: list[int] = []
    exempt_errors = [0]

    def sample_debug_vars() -> None:
        # The exempt lane's live evidence: /debug/vars must answer
        # THROUGH the storm, and its per-level queue depths are the
        # boundedness record.
        while not sampler_stop.wait(0.05):
            try:
                with urllib.request.urlopen(f"{api_url}/debug/vars",
                                            timeout=5) as r:
                    levels = ((json.loads(r.read()).get("overload")
                               or {}).get("levels") or {})
                depth_samples.append(max(
                    (lv.get("queued") or 0) for lv in levels.values()))
            except Exception:  # noqa: BLE001 — counted, then ratcheted
                exempt_errors[0] += 1

    try:
        # This process holds shard leases beside the apiserver's
        # handler threads: it runs in lease mode, as a factory with
        # shards does (scheduler/factory.py: full collections deferred,
        # a 1 ms switch interval, so the lease thread and the exempt
        # /debug/vars answer in time).
        enter_lease_mode()
        lease_mode = True
        mgr.run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                mgr.owned() != frozenset(range(4)):
            time.sleep(0.02)
        assert mgr.owned() == frozenset(range(4)), \
            f"lease plane never settled: {sorted(mgr.owned())}"
        # The scheduler process: the soak's compressed backoff (0.1 s,
        # at most 2 s), ready once its status port answers.
        daemon = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
             "--api-server", api_url, "--port", str(daemon_port),
             "--device", device, "--kube-api-qps", "5000",
             "--kube-api-burst", "5000"],
            env=dict(os.environ, PYTHONPATH=repo, KT_POD_BACKOFF_S="0.1",
                     KT_POD_BACKOFF_MAX_S="2"),
            cwd=repo, stdout=daemon_log, stderr=subprocess.STDOUT)
        status = f"http://127.0.0.1:{daemon_port}"
        deadline = time.monotonic() + 300
        while True:
            if daemon.poll() is not None:
                raise RuntimeError(f"the scheduler process exited "
                                   f"{daemon.returncode}; see "
                                   f"{daemon_log.name}")
            try:
                urllib.request.urlopen(f"{status}/healthz", timeout=2)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError("the scheduler process never "
                                       "became ready")
                time.sleep(0.1)
        log(f"scheduler process up (pid {daemon.pid})")

        # Warmup (uncounted): flush the first drains' lazy caches (and,
        # on a card, the kernel library's load) out of the capacity
        # measurement.
        direct.create_list("pods", [_pod_json(f"ov-warm-{i:04d}")
                                    for i in range(100)])
        warm_deadline = time.monotonic() + settle_timeout
        while monitor.binds < 100:
            if time.monotonic() > warm_deadline:
                raise RuntimeError("warmup wave never settled")
            time.sleep(0.05)

        # Calibration: the fleet's un-stormed SUSTAINED drain rate,
        # the denominator of the offered-load multiple.  Three spaced
        # bursts force multiple drain cycles so one lucky warm drain
        # can't inflate the measured capacity.
        t0 = time.monotonic()
        third = calibration_pods // 3
        for b in range(3):
            direct.create_list(
                "pods",
                [_pod_json(f"ov-cal-{i:05d}")
                 for i in range(b * third,
                                calibration_pods if b == 2
                                else (b + 1) * third)])
            while monitor.binds < 100 + (calibration_pods if b == 2
                                         else (b + 1) * third):
                if time.monotonic() - t0 > settle_timeout:
                    raise RuntimeError("calibration wave never settled")
                time.sleep(0.05)
        cal_rate = calibration_pods / (time.monotonic() - t0)
        log(f"calibrated capacity: {cal_rate:.1f} pods/s")

        sampler = threading.Thread(target=sample_debug_vars,
                                   daemon=True, name="ov-sampler")
        sampler.start()
        # The storm's clients run in child processes, as best-effort
        # clients do in a deployment (the docstring says why).  Each
        # child prints "ready" once its clients wait, so its start-up
        # stays out of the storm window; a line on its input starts
        # them; it prints their tallies when they are done.
        for first in range(0, storm_threads, STORM_CLIENTS_PER_PROCESS):
            n = min(STORM_CLIENTS_PER_PROCESS, storm_threads - first)
            storm_procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubernetes_tpu_torch.perf.soak",
                 "--storm-clients", api_url, str(first), str(n),
                 str(attempts_per_thread)],
                env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for proc in storm_procs:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError(f"a storm process exited "
                                   f"{proc.wait()} before it was ready")
        t_storm = time.monotonic()
        binds0 = monitor.binds
        for proc in storm_procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        tallies = []
        for proc in storm_procs:
            tallies.extend(json.loads(proc.stdout.readline()))
            proc.wait(timeout=60)
        storm_s = time.monotonic() - t_storm
        storm_binds = monitor.binds - binds0
        offered = [sum(t["offered"] for t in tallies)]
        acked = [sum(t["acked"] for t in tallies)]
        listed = sum(t["listed"] for t in tallies)
        shed = [sum(t["shed"] for t in tallies)]
        offered_rate = offered[0] / max(storm_s, 1e-9)
        admitted_rate = (acked[0] + listed) / max(storm_s, 1e-9)
        log(f"storm: {offered[0]} ops offered in {storm_s:.1f}s "
            f"({offered_rate:.0f}/s vs {admitted_rate:.0f}/s admitted "
            f"= {offered_rate / max(admitted_rate, 1e-9):.1f}x the "
            f"envelope; unstormed drain {cal_rate:.0f} pods/s), "
            f"{acked[0]} acked, {shed[0]} shed with 429")
        sampler_stop.set()
        sampler.join(timeout=5)

        # Every acked create still converges: graceful degradation
        # sheds NEW work at the door, never work already admitted.
        total = 100 + calibration_pods + acked[0]
        deadline = time.monotonic() + settle_timeout
        while monitor.binds < total and time.monotonic() < deadline:
            time.sleep(0.1)
        items, _ = store.list("pods")
        stranded = sum(1 for o in items
                       if not (o.get("spec") or {}).get("nodeName"))
        with urllib.request.urlopen(f"{status}/debug/vars",
                                    timeout=30) as r:
            daemon_launches = json.loads(r.read())["kernelLaunches"]
        levels = flow.report()["levels"]
        system_rejected = sum(
            (levels.get(apf.LEVEL_SYSTEM) or {})
            .get("rejected", {}).values())
        out = {
            "n_nodes": n_nodes,
            "queue_limit": queue_limit,
            "calibration_pods_per_s": round(cal_rate, 1),
            "offered_ops": offered[0],
            # Overload depth: offered rate over the rate the configured
            # envelope actually admitted (creates acked + LISTs served)
            # inside the storm window.  check_overload bars this at 3x.
            "offered_multiple": round(
                offered_rate / max(admitted_rate, 1e-9), 1),
            "admitted_ops_per_s": round(admitted_rate, 1),
            "offered_vs_calibrated": round(
                offered_rate / max(cal_rate, 1e-9), 1),
            "storm_window_s": round(storm_s, 1),
            "acked_creates": acked[0],
            "admitted_lists": listed,
            "shed_429": shed[0],
            "goodput_pods_per_s": round(storm_binds / max(storm_s, 1e-9),
                                        1),
            "lease_expiries": len(lost_leases),
            "leases_held_final": len(mgr.owned()),
            "system_rejected": int(system_rejected),
            "max_queue_depth": max(depth_samples) if depth_samples
            else 0,
            "debug_vars_samples": len(depth_samples),
            "debug_vars_errors": exempt_errors[0],
            "stranded_pending": stranded,
            "levels": levels,
            "daemon_launches": daemon_launches,
            "duration_s": round(time.monotonic() - t_start, 1),
        }
        log(f"done: {out['shed_429']} shed, goodput "
            f"{out['goodput_pods_per_s']} pods/s, "
            f"{out['lease_expiries']} lease expiries, max queue depth "
            f"{out['max_queue_depth']}/{queue_limit}, "
            f"{stranded} stranded")
        return out
    finally:
        sampler_stop.set()
        monitor.stop()
        try:
            mgr.stop(release=False)  # audit counts real expiries only
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        for proc in storm_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdin.close()
            proc.stdout.close()
        if daemon is not None and daemon.poll() is None:
            daemon.send_signal(signal.SIGTERM)
            try:
                daemon.wait(timeout=30)
            except subprocess.TimeoutExpired:
                daemon.kill()
                daemon.wait(timeout=10)
        daemon_log.close()
        api_srv.shutdown()
        if lease_mode:
            leave_lease_mode()


def run_defrag_wave(n_nodes: int = 8, quiet: bool = False,
                    device: str = "cuda") -> dict:
    """The continuous-rebalancing wave: fragmentation is
    injected by BIASED CHURN — a fleet packed with small pods, one small
    pod deleted per node (every node a little bit empty), then large
    pods created that fit NOWHERE whole — and the always-on defragmenter
    must consolidate the slivers: evict small pods into other nodes'
    free space (two-phase, intent-annotated, PDB-vetoed) so the large
    pods place.  The wave then lands a scheduler SIGKILL (``abandon``)
    mid-migration — after the evict-to-pending, with the rebind path
    chaos-blocked so the window cannot close — and the restarted
    scheduler's startup reconcile must requeue the in-flight pod and
    clear its intent.  The ratchet (``check_defrag``) pins:
    ``defrag_gain > 0``, migrations never exceeding the per-round cap,
    0 PDB violations, 0 stranded pods, 0 double-binds / double-capacity,
    0 invariant violations, and ``migrations_recovered >= 1``."""
    from kubernetes_tpu_torch.api.types import DEFRAG_MIGRATION_ANNOTATION_KEY
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.chaos.proxy import FAULT_ERROR, Rule
    from kubernetes_tpu_torch.controller.disruption import DisruptionController
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory

    device = _device(device)
    t_start = time.monotonic()
    n_large = 3

    def log(msg: str) -> None:
        if not quiet:
            print(f"defrag[{time.monotonic() - t_start:6.1f}s] {msg}",
                  file=sys.stderr)

    saved_env = {k: os.environ.get(k) for k in (
        "KT_DEFRAG", "KT_DEFRAG_PERIOD_S", "KT_DEFRAG_MAX_MIGRATIONS",
        "KT_DEFRAG_MIN_GAIN", "KT_DEFRAG_BUDGET", "KT_TENANTS",
        "KT_VERIFY_PERIOD", "KT_POD_BACKOFF_S", "KT_POD_BACKOFF_MAX_S")}
    os.environ.update({
        # Short period: the soak must converge in seconds, not minutes.
        "KT_DEFRAG": "1", "KT_DEFRAG_PERIOD_S": "0.3",
        "KT_DEFRAG_MAX_MIGRATIONS": "4", "KT_DEFRAG_MIN_GAIN": "0.2",
        "KT_DEFRAG_BUDGET": "16",
        # One tenant engages the SolverService, so the defrag probe
        # rides its low-priority submit_background lane (tenant
        # placement) and launches on the card.
        "KT_TENANTS": "default",
        "KT_VERIFY_PERIOD": "0.5",
        "KT_POD_BACKOFF_S": "0.1", "KT_POD_BACKOFF_MAX_S": "1",
    })
    inv0 = _labeled_snapshot(metrics.CACHE_INVARIANT_VIOLATIONS)
    store = MemStore()
    api_srv = serve(store)
    api_url = f"http://127.0.0.1:{api_srv.server_address[1]}"
    direct = APIClient(api_url, qps=0)
    # The scheduler rides through a ChaosProxy so phase B can BLOCK the
    # rebind path (500 every POST /bindings): the kill then provably
    # lands inside the evict->rebind window, not after it.
    proxy = ChaosProxy(api_url).start()

    # Geometry that makes every migration decision exact: 1000m nodes,
    # 300m small pods, 600m large pods.  Packed 3-up (900m) and churned
    # down to 2-up, every node holds 400m free — no large pod fits
    # anywhere, yet one 300m migration clears 700m on its source node.
    direct.create_list("nodes", [
        _node_json(f"df-{i:02d}", milli_cpu=1000, pods=16)
        for i in range(n_nodes)])
    # Two pods on node 0 are PDB-protected with minAvailable=2 — zero
    # disruption headroom, so the rebalancer must route around them.
    direct.create("poddisruptionbudgets", {
        "metadata": {"name": "df-pdb", "namespace": "default"},
        "spec": {"minAvailable": 2, "selector": {"app": "df-prot"}}})

    def small(i: int, j: int) -> dict:
        protected = i == 0 and j < 2
        obj = _pod_json(f"df-s-{i:02d}-{j}", cpu="300m")
        obj["spec"]["nodeName"] = f"df-{i:02d}"
        obj["metadata"]["labels"] = {
            "app": "df-prot" if protected else "df-small"}
        obj["status"] = {"phase": "Running", "conditions": [
            {"type": "Ready", "status": "True"}]}
        return obj

    direct.create_list("pods", [small(i, j) for i in range(n_nodes)
                                for j in range(3)])
    # The biased churn: delete one small pod per node.  Every node now
    # carries a 400m sliver; the fleet has 3200m free and can fit no
    # 600m pod.
    for i in range(n_nodes):
        direct.delete("pods", f"default/df-s-{i:02d}-2")
    dc = DisruptionController(store, sync_period=0.2).run()
    monitor = BindMonitor(store)
    protected = {"default/df-s-00-0", "default/df-s-00-1"}
    pdb_unbinds: list[str] = []
    kill_armed = threading.Event()
    intent_unbound = threading.Event()
    watch_stop = threading.Event()
    watcher = store.watch(["pods"], from_rv=store.list("pods")[1])

    ev_log: list[tuple] = []

    def watch_loop() -> None:
        while not watch_stop.is_set():
            ev = watcher.next(timeout=0.5)
            if ev is None:
                continue
            node = (ev.object.get("spec") or {}).get("nodeName") or ""
            ann = ((ev.object.get("metadata") or {})
                   .get("annotations") or {})
            ev_log.append((round(time.monotonic() - t_start, 2),
                           ev.type, ev.key, node,
                           DEFRAG_MIGRATION_ANNOTATION_KEY in ann))
            if ev.type == "DELETED":
                continue
            if not node and ev.key in protected:
                pdb_unbinds.append(ev.key)
            if not node and DEFRAG_MIGRATION_ANNOTATION_KEY in ann \
                    and kill_armed.is_set():
                intent_unbound.set()

    threading.Thread(target=watch_loop, daemon=True,
                     name="defrag-wave-watch").start()

    factory = factory2 = None
    stats1: dict = {}
    killed_mid_migration = False
    migrations_recovered = intents_cleared = 0
    stranded = -1
    try:
        factory = ConfigFactory(proxy.base_url, qps=5000, burst=5000,
                                device=device)
        factory.daemon.backoff = PodBackoff(default_duration=0.1,
                                            max_duration=1.0)
        factory.run()
        log(f"scheduler up, defrag on ({n_nodes} nodes, "
            f"{n_nodes * 2} small pods, 400m slivers everywhere)")

        # Phase A: two large pods that fit nowhere whole.  The live
        # path: probe marks them blocked, the planner clears a node per
        # pod, the ordinary enqueue->solve->bind path completes each
        # migration, and the settle pass credits the unblocks.
        direct.create_list("pods", [_pod_json(f"df-l-{k}", cpu="600m")
                                    for k in range(n_large - 1)])
        deadline = time.time() + 120
        while time.time() < deadline:
            items, _ = store.list("pods")
            unbound = sum(1 for o in items
                          if not (o.get("spec") or {}).get("nodeName"))
            rep = factory.defrag.report() if factory.defrag else {}
            if unbound == 0 and rep.get("unblocked", 0) >= n_large - 1:
                break
            time.sleep(0.1)
        rep = factory.defrag.report() if factory.defrag else {}
        log(f"phase A settled: {rep.get('migrations_executed', 0)} "
            f"migration(s), {rep.get('unblocked', 0)} unblocked, "
            f"{rep.get('vetoed_pdb', 0)} PDB-vetoed victim(s)")

        # Phase B: block the rebind path, offer one more large pod, and
        # SIGKILL the scheduler the moment a migration's evict lands —
        # the in-flight pod is then pending WITH an intent annotation,
        # exactly the state a crash between the two phases leaves.
        proxy.add_rules([Rule(fault=FAULT_ERROR, method="POST",
                              path=r"/bindings", every_nth=1)])
        kill_armed.set()
        direct.create("pods", _pod_json(f"df-l-{n_large - 1}",
                                        cpu="600m"))
        killed_mid_migration = intent_unbound.wait(timeout=90)
        factory.abandon()
        time.sleep(0.3)  # the abandoned round's _execute drains
        stats1 = factory.defrag.report() if factory.defrag else {}
        log(f"SIGKILLed the scheduler mid-migration "
            f"(caught-in-window={killed_mid_migration}, "
            f"{stats1.get('inflight', 0)} in flight)")
        proxy.clear()

        # The restarted scheduler: startup reconcile must requeue the
        # stranded migrant and clear its intent; the still-on defrag
        # loop finishes whatever rebalancing remains.
        factory2 = ConfigFactory(api_url, qps=5000, burst=5000,
                                 device=device)
        factory2.daemon.backoff = PodBackoff(default_duration=0.1,
                                             max_duration=1.0)
        factory2.run()
        rec = factory2.last_recovery or {}
        migrations_recovered = int(rec.get("migrations_recovered", 0))
        intents_cleared = int(rec.get("migration_intents_cleared", 0))
        log(f"restarted: {migrations_recovered} migration(s) requeued "
            f"by reconcile, {intents_cleared} stale intent(s) cleared")
        deadline = time.time() + 120
        last_dump = time.monotonic()
        while time.time() < deadline:
            items, _ = store.list("pods")
            unbound = [api.key_from_json(o) for o in items
                       if not (o.get("spec") or {}).get("nodeName")]
            intents = sum(
                1 for o in items
                if DEFRAG_MIGRATION_ANNOTATION_KEY in
                ((o.get("metadata") or {}).get("annotations") or {}))
            # Wait for the intent annotations to drain too: the clear
            # rides defrag's NEXT settle tick after the rebind, so
            # measuring at first-converged would flag a false lingerer.
            if not unbound and intents == 0:
                stranded = 0
                break
            if time.monotonic() - last_dump > 10:
                last_dump = time.monotonic()
                free = {(o.get("metadata") or {}).get("name"):
                        int((o.get("status") or {})
                            .get("allocatable", {}).get("cpu", "0m")
                            .rstrip("m"))
                        for o in store.list("nodes")[0]}
                for o in items:
                    nd = (o.get("spec") or {}).get("nodeName")
                    if nd in free:
                        free[nd] -= MemStore._pod_requests(o)[0]
                log(f"settling: unbound={unbound} free_milli={free} "
                    f"defrag={factory2.defrag.report() if factory2.defrag else {}}")
            time.sleep(0.1)
        if stranded < 0:
            items, _ = store.list("pods")
            bad = [api.key_from_json(o) for o in items
                   if not (o.get("spec") or {}).get("nodeName")]
            stranded = len(bad)
            for k in bad:
                log(f"stranded {k} event history: "
                    f"{[e for e in ev_log if e[2] == k]}")
        if factory2.verifier is not None:
            try:  # one forced settled pass so the artifact's invariant
                factory2.verifier.verify_once()  # column is post-moves
            except Exception:  # noqa: BLE001 — wave teardown races
                pass
        stats2 = factory2.defrag.report() if factory2.defrag else {}
    finally:
        watch_stop.set()
        watcher.stop()
        monitor.stop()
        dc.stop()
        for f in (factory, factory2):
            if f is not None:
                try:
                    f.stop()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
        proxy.stop()
        api_srv.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    items, _ = store.list("pods")
    larges_bound = sum(
        1 for o in items
        if o["metadata"]["name"].startswith("df-l-")
        and (o.get("spec") or {}).get("nodeName"))
    lingering_intents = sum(
        1 for o in items
        if DEFRAG_MIGRATION_ANNOTATION_KEY in
        ((o.get("metadata") or {}).get("annotations") or {}))
    migrations_executed = (int(stats1.get("migrations_executed", 0)) +
                           int(stats2.get("migrations_executed", 0)))
    inv_delta = _labeled_delta(metrics.CACHE_INVARIANT_VIOLATIONS, inv0)
    out = {
        "n_nodes": n_nodes,
        "small_pods": n_nodes * 3,
        "churn_deleted": n_nodes,
        "large_pods": n_large,
        "blocked_larges_bound": larges_bound,
        # The ratcheted column: placements unblocked per migration.
        # Every large pod fit nowhere at creation time, so each one
        # bound is a placement only the rebalancer could have made.
        "defrag_gain": round(larges_bound /
                             max(1, migrations_executed), 3),
        "unblocked_credited": int(stats1.get("unblocked", 0)) +
        int(stats2.get("unblocked", 0)),
        "migrations_executed": migrations_executed,
        "migrations_completed":
            int(stats1.get("migrations_completed", 0)) +
            int(stats2.get("migrations_completed", 0)),
        "max_batch": max(int(stats1.get("max_batch", 0)),
                         int(stats2.get("max_batch", 0))),
        "migration_cap": 4,
        "vetoed_budget": int(stats1.get("vetoed_budget", 0)) +
        int(stats2.get("vetoed_budget", 0)),
        "vetoed_pdb": int(stats1.get("vetoed_pdb", 0)) +
        int(stats2.get("vetoed_pdb", 0)),
        "cas_conflicts": int(stats1.get("cas_conflict", 0)) +
        int(stats2.get("cas_conflict", 0)),
        "pdb_violations": len(pdb_unbinds),
        "stranded": stranded,
        "lingering_intents": lingering_intents,
        "double_binds": monitor.double_binds,
        "double_capacity": monitor.double_capacity,
        "monitor_migrations_started": monitor.migrations_started,
        "monitor_migrations_completed": monitor.migrations_completed,
        "invariant_violations": int(sum(inv_delta.values())),
        "invariant_detail": {k: v for k, v in inv_delta.items() if v},
        "killed_mid_migration": bool(killed_mid_migration),
        "migrations_recovered": migrations_recovered,
        "migration_intents_cleared": intents_cleared,
        "duration_s": round(time.monotonic() - t_start, 1),
    }
    log(f"done: gain={out['defrag_gain']} over "
        f"{migrations_executed} migration(s), {stranded} stranded, "
        f"{len(pdb_unbinds)} PDB violations, "
        f"{monitor.double_capacity} double-capacity, "
        f"{migrations_recovered} crash-recovered")
    return out


def _reconcile(store: MemStore, factory, monitor: _BindMonitor) -> dict:
    """Post-soak apiserver-vs-oracle reconciliation: the acceptance
    invariants a mid-drain kill must not break."""
    items, _ = store.list("pods")
    node_names = {o["metadata"]["name"]
                  for o in store.list("nodes")[0]}
    bound = stranded = to_missing = 0
    for o in items:
        phase = (o.get("status") or {}).get("phase", "")
        if phase in ("Succeeded", "Failed"):
            continue
        node = (o.get("spec") or {}).get("nodeName") or ""
        if not node:
            stranded += 1
        else:
            bound += 1
            if node not in node_names:
                to_missing += 1
    orphaned = sum(1 for _k, _n, assumed
                   in factory.algorithm.cache.tracked_pods() if assumed)
    return {"reconciliation": {
        "pods_bound": bound,
        "stranded_pending": stranded,
        "orphaned_assumes": orphaned,
        "double_binds": monitor.double_binds,
        "bound_to_missing_node": to_missing,
    }}


def _restart_parity(store: MemStore, factory, samples: int = 50) -> dict:
    """Post-restart decision parity: the recovered scheduler's choices
    for fresh probe pods vs the pure-Python oracle evaluated on the
    apiserver's truth (the PARITY.json argmax-set-membership rule).  A
    recovery that corrupted the rebuilt cache or resident tensors
    diverges here; 100 % is the acceptance bar."""
    from kubernetes_tpu_torch import oracle
    from kubernetes_tpu_torch.engine.generic_scheduler import FitError
    from kubernetes_tpu_torch.perf.parity import IndexedClusterState
    nodes = [api.node_from_json(o) for o in store.list("nodes")[0]]
    pods = [api.pod_from_json(o) for o in store.list("pods")[0]
            if (o.get("spec") or {}).get("nodeName")]
    cluster = IndexedClusterState(nodes=nodes, pods=pods)
    agree = disagree = 0
    for i in range(samples):
        probe = api.Pod(
            name=f"__parity-{i}", namespace="default",
            containers=[api.Container(
                name="c", requests={"cpu": "50m", "memory": "64Mi"})])
        fits, _ = oracle.find_nodes_that_fit(probe, cluster)
        onames = {n.name for n in fits}
        try:
            choice = factory.algorithm.schedule(probe)
        except FitError:
            choice = None
        if choice is None:
            agree += 0 if onames else 1
            disagree += 1 if onames else 0
            continue
        if choice not in onames:
            disagree += 1
            continue
        scores = oracle.prioritize(probe, cluster)
        best = max(scores[nm] for nm in onames)
        if scores[choice] == best:
            agree += 1
        else:
            disagree += 1
    judged = agree + disagree
    return {"samples": judged,
            "decision_parity_pct": round(100.0 * agree /
                                         max(judged, 1), 2)}


def _wave(rec: dict, name: str, fn, *args, **kw):
    """Run one wave: its wall seconds and the kernels' launches in it
    (this process's, and a scheduler process's where the wave ran one)
    go under ``rec["waves"][name]``; returns what ``fn`` returns."""
    from kubernetes_tpu_torch.perf import harness
    before = harness.kernel_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    launches = harness.launches_since(before)
    # A wave whose scheduler ran as a process reports its launches.
    for k, v in (out.get("daemon_launches") or {}).items():
        launches[k] = launches.get(k, 0) + v
    rec.setdefault("waves", {})[name] = {
        "seconds": round(time.perf_counter() - t0, 3),
        "launches": launches}
    return out


def collect(ha: bool = True, device: str = "cuda", **kw) -> dict:
    """The bench's soak phase entry point, with the device-plane columns
    (per-cause transfer bytes-per-pod, device memory peak) stamped
    around the run — churn is exactly where a resident-state
    invalidation bug turns scatters into silent full re-uploads — and
    the other waves appended as sections (``BENCH_SOAK_HA=0``,
    ``BENCH_SOAK_CAPACITY=0``, ``BENCH_SOAK_TENANCY_POISON=0``,
    ``BENCH_SOAK_KILL=0``, ``BENCH_SOAK_OVERLOAD=0`` and
    ``BENCH_SOAK_DEFRAG=0`` skip one).  ``rec["waves"]`` holds each
    wave's seconds and the kernels' launches in it."""
    from kubernetes_tpu_torch.engine import devicestats
    from kubernetes_tpu_torch.perf import harness
    device = _device(device)
    quiet = kw.get("quiet", False)
    before = devicestats.transfer_snapshot()
    prof_before = harness._profile_snapshot()
    t_prof = time.perf_counter()
    waves: dict = {}
    rec = _wave(waves, "soak", run_soak, device=device, **kw)
    rec["waves"] = waves["waves"]
    after = devicestats.transfer_snapshot()
    # kt-prof over the churn run: the soak is the one window where
    # watch decode + handler dispatch run for minutes, so its per-event
    # costs are the highest-signal wire sample the records carry.
    rec["profile"] = harness.profile_section(
        prof_before, harness._profile_snapshot(),
        time.perf_counter() - t_prof)
    delta = {c: after[c] - before[c] for c in after}
    pods = (rec.get("scale") or {}).get("pods_scheduled_total") or 1
    rec["device"] = {
        "transfer_bytes": delta,
        "bytes_per_pod": {c: round(v / pods, 1)
                          for c, v in delta.items()},
        # Process-lifetime allocator peak at stamp time (transfer
        # bytes are windowed; the peak cannot be).
        "hbm_peak_bytes_process": devicestats.hbm_peak_bytes(),
    }
    if ha and os.environ.get("BENCH_SOAK_HA", "1") != "0":
        rec["ha"] = _wave(rec, "ha", run_ha_wave, quiet=quiet,
                          device=device)
    if os.environ.get("BENCH_SOAK_CAPACITY", "1") != "0":
        # The near-capacity wave: server-side bind capacity validation
        # under deliberate overcommit probes; violations() holds
        # overcommitted_nodes and stranded_pending to 0.
        rec["capacity"] = _wave(rec, "capacity", run_capacity_wave,
                                quiet=quiet, device=device)
    if os.environ.get("BENCH_SOAK_TENANCY_POISON", "1") != "0":
        rec["tenancy_poison"] = _wave(
            rec, "tenancy_poison", run_tenancy_poison_wave, quiet=quiet,
            device=device)
    if os.environ.get("BENCH_SOAK_KILL", "1") != "0":
        # The apiserver-kill wave: crash-consistency of the CONTROL
        # PLANE itself (0 acked-write loss, 0 double-binds).
        rec["apiserver_kill"] = _wave(
            rec, "apiserver_kill", run_apiserver_kill_wave, quiet=quiet,
            device=device)
    if os.environ.get("BENCH_SOAK_OVERLOAD", "1") != "0":
        # The overload wave: APF shedding + the protected lease plane
        # under a 3x-capacity best-effort storm.
        rec["overload"] = _wave(rec, "overload", run_overload_wave,
                                quiet=quiet, device=device)
    if os.environ.get("BENCH_SOAK_DEFRAG", "1") != "0":
        # The defrag wave: continuous rebalancing under biased-churn
        # fragmentation, with a scheduler SIGKILL mid-migration;
        # violations() holds gain > 0 and the zero columns.
        rec["defrag"] = _wave(rec, "defrag", run_defrag_wave,
                              quiet=quiet, device=device)
    # The record-level locktrace columns violations() holds to zero:
    # the main churn run + the HA wave (scraped from the survivor
    # processes) + the tenancy poison wave, all under KT_LOCKTRACE=1.
    main_lt = rec.get("locktrace") or {}
    ha_lt = (rec.get("ha") or {}).get("locktrace") or {}
    tp = rec.get("tenancy_poison") or {}
    rec["locktrace"] = {
        "lock_inversions": int(main_lt.get("lock_inversions", 0)) +
        int(ha_lt.get("lock_inversions", 0)) +
        int(tp.get("lock_inversions", 0)),
        "long_holds": int(main_lt.get("long_holds", 0)) +
        int(ha_lt.get("long_holds", 0)) +
        int(tp.get("long_holds", 0)),
        "waves": {
            "soak": {k: v for k, v in main_lt.items()
                     if k in ("lock_inversions", "long_holds",
                              "acquires")},
            "ha": dict(ha_lt),
            "tenancy_poison": {
                k: tp.get(k, 0)
                for k in ("lock_inversions", "long_holds",
                          "acquires")},
        },
        "inversion_detail": main_lt.get("inversion_detail", []),
        "long_hold_detail": main_lt.get("long_hold_detail", []),
    }
    return rec


def violations(rec: dict) -> list[str]:
    """Every bar the soak record ``rec`` misses, by name; [] when it
    passes them all.  The bars are the JAX package's
    ``tools/check_bench.py`` ``check_soak``, ``check_overload`` and
    ``check_defrag`` rows that need no predecessor record and the HA
    wave's invariant rows of ``check_ha``; the run must end with the
    breaker closed (the engine in mode ``device``).  A section a run
    left out holds no bar."""
    out: list[str] = []
    if rec.get("invariant_violations"):
        out.append(f"{rec['invariant_violations']} resident-state "
                   f"invariant violation(s)")
    recon = rec.get("reconciliation") or {}
    for name in ("double_binds", "stranded_pending", "orphaned_assumes",
                 "bound_to_missing_node"):
        if recon.get(name):
            out.append(f"reconciliation: {recon[name]} {name}")
    depth = rec.get("queue_depth") or {}
    if depth.get("monotonic_growth"):
        out.append(f"steady-state queue depth grew monotonically (slope "
                   f"{depth.get('steady_window_slope_pods_per_s')} "
                   f"pods/s)")
    parity = rec.get("restart_parity") or {}
    if parity and parity.get("decision_parity_pct", 100.0) < 100.0:
        out.append(f"restart parity {parity['decision_parity_pct']}% "
                   f"below 100%")
    gate = rec.get("sanity_gate") or {}
    if gate.get("rejected_binds"):
        out.append(f"{gate['rejected_binds']} pod(s) bound from a "
                   f"gate-rejected solve")
    if "engine_mode_final" in rec and rec["engine_mode_final"] != "device":
        out.append(f"the run ended with the engine in mode "
                   f"{rec['engine_mode_final']!r}, not 'device'")
    lost = rec.get("device_lost_wave") or {}
    if lost and not lost.get("repromoted"):
        out.append("the device-lost wave never re-promoted the card")
    cap = rec.get("capacity") or {}
    if cap.get("overcommitted_nodes"):
        out.append(f"capacity: {cap['overcommitted_nodes']} node(s) "
                   f"overcommitted")
    if cap.get("stranded_pending"):
        out.append(f"capacity: {cap['stranded_pending']} pod(s) "
                   f"stranded")
    tp = rec.get("tenancy_poison") or {}
    if tp and tp.get("bound", 0) < tp.get("offered", 0):
        out.append(f"tenancy poison: bound {tp.get('bound')} of "
                   f"{tp.get('offered')}")
    if tp and not tp.get("repromoted"):
        out.append("tenancy poison: the poisoned tenant was not "
                   "re-promoted")
    lt = rec.get("locktrace") or {}
    if lt.get("lock_inversions"):
        out.append(f"{lt['lock_inversions']} lock-order inversion(s)")
    if lt.get("long_holds"):
        out.append(f"{lt['long_holds']} long lock hold(s)")
    ha = rec.get("ha") or {}
    if ha:
        for name in ("double_binds", "stranded_pending",
                     "invariant_violations"):
            if ha.get(name):
                out.append(f"ha: {ha[name]} {name}")
        took = (ha.get("takeover") or {}).get("takeover_settle_s")
        if took is None:
            out.append("ha: no takeover_settle_s (the kill never ran)")
        elif float(took) > 1.0:
            out.append(f"ha: takeover settled in {took} s (bar: < 1 s)")
    kill = rec.get("apiserver_kill") or {}
    if kill:
        for name in ("acked_writes_lost", "double_binds",
                     "stranded_pending"):
            if kill.get(name):
                out.append(f"apiserver kill: {kill[name]} {name}")
        if not kill.get("killed_mid_avalanche"):
            out.append(f"apiserver kill: the kill did not land "
                       f"mid-avalanche (bound {kill.get('bound_at_kill')}"
                       f", pending {kill.get('pending_at_kill')})")
        if not kill.get("relists"):
            out.append("apiserver kill: 0 reflector relists")
    ov = rec.get("overload") or {}
    if ov:
        if not ov.get("shed_429"):
            out.append("overload: 0 shed 429s")
        for name in ("lease_expiries", "system_rejected",
                     "stranded_pending"):
            if ov.get(name):
                out.append(f"overload: {ov[name]} {name}")
        if ov.get("max_queue_depth", 0) > ov.get("queue_limit", 0):
            out.append(f"overload: queue depth {ov['max_queue_depth']} "
                       f"past its limit {ov.get('queue_limit')}")
        if not ov.get("goodput_pods_per_s"):
            out.append("overload: zero goodput")
        if ov.get("debug_vars_samples", 1) == 0 or \
                ov.get("debug_vars_errors"):
            out.append(f"overload: /debug/vars answered "
                       f"{ov.get('debug_vars_samples')} samples with "
                       f"{ov.get('debug_vars_errors')} errors")
        mult = ov.get("offered_multiple")
        if mult is not None and float(mult) < 3.0:
            out.append(f"overload: offered {mult}x the envelope "
                       f"(bar: >= 3x)")
    df = rec.get("defrag") or {}
    if df:
        if float(df.get("defrag_gain", 0)) <= 0:
            out.append(f"defrag: gain {df.get('defrag_gain')}")
        if not df.get("migrations_executed"):
            out.append("defrag: 0 migrations executed")
        for name in ("pdb_violations", "stranded", "lingering_intents",
                     "double_binds", "double_capacity",
                     "invariant_violations"):
            if df.get(name):
                out.append(f"defrag: {df[name]} {name}")
        cap_n = df.get("migration_cap")
        if cap_n is not None and int(df.get("max_batch", 0)) > int(cap_n):
            out.append(f"defrag: a round of {df['max_batch']} "
                       f"migrations past the cap {cap_n}")
        if not df.get("killed_mid_migration"):
            out.append("defrag: the kill did not land mid-migration")
        if int(df.get("migrations_recovered", 0)) < 1:
            out.append("defrag: the restart's reconcile requeued no "
                       "migrant")
    return out


_REFERENCE_RECORD = "SOAK_r"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--storm-clients"]:
        storm_clients(argv[1], int(argv[2]), int(argv[3]), int(argv[4]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="",
                    help="where the record is written (default "
                         "build/SOAK_<backend>.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: exits non-zero "
                         "without a card; cpu must be asked for)")
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--no-chaos", action="store_true")
    ap.add_argument("--no-device-chaos", action="store_true")
    ap.add_argument("--no-restart", action="store_true")
    ap.add_argument("--no-ha", action="store_true",
                    help="skip the active-active HA wave")
    ap.add_argument("--no-kill", action="store_true",
                    help="skip the apiserver-kill wave")
    ap.add_argument("--no-overload", action="store_true",
                    help="skip the overload wave")
    ap.add_argument("--no-defrag", action="store_true",
                    help="skip the defrag wave")
    opts = ap.parse_args(argv)
    try:
        device = _device(opts.device)
    except RuntimeError as err:
        raise SystemExit(f"soak: {err}")
    out = opts.out or f"build/SOAK_{device.split(':')[0]}.json"
    if os.path.basename(out).startswith(_REFERENCE_RECORD):
        raise SystemExit(f"{os.path.basename(out)} is a record of the JAX "
                         f"package; write this package's record "
                         f"elsewhere (--out)")
    waves: dict = {}
    rec = _wave(waves, "soak", run_soak, n_nodes=opts.nodes,
                duration_s=opts.duration, chaos=not opts.no_chaos,
                device_chaos=not opts.no_device_chaos,
                restart=not opts.no_restart, device=device)
    rec["waves"] = waves["waves"]
    if not opts.no_ha:
        rec["ha"] = _wave(rec, "ha", run_ha_wave, device=device)
    if not opts.no_kill:
        rec["apiserver_kill"] = _wave(rec, "apiserver_kill",
                                      run_apiserver_kill_wave,
                                      device=device)
    if not opts.no_overload:
        rec["overload"] = _wave(rec, "overload", run_overload_wave,
                                device=device)
    if not opts.no_defrag:
        rec["defrag"] = _wave(rec, "defrag", run_defrag_wave,
                              device=device)
    if device.startswith("cuda"):
        from kubernetes_tpu_torch.perf.parity import backend
        rec["card"] = backend(device).get("card")
    missed = violations(rec)
    rec["violations"] = missed
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"wrote {out}: {rec['scale']['pods_scheduled_total']} "
          f"pods over {rec['duration_s']}s, "
          f"{rec['invariant_violations']} invariant violations")
    if missed:
        print(f"soak: FAILED: {'; '.join(missed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

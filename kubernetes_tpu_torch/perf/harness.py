"""Scheduler performance harness on PyTorch — the
``test/component/scheduler/perf`` rig around the port's daemon.

Counterpart of ``kubernetes_tpu/perf/harness.py``.  The reference drives
a real scheduler against an in-process apiserver with fabricated nodes
and pause pods, printing pods-scheduled-per-second until the queue
drains (scheduler_test.go:26-60), plus a ``BenchmarkScheduling`` matrix
over {100, 1000} nodes x {0, 1000} preexisting pods
(scheduler_bench_test.go:24-46).  Here the full daemon (queue -> batched
device solve -> assume -> CAS bind) runs against the in-memory binder
(``density``) or, across a real process boundary, against an apiserver
subprocess over HTTP list/watch/bind (``density_wire``).  Run as ``python
-m kubernetes_tpu_torch.perf.harness [--device cpu]``.

**The route is a setting, not a backend test.**  The reference picks the
drain route by backend: off a TPU it streams 4,096-pod chunks (in
process, and over the wire with a 20 ms formation deadline); on a TPU it
solves the whole burst at once (over the wire with a 3,000 ms window).
On the H100 the one-shot route won both times it was measured, so here
``density`` and ``density_wire`` take ``setting="stream" | "one-shot"``
and record it; ``stream`` (the reference's choice off a TPU) is the
default:

* ``density``: ``stream`` sets ``STREAM_THRESHOLD = 4096`` (every drain
  of 4,096 pods or more streams in 4,096-pod chunks); ``one-shot`` keeps
  the daemon's default (drains of 4,096 pods or more solve in one
  launch).  ``KT_STREAM_CHUNK`` overrides both, as in the reference.
* ``density_wire``: ``stream`` routes every drain through the stream
  path (``STREAM_THRESHOLD = 1``) in chunks of ``min(4096, whole burst)``
  with a 20 ms formation deadline; ``one-shot`` keeps every drain of
  4,096 pods or more on the one-shot route (``STREAM_THRESHOLD =
  2**40``) with the whole burst as the former's target and a 3,000 ms
  deadline.  ``KT_WIRE_CHUNK`` and ``KT_WIRE_ACCUM`` (ms) override.

``density_wire`` runs the native apiserver (``apiserver/native.py``,
built into ``build/``) unless ``KT_NATIVE_APISERVER=0``, then ``python -m
kubernetes_tpu_torch.apiserver``; the result records which.

Left out, and where they come from: ``warm_start_compile_s`` and
``--warm-only`` time the JAX persistent compile cache, which this
package has no counterpart of (torch compiles nothing per shape; the
``nvcc`` library is cached by a hash of its sources, ``engine/
kernels.py``), so the bench reports the one-time library build instead;
``fleet_metrics`` needs the controllers and the hollow kubelet, which
come with the control-plane slice (ROADMAP §A item 8).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from dataclasses import dataclass

from kubernetes_tpu_torch.perf import synth
from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                      SchedulerConfig)

SETTINGS = ("stream", "one-shot")


def _check_setting(setting: str) -> None:
    if setting not in SETTINGS:
        raise ValueError(f"setting must be one of {SETTINGS}, not "
                         f"{setting!r}")


@dataclass
class DensityResult:
    num_nodes: int
    num_pods: int
    elapsed_s: float
    scheduled: int
    pods_per_second: float
    algorithm_ms_per_pod: float
    # Per-stage wall-time breakdown of the timed window (seconds +
    # observation counts), harvested from the stage histogram.
    stages: dict = None
    # Wall time of the pre-clock warm drain (the kernel library's build
    # and load on a first run, then one drain at the batch shape).
    warm_s: float = 0.0
    # Device-plane accounting (engine/devicestats.py): per-cause
    # transfer bytes + bytes-per-pod over the steady-state waves, device
    # memory live/peak, the kernel-build watchdog over the whole
    # measured window (timed drain + waves) and the kernels' launches in
    # the timed drain.
    device: dict = None
    # kt-prof attribution over the timed window: per-component CPU
    # split, unclassified fraction, and per-event wire accounting
    # (profile_section).
    profile: dict = None
    # The route this run took ("stream" or "one-shot") and the daemon
    # knobs that made it.
    setting: str = "stream"
    route: dict = None


def _stage_snapshot() -> dict:
    """Current per-stage (sum_us, count) from the labeled stage
    histogram (kubernetes_tpu_torch.utils.metrics.STAGE_LATENCY)."""
    from kubernetes_tpu_torch.utils.metrics import STAGE_LATENCY
    return {key[0]: (child.sum, child.count)
            for key, child in STAGE_LATENCY.children().items()}


def stage_breakdown(before: dict, after: dict) -> dict:
    """Per-stage wall time accumulated between two snapshots:
    {stage: {"seconds": s, "count": n}} — the answer to *where* a run's
    time went (and, diffed between the density and wire shapes, where the
    wire path loses its gap)."""
    out = {}
    for name, (s1, n1) in sorted(after.items()):
        s0, n0 = before.get(name, (0.0, 0))
        if n1 > n0:
            out[name] = {"seconds": round((s1 - s0) / 1e6, 6),
                         "count": n1 - n0}
    return out


# One regex scrapes BOTH apiservers (Python and native C++): each
# renders Prometheus text with identical serialize family names.
_SER_ROW = re.compile(
    rb'^apiserver_serialize_(seconds|ops)_total\{verb="[A-Z]+"\}'
    rb'\s+([0-9.eE+-]+)', re.M)


def _scrape_serialize(port: int) -> tuple[float, float]:
    """Total serialize (seconds, ops) across verbs from an apiserver
    subprocess's /metrics — the one wire-accounting counter that lives on
    the far side of the process boundary in the wire rig."""
    import http.client
    try:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        c.request("GET", "/metrics")
        body = c.getresponse().read()
        c.close()
    except OSError:
        return 0.0, 0.0
    sec = ops = 0.0
    for kind, val in _SER_ROW.findall(body):
        if kind == b"seconds":
            sec += float(val)
        else:
            ops += float(val)
    return sec, ops


def _profile_snapshot(serialize_port: int = None) -> dict:
    """Cumulative kt-prof + wire-accounting state; the harness diffs two
    of these around a timed window (profile_section).  Forces one sampler
    tick so the window's edges carry fresh per-thread CPU baselines."""
    from kubernetes_tpu_torch.utils import metrics as m
    from kubernetes_tpu_torch.utils import profiler
    prof = profiler.ensure_started()
    if prof is not None:
        prof.sample_once()

    def total(counter):
        return sum(child.value for child in counter.children().values())

    snap = {
        "cpu": prof.snapshot() if prof is not None else None,
        "decode_s": total(m.WATCH_DECODE_SECONDS),
        "decode_n": total(m.WATCH_DECODE_EVENTS),
        "handler_s": total(m.HANDLER_SECONDS),
        "handler_n": total(m.HANDLER_EVENTS),
    }
    if serialize_port is not None:
        snap["ser_s"], snap["ser_n"] = _scrape_serialize(serialize_port)
    else:
        snap["ser_s"] = total(m.APISERVER_SERIALIZE_SECONDS)
        snap["ser_n"] = total(m.APISERVER_SERIALIZE_OPS)
    return snap


def profile_section(before: dict, after: dict, wall_s: float) -> dict:
    """The bench artifact's ``profile`` section: where the window's CPU
    went (kt-prof component split + unclassified fraction) and what each
    wire event cost (decode/handler µs per event, serialize µs per op)."""
    from kubernetes_tpu_torch.utils import profiler
    sec: dict = {"wall_s": round(wall_s, 3)}
    b_cpu, a_cpu = before.get("cpu"), after.get("cpu")
    if b_cpu is not None and a_cpu is not None:
        delta = {c: max(0.0, a_cpu["cpu_seconds"][c]
                        - b_cpu["cpu_seconds"][c])
                 for c in profiler.COMPONENTS}
        total = sum(delta.values())
        sec["enabled"] = True
        sec["samples"] = a_cpu["samples"] - b_cpu["samples"]
        sec["cpu_seconds"] = {c: round(v, 4)
                              for c, v in delta.items() if v > 0}
        if total > 0:
            sec["cpu_fraction"] = {c: round(v / total, 4)
                                   for c, v in delta.items() if v > 0}
            sec["unclassified_fraction"] = round(delta["other"] / total, 4)
        sec["sampler_self_cpu_s"] = round(
            a_cpu["sampler_self_cpu_s"] - b_cpu["sampler_self_cpu_s"], 4)
    else:
        sec["enabled"] = False
    wire: dict = {}
    for name, skey, nkey, per in (
            ("decode", "decode_s", "decode_n", "us_per_event"),
            ("handler", "handler_s", "handler_n", "us_per_event"),
            ("serialize", "ser_s", "ser_n", "us_per_op")):
        d_s = after.get(skey, 0.0) - before.get(skey, 0.0)
        d_n = after.get(nkey, 0) - before.get(nkey, 0)
        if d_n > 0:
            wire[name] = {"seconds": round(d_s, 6), "events": int(d_n),
                          per: round(d_s / d_n * 1e6, 3)}
    if wire:
        sec["wire"] = wire
    return sec


def kernel_launches() -> dict:
    """The kernel wrappers' launch counts so far (each wrapper counts
    the launches of its kernel; none launches on the CPU)."""
    from kubernetes_tpu_torch.engine import fused, scan
    from kubernetes_tpu_torch.ops import combine
    return {"scan_chunk": scan.scan_chunk.launches,
            "select_rows": fused.select_rows.launches,
            "select_hosts": combine.select_hosts.launches}


def launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def _make_daemon(num_nodes: int, profile: str = "uniform",
                 preexisting: int = 0, setting: str = "stream",
                 device: str = "cuda") -> Scheduler:
    _check_setting(setting)
    sched, _ = synth.make_rig(num_nodes, 0, profile=profile, device=device)
    pre = synth.make_pods(preexisting, profile=profile, name_prefix="pre")
    for pod, dest in zip(pre, sched.schedule_batch(pre)):
        if dest is not None:
            pod.node_name = dest
            sched.cache.add_pod(pod)
    daemon = Scheduler(SchedulerConfig(algorithm=sched,
                                       binder=InMemoryBinder(),
                                       async_bind=False))
    from kubernetes_tpu_torch.utils import knobs
    if setting == "stream" and not knobs.get_int("KT_STREAM_CHUNK"):
        # Stream the avalanche in pipelined 4096-pod chunks (the
        # reference's choice off a TPU); "one-shot" keeps the daemon's
        # default, one launch for a drain of 4,096 pods or more.
        daemon.STREAM_THRESHOLD = 4096
    return daemon


def _route(daemon: Scheduler, setting: str) -> dict:
    return {"setting": setting,
            "stream_threshold": daemon.STREAM_THRESHOLD,
            "stream_chunk": daemon.stream_chunk_size(),
            "formation_deadline_ms": round(
                daemon.pipeline.former.deadline_s * 1e3, 3)}


def density(num_nodes: int, num_pods: int, profile: str = "uniform",
            preexisting: int = 0, warm: bool = True,
            quiet: bool = False, steady_waves: int = 3,
            setting: str = "stream", device: str = "cuda") -> DensityResult:
    """Density test (scheduler_test.go:26-60): N pods onto M nodes, full
    daemon path, wall-clock throughput.

    After the timed avalanche, ``steady_waves`` smaller follow-up
    drains run on the SAME rig (each scattering the previous wave's
    dirty rows into the resident mirror) with the kernel-build watchdog
    armed — the steady-state window whose per-cause transfer bytes and
    build count the bench artifact carries."""
    import torch

    from kubernetes_tpu_torch.engine import devicestats
    daemon = _make_daemon(num_nodes, profile, preexisting, setting, device)
    pods = synth.make_pods(num_pods, profile=profile)
    # Steady-wave size: small enough that a wave's dirty-row set stays
    # under the scatter threshold (N/4 rows) on the headline shape.
    # Waves are BEST-EFFORT pods: always placeable even on the fleet
    # the avalanche just filled (the pods-count aggregate still dirties
    # their rows, which is all the scatter window needs), so the
    # failure-explain pass never runs inside the armed window.
    from kubernetes_tpu_torch.api import types as api_types
    wave_n = max(min(num_pods // 40, max(num_nodes // 8, 1)), 1)
    wave_pods = [api_types.Pod(name=f"steady-{i}",
                               namespace="__steady__")
                 for i in range(steady_waves * wave_n)] \
        if steady_waves > 0 else []
    warm_s = 0.0
    alg = daemon.config.algorithm
    cuda = alg.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(alg.device)

    if warm:
        # Build and load the kernel library and run one drain at the
        # batch shape before the clock, routed EXACTLY like the pipeline
        # will route the drain (the reference excludes apiserver warmup
        # the same way).
        from kubernetes_tpu_torch.utils.featuregate import \
            DEFAULT_FEATURE_GATE
        t_warm = time.perf_counter()
        streaming = DEFAULT_FEATURE_GATE.enabled("StreamingDrain") \
            and not alg.extenders
        if streaming and num_pods >= daemon.STREAM_THRESHOLD:
            for _ in alg.schedule_batch_stream(
                    pods, chunk_size=daemon.stream_chunk_size()):
                pass
        elif streaming and num_pods < daemon._PAD_LIMIT:
            bucket = max(1 << (num_pods - 1).bit_length(),
                         daemon.stream_min_bucket)
            for _ in alg.schedule_batch_stream(pods, chunk_size=bucket):
                pass
        else:
            alg.schedule_batch(pods)
        if wave_pods:
            # The steady waves drain through the pipeline's small-drain
            # stream path: run the same pow2 bucket once.  (The port's
            # dirty-row scatter is plain indexing: no program to warm.)
            bucket = max(1 << (wave_n - 1).bit_length(),
                         daemon.stream_min_bucket)
            for _ in alg.schedule_batch_stream(wave_pods[:wave_n],
                                               chunk_size=bucket):
                pass
        sync()
        warm_s = time.perf_counter() - t_warm
    for pod in pods:
        daemon.enqueue(pod)
    stages_before = _stage_snapshot()
    prof_before = _profile_snapshot()
    t_prof = time.perf_counter()
    with devicestats.watchdog_window() as compiles:
        launches0 = kernel_launches()
        start = time.perf_counter()
        popped = daemon.schedule_pending(wait_first=False)
        daemon.wait_for_binds()
        sync()
        elapsed = time.perf_counter() - start
        launches = launches_since(launches0)
        device_cols = _steady_state_device_window(daemon, wave_pods,
                                                  wave_n, quiet=quiet)
    device_cols["post_prewarm_compiles"] = compiles()
    device_cols["launches"] = launches
    # Device fault-tolerance columns: a density run must end with the
    # breaker closed and zero sanity-gate-rejected binds.
    from kubernetes_tpu_torch.utils import metrics as metrics_mod
    device_cols["engine_mode_final"] = alg.guard.mode
    device_cols["sanity_rejected_binds"] = \
        int(metrics_mod.GATE_REJECTED_BINDS.value)
    stages = stage_breakdown(stages_before, _stage_snapshot())
    # Profile window = timed drain + steady waves (the same span the
    # device columns cover); in-process rig, so serialize stays local.
    profile_sec = profile_section(prof_before, _profile_snapshot(),
                                  time.perf_counter() - t_prof)
    scheduled = daemon.config.binder.count() - \
        device_cols.pop("_steady_bound")
    route = _route(daemon, setting)
    daemon.stop()
    if not quiet:
        print(f"density {num_nodes} nodes x {num_pods} pods ({setting}): "
              f"{scheduled} scheduled in {elapsed:.3f}s = "
              f"{scheduled / elapsed:,.0f} pods/s", file=sys.stderr)
    assert popped == num_pods
    return DensityResult(
        num_nodes=num_nodes, num_pods=num_pods, elapsed_s=elapsed,
        scheduled=scheduled, pods_per_second=scheduled / elapsed,
        algorithm_ms_per_pod=elapsed / max(scheduled, 1) * 1e3,
        stages=stages, warm_s=warm_s, device=device_cols,
        profile=profile_sec, setting=setting, route=route)


def _steady_state_device_window(daemon, wave_pods: list, wave_n: int,
                                quiet: bool = False) -> dict:
    """Drive the steady-state waves and account the device plane over
    them.  The FIRST wave is a settling drain (it absorbs the avalanche's
    whole-cluster dirty set, legitimately a full upload) and is excluded;
    the measured window covers the remaining waves, whose dirty sets are
    one wave each — the window where scatter bytes must dominate."""
    from kubernetes_tpu_torch.engine import devicestats
    bound_before = daemon.config.binder.count()
    waves = [wave_pods[i:i + wave_n]
             for i in range(0, len(wave_pods), wave_n)]
    transfers_before = None
    for i, wave in enumerate(waves):
        if i == 1:
            transfers_before = devicestats.transfer_snapshot()
        for pod in wave:
            daemon.enqueue(pod)
        daemon.schedule_pending(wait_first=False)
        daemon.wait_for_binds()
        devicestats.sample_hbm()
    if transfers_before is None:  # 0 or 1 waves: nothing steady to measure
        transfers_before = devicestats.transfer_snapshot()
    after = devicestats.transfer_snapshot()
    delta = {c: after[c] - transfers_before[c] for c in after}
    steady_pods = max(sum(len(w) for w in waves[1:]), 1) \
        if len(waves) > 1 else 1
    device = {
        "transfer_bytes": delta,
        "bytes_per_pod": {c: round(v / steady_pods, 1)
                          for c, v in delta.items()},
        "steady_pods": steady_pods if len(waves) > 1 else 0,
        "scatter_dominates":
            delta["scatter"] > delta["full_upload"],
        "hbm_live_bytes": devicestats.hbm_live_bytes(),
        "hbm_peak_bytes": devicestats.hbm_peak_bytes(),
        "_steady_bound": daemon.config.binder.count() - bound_before,
    }
    if not quiet and len(waves) > 1:
        print(f"steady-state device window ({len(waves) - 1} waves x "
              f"{wave_n} pods): {delta} "
              f"scatter_dominates={device['scatter_dominates']}",
              file=sys.stderr)
    return device


class ZeroBoundError(RuntimeError):
    """A wire run bound NOTHING before the stall detector fired — a
    rig/daemon fault, not a throughput sample: the run fails loudly and
    the bench counts it as a failed run instead of a sample."""


@dataclass
class WireDensityResult:
    num_nodes: int
    num_pods: int
    elapsed_s: float          # first pod POST -> last pod bound
    scheduled: int
    pods_per_second: float
    create_s: float           # time to POST all pods (overlaps scheduling)
    warm_s: float             # daemon-side warmup before the clock
    # (elapsed_s, bound_count) samples every poll tick — the bind-progress
    # timeline, for diagnosing where a wire run's time goes.
    timeline: list = None
    # Per-stage wall-time breakdown (daemon-side stages of the timed
    # window; apiserver-side time shows up as bind wall time).
    stages: dict = None
    # Where the pre-clock warm wall went: the pre-intern compile plus
    # prewarm's per-key {builds, seconds} (scheduler.prewarm_cache_stats).
    warm_breakdown: dict = None
    # kt-prof attribution over the wire window: component CPU split plus
    # decode/handler µs per event (daemon side) and serialize µs per op
    # (scraped from the apiserver subprocess's /metrics — the Python and
    # the native server alike).
    profile: dict = None
    setting: str = "stream"
    route: dict = None
    apiserver: str = ""       # "native" or "python"
    # The kernels' launches and the kernel builds in the timed window.
    launches: dict = None
    post_prewarm_compiles: int = 0
    # {path: [status, content type]} of the daemon status-mux routes
    # fetched during the timed window (``status_routes``).
    status_routes: dict = None


def _wire_route(daemon, setting: str, num_pods: int) -> None:
    """Apply a wire setting to a daemon (module docstring)."""
    from kubernetes_tpu_torch.utils import knobs
    whole = (num_pods + 2047) // 2048 * 2048
    if setting == "stream":
        daemon.STREAM_THRESHOLD = 1
        chunk, accum_ms = min(4096, whole), 20.0
    else:
        daemon.STREAM_THRESHOLD = 1 << 40
        chunk, accum_ms = whole, 3000.0
    daemon.stream_chunk = knobs.get_int("KT_WIRE_CHUNK", default=chunk)
    daemon.pipeline.former.deadline_s = knobs.get_float(
        "KT_WIRE_ACCUM", default=accum_ms) / 1e3
    # Start the adaptive target at the wire chunk rather than the
    # serving default of growing up from the floor bucket.
    daemon.pipeline.former._target = daemon.stream_chunk_size()


def _get(port: int, path: str) -> tuple[int, str]:
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", path)
        r = c.getresponse()
        r.read()
        return r.status, r.getheader("Content-Type", "")
    finally:
        c.close()


def density_wire(num_nodes: int, num_pods: int, profile: str = "uniform",
                 qps: float = 5000.0, burst: int = 5000,
                 creators: int = 4, quiet: bool = False,
                 timeout_s: float = 900.0, setting: str = "stream",
                 device: str = "cuda",
                 status_routes: tuple = ()) -> WireDensityResult:
    """The density rig across a REAL process boundary: the apiserver runs
    as a separate process, the daemon in this process joins it over HTTP
    list/watch/bind at QPS/Burst — the reference's rig shape (util.go:
    46-74 binds through a real apiserver; client QPS/Burst 5000,
    util.go:63-64).  Pods are created by parallel keep-alive connections
    like makePodsFromRC's 30-way creation (util.go:85-170); the clock runs
    from the first pod POST until every pod is bound.

    ``status_routes`` names daemon status-mux paths (``scheduler/
    __main__.status_mux``) to fetch once the pods are created, while the
    daemon drains; their statuses and content types land in the result."""
    import http.client
    import os as _os
    import socket
    import subprocess
    import threading

    from kubernetes_tpu_torch.apiserver import native
    from kubernetes_tpu_torch.engine import devicestats
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    from kubernetes_tpu_torch.utils import knobs

    _check_setting(setting)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # The native (C++) apiserver unless KT_NATIVE_APISERVER=0: the
    # reference's rig runs a compiled Go apiserver.  A failed native
    # build raises (native.NativeBuildError); nothing falls back.
    apiserver = "native" if knobs.get_bool("KT_NATIVE_APISERVER") \
        else "python"
    proc = subprocess.Popen(
        native.server_command(port), env=dict(_os.environ),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def conn() -> http.client.HTTPConnection:
        return http.client.HTTPConnection("127.0.0.1", port, timeout=30)

    factory = mux = None
    try:
        # Wait for the apiserver socket.
        deadline = time.time() + 30
        while True:
            try:
                c0 = conn()
                c0.request("GET", "/healthz")
                c0.getresponse().read()
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise RuntimeError("apiserver never came up") from None
                time.sleep(0.1)

        from kubernetes_tpu_torch.api.types import node_to_json, pod_to_json
        nodes = synth.make_nodes(num_nodes, profile=profile, n_zones=4)
        # Batch creates (a v1 List body): same admission/validation per
        # item server-side, ~1000x fewer requests through the framing
        # layer than one POST per object.
        for i in range(0, len(nodes), 1000):
            c0.request("POST", "/api/v1/nodes", json.dumps(
                {"kind": "List",
                 "items": [node_to_json(nd) for nd in nodes[i:i + 1000]]}),
                {"Content-Type": "application/json"})
            r = c0.getresponse()
            body = json.loads(r.read() or b"{}")
            if r.status != 200 or body.get("created") != \
                    len(nodes[i:i + 1000]):
                raise RuntimeError(f"node batch create failed: {r.status} "
                                   f"{body}")

        factory = ConfigFactory(f"http://127.0.0.1:{port}",
                                qps=qps, burst=burst, device=device).run()
        daemon = factory.daemon
        _wire_route(daemon, setting, num_pods)
        if status_routes:
            from kubernetes_tpu_torch.scheduler.__main__ import status_mux
            mux = status_mux(factory, {"enableProfiling": True}, 0)

        # Warm before the clock (the reference excludes apiserver warmup
        # the same way); the warm cost is reported, and attributed.
        t_warm = time.perf_counter()
        pods = synth.make_pods(num_pods, profile=profile)
        # Pre-intern the LIVE pod set's vocabulary (ports/volumes/taints/
        # labels) before the ladder runs, so capacities never grow on
        # the clock.
        factory.algorithm._compile(pods)
        t_intern = time.perf_counter() - t_warm
        # Run the bucket ladder (floor -> wire chunk): the arrival race
        # can legally drain any ladder bucket.
        warm_pods = synth.make_pods(
            min(num_pods, 2 * daemon.stream_chunk_size()),
            profile=profile, name_prefix="warm")
        daemon.prewarm(sample_pods=warm_pods)
        warm_s = time.perf_counter() - t_warm
        warm_breakdown = {
            "pre_intern_s": round(t_intern, 3),
            "prewarm": {str(k): v for k, v in
                        daemon.prewarm_cache_stats.items()},
        }

        pod_jsons = [pod_to_json(pod) for pod in pods]
        # Pre-serialize the batch bodies BEFORE the clock (makePodsFromRC
        # builds its pod objects up front the same way): during the run
        # the creator threads only move bytes.
        bodies = [json.dumps({"kind": "List",
                              "items": pod_jsons[i:i + 1000]}).encode()
                  for i in range(0, len(pod_jsons), 1000)]
        expected = [len(pod_jsons[i:i + 1000])
                    for i in range(0, len(pod_jsons), 1000)]

        stages_before = _stage_snapshot()
        prof_before = _profile_snapshot(serialize_port=port)
        builds_before = devicestats.post_prewarm_compiles()
        launches0 = kernel_launches()
        bound0 = daemon.config.metrics.binding_latency.count
        start = time.perf_counter()
        chunks = list(zip(bodies, expected))
        shards = [chunks[i::creators] for i in range(creators)]
        create_failures: list[str] = []

        def create(shard):
            c = conn()
            for body, n_items in shard:
                c.request("POST", "/api/v1/pods", body,
                          {"Content-Type": "application/json"})
                r = c.getresponse()
                resp_body = r.read()
                if r.status != 200:
                    create_failures.append(
                        f"{r.status}: {resp_body[:200]!r}")
                    continue
                res = json.loads(resp_body or b"{}")
                if res.get("created") != n_items:
                    bad = [x for x in res.get("results", [])
                           if x.get("code") != 201]
                    create_failures.append(
                        f"batch created {res.get('created')}/{n_items}"
                        f"; first error: {bad[0] if bad else '?'}")

        threads = [threading.Thread(target=create, args=(sh,), daemon=True)
                   for sh in shards]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if create_failures:
            raise RuntimeError(
                f"{len(create_failures)} pod creates failed; first: "
                f"{create_failures[0]}")
        create_s = time.perf_counter() - start
        routes = {path: list(_get(mux.server_address[1], path))
                  for path in status_routes}

        # Poll the daemon-side bind metric until the queue drains; also
        # stop when binding makes no progress for a stall window.
        deadline = time.time() + timeout_s
        bound = 0
        last_change = time.perf_counter()
        stalled = False
        timeline: list[tuple[float, int]] = []
        # No-progress stall window: must exceed the longest legitimate
        # bind-silent stretch (a whole-burst chunk binds nothing until
        # its scan ends).
        stall_window = 15.0 if daemon.stream_chunk_size() < num_pods \
            else max(30.0, timeout_s / 6)

        def bound_now() -> int:
            return daemon.config.metrics.binding_latency.count - bound0

        while time.time() < deadline:
            now_bound = bound_now()
            timeline.append((round(time.perf_counter() - start, 4),
                             now_bound))
            if now_bound != bound:
                bound = now_bound
                last_change = time.perf_counter()
            if bound >= num_pods:
                break
            if time.perf_counter() - last_change > stall_window:
                stalled = True
                break
            time.sleep(0.01)
        daemon.wait_for_binds()
        # On a stall exit the clock stops at the LAST bind, not at stall
        # detection — the tail is idle requeue time of unschedulable pods.
        elapsed = (last_change if stalled else time.perf_counter()) - start
        bound = bound_now()
        launches = launches_since(launches0)
        # Profile edge BEFORE tearing the rig down: the serialize side
        # lives in the apiserver subprocess and dies with it.
        profile_sec = profile_section(
            prof_before, _profile_snapshot(serialize_port=port), elapsed)
        if bound == 0:
            # A zero-bound run is a rig fault, never a sample.
            raise ZeroBoundError(
                f"density-wire bound 0/{num_pods} pods before the "
                f"{stall_window:.0f}s stall window (create "
                f"{create_s:.1f}s, warm {warm_s:.1f}s) — daemon never "
                f"drained")
        if not quiet:
            print(f"density-wire {num_nodes} nodes x {num_pods} pods "
                  f"({setting}, {apiserver} apiserver): {bound} bound in "
                  f"{elapsed:.3f}s = {bound / max(elapsed, 1e-9):,.0f} "
                  f"pods/s (create {create_s:.1f}s, warm {warm_s:.1f}s)",
                  file=sys.stderr)
        return WireDensityResult(
            num_nodes=num_nodes, num_pods=num_pods, elapsed_s=elapsed,
            scheduled=int(bound),
            pods_per_second=int(bound) / max(elapsed, 1e-9),
            create_s=create_s, warm_s=warm_s, timeline=timeline,
            stages=stage_breakdown(stages_before, _stage_snapshot()),
            warm_breakdown=warm_breakdown, profile=profile_sec,
            setting=setting, route=_route(daemon, setting),
            apiserver=apiserver, launches=launches,
            post_prewarm_compiles=devicestats.post_prewarm_compiles()
            - builds_before,
            status_routes=routes)
    finally:
        # Stop the daemon's reflector/scheduler threads on EVERY exit path
        # (left running they'd relist-spin against the dead apiserver).
        if mux is not None:
            mux.shutdown()
            mux.server_close()
        if factory is not None:
            factory.stop()
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


BENCH_MATRIX = ((100, 0), (100, 1000), (1000, 0), (1000, 1000))


def benchmark_scheduling(num_pods: int = 1000, matrix=BENCH_MATRIX,
                         setting: str = "stream",
                         device: str = "cuda") -> list[DensityResult]:
    """BenchmarkScheduling (scheduler_bench_test.go:24-46): ns/op over the
    {nodes} x {preexisting} matrix."""
    results = []
    for num_nodes, preexisting in matrix:
        r = density(num_nodes, num_pods, preexisting=preexisting,
                    setting=setting, device=device)
        print(f"BenchmarkScheduling/{num_nodes}-nodes/"
              f"{preexisting}-pods: {r.elapsed_s / num_pods * 1e9:,.0f} "
              f"ns/op", file=sys.stderr)
        results.append(r)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--profile", default="uniform",
                    choices=["uniform", "mixed"])
    ap.add_argument("--preexisting", type=int, default=0)
    ap.add_argument("--setting", default="stream", choices=SETTINGS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked "
                         "for)")
    ap.add_argument("--bench-matrix", action="store_true",
                    help="run the BenchmarkScheduling matrix instead")
    opts = ap.parse_args(argv)
    if opts.bench_matrix:
        results = benchmark_scheduling(setting=opts.setting,
                                       device=opts.device)
        print(json.dumps([r.__dict__ for r in results]))
    else:
        r = density(opts.nodes, opts.pods, profile=opts.profile,
                    preexisting=opts.preexisting, setting=opts.setting,
                    device=opts.device)
        print(json.dumps(r.__dict__))


if __name__ == "__main__":
    main()

"""Serving-path latency bench: per-decision submit->bind SLOs under
production-shaped arrival processes.

Counterpart of ``kubernetes_tpu/perf/serving.py`` on the port's daemon
(``device=``, default ``cuda``).  A throughput bench throws a single
avalanche at the solver; a control plane serving many users sees a
TRICKLE of single-pod arrivals punctuated by deployment and failover
BURSTS, and what matters per pod is the submit->bind latency while
batches form.  This harness drives the FULL daemon over the HTTP rig
(MemStore -> HTTP apiserver thread -> ConfigFactory joined by
list/watch/bind) with three open-loop arrival processes (arrivals follow
their schedule whatever the daemon does):

* ``poisson_trickle`` — memoryless single-pod arrivals at a fixed rate,
  the steady-state serving workload the SLO is declared against;
* ``burst_replay``   — a RECORDED burst trace (deployment-rollout
  cadence: irregular waves of 50-400 pods) replayed deterministically;
* ``ramp``           — arrival rate growing linearly, the failover
  pile-on shape that exercises the batch former's adaptive target.

The generators give the JAX package's arrival times exactly for the same
seed.  Submit time is stamped at the load generator's create POST; bind
time comes from a nodeName-transition watch on the store (delivered
synchronously under the store lock, so no event is missed).  Per
workload the record reports the per-decision latency distribution
(p50/p90/p99/max), SLO attainment against the declared per-row SLO and
its floor, p99-vs-deadline, goodput, and the former's formation/
deadline-miss counters.

Run: ``python -m kubernetes_tpu_torch.perf.serving --out
build/SERVING_cuda.json [--device cpu]``.
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
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.perf.parity import (backend,
                                              refuse_reference_artifact)
from kubernetes_tpu_torch.utils import metrics

# The serving deadline the artifact declares (KT_BATCH_DEADLINE_MS for
# the daemon under test) and the default per-row SLOs.  The SLO is
# deliberately a multiple of the deadline: a decision pays up to one
# deadline of batch formation plus the solve and the bind round-trip.
DEFAULT_DEADLINE_MS = 100.0
TRICKLE_SLO_MS = 1000.0
BURST_SLO_MS = 5000.0

# The recorded burst trace: (offset_s, pods) waves with the irregular
# cadence of a churn soak's rolling-update/storm phases (a big storm
# front, decaying aftershocks, then rolling waves) — the JAX package's
# trace, value for value.  Replayed verbatim so burst rows are
# comparable across records.
RECORDED_BURST_TRACE: tuple = (
    (0.0, 400), (0.3, 250), (0.7, 150), (1.2, 100),
    (2.5, 300), (2.8, 200), (3.4, 100),
    (5.0, 250), (5.6, 250),
    (7.5, 200), (8.1, 150), (8.9, 100),
    (10.4, 150), (11.2, 100),
)


def poisson_arrivals(rate_pods_s: float, duration_s: float,
                     seed: int = 7) -> list[tuple[float, int]]:
    """Single-pod arrival events with exponential gaps (a Poisson
    process), deterministic per seed."""
    rng = np.random.RandomState(seed)
    events = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_pods_s))
        if t >= duration_s:
            return events
        events.append((t, 1))


def burst_arrivals(trace=None, scale: float = 1.0
                   ) -> list[tuple[float, int]]:
    """The recorded burst trace (optionally scaled in pod count)."""
    trace = RECORDED_BURST_TRACE if trace is None else trace
    return [(t, max(int(n * scale), 1)) for t, n in trace]


def ramp_arrivals(rate0: float, rate1: float, duration_s: float,
                  tick_s: float = 0.25) -> list[tuple[float, int]]:
    """Arrival rate ramping linearly rate0 -> rate1 over the window,
    emitted as per-tick batches (the failover pile-on shape)."""
    events = []
    t = 0.0
    while t < duration_s:
        rate = rate0 + (rate1 - rate0) * (t / duration_s)
        n = int(round(rate * tick_s))
        if n > 0:
            events.append((t, n))
        t += tick_s
    return events


def load_trace(path: str) -> list[tuple[float, int]]:
    """A burst trace from a JSON file: [[offset_s, pods], ...]."""
    with open(path) as f:
        return [(float(t), int(n)) for t, n in json.load(f)]


class _BindTimer:
    """Per-pod bind timestamps off the store's own watch stream (the
    soak monitor's delivery guarantee: synchronous under the store lock
    into an unbounded queue, so no transition is missed)."""

    def __init__(self, store: MemStore):
        self.bound_at: dict[str, float] = {}
        self._stopped = threading.Event()
        self._watcher = store.watch(["pods"],
                                    from_rv=store.list("pods")[1])
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="serving-bind-timer")
        self._thread.start()

    def _pump(self) -> None:
        while not self._stopped.is_set():
            ev = self._watcher.next(timeout=0.5)
            if ev is None:
                continue
            if ev.type == "DELETED":
                continue
            node = (ev.object.get("spec") or {}).get("nodeName") or ""
            if node and ev.key not in self.bound_at:
                self.bound_at[ev.key] = time.perf_counter()

    def stop(self) -> None:
        self._stopped.set()
        self._watcher.stop()


def _node_json(name: str) -> dict:
    return {"metadata": {"name": name,
                         "labels": {api.HOSTNAME_LABEL: name}},
            "status": {"allocatable": {"cpu": "16000m",
                                       "memory": str(64 * 1024 ** 3),
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}}


def _pod_json(name: str) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": "50m", "memory": "64Mi"}}}]}}


def _percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def run_workload(name: str, events: list[tuple[float, int]],
                 n_nodes: int = 500, deadline_ms: float = DEFAULT_DEADLINE_MS,
                 slo_ms: float = TRICKLE_SLO_MS,
                 attainment_floor_pct: float = 99.0,
                 stream_chunk: int = 2048, settle_timeout: float = 240.0,
                 quiet: bool = False, device: str = "cuda") -> dict:
    """Drive one arrival process against a fresh full-daemon HTTP rig;
    returns the artifact row."""
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory

    total_pods = sum(n for _, n in events)
    store = MemStore()
    api_srv = serve(store)
    api_url = f"http://127.0.0.1:{api_srv.server_address[1]}"
    direct = APIClient(api_url, qps=0)
    for i in range(0, n_nodes, 1000):
        direct.create_list("nodes", [_node_json(f"vn-{j:05d}")
                                     for j in range(i, min(i + 1000,
                                                           n_nodes))])
    saved_env = {k: os.environ.get(k)
                 for k in ("KT_PREWARM", "KT_BATCH_DEADLINE_MS")}
    os.environ["KT_PREWARM"] = "1"
    os.environ["KT_BATCH_DEADLINE_MS"] = str(deadline_ms)
    factory = None
    timer = _BindTimer(store)
    misses0 = metrics.BATCH_DEADLINE_MISSES.value
    formation0 = metrics.BATCH_FORMATION_LATENCY.count
    try:
        factory = ConfigFactory(api_url, qps=5000, burst=5000,
                                device=device)
        daemon = factory.daemon
        daemon.STREAM_THRESHOLD = stream_chunk
        daemon.stream_chunk = stream_chunk
        factory.run()

        submit_at: dict[str, float] = {}
        seq = [0]
        t_start = time.perf_counter()
        for offset, n in events:
            now = time.perf_counter() - t_start
            if offset > now:
                time.sleep(offset - now)
            names = []
            for _ in range(n):
                seq[0] += 1
                names.append(f"sv-{seq[0]:06d}")
            t_submit = time.perf_counter()
            if n == 1:
                direct.create("pods", _pod_json(names[0]))
            else:
                direct.create_list("pods",
                                   [_pod_json(nm) for nm in names])
            for nm in names:
                submit_at[f"default/{nm}"] = t_submit
        submitted_s = time.perf_counter() - t_start

        deadline = time.time() + settle_timeout
        while time.time() < deadline and \
                len(timer.bound_at) < total_pods:
            time.sleep(0.05)
        lat_ms = []
        unbound = 0
        for key, t0 in submit_at.items():
            t1 = timer.bound_at.get(key)
            if t1 is None:
                unbound += 1
            else:
                lat_ms.append((t1 - t0) * 1e3)
        attained = sum(1 for v in lat_ms if v <= slo_ms)
        attainment = 100.0 * attained / max(total_pods, 1)
        span_s = (max(timer.bound_at.values()) -
                  min(submit_at.values())) if lat_ms else 0.0
        p99 = _percentile(lat_ms, 99)
        row = {
            "arrival": name,
            "nodes": n_nodes,
            "pods": total_pods,
            "bound": len(lat_ms),
            "unbound": unbound,
            "arrival_window_s": round(submitted_s, 2),
            "latency_ms": {
                "p50": round(_percentile(lat_ms, 50), 1),
                "p90": round(_percentile(lat_ms, 90), 1),
                "p99": round(p99, 1),
                "max": round(max(lat_ms), 1) if lat_ms else 0.0,
            },
            "slo": {
                "slo_ms": slo_ms,
                "attainment_pct": round(attainment, 2),
                "attainment_floor_pct": attainment_floor_pct,
            },
            "deadline_ms": deadline_ms,
            "p99_vs_deadline": round(p99 / max(deadline_ms, 1e-9), 2),
            "goodput_pods_s": round(len(lat_ms) / max(span_s, 1e-9), 1),
            "deadline_misses":
                metrics.BATCH_DEADLINE_MISSES.value - misses0,
            "batches_formed":
                metrics.BATCH_FORMATION_LATENCY.count - formation0,
        }
        if not quiet:
            print(f"serving[{name}] {total_pods} pods: p50 "
                  f"{row['latency_ms']['p50']}ms p99 "
                  f"{row['latency_ms']['p99']}ms attainment "
                  f"{attainment:.2f}% goodput "
                  f"{row['goodput_pods_s']} pods/s", file=sys.stderr)
        return row
    finally:
        timer.stop()
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


def collect(n_nodes: int = 500, deadline_ms: float = DEFAULT_DEADLINE_MS,
            trickle_rate: float = 50.0, trickle_s: float = 20.0,
            burst_scale: float = 1.0, burst_trace: str = "",
            quiet: bool = False, device: str = "cuda") -> dict:
    """The bench's serving phase: all three arrival rows as one record
    payload."""
    from kubernetes_tpu_torch.engine import devicestats
    transfers_before = devicestats.transfer_snapshot()
    compiles_before = devicestats.post_prewarm_compiles()
    trace = load_trace(burst_trace) if burst_trace else None
    rows = {
        "poisson_trickle": run_workload(
            "poisson", poisson_arrivals(trickle_rate, trickle_s),
            n_nodes=n_nodes, deadline_ms=deadline_ms,
            slo_ms=TRICKLE_SLO_MS, attainment_floor_pct=99.0,
            quiet=quiet, device=device),
        "burst_replay": run_workload(
            "burst_replay", burst_arrivals(trace, scale=burst_scale),
            n_nodes=n_nodes, deadline_ms=deadline_ms,
            slo_ms=BURST_SLO_MS, attainment_floor_pct=95.0,
            quiet=quiet, device=device),
        "ramp": run_workload(
            "ramp", ramp_arrivals(10.0, 200.0, 10.0),
            n_nodes=n_nodes, deadline_ms=deadline_ms,
            slo_ms=BURST_SLO_MS, attainment_floor_pct=95.0,
            quiet=quiet, device=device),
    }
    after = devicestats.transfer_snapshot()
    delta = {c: after[c] - transfers_before[c] for c in after}
    bound = sum((row.get("bound") or row.get("pods") or 0)
                for row in rows.values()) or 1
    return {
        "harness": "kubernetes_tpu_torch/perf/serving.py (full daemon "
                   "over HTTP: Poisson trickle + recorded burst replay + "
                   "ramp, per-decision submit->bind latency vs a "
                   "declared SLO)",
        **backend(device),
        "deadline_ms": deadline_ms,
        "trickle": {"rate_pods_s": trickle_rate,
                    "duration_s": trickle_s},
        "workloads": rows,
        # Device telemetry columns over the whole serving run (a
        # trickle whose drains full-upload, or build a kernel, is
        # burning its latency budget on the device side).
        "device": {
            "transfer_bytes": delta,
            "bytes_per_pod": {c: round(v / bound, 1)
                              for c, v in delta.items()},
            # Process-lifetime allocator peak at stamp time (transfer
            # bytes ARE windowed via the snapshot delta above).
            "hbm_peak_bytes_process": devicestats.hbm_peak_bytes(),
            "post_prewarm_compiles":
                devicestats.post_prewarm_compiles() - compiles_before,
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/SERVING_cuda.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=500)
    ap.add_argument("--deadline-ms", type=float,
                    default=DEFAULT_DEADLINE_MS)
    ap.add_argument("--trickle-rate", type=float, default=50.0)
    ap.add_argument("--trickle-s", type=float, default=20.0)
    ap.add_argument("--burst-trace", default="",
                    help="JSON [[offset_s, pods], ...] replacing the "
                         "recorded default trace")
    opts = ap.parse_args(argv)
    refuse_reference_artifact(opts.out, "SERVING_r08.json")
    rec = collect(n_nodes=opts.nodes, deadline_ms=opts.deadline_ms,
                  trickle_rate=opts.trickle_rate,
                  trickle_s=opts.trickle_s,
                  burst_trace=opts.burst_trace, device=opts.device)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    t = rec["workloads"]["poisson_trickle"]
    print(f"wrote {opts.out}: trickle p99 {t['latency_ms']['p99']}ms, "
          f"attainment {t['slo']['attainment_pct']}%")


if __name__ == "__main__":
    main()

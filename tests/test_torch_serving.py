"""The port's serving harness (``kubernetes_tpu_torch/perf/serving.py``)
against the JAX package's, on the CPU.

The arrival generators (Poisson trickle, the recorded burst trace, the
ramp, a trace file) give the JAX package's arrival times and pod counts
exactly for the same seeds and parameters.  A serving smoke drives the
port's full daemon over HTTP (an in-process apiserver thread, the
daemon joined by list/watch/bind, KT_PREWARM on) with a short open-loop
trickle on the CPU: every pod binds, the row carries the JAX package's
keys, and its latency distribution is ordered and positive."""

from __future__ import annotations

import json

import pytest

from kubernetes_tpu.perf import serving as ref_serving
from kubernetes_tpu_torch.perf import serving


@pytest.mark.parametrize("rate,duration,seed", [
    (50.0, 20.0, 7), (5.0, 3.0, 0), (200.0, 1.5, 123)])
def test_poisson_arrivals_equal_the_reference(rate, duration, seed):
    got = serving.poisson_arrivals(rate, duration, seed=seed)
    assert got == ref_serving.poisson_arrivals(rate, duration, seed=seed)
    assert got and all(n == 1 for _, n in got)
    assert all(a[0] < b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("scale", [1.0, 0.1, 2.5])
def test_burst_and_ramp_arrivals_equal_the_reference(scale):
    assert serving.RECORDED_BURST_TRACE == ref_serving.RECORDED_BURST_TRACE
    assert serving.burst_arrivals(scale=scale) == \
        ref_serving.burst_arrivals(scale=scale)
    trace = ((0.0, 3), (0.5, 1))
    assert serving.burst_arrivals(trace, scale) == \
        ref_serving.burst_arrivals(trace, scale)
    assert serving.ramp_arrivals(10.0 * scale, 200.0, 10.0) == \
        ref_serving.ramp_arrivals(10.0 * scale, 200.0, 10.0)
    assert serving.ramp_arrivals(1.0, 9.0, 2.0, tick_s=0.1) == \
        ref_serving.ramp_arrivals(1.0, 9.0, 2.0, tick_s=0.1)


def test_trace_file_and_declared_slos_equal_the_reference(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps([[0, 4], [1.25, "7"]]))
    assert serving.load_trace(str(path)) == \
        ref_serving.load_trace(str(path)) == [(0.0, 4), (1.25, 7)]
    for name in ("DEFAULT_DEADLINE_MS", "TRICKLE_SLO_MS", "BURST_SLO_MS"):
        assert getattr(serving, name) == getattr(ref_serving, name)
    assert serving._pod_json("p") == ref_serving._pod_json("p")
    assert serving._node_json("n") == ref_serving._node_json("n")


ROW_KEYS = {"arrival", "nodes", "pods", "bound", "unbound",
            "arrival_window_s", "latency_ms", "slo", "deadline_ms",
            "p99_vs_deadline", "goodput_pods_s", "deadline_misses",
            "batches_formed"}


def test_a_serving_smoke_over_http_on_the_cpu():
    events = serving.poisson_arrivals(40.0, 1.0, seed=3) + \
        [(1.1, 12)]
    row = serving.run_workload(
        "poisson", events, n_nodes=16, deadline_ms=20.0,
        slo_ms=serving.TRICKLE_SLO_MS, stream_chunk=256,
        settle_timeout=120.0, quiet=True, device="cpu")
    assert set(row) == ROW_KEYS
    total = sum(n for _, n in events)
    assert (row["pods"], row["bound"], row["unbound"]) == (total, total, 0)
    lat = row["latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]
    assert row["batches_formed"] >= 1
    assert 0 <= row["slo"]["attainment_pct"] <= 100
    assert row["slo"]["attainment_floor_pct"] == 99.0

"""The port's self-scrape telemetry ring (``kubernetes_tpu_torch/utils/
telemetry.py``) against the JAX package's ``tests/test_telemetry.py``
ring, cadence and dashboard cases, and the device-plane additions it
reads (``engine/devicestats.py``: ``sample_hbm``, ``armed``,
``watchdog_window``).

For the same samples under a fake clock, the port's ``/debug/timeseries``
payload equals the JAX package's byte for byte, and ``flatten`` gives
the same series for the same metric objects."""

from __future__ import annotations

import json
import threading
import time

from kubernetes_tpu.utils import metrics as ref_m
from kubernetes_tpu.utils import telemetry as ref_telemetry
from kubernetes_tpu_torch.engine import devicestats
from kubernetes_tpu_torch.utils import metrics as m
from kubernetes_tpu_torch.utils import telemetry


class TestTimeSeriesRing:
    def test_bounded_memory(self):
        ring = telemetry.TimeSeriesRing(
            capacity=10, period_s=0,
            collect=lambda: {"x": 1.0, "y": 2.0})
        for i in range(100):
            ring.scrape(now=float(i))
        payload = ring.payload()
        assert payload["samples"] == 10
        assert payload["series"]["x"][0][0] == 90.0
        assert payload["series"]["x"][-1][0] == 99.0
        assert len(ring._samples) == 10

    def test_cadence(self):
        ticks = []
        ring = telemetry.TimeSeriesRing(
            capacity=100, period_s=0.02,
            collect=lambda: ticks.append(1) or {"n": float(len(ticks))})
        ring.run()
        try:
            deadline = time.time() + 5.0
            while ring.scrapes < 3 and time.time() < deadline:
                time.sleep(0.01)
            assert ring.scrapes >= 3, "self-scrape cadence never fired"
        finally:
            ring.stop()

    def test_default_collector_flattens_registry_and_extras(self):
        ring = telemetry.TimeSeriesRing(capacity=4, period_s=0)
        extra = m.SchedulerMetrics()
        extra.queue_depth.set(7)
        ring.add_metrics(extra.all_metrics())
        ring.add_metrics(extra.all_metrics())  # identity-deduped
        assert len(ring._extra) == len(extra.all_metrics())
        sample = ring.scrape()["values"]
        assert sample["scheduler_pending_queue_depth"] == 7.0
        assert "apiclient_retry_budget_exhausted_total" in sample
        assert "scheduler_e2e_decision_latency_microseconds_count" \
            in sample
        m.DEVICE_TRANSFER_BYTES.labels(cause="scatter").inc(0)
        sample = ring.scrape()["values"]
        assert 'scheduler_device_transfer_bytes_total{cause="scatter"}' \
            in sample

    def test_payload_is_series_major_json(self):
        ring = telemetry.TimeSeriesRing(capacity=4, period_s=0,
                                        collect=lambda: {"x": 3.5})
        ring.scrape(now=1.0)
        ring.scrape(now=2.0)
        payload = json.loads(json.dumps(ring.payload()))
        assert payload["series"]["x"] == [[1.0, 3.5], [2.0, 3.5]]

    def test_empty_ring_serves_one_on_demand_sample(self):
        ring = telemetry.TimeSeriesRing(capacity=4, period_s=0,
                                        collect=lambda: {"x": 1.0})
        assert ring.payload()["samples"] == 1

    def test_dashboard_is_self_contained_html(self):
        html = telemetry.DASHBOARD_HTML
        assert "/debug/timeseries" in html
        assert "<script>" in html and "fetch(" in html
        assert "http://" not in html and "https://" not in html
        for series in ("scheduler_slo_", "scheduler_device_hbm_",
                       "stage_latency"):
            assert series in html
        assert "Control-plane CPU" in html
        for series in ("cpu_fraction", "apiserver_serialize",
                       "watch_decode"):
            assert series in html
        assert "kubernetes_tpu_torch dashboard" in html
        # The same page as the JAX package's but for its name.
        assert html.replace("kubernetes_tpu_torch", "kubernetes_tpu") == \
            ref_telemetry.DASHBOARD_HTML
        assert telemetry.dashboard_html() == html


def _fake_clock(times):
    it = iter(times)
    return lambda: next(it)


def test_timeseries_payload_equals_the_reference_under_a_fake_clock():
    """Ten scrapes of the same changing values at the same fake times
    (off the 3-decimal grid, so the rounding is exercised) into a ring
    of 6: the JSON the port serves equals the JAX package's."""
    times = [1_700_000_000.0 + 0.3337 * i for i in range(10)]
    values = [{"a_total": float(i), 'b{k="v"}': 0.5 * i, "c": -1.0}
              for i in range(10)]
    payloads = []
    for mod in (telemetry, ref_telemetry):
        feed = iter(values)
        ring = mod.TimeSeriesRing(capacity=6, period_s=5.0,
                                  collect=lambda feed=feed: next(feed),
                                  clock=_fake_clock(times))
        for _ in range(10):
            ring.scrape()
        payloads.append(json.dumps(ring.payload()))
    assert payloads[0] == payloads[1]
    assert json.loads(payloads[0])["samples"] == 6


def test_flatten_equals_the_reference_for_the_same_metrics():
    pairs = []
    for mod in (m, ref_m):
        c = mod.Counter("tt_requests_total", "h", labelnames=("verb",))
        c.labels(verb="GET").inc(3)
        c.labels(verb="POST").inc()
        g = mod.Gauge("tt_depth", "h")
        g.set(4)
        h = mod.Histogram("tt_latency_us", "h", [1e3, 1e4])
        for v in (5e2, 5e3, 5e4):
            h.observe(v)
        pairs.append([telemetry.flatten(x) if mod is m
                      else ref_telemetry.flatten(x) for x in (c, g, h)])
    assert pairs[0] == pairs[1]
    assert pairs[0][2] == {"tt_latency_us_count": 3.0,
                           "tt_latency_us_sum": 55500.0}


def test_the_global_ring_serves_and_starts_once():
    ring = telemetry.ensure_started()
    assert telemetry.ensure_started() is ring
    doc = json.loads(telemetry.timeseries_json())
    assert set(doc) == {"period_s", "capacity", "samples", "series"}
    assert doc["samples"] >= 1 and doc["series"]


def test_scrape_samples_device_memory_only_where_the_plane_is_loaded(
        monkeypatch):
    calls = []
    monkeypatch.setattr(devicestats, "sample_hbm",
                        lambda: calls.append(1) or 0)
    ring = telemetry.TimeSeriesRing(capacity=2, period_s=0,
                                    collect=lambda: {})
    ring.scrape()
    assert calls == [1]
    monkeypatch.delitem(__import__("sys").modules,
                        "kubernetes_tpu_torch.engine.devicestats")
    ring.scrape()
    assert calls == [1]


# -- the device plane the ring and the bench read -----------------------------

def test_sample_hbm_reads_the_tracked_device():
    devicestats.track_device("cpu")
    assert devicestats.sample_hbm() == 0
    assert devicestats.hbm_live_bytes() == 0
    assert float(m.DEVICE_HBM_LIVE_BYTES.value) == 0.0


def test_watchdog_window_counts_builds_inside_it_only():
    devicestats.disarm()
    before = devicestats.post_prewarm_compiles()
    devicestats.record_build(0.5)          # disarmed: not counted
    assert devicestats.post_prewarm_compiles() == before
    assert devicestats.armed() is False
    with devicestats.watchdog_window() as builds:
        assert devicestats.armed() is True
        with devicestats.live_path("stream_test"):
            devicestats.record_build(0.25)
        assert builds() == 1
    assert devicestats.armed() is False
    assert m.POST_PREWARM_COMPILES.labels(path="stream_test").value >= 1
    devicestats.arm()
    try:
        with devicestats.watchdog_window() as builds:
            pass
        assert builds() == 0 and devicestats.armed() is True
    finally:
        devicestats.disarm()


def test_cadence_thread_is_registered_and_stops():
    ring = telemetry.TimeSeriesRing(capacity=4, period_s=0.01,
                                    collect=lambda: {"x": 1.0})
    t = ring.run()
    assert isinstance(t, threading.Thread) and t.name == "telemetry-ring"
    assert ring.run() is t
    ring.stop()
    t.join(5)
    assert not t.is_alive()

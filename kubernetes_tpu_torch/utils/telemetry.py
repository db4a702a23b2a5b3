"""On-daemon time-series ring + zero-dependency dashboard.

Counterpart of ``kubernetes_tpu/utils/telemetry.py``.

Prometheus answers "what is the value now"; the first question during
an incident is "what was it doing for the last half hour" — and the
rigs this control plane runs on (benches, soaks, a laptop) have no
scrape infrastructure.  So every daemon SELF-scrapes: a bounded ring
samples the process's own metric registry every ``KT_TELEMETRY_PERIOD``
seconds (default 5; 0 disables the thread) and serves it two ways:

* ``/debug/timeseries`` — the ring as JSON, series-major:
  ``{"period_s": .., "series": {"name{label=\"v\"}": [[t, value], ..]}}``
  with counters/histograms flattened to their numeric samples
  (``_count``/``_sum`` for histograms).  Time is ``time.time()``.
* ``/debug/dashboard`` — a single-file HTML page (no external
  dependencies: inline JS rendering inline SVG sparklines) that polls
  the JSON and draws queue depth, per-stage latencies (windowed mean
  from the ``_sum``/``_count`` deltas), SLO burn, HBM occupancy, and
  per-cause transfer rates.  Counter-like series render as per-tick
  deltas; gauges render raw.

The ring is process-global (like the metric registry — multiple
daemons in one test process share one ring), bounded at
``KT_TELEMETRY_RING`` samples (default 720 — an hour at the default
cadence), and each scrape also samples device memory
(engine/devicestats.sample_hbm) when the process has loaded the device
plane; a process that never imported it (the apiserver, which imports
no torch) is not made to import torch by its own self-scrape.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

from kubernetes_tpu_torch.utils import knobs, locktrace, metrics, threadreg
from kubernetes_tpu_torch.utils.logging import get_logger
from kubernetes_tpu_torch.utils.metrics import (Counter, Gauge,
                                                Histogram, _label_str)

log = get_logger("telemetry")

DEFAULT_PERIOD_S = 5.0
DEFAULT_CAPACITY = 720


def flatten(metric: object) -> dict[str, float]:
    """One metric object -> {exposition-style sample name: value}.
    Histograms flatten to ``_count``/``_sum`` (bucket vectors belong to
    /metrics; the ring charts trends, and mean latency per tick falls
    out of the two).  Label sets render inline so every child is its
    own series."""
    out: dict[str, float] = {}

    def emit(name: str, labels: str, m) -> None:
        if isinstance(m, Histogram):
            out[f"{name}_count{labels}"] = float(m.count)
            out[f"{name}_sum{labels}"] = float(m.sum)
        elif isinstance(m, (Counter, Gauge)):
            out[f"{name}{labels}"] = float(m.value)

    if metric._labelnames:
        for key, child in sorted(metric.children().items()):
            emit(metric.name, _label_str(metric._labelnames, key), child)
    else:
        emit(metric.name, "", metric)
    return out


class TimeSeriesRing:
    """Bounded ring of self-scraped samples."""

    def __init__(self, capacity: Optional[int] = None,
                 period_s: Optional[float] = None,
                 collect: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.time):
        self.capacity = capacity if capacity is not None else \
            knobs.get_int("KT_TELEMETRY_RING")
        self.period_s = period_s if period_s is not None else \
            knobs.get_float("KT_TELEMETRY_PERIOD")
        self.clock = clock
        self._collect = collect
        # Extra metric objects beyond the default registry (the
        # scheduler daemon's SchedulerMetrics set), identity-deduped.
        self._extra: list = []
        self._samples: deque = deque(maxlen=max(self.capacity, 1))
        self._lock = locktrace.make_lock("telemetry.TimeSeriesRing")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scrapes = 0

    def add_metrics(self, extra: Iterable) -> None:
        with self._lock:
            for m in extra:
                if not any(m is e for e in self._extra):
                    self._extra.append(m)

    def _default_collect(self) -> dict[str, float]:
        values: dict[str, float] = {}
        with self._lock:
            extra = list(self._extra)
        for m in list(metrics.registry_metrics()) + extra:
            try:
                values.update(flatten(m))
            except Exception:  # noqa: BLE001 — one bad metric, not all
                pass
        return values

    def scrape(self, now: Optional[float] = None) -> dict:
        """Take one sample (also samples device memory where the device
        plane is loaded)."""
        devicestats = sys.modules.get("kubernetes_tpu_torch.engine."
                                      "devicestats")
        if devicestats is not None:
            try:
                devicestats.sample_hbm()
            except Exception:  # noqa: BLE001 — observability only
                pass
        now = self.clock() if now is None else now
        values = (self._collect or self._default_collect)()
        sample = (now, values)
        self._samples.append(sample)  # deque append: atomic, bounded
        self.scrapes += 1
        return {"t": now, "values": values}

    def run(self) -> Optional[threading.Thread]:
        """Start the self-scrape thread (no-op when the period is 0 or
        a thread is already running)."""
        if self.period_s <= 0 or \
                (self._thread is not None and self._thread.is_alive()):
            return self._thread

        def loop():
            while not self._stop.wait(self.period_s):
                try:
                    self.scrape()
                except Exception:  # noqa: BLE001 — keep scraping
                    log.exception("telemetry scrape crashed; continuing")
        self._thread = threadreg.spawn(loop, name="telemetry-ring")
        return self._thread

    def stop(self) -> None:
        self._stop.set()

    def payload(self) -> dict:
        """The ring, series-major, for /debug/timeseries."""
        samples = list(self._samples)
        if not samples:
            # Nothing scraped yet (thread disabled or just started):
            # take one on-demand sample so the endpoint is never empty.
            self.scrape()
            samples = list(self._samples)
        series: dict[str, list] = {}
        for t, values in samples:
            for name, v in values.items():
                series.setdefault(name, []).append([round(t, 3), v])
        return {"period_s": self.period_s, "capacity": self.capacity,
                "samples": len(samples), "series": series}


# -- the process-global ring -------------------------------------------------

_ring: Optional[TimeSeriesRing] = None
_ring_lock = locktrace.make_lock("telemetry.ring_global")


def ring() -> TimeSeriesRing:
    global _ring
    with _ring_lock:
        if _ring is None:
            _ring = TimeSeriesRing()
        return _ring


def ensure_started(extra_metrics: Optional[Iterable] = None
                   ) -> TimeSeriesRing:
    """Every daemon mux calls this at startup: register any daemon-
    scoped metric objects and make sure the scrape thread runs."""
    r = ring()
    if extra_metrics is not None:
        r.add_metrics(extra_metrics)
    r.run()
    return r


def timeseries_json() -> str:
    return json.dumps(ensure_started().payload())


def _reset_for_tests() -> None:
    global _ring
    with _ring_lock:
        if _ring is not None:
            _ring.stop()
        _ring = None


# -- the dashboard -----------------------------------------------------------

DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>kubernetes_tpu_torch dashboard</title>
<style>
 body{font:13px/1.4 system-ui,sans-serif;margin:0;background:#12161b;
      color:#d8dee6}
 h1{font-size:15px;margin:14px 16px 4px}
 h1 small{color:#7a8694;font-weight:normal}
 h2{font-size:12px;text-transform:uppercase;letter-spacing:.08em;
    color:#7a8694;margin:18px 16px 6px}
 .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(300px,1fr));
       gap:8px;margin:0 16px}
 .card{background:#1a2129;border:1px solid #242d38;border-radius:6px;
       padding:8px 10px}
 .name{color:#9fb0c0;font-size:11px;overflow:hidden;white-space:nowrap;
       text-overflow:ellipsis}
 .val{font-size:16px;font-variant-numeric:tabular-nums}
 svg{width:100%;height:36px;display:block}
 polyline{fill:none;stroke:#5ab0f0;stroke-width:1.5}
 .err polyline{stroke:#f07860}
 #status{color:#7a8694;margin:4px 16px}
</style></head><body>
<h1>kubernetes_tpu_torch <small>on-daemon telemetry &mdash; self-scraped
ring, no external collector</small></h1>
<div id="status">loading&hellip;</div>
<div id="root"></div>
<script>
"use strict";
// Section order = the incident-triage order: is the queue backing up,
// where is the time going, is the SLO burning, is the device filling.
const GROUPS = [
 ["Queue & drains", /^scheduler_(pending_queue_depth|last_batch_size|queue_|degraded_drains)/],
 ["Stage latency (mean per tick)", /^scheduler_batch_stage_latency_microseconds_mean_us/],
 ["SLO burn", /^scheduler_slo_/],
 ["Device HBM", /^scheduler_device_hbm_/],
 ["Device faults & fallback", /^scheduler_(device_faults|solve_fallback|engine_mode|hbm_watermark|sanity_)/],
 ["Multi-tenant service", /^scheduler_tenant_|^apiserver_bind_capacity/],
 ["Device transfers", /^scheduler_(device_transfer|post_prewarm_compiles)/],
 ["Decisions & binds", /^scheduler_(pod_scheduling_attempts|e2e_decision|bind_|batch_formation|batch_deadline)/],
 ["Overload", /^apiserver_(inflight|queue_depth|rejected_total|queue_wait)/],
 ["Control-plane CPU", /^process_(cpu_fraction|thread_cpu)|^scheduler_(watch_decode|handler_seconds|handler_events)|^apiserver_serialize/],
 ["Everything else", /./],
];
const DERIV = /(_total|_count|_sum)(\\{|$)/;   // counters chart as rates
function spark(points){
 if(points.length<2) return "<svg></svg>";
 const vs=points.map(p=>p[1]);
 const lo=Math.min(...vs), hi=Math.max(...vs), span=(hi-lo)||1;
 const pts=points.map((p,i)=>
   `${(i/(points.length-1)*100).toFixed(2)},${(34-(p[1]-lo)/span*30).toFixed(2)}`);
 return `<svg viewBox="0 0 100 36" preserveAspectRatio="none">`+
        `<polyline points="${pts.join(" ")}"/></svg>`;
}
function fmt(v){
 if(!isFinite(v)) return "-";
 const a=Math.abs(v);
 if(a>=1e9) return (v/1e9).toFixed(2)+"G";
 if(a>=1e6) return (v/1e6).toFixed(2)+"M";
 if(a>=1e3) return (v/1e3).toFixed(1)+"k";
 return (Math.round(v*100)/100).toString();
}
function derive(points){               // per-tick delta, reset-safe
 const out=[];
 for(let i=1;i<points.length;i++){
  out.push([points[i][0], Math.max(points[i][1]-points[i-1][1],0)]);
 }
 return out;
}
function stageMeans(series){           // _sum & _count -> mean us/tick
 const out={};
 for(const name in series){
  const m=name.match(/^(.*latency_microseconds)_sum(\\{.*\\})?$/);
  if(!m) continue;
  const cname=`${m[1]}_count${m[2]||""}`;
  if(!(cname in series)) continue;
  const s=series[name], c=series[cname], pts=[];
  for(let i=1;i<s.length;i++){
   const dc=c[i][1]-c[i-1][1];
   if(dc>0) pts.push([s[i][0],(s[i][1]-s[i-1][1])/dc]);
  }
  if(pts.length) out[`${m[1]}_mean_us${m[2]||""}`]=pts;
 }
 return out;
}
async function refresh(){
 let data;
 try{
  const r=await fetch("/debug/timeseries");
  data=await r.json();
 }catch(e){
  document.getElementById("status").textContent="fetch failed: "+e;
  return;
 }
 const series=Object.assign({}, data.series, stageMeans(data.series));
 const used=new Set(), html=[];
 for(const [title, re] of GROUPS){
  const cards=[];
  for(const name of Object.keys(series).sort()){
   if(used.has(name)||!re.test(name)) continue;
   used.add(name);
   let pts=series[name];
   if(DERIV.test(name)&&!name.includes("_mean_us")) pts=derive(pts);
   if(!pts.length) continue;
   const last=pts[pts.length-1][1];
   const cls=/burn_rate/.test(name)&&last>1?"card err":"card";
   cards.push(`<div class="${cls}"><div class="name" title="${name}">`+
     `${name}</div><div class="val">${fmt(last)}</div>${spark(pts)}</div>`);
  }
  if(cards.length)
   html.push(`<h2>${title}</h2><div class="grid">${cards.join("")}</div>`);
 }
 document.getElementById("root").innerHTML=html.join("");
 document.getElementById("status").textContent=
  `${data.samples} samples, scrape period ${data.period_s}s, `+
  `${Object.keys(data.series).length} series — refreshed `+
  new Date().toLocaleTimeString();
}
refresh();
setInterval(refresh, 5000);
</script></body></html>
"""


def dashboard_html() -> str:
    ensure_started()
    return DASHBOARD_HTML

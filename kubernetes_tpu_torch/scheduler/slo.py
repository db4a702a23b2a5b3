"""SLO burn-rate monitor: multi-window error-budget burn for the
per-decision latency SLO.

Every pod carries a measured submit->bind latency
(``scheduler_e2e_decision_latency_microseconds``), and a serving bench
an attainment number — but attainment is a POST-HOc verdict.  What an
operator pages on is the BURN RATE: how fast the error budget is being
consumed right now, over more than one window (the SRE-workbook
multi-window multi-burn-rate shape: a short window catches a fast burn,
a long one a slow bleed; alerting on both windows firing suppresses
blips).  This module computes exactly that from the decision-latency
histogram the commit path already records:

* The SLO is declared as ``KT_SLO_MS`` (default 1000 ms) at
  ``KT_SLO_OBJECTIVE`` (default 99.0 % of decisions inside it) — the
  serving bench's trickle SLO, now a live daemon signal.
* ``tick()`` snapshots (total, good) from the histogram's buckets (good
  = observations at or under the largest bucket bound <= the SLO — the
  conservative read) into a bounded ring; burn over a window is
  ``error_rate / error_budget`` computed from the deltas between the
  newest sample and the oldest one inside the window.  Burn 1.0 means
  "exactly exhausting the budget"; > 1 is an alerting burn.
* Gauges: ``scheduler_slo_burn_rate{window="5m"|"1h"}`` and
  ``scheduler_slo_budget_remaining`` (fraction of the 1h window's
  budget left).  ``report()`` feeds ``/debug/vars`` and the telemetry
  dashboard's burn sparkline.

The monitor is clock-injected (window math is unit-tested with a fake
clock) and runs as one daemon thread started by ``ConfigFactory.run``
(``KT_SLO_PERIOD`` seconds per tick, default 5; 0 disables).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from typing import Callable, Optional

from kubernetes_tpu_torch.utils import knobs, locktrace, metrics, threadreg
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("slo")

DEFAULT_SLO_MS = 1000.0
DEFAULT_OBJECTIVE_PCT = 99.0
# (label, seconds): the 5m window catches a fast burn, the 1h window a
# slow bleed — the standard multi-window pair scaled to a scheduler's
# decision volume.
WINDOWS = (("5m", 300.0), ("1h", 3600.0))


class SLOMonitor:
    """Error-budget burn over trailing windows of the decision-latency
    histogram."""

    def __init__(self,
                 histogram: Optional[metrics.Histogram] = None,
                 slo_ms: Optional[float] = None,
                 objective_pct: Optional[float] = None,
                 windows=WINDOWS,
                 clock: Callable[[], float] = time.monotonic):
        self.histogram = histogram if histogram is not None \
            else metrics.E2E_DECISION_LATENCY
        self.slo_ms = slo_ms if slo_ms is not None \
            else knobs.get_float("KT_SLO_MS")
        self.objective_pct = objective_pct if objective_pct is not None \
            else knobs.get_float("KT_SLO_OBJECTIVE")
        self.budget = max(1.0 - self.objective_pct / 100.0, 1e-9)
        self.windows = tuple(windows)
        self.clock = clock
        self._lock = locktrace.make_lock("scheduler.SLOMonitor")
        # (t, total, good) samples, oldest first, bounded to the longest
        # window (plus one sample of slack for the delta at the edge).
        self._samples: list[tuple[float, int, int]] = []
        self._longest = max(w for _, w in self.windows)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_burn: dict[str, float] = {}
        # Per-tenant burn (multi-tenant solver service): sample rings
        # per tenant child of the {tenant=}-labeled decision histogram,
        # burned over the SHORT window only (the paging signal; the
        # global gauge keeps both windows).  Zero cost until a tenant
        # child exists — i.e. until tenancy actually observes.
        self._tenant_samples: dict[str, list] = {}
        self.last_tenant_burn: dict[str, float] = {}

    # -- histogram reading ------------------------------------------------

    def _counts(self) -> tuple[int, int]:
        """(total, good) observation counts so far.  ``good`` is the
        cumulative count at the largest bucket bound <= the SLO — the
        conservative (under-)estimate the exponential ladder allows."""
        uppers, counts, total, _ = self.histogram.bucket_counts()
        slo_us = self.slo_ms * 1e3
        k = bisect_right(uppers, slo_us)
        return total, sum(counts[:k])

    # -- the tick ---------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> dict[str, float]:
        """Take one sample, recompute every window's burn, drive the
        gauges.  Returns {window_label: burn_rate}."""
        now = self.clock() if now is None else now
        total, good = self._counts()
        with self._lock:
            self._samples.append((now, total, good))
            # Bound the ring: drop samples older than the longest
            # window, keeping ONE older sample as the delta base so a
            # window that spans the whole ring still has an edge.
            cutoff = now - self._longest
            keep = 0
            while keep + 1 < len(self._samples) and \
                    self._samples[keep + 1][0] <= cutoff:
                keep += 1
            del self._samples[:keep]
            samples = list(self._samples)
        burns: dict[str, float] = {}
        for label, span in self.windows:
            burns[label] = self._burn(samples, now - span, total, good)
        for label, burn in burns.items():
            metrics.SLO_BURN_RATE.labels(window=label).set(burn)
        longest_label = max(self.windows, key=lambda w: w[1])[0]
        remaining = max(0.0, 1.0 - burns.get(longest_label, 0.0))
        metrics.SLO_BUDGET_REMAINING.set(remaining)
        self.last_burn = burns
        self._tick_tenants(now)
        return burns

    def _tick_tenants(self, now: float) -> None:
        """Per-tenant burn over the shortest window, one sample ring per
        tenant child of the labeled decision histogram."""
        children = metrics.TENANT_DECISION_LATENCY.children()
        if not children:
            return
        span = min(w for _, w in self.windows)
        slo_us = self.slo_ms * 1e3
        tenant_burns: dict[str, float] = {}
        with self._lock:
            for key, child in children.items():
                tenant = key[0]
                uppers, counts, total, _ = child.bucket_counts()
                k = bisect_right(uppers, slo_us)
                good = sum(counts[:k])
                ring = self._tenant_samples.setdefault(tenant, [])
                ring.append((now, total, good))
                cutoff = now - self._longest
                keep = 0
                while keep + 1 < len(ring) and \
                        ring[keep + 1][0] <= cutoff:
                    keep += 1
                del ring[:keep]
                tenant_burns[tenant] = self._burn(
                    list(ring), now - span, total, good)
        for tenant, burn in tenant_burns.items():
            metrics.TENANT_SLO_BURN.labels(tenant=tenant).set(burn)
        self.last_tenant_burn = tenant_burns

    @staticmethod
    def _base(samples: list, t0: float) -> tuple[int, int]:
        """The (total, good) base for a window starting at ``t0``: the
        newest sample at or before t0 (the monitor was already running),
        else zeros (the window predates the monitor)."""
        base = (0, 0)
        for t, total, good in samples:
            if t <= t0:
                base = (total, good)
            else:
                break
        return base

    def _burn(self, samples: list, t0: float,
              total: int, good: int) -> float:
        base_total, base_good = self._base(samples, t0)
        d_total = total - base_total
        if d_total <= 0:
            return 0.0
        d_bad = d_total - (good - base_good)
        return (d_bad / d_total) / self.budget

    # -- reporting / lifecycle -------------------------------------------

    def report(self) -> dict:
        """The /debug/vars payload."""
        total, good = self._counts()
        out = {"sloMs": self.slo_ms,
               "objectivePct": self.objective_pct,
               "decisionsTotal": total,
               "decisionsOverSlo": total - good,
               "burnRate": {k: round(v, 4)
                            for k, v in self.last_burn.items()},
               "budgetRemaining": round(
                   float(metrics.SLO_BUDGET_REMAINING.value), 4)}
        if self.last_tenant_burn:
            out["tenantBurnRate"] = {t: round(v, 4) for t, v in
                                     self.last_tenant_burn.items()}
        return out

    def run(self, period: float = 5.0) -> threading.Thread:
        def loop():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — monitor must survive
                    log.exception("slo tick crashed; continuing")
        self._thread = threadreg.spawn(loop, name="slo-burn-monitor")
        return self._thread

    def stop(self) -> None:
        self._stop.set()

"""Client-side flow control: a token-bucket rate limiter.

The reference rate-limits every apiserver client at QPS with a Burst bucket
(``pkg/util/flowcontrol/throttle.go`` tokenBucketRateLimiter, wired through
``pkg/client/restclient/config.go``; the scheduler passes --kube-api-qps /
--kube-api-burst, options/options.go:66-67, and the perf rig raises them to
5000, test/component/scheduler/perf/util.go:63-64).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class TokenBucketRateLimiter:
    """flowcontrol.NewTokenBucketRateLimiter(qps, burst).

    ``accept()`` blocks until a token is available (throttle.go Accept);
    ``try_accept()`` is the non-blocking TryAccept.  qps <= 0 disables
    limiting (flowcontrol's fakeAlwaysRateLimiter shape).
    """

    def __init__(self, qps: float, burst: int,
                 now: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.qps = qps
        self.burst = max(burst, 1)
        self._now = now
        self._sleep = sleep
        self._tokens = float(self.burst)
        self._last = now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._now()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_accept(self) -> bool:
        if self.qps <= 0:
            return True
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def accept(self) -> None:
        if self.qps <= 0:
            return
        while True:
            with self._lock:
                self._refill()
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            self._sleep(wait)

    def saturation(self) -> float:
        """Fraction of the bucket consumed (throttle.go Saturation)."""
        if self.qps <= 0:
            return 0.0
        with self._lock:
            self._refill()
            return 1.0 - self._tokens / self.burst


class AIMDLimiter:
    """Adaptive concurrency window: additive increase on success,
    multiplicative decrease on server backpressure (TCP-congestion
    shape; Netflix concurrency-limits is the production precedent).

    Governs the pipelined ``bind_list`` chunk fan-out: a shedding server
    (429) halves the window, so retried load *decreases* instead of
    re-offering the same storm.  ``acquire()`` blocks while inflight >=
    the current window; the window floats in [min_limit, max_limit] as a
    float but is enforced at its floor'd integer value.
    """

    def __init__(self, min_limit: int = 1, max_limit: int = 4,
                 backoff: float = 0.5, increase: float = 1.0):
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self._backoff = min(max(backoff, 0.1), 0.9)
        self._increase = increase
        self._window = float(self.max_limit)
        self._inflight = 0
        self._throttles = 0
        self._cv = threading.Condition(threading.Lock())

    def limit(self) -> int:
        with self._cv:
            return int(self._window)

    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def acquire(self) -> None:
        with self._cv:
            while self._inflight >= int(self._window):
                self._cv.wait()
            self._inflight += 1

    def release(self) -> None:
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            self._cv.notify()

    def on_success(self) -> None:
        """One full round-trip succeeded: probe upward additively,
        amortized over the window (classic AIMD per-RTT increase)."""
        with self._cv:
            self._window = min(float(self.max_limit),
                               self._window + self._increase / max(
                                   self._window, 1.0))
            self._cv.notify()

    def on_throttle(self) -> None:
        """The server shed (429): multiplicative decrease."""
        with self._cv:
            self._window = max(float(self.min_limit),
                               self._window * self._backoff)
            self._throttles += 1

    def report(self) -> dict:
        with self._cv:
            return {"limit": int(self._window),
                    "window": round(self._window, 3),
                    "inflight": self._inflight,
                    "throttles": self._throttles,
                    "floor": self.min_limit, "ceiling": self.max_limit}

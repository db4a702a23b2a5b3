"""Per-pod exponential retry backoff (factory.go:602-688): 1s initial,
doubling to a 60s cap; entries garbage-collected after max-duration idle."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class _Entry:
    backoff: float
    last_update: float


@dataclass
class PodBackoff:
    default_duration: float = 1.0   # factory.go:520
    max_duration: float = 60.0
    now: Callable[[], float] = time.monotonic
    _entries: dict[str, _Entry] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def get_backoff(self, pod_key: str) -> float:
        """Current backoff for the pod, doubling for next time
        (getEntry + getBackoff, factory.go:667-682)."""
        with self._lock:
            entry = self._entries.get(pod_key)
            if entry is None:
                entry = _Entry(self.default_duration, self.now())
                self._entries[pod_key] = entry
            entry.last_update = self.now()
            duration = entry.backoff
            entry.backoff = min(duration * 2, self.max_duration)
            return duration

    def gc(self) -> None:
        """Drop entries idle beyond max_duration (factory.go:684-688)."""
        with self._lock:
            now = self.now()
            stale = [k for k, e in self._entries.items()
                     if now - e.last_update > self.max_duration]
            for k in stale:
                del self._entries[k]

"""Pod garbage collector: bound the terminated-pod population.

The reference's podgc controller (pkg/controller/podgc/gc_controller.go)
deletes the oldest terminated (Succeeded/Failed) pods once their count
exceeds ``--terminated-pod-gc-threshold``, so a cluster running Jobs and
crash-looping workloads doesn't accumulate completed pods forever.  Job
records survive until the threshold — the same contract the reference
gives (the Job controller never deletes its succeeded pods; podgc is the
backstop).

A copy of ``kubernetes_tpu/controller/podgc.py`` with its imports
pointed at this package.
"""

from __future__ import annotations

import threading
from typing import Union

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.client.reflector import Reflector
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("podgc")

SYNC_PERIOD = 5.0
# gc_controller.go's flag default is 12500; scaled to this framework's
# hollow-fleet sizes.
DEFAULT_THRESHOLD = 1000


class PodGCController:
    def __init__(self, source: Union[MemStore, APIClient, str],
                 threshold: int = DEFAULT_THRESHOLD,
                 sync_period: float = SYNC_PERIOD, token: str = "",
                 tls=None):
        if isinstance(source, str):
            source = APIClient(source, token=token, tls=tls)
        self.store = source
        self.threshold = threshold
        self.sync_period = sync_period
        self._terminated: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reflector: Reflector | None = None

    def run(self) -> "PodGCController":
        self._reflector = Reflector(self.store, "pods", self._on_pod)
        self._reflector.run()
        self._reflector.wait_for_sync()
        t = threading.Thread(target=self._loop, daemon=True, name="podgc")
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._reflector is not None:
            self._reflector.stop()

    def _on_pod(self, etype: str, obj: dict) -> None:
        key = MemStore.object_key(obj)
        phase = (obj.get("status") or {}).get("phase", "")
        with self._lock:
            if etype == "DELETED" or phase not in ("Succeeded", "Failed"):
                self._terminated.pop(key, None)
            else:
                self._terminated[key] = obj

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.gc_once()
            except Exception:  # noqa: BLE001 — HandleCrash analogue
                log.exception("podgc sync crashed; continuing")

    def gc_once(self) -> int:
        """Delete the oldest terminated pods beyond the threshold.
        Returns the number deleted."""
        with self._lock:
            pods = list(self._terminated.items())
        excess = len(pods) - self.threshold
        if excess <= 0:
            return 0
        # Oldest first: RVs are a decimal counter.
        pods.sort(key=lambda kv: int((kv[1].get("metadata") or {})
                                     .get("resourceVersion", 0) or 0))
        deleted = 0
        for key, _ in pods[:excess]:
            try:
                self.store.delete("pods", key)
                deleted += 1
            except Exception:  # noqa: BLE001 — already gone
                pass
        if deleted:
            log.info("podgc: deleted %d terminated pods (threshold %d)",
                     deleted, self.threshold)
        return deleted

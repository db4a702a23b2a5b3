"""Guarded device execution: fault taxonomy, recovery policy, and the
post-solve sanity gate.

Counterpart of ``kubernetes_tpu/engine/guard.py`` with a CUDA taxonomy.
Every solve site (one-shot, stream chunk, joint, single-pod, preemption
victim solve) runs inside this layer so a device fault is a policy decision
instead of a stalled drain loop:

* **Classification.**  ``classify()`` buckets an exception into
  ``oom`` (``torch.OutOfMemoryError``, or the CUDA out-of-memory text),
  ``compile`` (``engine/kernels.py``'s ``nvcc failed``), ``lost`` (a
  sticky CUDA error: an illegal memory access, a device-side assert, an
  unspecified launch failure, any ``CUDA error`` text, the kernel
  wrappers' ``kernel launch failed (cudaError N)``, or the installed
  torch's accelerator-error class where it has one), or None (not a
  device fault: re-raised untouched so real bugs keep crashing as
  themselves).  Classified faults count in
  ``scheduler_device_faults_total{kind=}`` and re-raise as
  ``DeviceFault`` for the drain pipeline's recovery ladder.

* **Recovery ladder** (``recover()``): OOM evicts the resident cluster
  tensors and bisects the batch onto the NEXT SMALLER pre-warmed bucket
  (the cap walks ``effective_ladder()`` downward); compile and corrupt
  faults retry.  Repeated faults of one kind, or a single ``lost``, open
  a circuit breaker.  There is no host engine behind it: an open breaker
  SURFACES the fault — the pipeline raises it into ``drain()``'s crash
  handler, which requeues the batch through backoff, so no pod is
  dropped and none is decided off the device.  While the breaker is open
  a drain requeues at once without touching the card, until a probe is
  due (``KT_GUARD_PROBE_S``); a probe drain that succeeds closes it.

* **Sanity gate** (``checked_readback``): every assignment vector read
  back from the device is validated before anything binds — integral
  dtype, no NaN/inf, indices in ``[-1, n_nodes)``, padded rows place
  nothing, and a host spot-check that sampled placed pods' requests fit
  their chosen node's total allocatable.  A failed gate classifies as
  ``corrupt`` and requeues the batch; the pod keys of a rejected batch
  are remembered so the commit path can refuse them outright
  (``scheduler_sanity_rejected_binds_total``, which must stay 0).

* **Device-memory watermark** (``KT_HBM_WATERMARK`` bytes): when live
  device memory crosses it, bucket growth is capped at the ladder floor
  (and the resident tensors evicted once) before the allocator throws.

Fault injection for all of this is ``chaos/device.py``; the guard is
its only consumer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from kubernetes_tpu_torch.chaos import device as chaos_device
from kubernetes_tpu_torch.utils import knobs, locktrace, metrics
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("guard")

KIND_OOM = "oom"
KIND_COMPILE = "compile"
KIND_LOST = "lost"
KIND_CORRUPT = "corrupt"

# Substring -> kind, checked in order: out of memory first (a failed
# allocation can surface as "CUDA error: out of memory"), the build
# failure before the generic CUDA error text.
_PATTERNS = (
    ("out of memory", KIND_OOM),
    ("nvcc failed", KIND_COMPILE),
    ("kernel launch failed (cudaError", KIND_LOST),
    ("illegal memory access", KIND_LOST),
    ("device-side assert", KIND_LOST),
    ("unspecified launch failure", KIND_LOST),
    ("CUDA error", KIND_LOST),
)


def _accelerator_error() -> Optional[type]:
    """The installed torch's accelerator-error class, where it has one."""
    return getattr(torch, "AcceleratorError", None)


def _is_device_error(exc: BaseException) -> bool:
    """Only errors of the device stack (torch's CUDA errors, the kernel
    wrappers' and the kernel build's RuntimeErrors, the chaos
    simulation) classify; arbitrary Python bugs keep crashing as
    themselves."""
    if isinstance(exc, (chaos_device.SimulatedDeviceError,
                        torch.cuda.OutOfMemoryError)):
        return True
    accel = _accelerator_error()
    if accel is not None and isinstance(exc, accel):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    return any(token in msg for token, _ in _PATTERNS)


def classify(exc: BaseException) -> str | None:
    """The fault taxonomy: oom / compile / lost, or None when the
    exception is not a device fault."""
    if isinstance(exc, DeviceFault):
        return exc.kind
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return KIND_OOM
    if not _is_device_error(exc):
        return None
    msg = str(exc)
    for token, kind in _PATTERNS:
        if token in msg:
            return kind
    # A device error with an unknown text: treat as lost, the
    # conservative end of the ladder.
    return KIND_LOST


class DeviceFault(Exception):
    """A classified device fault, carrying the recovery ladder's inputs:
    the fault kind and the solve path it struck."""

    def __init__(self, kind: str, path: str, orig: BaseException | None = None):
        self.kind = kind
        self.path = path
        self.orig = orig
        super().__init__(f"device fault [{kind}] on {path} path: {orig}")


class ScoreGateError(DeviceFault):
    """The single-pod sanity gate: the score plane held a NaN or an
    infinity, which would select garbage (a ``corrupt`` fault)."""

    def __init__(self, path: str = "single_pod"):
        super().__init__(KIND_CORRUPT, path,
                         RuntimeError("sanity gate: NaN/inf score plane"))


# Recovery actions recover() hands the pipeline.
ACT_RETRY = "retry"      # re-dispatch the remaining pods unchanged
ACT_BISECT = "bisect"    # re-dispatch chunked at the shrunken bucket cap
ACT_SURFACE = "surface"  # breaker open: raise to the crash handler


class DeviceGuard:
    """Per-engine fault-policy state machine (breaker, bucket cap,
    rejected-batch memory).  Thread-safe: the drain thread, the commit
    worker and the single-pod path all cross it."""

    def __init__(self, evict_fn: Optional[Callable[[], None]] = None,
                 ladder_fn: Optional[Callable[[], list[int]]] = None):
        self.enabled = knobs.get_bool("KT_GUARD")
        # Consecutive same-kind faults before the breaker opens.
        self.breaker_threshold = knobs.get_int("KT_GUARD_BREAKER")
        # Seconds between probe drains while the breaker is open.
        self.probe_period_s = knobs.get_float("KT_GUARD_PROBE_S")
        # Bound on recovery rounds per drain (each round re-solves only
        # the still-uncommitted pods, so progress is monotone anyway).
        self.max_rounds = knobs.get_int("KT_GUARD_ROUNDS")
        # Device-healthy drains before a bisected bucket cap resets.
        self.cap_reset_streak = knobs.get_int("KT_GUARD_CAP_RESET")
        # Proactive device-memory ceiling in bytes (0 = off).
        self.hbm_watermark = knobs.get_int("KT_HBM_WATERMARK")
        self.evict_fn = evict_fn
        self.ladder_fn = ladder_fn or (lambda: [])
        self._lock = locktrace.make_lock("engine.DeviceGuard")
        self._mode = "device"
        self._consecutive: dict[str, int] = {}
        self._bucket_cap: int | None = None
        self._success_streak = 0
        self._opened_at = 0.0
        self._open_kind = KIND_LOST
        self._open_s = 0.0   # accumulated seconds with the breaker open
        self._last_probe = 0.0
        self._probing = False
        self._wm_active = False
        self._suppress = False
        self._last_fault: dict | None = None
        self._rejected_keys: set[str] = set()
        self.gate_rejects = 0
        # Pods requeued with backoff because a fault surfaced (where the
        # JAX guard decides them on its host engine).
        self.requeued_pods = 0
        if self.enabled:
            metrics.ENGINE_MODE.set(0.0)

    # -- mode / breaker ---------------------------------------------------

    @property
    def mode(self) -> str:
        """``device`` (breaker closed) or ``open``."""
        return self._mode

    def solve_mode(self) -> str:
        """Routing decision for the next drain: ``device``, ``probe``
        (breaker open and a probe is due — attempt the device), or
        ``open`` (breaker open: requeue without touching the card).
        Never ``host``: this package has no host engine."""
        with self._lock:
            if self._mode == "device":
                return "device"
            now = time.monotonic()
            if now - self._last_probe >= self.probe_period_s:
                self._last_probe = now
                self._probing = True
                return "probe"
            return "open"

    def breaker_fault(self) -> DeviceFault:
        """The fault an ``open`` drain surfaces (not a new fault: nothing
        ran on the device, so nothing is counted)."""
        with self._lock:
            kind = self._open_kind
            wait = max(self.probe_period_s -
                       (time.monotonic() - self._last_probe), 0.0)
        return DeviceFault(kind, "breaker", RuntimeError(
            f"device breaker open; next probe in {wait:.1f} s"))

    def note_requeued(self, pods: int) -> None:
        """``pods`` pods of a drain that surfaced a fault went back to
        the queue through backoff (``drain()``'s crash handler, the
        single-pod path)."""
        with self._lock:
            self.requeued_pods += pods

    def note_success(self, probe: bool = False) -> None:
        """A device solve completed and passed the gate: close the
        breaker if this was a probe, and walk the bucket cap back up
        after a healthy streak."""
        with self._lock:
            self._consecutive.clear()
            if probe and self._mode == "open":
                self._open_s += time.monotonic() - self._opened_at
                self._mode = "device"
                self._probing = False
                metrics.ENGINE_MODE.set(0.0)
                log.info("device probe succeeded; breaker closed")
            self._success_streak += 1
            if self._bucket_cap is not None and \
                    self._success_streak >= self.cap_reset_streak:
                log.info("device healthy for %d drains; lifting bisect "
                         "cap %d", self._success_streak, self._bucket_cap)
                self._bucket_cap = None

    def _trip(self, kind: str) -> None:
        # Called under self._lock.
        self._open_kind = kind
        if self._mode != "open":
            self._mode = "open"
            self._opened_at = time.monotonic()
            self._last_probe = self._opened_at
            metrics.ENGINE_MODE.set(1.0)
            log.warning("device breaker OPEN after %s fault(s); drains "
                        "requeue until a probe succeeds (every %.1fs)",
                        kind, self.probe_period_s)

    def recover(self, fault: DeviceFault, can_bisect: bool = True) -> str:
        """The bounded policy ladder: map a classified fault to the
        pipeline's next action.  OOM walks the pre-warmed bucket ladder
        downward (after evicting the resident tensors); repeated faults
        of one kind, any ``lost``, or a failed probe open the breaker and
        surface the fault."""
        with self._lock:
            self._success_streak = 0
            n = self._consecutive.get(fault.kind, 0) + 1
            self._consecutive[fault.kind] = n
            if self._probing:
                # A failed probe keeps the breaker open and resets the
                # probe clock.
                self._probing = False
                self._last_probe = time.monotonic()
                self._trip(fault.kind)
                return ACT_SURFACE
            if fault.kind == KIND_LOST or n >= self.breaker_threshold:
                self._trip(fault.kind)
                return ACT_SURFACE
            if fault.kind == KIND_OOM:
                self._evict_locked()
                if can_bisect and self._shrink_cap_locked():
                    metrics.SOLVE_FALLBACKS.labels(mode="bisect").inc()
                    return ACT_BISECT
                return ACT_RETRY  # at the ladder floor: evicted, retry
            # compile / corrupt under the threshold: plain retry.
            return ACT_RETRY

    def _evict_locked(self) -> None:
        if self.evict_fn is not None:
            try:
                self.evict_fn()
            except Exception:  # noqa: BLE001 — eviction is best-effort
                log.exception("resident-tensor eviction failed")

    def _shrink_cap_locked(self) -> bool:
        """Walk the bucket cap one rung down the PRE-WARMED ladder;
        False when already at (or below) the floor."""
        ladder = sorted(self.ladder_fn() or [])
        if not ladder:
            return False
        current = self._bucket_cap if self._bucket_cap is not None \
            else ladder[-1]
        smaller = [b for b in ladder if b < current]
        if not smaller:
            return False
        self._bucket_cap = smaller[-1]
        log.warning("OOM: resident tensors evicted, batch bisected onto "
                    "the %d-pod pre-warmed bucket", self._bucket_cap)
        return True

    def bucket_cap(self) -> int | None:
        """The ladder bucket device drains are currently capped at: the
        bisect cap, tightened to the ladder floor while the memory
        watermark is tripped."""
        with self._lock:
            cap = self._bucket_cap
        wm = self._watermark_cap()
        if wm is not None:
            cap = wm if cap is None else min(cap, wm)
        return cap

    def _watermark_cap(self) -> int | None:
        if not self.hbm_watermark:
            return None
        from kubernetes_tpu_torch.engine import devicestats
        live = devicestats.hbm_live_bytes()
        with self._lock:
            if live <= self.hbm_watermark:
                self._wm_active = False
                return None
            if not self._wm_active:
                self._wm_active = True
                metrics.HBM_WATERMARK_TRIPS.inc()
                self._evict_locked()
                log.warning("device-memory watermark tripped (%d > %d "
                            "bytes): bucket growth capped at the ladder "
                            "floor", live, self.hbm_watermark)
        ladder = sorted(self.ladder_fn() or [])
        return ladder[0] if ladder else None

    # -- the solve-site wrapper -------------------------------------------

    @contextlib.contextmanager
    def suppressed(self) -> Iterator[None]:
        """Turn chaos injection off for a scope (``Scheduler.prewarm``
        launches the live solve sites with no recovery ladder above
        them).  Real device faults still propagate."""
        prev = self._suppress
        self._suppress = True
        try:
            yield
        finally:
            self._suppress = prev

    @contextlib.contextmanager
    def watch(self, path: str, inject: bool = True) -> Iterator[None]:
        """Wrap one device interaction: chaos injection on entry (only at
        the solve LAUNCH sites — ``inject=False`` marks compile/readback
        wrappers that classify real faults but don't consume the
        injector's cadence), fault classification on the way out.
        Classified faults count and re-raise as ``DeviceFault``;
        everything else passes through untouched."""
        if not self.enabled or self._suppress:
            yield
            return
        chaos = chaos_device.active()
        if chaos is not None and inject:
            try:
                chaos.maybe_fail(path)
            except chaos_device.SimulatedDeviceError as exc:
                kind = classify(exc) or KIND_LOST
                self._record_fault(kind, path)
                raise DeviceFault(kind, path, exc) from exc
        try:
            yield
        except DeviceFault:
            raise
        except Exception as exc:  # noqa: BLE001 — classify, then decide
            kind = classify(exc)
            if kind is None:
                raise
            self._record_fault(kind, path)
            raise DeviceFault(kind, path, exc) from exc

    def _record_fault(self, kind: str, path: str) -> None:
        metrics.DEVICE_FAULTS.labels(kind=kind).inc()
        with self._lock:
            self._last_fault = {"kind": kind, "path": path,
                                "at": time.time()}
        log.warning("device fault [%s] on %s path", kind, path)

    # -- the post-solve sanity gate ---------------------------------------

    def checked_readback(self, path: str, rows: np.ndarray, n_nodes: int,
                         live: Optional[np.ndarray] = None,
                         alloc: Optional[np.ndarray] = None,
                         requests: Optional[np.ndarray] = None,
                         keys_fn: Optional[Callable[[], list[str]]] = None,
                         spot_k: int = 16) -> np.ndarray:
        """Validate an assignment readback before anything commits.

        ``rows`` is the choices vector; ``live`` the real-row mask when
        the batch was padded; ``alloc``/``requests`` the host-side
        [N,4]/[P,4] arrays for the capacity spot-check; ``keys_fn``
        lazily names the batch's pod keys so a rejected batch is
        remembered (and a later clean solve of the same pods forgets
        it).  Returns the int32 choices; raises
        ``DeviceFault('corrupt')`` on any violation."""
        if not self.enabled:
            return np.asarray(rows)
        chaos = chaos_device.active()
        if chaos is not None and not self._suppress:
            rows = chaos.maybe_corrupt(path, rows)
        arr = np.asarray(rows)
        problem = None
        if arr.dtype.kind == "f":
            if not np.isfinite(arr).all():
                problem = "NaN/inf in readback"
            elif arr.size and not (arr == np.trunc(arr)).all():
                problem = "non-integral assignment indices"
        if problem is None:
            choices = arr.astype(np.int64, copy=False)
            if choices.size and (int(choices.min(initial=0)) < -1 or
                                 int(choices.max(initial=-1)) >= n_nodes):
                problem = (f"assignment index out of range "
                           f"[-1, {n_nodes})")
            elif live is not None:
                dead = ~np.asarray(live, bool)
                if choices.size and (choices[dead[:len(choices)]]
                                     != -1).any():
                    problem = "padded (dead) row received a placement"
        if problem is None and alloc is not None and requests is not None:
            # Host spot-check on sampled rows: a placed pod's request can
            # never exceed its node's TOTAL allocatable (in-batch
            # occupancy is the scan's job, not the gate's).
            placed = np.nonzero(choices >= 0)[0]
            if placed.size:
                step = max(placed.size // spot_k, 1)
                sample = placed[::step][:spot_k]
                req = np.asarray(requests)[sample, :3]
                cap = np.asarray(alloc)[choices[sample], :3]
                if (req > cap).any():
                    problem = ("sampled placement exceeds the node's "
                               "total allocatable")
        if problem is not None:
            self.gate_rejects += 1
            metrics.GATE_REJECTS.inc()
            if keys_fn is not None:
                try:
                    with self._lock:
                        self._rejected_keys.update(keys_fn())
                except Exception:  # noqa: BLE001 — bookkeeping only
                    pass
            self._record_fault(KIND_CORRUPT, path)
            raise DeviceFault(KIND_CORRUPT, path,
                              RuntimeError(f"sanity gate: {problem}"))
        if keys_fn is not None and self._rejected_keys:
            with self._lock:
                if self._rejected_keys:
                    self._rejected_keys.difference_update(keys_fn())
        return choices.astype(np.int32, copy=False)

    def checked_scores(self, path: str, finite: bool) -> None:
        """The single-pod gate: the evaluation planes must be finite (a
        NaN score would select garbage).  ``finite`` is the device's own
        reduction, read back with the choice; raises ``ScoreGateError``
        when it is false, guard on or off."""
        if self.enabled and not self._suppress:
            chaos = chaos_device.active()
            if chaos is not None:
                poisoned = chaos.maybe_corrupt(path, np.zeros(1, np.float32))
                finite = finite and bool(np.isfinite(poisoned).all())
        if finite:
            return
        if self.enabled:
            self.gate_rejects += 1
            metrics.GATE_REJECTS.inc()
            self._record_fault(KIND_CORRUPT, path)
        raise ScoreGateError(path)

    # -- rejected-batch memory (defense in depth at the bind path) --------

    def has_rejections(self) -> bool:
        return bool(self._rejected_keys)

    def filter_rejected(self, placed: list) -> tuple[list, list]:
        """Split (pod, dest) pairs into (clean, rejected): a pod whose
        last solve failed the gate and was never cleanly re-solved must
        NOT bind.  Structurally unreachable (the gate raises before
        placements exist); every hit counts in
        ``scheduler_sanity_rejected_binds_total``."""
        if not self._rejected_keys:
            return placed, []
        with self._lock:
            rejected = [(pod, dest) for pod, dest in placed
                        if pod.key in self._rejected_keys]
        if rejected:
            metrics.GATE_REJECTED_BINDS.inc(len(rejected))
            log.error("refused to bind %d pod(s) from a sanity-gate-"
                      "rejected batch", len(rejected))
            drop = {id(p) for p, _ in rejected}
            placed = [pd for pd in placed if id(pd[0]) not in drop]
        return placed, rejected

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """The /debug/vars payload."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "mode": self._mode,
                "breakerOpen": self._mode == "open",
                "bucketCap": self._bucket_cap,
                "lastFault": self._last_fault,
                "gateRejects": self.gate_rejects,
                "requeuedPods": self.requeued_pods,
                "hbmWatermark": self.hbm_watermark,
                "breakerOpenSeconds": round(
                    self._open_s +
                    (time.monotonic() - self._opened_at
                     if self._mode == "open" else 0.0), 2),
            }

"""Device accounting: device-memory occupancy, per-cause transfer bytes,
and the post-prewarm kernel-build watchdog.

Counterpart of ``kubernetes_tpu/engine/devicestats.py`` on ``torch.cuda``:

* **Transfer accounting.**  ``record_transfer(cause, nbytes)`` feeds
  ``scheduler_device_transfer_bytes_total{cause=}`` (and an ops
  counter).  The drain path records ``scatter`` (dirty rows into the
  resident cluster mirror), ``full_upload`` (whole-cluster re-upload:
  relist or capacity growth) and ``readback`` (device-to-host result
  copies).  ``transfer_snapshot()`` returns the per-cause byte totals so
  a bench can diff a window.

* **Device memory.**  ``hbm_live_bytes()`` / ``hbm_peak_bytes()`` read
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` on the
  scheduler's device (``track_device``), and 0 for a CPU device; the
  ``scheduler_device_hbm_{live,peak}_bytes`` gauges read through them at
  expose.  ``sample_hbm()`` is the per-scrape read the telemetry ring
  and the benches call (the allocator keeps its own peak, so a sample
  refreshes nothing).

* **Kernel-build watchdog.**  The JAX package counts XLA compiles after
  prewarm; torch has no per-shape compile, so the honest counterpart is
  the ``nvcc`` build of the kernel library (``engine/kernels.py:build``
  reports each one).  ``arm()`` (called when ``Scheduler.prewarm()``
  finishes) makes every later build count in
  ``scheduler_post_prewarm_compiles_total{path=}`` (the live path the
  drain declared via ``live_path()``) and record a
  ``post_prewarm_compile`` span.  ``watchdog_window()`` arms it for a
  measured window and yields the count of builds inside it.

Everything here is observability: no hook can take the drain path down.
"""

from __future__ import annotations

import contextlib
import threading
import traceback
from typing import Callable, Iterator

import torch

from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("devicestats")

CAUSES = ("scatter", "full_upload", "readback")

_lock = threading.Lock()
_device: torch.device = torch.device("cpu")
_armed = False
_builds = 0
_tls = threading.local()    # .path — the live path running right now


# -- host reads and syncs outside the solve paths ---------------------------

def to_host(t: torch.Tensor):
    """``t`` read back as a numpy array: the one readback site of host
    layers that hold an engine-returned tensor (the extender's
    per-template evaluate rows and failure masks).  Unrecorded, as the
    JAX package's extender reads them with ``np.asarray``."""
    return t.cpu().numpy()


def synchronize(device: "torch.device | str") -> None:
    """Wait for the work queued on ``device`` (a no-op off CUDA): the
    prewarm's per-step timing edge."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- transfer accounting -----------------------------------------------------

def nbytes(tree: object) -> int:
    """Total bytes of a tensor tree (NamedTuple / list / tuple / dict of
    tensors or numpy arrays)."""
    if tree is None:
        return 0
    if hasattr(tree, "nbytes"):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):  # NamedTuples included
        return sum(nbytes(v) for v in tree)
    return 0


def record_transfer(cause: str, n: int) -> None:
    """Count ``n`` bytes moved for ``cause`` (scatter/full_upload/
    readback)."""
    if n <= 0:
        return
    metrics.DEVICE_TRANSFER_BYTES.labels(cause=cause).inc(int(n))
    metrics.DEVICE_TRANSFERS.labels(cause=cause).inc()


def transfer_snapshot() -> dict[str, int]:
    """Per-cause byte totals so far — diff two snapshots to account a
    window."""
    out = {cause: 0 for cause in CAUSES}
    for key, child in metrics.DEVICE_TRANSFER_BYTES.children().items():
        out[key[0]] = int(child.value)
    return out


# -- device memory -----------------------------------------------------------

def track_device(device: "torch.device | str") -> None:
    """The device whose memory the gauges report (the scheduler's)."""
    global _device
    _device = torch.device(device)


def hbm_live_bytes() -> int:
    """Bytes held by live tensors on the tracked device (0 on a CPU)."""
    try:
        if _device.type != "cuda":
            return 0
        return int(torch.cuda.memory_allocated(_device))
    except Exception:  # noqa: BLE001 — accounting must never raise
        return 0


def hbm_peak_bytes() -> int:
    """Peak bytes held on the tracked device since the process started
    (0 on a CPU)."""
    try:
        if _device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(_device))
    except Exception:  # noqa: BLE001
        return 0


def sample_hbm() -> int:
    """The live bytes now (called per telemetry scrape and per bench
    wave).  The CUDA caching allocator keeps the peak itself
    (``max_memory_allocated``), so there is no fallback peak to refresh;
    0 on a CPU device."""
    return hbm_live_bytes()


metrics.DEVICE_HBM_LIVE_BYTES.set_fn(hbm_live_bytes)
metrics.DEVICE_HBM_PEAK_BYTES.set_fn(hbm_peak_bytes)


# -- kernel-build watchdog ---------------------------------------------------

def _offending_signature() -> str:
    """The innermost frame of this package outside the build machinery:
    the call site whose launch needed the build."""
    try:
        for frame in reversed(traceback.extract_stack()):
            fn = frame.filename
            if "kubernetes_tpu_torch" in fn and not fn.endswith(
                    ("devicestats.py", "kernels.py")):
                return (f"{fn.rsplit('/', 1)[-1]}:{frame.lineno} "
                        f"{frame.name}")
    except Exception:  # noqa: BLE001
        pass
    return "unknown"


def record_build(seconds: float) -> None:
    """Called by ``kernels.build`` after every ``nvcc`` build; counts it
    as a post-prewarm build when the watchdog is armed."""
    global _builds
    with _lock:
        _builds += 1
        armed_now = _armed
    if not armed_now:
        return
    path = getattr(_tls, "path", None) or "unknown"
    sig = _offending_signature()
    metrics.POST_PREWARM_COMPILES.labels(path=path).inc()
    try:
        from kubernetes_tpu_torch.utils import trace
        trace.begin_span("post_prewarm_compile", path=path,
                         signature=sig, compile_s=round(seconds, 3)).end()
    except Exception:  # noqa: BLE001
        pass
    log.warning("post-prewarm kernel build on live path %r (%.2fs) at %s",
                path, seconds, sig)


def builds() -> int:
    """``nvcc`` builds this process has run."""
    return _builds


def arm() -> None:
    """Arm the watchdog: every kernel build from now on counts as a
    post-prewarm build.  Called by ``Scheduler.prewarm()``."""
    global _armed
    with _lock:
        _armed = True


def disarm() -> None:
    global _armed
    with _lock:
        _armed = False


def armed() -> bool:
    return _armed


def post_prewarm_compiles() -> int:
    return int(metrics.POST_PREWARM_COMPILES.value)


@contextlib.contextmanager
def watchdog_window() -> Iterator[Callable[[], int]]:
    """Arm for the duration of a measured window (benches, tests) and
    yield a callable returning the builds counted inside it."""
    before = post_prewarm_compiles()
    was = _armed
    arm()
    try:
        yield lambda: post_prewarm_compiles() - before
    finally:
        if not was:
            disarm()


@contextlib.contextmanager
def live_path(name: str) -> Iterator[None]:
    """Declare the live path (stream/oneshot/joint/single_pod/victim) for
    builds fired from this thread — the watchdog's ``path`` label."""
    prev = getattr(_tls, "path", None)
    _tls.path = name
    try:
        yield
    finally:
        _tls.path = prev

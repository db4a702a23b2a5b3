"""The solver-service boundary: one device engine shared by N tenants,
with per-tenant fault isolation and a packed multi-request solve API.

``SolverService`` owns the relationship between tenants and ONE engine
(a ``GenericScheduler`` with its resident cluster state, guard ladder,
and pre-warmed buckets).  Three surfaces:

* **Daemon-embedded** (``KT_TENANTS`` on a ConfigFactory): the drain
  pipeline consults the service for weighted packing
  (``tenancy/packer.py``), per-tenant breaker routing, and fault
  attribution — one daemon's queue serves N tenants' namespaces.
* **In-process submit** (``submit(tenant, pods)``): N daemons (or any
  rig) share one service; concurrent submissions inside the pack
  window coalesce into ONE padded device solve — tenant-tagged row
  slices, the pad's live mask covering them all — and the results
  split back per request.  The sequential-greedy scan gives later rows
  in-batch visibility of earlier ones, so a packed solve decides
  exactly like solving each request in sequence (the parity the tests
  pin).
* **HTTP** (``serve_solver`` / ``SolverClient`` / ``ServiceEngine``):
  the same submit API over the wire — POST ``/solve`` with pod JSON —
  so a remote ConfigFactory schedules against a device it doesn't own.

**Fault isolation.**  Device faults are attributed per tenant: a mixed
batch that faults is SPLIT per tenant and re-solved (the attribution
bisection); the tenant whose sub-batch keeps faulting trips ITS breaker
(``KT_TENANT_BREAKER`` consecutive, default 2) while every other tenant
stays on device.  Probe solves every ``KT_TENANT_PROBE_S`` (default
10 s) re-promote a broken tenant once its solves come back clean.  A
``lost`` fault is a whole-device event and still escalates through the
global guard (engine/guard.py) — per-tenant isolation covers the
ATTRIBUTABLE faults (poison batches, one tenant's OOM-sized rows), not a
dead card.

**The tripped tenant's pods** (the one known difference from the JAX
package, which decides them on its NumPy host engine): this package has
no host engine, and nothing carries on on the CPU when the card fails.
While a tenant's breaker is open (``MODE_OPEN``) its pods are surfaced —
the embedded daemon requeues them with backoff, a submit raises the
tenant's ``DeviceFault`` to its caller — and never placed, until the
tenant's probe rides the device again and re-promotes it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch import tenancy as tenancy_mod
from kubernetes_tpu_torch.tenancy.packer import TenantPacker
from kubernetes_tpu_torch.utils import knobs, locktrace, metrics, threadreg
from kubernetes_tpu_torch.utils.logging import get_logger

log = get_logger("tenancy")

MODE_DEVICE = "device"
# Breaker open: the JAX package's "host" mode, where its host engine
# decides the tenant's pods; here they are surfaced and requeued.
MODE_OPEN = "open"


class TenantState:
    """One tenant's breaker: consecutive attributable faults, mode, and
    the probe clock (mirrors the global guard's state machine, scoped)."""

    __slots__ = ("mode", "consecutive", "trips", "last_probe",
                 "opened_at", "open_s", "faults", "requeued_pods",
                 "open_kind")

    def __init__(self):
        self.mode = MODE_DEVICE
        self.consecutive = 0
        self.trips = 0
        self.last_probe = 0.0
        self.opened_at = 0.0
        self.open_s = 0.0
        self.faults: dict[str, int] = {}
        self.requeued_pods = 0
        self.open_kind = ""


class SolverService:
    """Per-tenant policy + the packed solve API over one shared engine."""

    def __init__(self, engine=None, tenants: Optional[list[str]] = None,
                 weights: Optional[dict[str, float]] = None,
                 ladder_fn: Optional[Callable[[], list]] = None,
                 urgent_s_fn: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.tenants = list(tenants) if tenants is not None \
            else tenancy_mod.tenant_names()
        self.weights = dict(weights) if weights is not None \
            else tenancy_mod.tenant_weights(self.tenants)
        self.ladder_fn = ladder_fn or (lambda: [])
        self.breaker_threshold = knobs.get_int("KT_TENANT_BREAKER")
        self.probe_period_s = knobs.get_float("KT_TENANT_PROBE_S")
        self.pack_window_s = knobs.get_float("KT_TENANT_PACK_MS") / 1e3
        self.packer = TenantPacker(self.pod_tenant, self.weights,
                                   urgent_s_fn=urgent_s_fn)
        self._lock = locktrace.make_lock("tenancy.SolverService.state")
        self._states: dict[str, TenantState] = {}
        # Fault-attribution accounting: splits of mixed faulted batches,
        # and faults that landed on a batch carrying NO tenant currently
        # under suspicion (the cross-tenant leak the tenancy bench holds at 0).
        self.fault_splits = 0
        self.cross_tenant_faults = 0
        # Packed-submit accounting (the service API surface).
        self.packed_solves = 0
        self.packed_requests = 0
        # Per-tenant row-share EMA for HBM attribution (+ the 1/s
        # refresh stamp bounding the live-arrays walk).
        self._share_ema: dict[str, float] = {}
        self._hbm_stamp = 0.0
        # In-process submit coalescing.  ``engine_lock`` serializes
        # EVERY solve against the shared engine — packed submits here
        # AND the embedded daemon's drain dispatches (the pipeline
        # takes it around its tenant solve path): GenericScheduler's
        # solve state (last_node_index, agg handoff, resident arrays)
        # is not safe under two concurrent solvers.
        self._pending: list[dict] = []
        self._pending_lock = locktrace.make_lock(
            "tenancy.SolverService.pending")
        # hold_ms=0: this lock IS the device occupancy — packed submits
        # and the embedded daemon's drain serialize on one solver, so
        # its hold time is the solve itself (measured by stage spans),
        # not a long-hold bug.  Order tracking stays on.
        self.engine_lock = locktrace.make_lock(
            "tenancy.SolverService.engine", hold_ms=0)
        for t in self.tenants:
            metrics.TENANT_ENGINE_MODE.labels(tenant=t).set(0.0)

    # -- identity ---------------------------------------------------------

    def pod_tenant(self, pod) -> str:
        return tenancy_mod.tenant_of(pod.namespace, self.tenants)

    def tenants_of(self, pods: list) -> list[str]:
        return sorted({self.pod_tenant(p) for p in pods})

    def split_by_tenant(self, pods: list) -> list[list]:
        """Per-tenant sub-batches (arrival order preserved) — the fault
        attribution bisection's unit."""
        groups: dict[str, list] = {}
        for pod in pods:
            groups.setdefault(self.pod_tenant(pod), []).append(pod)
        return [groups[t] for t in sorted(groups)]

    def count_tenants(self, pods: list) -> dict[str, int]:
        counts: dict[str, int] = {}
        for pod in pods:
            t = self.pod_tenant(pod)
            counts[t] = counts.get(t, 0) + 1
        return counts

    def _state(self, tenant: str) -> TenantState:
        st = self._states.get(tenant)
        if st is None:
            st = self._states[tenant] = TenantState()
        return st

    # -- the per-tenant breaker -------------------------------------------

    def _routes_to_device(self, tenant: str, probing: set,
                          now: float) -> bool:
        """Called under ``self._lock``: True when ``tenant``'s pods may
        ride the device — its breaker is closed, or it is open and its
        probe is due (``tenant`` then joins ``probing``)."""
        st = self._state(tenant)
        if st.mode != MODE_OPEN or tenant in probing:
            return True
        if now - st.last_probe >= self.probe_period_s:
            st.last_probe = now
            probing.add(tenant)
            return True
        return False

    def partition(self, pods: list) -> tuple[list, list, set]:
        """(device_pods, held_pods, probing_tenants): an open-breaker
        tenant's pods are held (the caller surfaces and requeues them),
        EXCEPT a tenant whose probe is due — its pods ride the device
        set as a probe (success closes its breaker; a fault sends it
        back without re-escalating)."""
        device: list = []
        held: list = []
        probing: set = set()
        now = time.monotonic()
        with self._lock:
            for pod in pods:
                if self._routes_to_device(self.pod_tenant(pod), probing,
                                          now):
                    device.append(pod)
                else:
                    held.append(pod)
        return device, held, probing

    def note_fault(self, tenant: str, kind: str,
                   probe: bool = False) -> bool:
        """An attributable device fault on this tenant's (single-tenant)
        sub-batch.  Returns True when the tenant's breaker is (now)
        open — the caller surfaces and requeues the remainder."""
        metrics.TENANT_FAULTS.labels(tenant=tenant, kind=kind).inc()
        with self._lock:
            st = self._state(tenant)
            st.faults[kind] = st.faults.get(kind, 0) + 1
            if probe and st.mode == MODE_OPEN:
                # A failed probe never re-escalates: stay open, reset
                # the probe clock.
                st.last_probe = time.monotonic()
                return True
            st.consecutive += 1
            if st.mode == MODE_OPEN:
                return True
            if st.consecutive >= self.breaker_threshold:
                st.mode = MODE_OPEN
                st.open_kind = kind
                st.trips += 1
                st.opened_at = time.monotonic()
                st.last_probe = st.opened_at
                metrics.TENANT_BREAKER_TRIPS.labels(tenant=tenant).inc()
                metrics.TENANT_ENGINE_MODE.labels(tenant=tenant).set(1.0)
                log.warning(
                    "tenant %s breaker OPEN after %d consecutive "
                    "attributable fault(s); its pods requeue until a "
                    "probe succeeds (every %.1fs) — other tenants stay "
                    "on device", tenant, st.consecutive,
                    self.probe_period_s)
                return True
        return False

    def note_success(self, tenant: str, probe: bool = False) -> None:
        with self._lock:
            st = self._state(tenant)
            st.consecutive = 0
            if probe and st.mode == MODE_OPEN:
                st.open_s += time.monotonic() - st.opened_at
                st.mode = MODE_DEVICE
                metrics.TENANT_ENGINE_MODE.labels(tenant=tenant).set(0.0)
                log.info("tenant %s probe succeeded; breaker closed, "
                         "tenant re-promoted to device", tenant)

    def note_split(self, fault) -> None:
        """A mixed-tenant batch faulted: the caller is splitting it per
        tenant to attribute.  If NO tenant in flight is under suspicion
        yet this is the first sighting, not a leak — leaks are faults
        that keep landing on clean tenants' SOLO batches, counted by
        note_fault attribution in the artifact's cross-tenant row."""
        with self._lock:
            self.fault_splits += 1

    def note_cross_tenant_fault(self) -> None:
        with self._lock:
            self.cross_tenant_faults += 1

    def note_requeued(self, tenant: str, pods: int) -> None:
        """``pods`` of an open-breaker tenant were surfaced and
        requeued (or refused to a submitter) instead of placed."""
        with self._lock:
            self._state(tenant).requeued_pods += pods

    def breaker_fault(self, tenant: str):
        """The fault an open-breaker tenant's held pods surface (not a
        new fault: nothing ran on the device, so nothing is counted)."""
        from kubernetes_tpu_torch.engine.guard import KIND_CORRUPT, DeviceFault
        with self._lock:
            st = self._state(tenant)
            kind = st.open_kind or KIND_CORRUPT
            wait = max(self.probe_period_s -
                       (time.monotonic() - st.last_probe), 0.0)
        return DeviceFault(kind, "tenant-breaker", RuntimeError(
            f"tenant {tenant} breaker open; next probe in {wait:.1f} s"))

    def tenant_mode(self, tenant: str) -> str:
        with self._lock:
            return self._state(tenant).mode

    # -- accounting (the SLO plane, per tenant) ---------------------------

    def record_bound(self, pod, latency_s: Optional[float]) -> None:
        """Bind-ack hook: per-tenant bound counter + decision-latency
        histogram (the per-tenant SLO's source)."""
        t = self.pod_tenant(pod)
        metrics.TENANT_BOUND.labels(tenant=t).inc()
        if latency_s is not None:
            metrics.TENANT_DECISION_LATENCY.labels(tenant=t).observe(
                latency_s * 1e6)

    def record_solve(self, pods: list, transfer_bytes: int) -> None:
        """Post-solve attribution: the solve's host<->device bytes split
        by tenant row share, and the live-HBM gauge attributed by an
        EMA of row shares (the resident tensors serve every tenant; the
        EMA answers 'whose load is the device carrying')."""
        if not pods:
            return
        counts = self.count_tenants(pods)
        total = sum(counts.values()) or 1
        if transfer_bytes > 0:
            for t, n in counts.items():
                metrics.TENANT_TRANSFER_BYTES.labels(tenant=t).inc(
                    int(transfer_bytes * n / total))
        # Refresh the live device-memory attribution gauge at most 1/s,
        # not per drain (the JAX package's rate, whose read can walk
        # every live array).
        from kubernetes_tpu_torch.engine import devicestats
        now = time.monotonic()
        refresh = now - self._hbm_stamp >= 1.0
        hbm = devicestats.hbm_live_bytes() if refresh else 0
        with self._lock:
            if refresh:
                self._hbm_stamp = now
            for t in self.tenants:
                share = counts.get(t, 0) / total
                ema = self._share_ema.get(t, share)
                self._share_ema[t] = ema = 0.8 * ema + 0.2 * share
                if hbm:
                    metrics.TENANT_HBM_BYTES.labels(tenant=t).set(
                        hbm * ema)

    def report(self) -> dict:
        """The /debug/vars + artifact payload."""
        now = time.monotonic()
        with self._lock:
            per_tenant = {}
            for t in self.tenants:
                st = self._state(t)
                per_tenant[t] = {
                    "mode": st.mode,
                    "weight": self.weights.get(t, 1.0),
                    "breakerTrips": st.trips,
                    "faults": dict(st.faults),
                    "requeuedPods": st.requeued_pods,
                    "breakerOpenSeconds": round(
                        st.open_s + (now - st.opened_at
                                     if st.mode == MODE_OPEN else 0.0),
                        2),
                }
            return {
                "tenants": per_tenant,
                "faultSplits": self.fault_splits,
                "crossTenantFaults": self.cross_tenant_faults,
                "packedSolves": self.packed_solves,
                "packedRequests": self.packed_requests,
            }

    # -- the packed submit API (in-process service boundary) --------------

    def _pad_bucket(self, n: int) -> int:
        """The warm ladder bucket a packed solve pads to (never an
        unwarmed shape); above the ladder, no pad (the one-shot path's
        own shape discipline applies)."""
        ladder = sorted(self.ladder_fn() or [])
        for b in ladder:
            if n <= b:
                return b
        return 0

    def submit(self, tenant: str, pods: list,
               timeout: float = 60.0) -> list:
        """Solve one tenant's pods against the shared engine.  Returns
        placements (node name or None per pod).  Concurrent submissions
        inside the pack window coalesce into one padded solve."""
        if not pods:
            return []
        if tenant not in self.tenants:
            # Client-supplied tenant strings are NOT trusted to name
            # state: map them onto the configured ring exactly like a
            # foreign namespace, so per-tenant state (and the
            # {tenant=} metric families) stay bounded by KT_TENANTS.
            tenant = tenancy_mod.tenant_of(tenant, self.tenants)
        req = {"tenant": tenant, "pods": list(pods),
               "done": threading.Event(), "result": None, "err": None}
        with self._pending_lock:
            self._pending.append(req)
        deadline = time.monotonic() + timeout
        while not req["done"].is_set():
            if not self.engine_lock.acquire(timeout=0.05):
                if time.monotonic() > deadline:
                    raise TimeoutError("solver service submit timed out")
                continue
            try:
                if req["done"].is_set():
                    break
                # Leader: linger one pack window so concurrent tenants'
                # requests coalesce, then take the whole pending set.
                if self.pack_window_s > 0:
                    time.sleep(self.pack_window_s)
                with self._pending_lock:
                    batch, self._pending = self._pending, []
                if batch:
                    self._solve_packed(batch)
            finally:
                self.engine_lock.release()
        if req["err"] is not None:
            raise req["err"]
        return req["result"]

    def submit_background(self, pods: list, timeout: float = 30.0,
                          joint: bool = True) -> Optional[list]:
        """Low-priority solve lane (the defragmenter's tenancy seat):
        solve only when NO live submit is pending or holding
        the engine — a background solve never queues ahead of a drain,
        so defrag dry-solves cannot steal device time from live
        tenants.  Returns placements, or None if the engine stayed busy
        for the whole ``timeout`` (the caller skips this round)."""
        if not pods:
            return []
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._pending_lock:
                busy = bool(self._pending)
            if busy:
                time.sleep(0.02)
                continue
            if not self.engine_lock.acquire(timeout=0.05):
                continue
            try:
                with self._pending_lock:
                    if self._pending:
                        # A live submit arrived while we took the lock:
                        # yield immediately — it becomes the leader on
                        # our release and drains the pending set.
                        continue
                return self.engine.schedule_batch(
                    pods, joint=joint, pad_to=self._pad_bucket(len(pods)))
            finally:
                self.engine_lock.release()
        return None

    def _solve_packed(self, batch: list[dict]) -> None:
        """One packed solve for every pending request: an open-breaker
        tenant's request is refused with the tenant's breaker fault
        unless its probe is due; the device set concatenates into ONE
        padded solve (tenant-tagged slices) whose sequential scan gives
        later requests in-batch visibility of earlier placements —
        decision parity with solving them in sequence.  A device fault
        splits per tenant for attribution, exactly like the pipeline
        path."""
        with self._pending_lock:
            self.packed_solves += 1
            self.packed_requests += len(batch)
        device_reqs: list[dict] = []
        probing: set = set()
        now = time.monotonic()
        for req in batch:
            with self._lock:
                routed = self._routes_to_device(req["tenant"], probing,
                                                now)
            if routed:
                device_reqs.append(req)
            else:
                self._hold_req(req, self.breaker_fault(req["tenant"]))
        if not device_reqs:
            return
        combined: list = []
        slices: list[tuple[dict, int, int]] = []
        for req in device_reqs:
            start = len(combined)
            combined.extend(req["pods"])
            slices.append((req, start, len(combined)))
        try:
            placements = self._solve_device(combined)
        except Exception as err:  # noqa: BLE001 — attribute per tenant
            self._solve_split(device_reqs, err, probing)
            return
        for req, a, b in slices:
            req["result"] = placements[a:b]
            req["done"].set()
        for t in {r["tenant"] for r in device_reqs}:
            self.note_success(t, probe=(t in probing))
        self.record_solve(combined, 0)

    def _solve_device(self, pods: list) -> list:
        from kubernetes_tpu_torch.chaos import device as chaos_device
        with chaos_device.tenant_context(self.tenants_of(pods)):
            return self.engine.schedule_batch(
                pods, pad_to=self._pad_bucket(len(pods)))

    def _hold_req(self, req: dict, fault) -> None:
        """Refuse a request with ``fault``: its submitter requeues the
        pods (the embedded and client daemons' crash handlers do) —
        nothing decides them on the CPU."""
        self.note_requeued(req["tenant"], len(req["pods"]))
        req["err"] = fault
        req["done"].set()

    def _solve_split(self, reqs: list[dict], fault,
                     probing: frozenset = frozenset()) -> None:
        """Attribution on the submit path: re-solve each request alone;
        the one that still faults counts against ITS tenant's breaker
        and is refused with its fault — the rest stay on device."""
        from kubernetes_tpu_torch.engine.guard import DeviceFault
        if len(reqs) > 1:
            self.note_split(fault)
        for req in reqs:
            t = req["tenant"]
            try:
                req["result"] = self._solve_device(req["pods"])
                req["done"].set()
                self.note_success(t, probe=(t in probing))
            except DeviceFault as f:
                self.note_fault(t, f.kind, probe=(t in probing))
                self._hold_req(req, f)
            except Exception as err:  # noqa: BLE001 — not a device fault
                req["err"] = err
                req["done"].set()


# -- HTTP exposure -----------------------------------------------------------


def solve_route(service: SolverService, body: bytes
                ) -> tuple[int, bytes, str]:
    """POST /solve handler body, shared by the standalone solver server
    and the scheduler daemon's status mux: ``{"tenant": t, "pods":
    [pod JSON, ...]}`` -> ``{"placements": [node|null, ...]}``."""
    from kubernetes_tpu_torch.api import types as api
    try:
        obj = json.loads(body or b"{}")
        tenant = obj.get("tenant", "")
        pods = [api.pod_from_json(p) for p in obj.get("pods") or []]
    except (ValueError, KeyError, TypeError) as err:
        return 400, json.dumps({"error": f"bad request: {err}"}).encode(), \
            "application/json"
    try:
        placements = service.submit(tenant, pods)
    except Exception as err:  # noqa: BLE001 — surface as a 500 payload
        return 500, json.dumps({"error": str(err)}).encode(), \
            "application/json"
    return 200, json.dumps({"tenant": tenant,
                            "placements": placements}).encode(), \
        "application/json"


def serve_solver(service: SolverService, port: int = 0,
                 host: str = "127.0.0.1"):
    """The standalone solver-service HTTP surface (the scheduler's
    status mux serves the same routes when tenancy is on): POST /solve,
    GET /tenancy (the report), GET /healthz."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.partition("?")[0]
            if path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif path == "/tenancy":
                self._send(200, json.dumps(service.report()).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            path = self.path.partition("?")[0]
            if path != "/solve":
                self._send(404, b'{"error": "not found"}')
                return
            try:
                clen = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                clen = 0
            body = self.rfile.read(clen) if clen else b""
            self._send(*solve_route(service, body))

    server = ThreadingHTTPServer((host, port), Handler)
    threadreg.spawn(server.serve_forever, name="solver-service-http")
    return server


class SolverClient:
    """Client side of the HTTP solve surface."""

    def __init__(self, base_url: str, timeout: float = 60.0):
        from urllib.parse import urlparse
        u = urlparse(base_url)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.timeout = timeout

    def solve(self, tenant: str, pods: list) -> list:
        """``pods``: api.Pod objects (serialized via pod_to_json) or raw
        pod JSON dicts."""
        import http.client

        from kubernetes_tpu_torch.api import types as api
        payload = json.dumps({
            "tenant": tenant,
            "pods": [p if isinstance(p, dict) else api.pod_to_json(p)
                     for p in pods]}).encode()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("POST", "/solve", body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        obj = json.loads(body or b"{}")
        if resp.status != 200:
            raise RuntimeError(f"solver service {resp.status}: "
                               f"{obj.get('error')}")
        return obj.get("placements") or []


class ServiceEngine:
    """A drop-in solve façade for a ConfigFactory whose daemon submits
    to a SHARED solver service instead of owning a device: the solve
    verbs forward to ``service.submit`` (in-process) or a
    ``SolverClient`` (HTTP), tagged with this daemon's tenant; cache
    feeding, assume/bind, and failure handling stay on the daemon.
    Built by ``ConfigFactory(solver_service=...)``."""

    def __init__(self, backend, tenant: str = "",
                 cache=None, listers=None):
        from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
        from kubernetes_tpu_torch.engine.generic_scheduler import Listers
        self.backend = backend
        self.tenant = tenant
        self.cache = cache if cache is not None else SchedulerCache()
        self.listers = listers if listers is not None else Listers()
        self.extenders = []
        # The client daemon owns no device (its prewarm no-ops).
        self.device = None
        # The client daemon runs no device solves of its own: its guard
        # is a disabled shim so the pipeline takes the plain dispatch
        # path (faults are handled service-side).
        from kubernetes_tpu_torch.engine.guard import DeviceGuard
        self.guard = DeviceGuard()
        self.guard.enabled = False

    # The resident mirror lives with the service's engine; recovery's
    # force_resnapshot hook degrades to a no-op shim here.
    @property
    def resident(self):
        class _Shim:
            def invalidate(self):
                pass

            def prewarm_scatter(self):
                pass
        return _Shim()

    def _submit(self, pods: list) -> list:
        if hasattr(self.backend, "submit"):
            return self.backend.submit(self.tenant, pods)
        return self.backend.solve(self.tenant, pods)

    def schedule_batch(self, pods: list, joint: bool = False,
                       pad_to: int = 0) -> list:
        return self._submit(pods) if pods else []

    def schedule_batch_host(self, pods: list) -> list:
        """The JAX package's host-engine verb: this package has no host
        engine, and a tripped tenant's pods requeue instead."""
        raise NotImplementedError(
            "kubernetes_tpu_torch has no host engine: a tripped tenant's "
            "pods are requeued until its probe re-promotes it, never "
            "decided on the CPU")

    def schedule_batch_stream(self, pods: list, chunk_size: int = 0,
                              defer_readback: bool = False):
        chunk = max(chunk_size or len(pods), 1)
        for i in range(0, len(pods), chunk):
            part = pods[i:i + chunk]
            placements = self._submit(part)
            if defer_readback:
                yield part, (lambda p=part, r=placements: (p, r))
            else:
                yield part, placements

    def schedule(self, pod):
        from kubernetes_tpu_torch.engine.generic_scheduler import FitError
        dest = self._submit([pod])[0]
        if dest is None:
            raise FitError(pod, {})
        return dest

    def explain_failures(self, pods: list) -> dict:
        return {}

    def find_preemptions(self, pods: list, protected=frozenset()) -> list:
        return []

    def take_agg_handoff(self):
        return None

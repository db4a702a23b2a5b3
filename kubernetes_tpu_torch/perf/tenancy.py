"""Multi-tenant solver-service bench: K tenants of mixed trickle /
burst / adversarial profiles over the full HTTP rig, measuring the four
numbers the tenancy subsystem exists for:

* **Per-tenant latency** — each tenant's own submit->bind distribution
  against its declared SLO (``rows``);
* **Cross-tenant interference** — the trickle tenant's p99 WITH a
  saturating noisy neighbor vs its solo p99 (``interference.ratio``;
  the acceptance bar is 2x at 100 % SLO attainment);
* **Weighted fairness** — under saturation (every tenant offering more
  than its share), observed bound-pod shares vs the configured
  ``KT_TENANT_WEIGHTS`` (``fairness.max_rel_error``; bar 10 %);
* **Fault isolation** — an adversarial tenant's poison batches (tenant-
  scoped ``chaos/device.py`` corrupt rules) must trip THAT tenant's
  breaker while the victims stay on device with zero cross-tenant
  faults, and the poisoned tenant must re-promote once the poison
  clears (``isolation``).  Where the JAX package decides the tripped
  tenant's pods on its host engine (its row counts them as host pods),
  this package requeues them until the probe re-promotes the tenant:
  the row counts them as ``requeued_pods``, and they must all bind on
  the device afterwards (``all_bound``).

The rig is the serving bench's: MemStore -> HTTP apiserver thread ->
one ConfigFactory daemon joined by list/watch/bind, with ``KT_TENANTS``
set so the daemon embeds the SolverService — tenants are namespaces,
and the three profiles drive three namespaces concurrently.

Counterpart of ``kubernetes_tpu/perf/tenancy.py`` on the port's daemon
(``device=``, default ``cuda``).  ``violations(rec)`` checks an artifact
against its own bars (SLO floors, interference, fairness, cross-tenant
faults, the isolation story, post-prewarm builds); ``main`` exits
non-zero on any.

Run: ``python -m kubernetes_tpu_torch.perf.tenancy --out
build/TENANCY_cuda.json [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kubernetes_tpu_torch.apiserver.memstore import MemStore
from kubernetes_tpu_torch.chaos import device as chaos_device
from kubernetes_tpu_torch.client.http import APIClient
from kubernetes_tpu_torch.perf.parity import (backend,
                                              refuse_reference_artifact)
from kubernetes_tpu_torch.perf.serving import (_BindTimer, _node_json,
                                               _percentile,
                                               poisson_arrivals)
from kubernetes_tpu_torch.utils import metrics

TENANTS = ("t-a", "t-b", "t-c")
WEIGHTS = {"t-a": 2.0, "t-b": 1.0, "t-c": 1.0}
DEADLINE_MS = 100.0
SLO_MS = 1000.0
INTERFERENCE_BAR = 2.0
FAIRNESS_BAR = 0.10


def _pod_json(ns: str, name: str) -> dict:
    return {"metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": "50m", "memory": "64Mi"}}}]}}


class _Rig:
    """One tenancy-enabled full-daemon HTTP rig.  ``preload`` (tenant ->
    pod count) creates a pending avalanche BEFORE the daemon starts —
    the reflector's initial list then hands the drain loop a saturated
    multi-tenant backlog from its first pop, the regime the fairness
    phase measures."""

    def __init__(self, n_nodes: int, stream_chunk: int = 2048,
                 preload: dict | None = None, device: str = "cuda"):
        from kubernetes_tpu_torch.apiserver.server import serve
        from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
        self.store = MemStore()
        self.api_srv = serve(self.store)
        self.url = f"http://127.0.0.1:{self.api_srv.server_address[1]}"
        self.direct = APIClient(self.url, qps=0)
        for i in range(0, n_nodes, 1000):
            self.direct.create_list(
                "nodes", [_node_json(f"tn-{j:05d}")
                          for j in range(i, min(i + 1000, n_nodes))])
        self.seq = 0
        self.submit_at: dict[str, float] = {}
        self.preloaded: dict[str, list[str]] = {}
        if preload:
            # Interleaved across tenants in small chunks so arrival
            # order (and with it the urgency lane) is tenant-fair.
            remaining = dict(preload)
            while any(remaining.values()):
                for tenant in list(remaining):
                    n = min(remaining[tenant], 250)
                    if n <= 0:
                        continue
                    remaining[tenant] -= n
                    self.preloaded.setdefault(tenant, []).extend(
                        f"{tenant}/{nm}"
                        for nm in self._create(tenant, n, direct=True))
        self.saved_env = {}
        for k, v in (("KT_PREWARM", "1"),
                     ("KT_BATCH_DEADLINE_MS", str(DEADLINE_MS)),
                     ("KT_TENANTS", ",".join(TENANTS)),
                     ("KT_TENANT_WEIGHTS",
                      ",".join(f"{t}:{w:g}" for t, w in WEIGHTS.items())),
                     ("KT_TENANT_BREAKER", "2"),
                     ("KT_TENANT_PROBE_S", "1.5"),
                     ("KT_POD_BACKOFF_S", "0.1"),
                     ("KT_POD_BACKOFF_MAX_S", "1")):
            self.saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        self.timer = _BindTimer(self.store)
        self.factory = ConfigFactory(self.url, qps=5000, burst=5000,
                                     device=device)
        self.daemon = self.factory.daemon
        self.daemon.STREAM_THRESHOLD = stream_chunk
        self.daemon.stream_chunk = stream_chunk
        self.factory.run()
        self.svc = self.factory.tenancy

    def _create(self, tenant: str, n: int, direct: bool) -> list[str]:
        names = []
        for _ in range(n):
            self.seq += 1
            names.append(f"tp-{self.seq:06d}")
        t = time.perf_counter()
        if direct:
            # Straight into the in-process store (no HTTP, no
            # admission): the avalanche loader; the daemon still
            # observes every pod through its HTTP list/watch.
            for nm in names:
                self.store.create("pods", _pod_json(tenant, nm))
        elif n == 1:
            self.direct.create("pods", _pod_json(tenant, names[0]))
        else:
            self.direct.create_list(
                "pods", [_pod_json(tenant, nm) for nm in names])
        for nm in names:
            self.submit_at[f"{tenant}/{nm}"] = t
        return names

    def submit(self, tenant: str, n: int) -> list[str]:
        return self._create(tenant, n, direct=False)

    def wait_bound(self, keys: list[str], timeout: float = 120.0) -> int:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all(k in self.timer.bound_at for k in keys):
                break
            time.sleep(0.05)
        return sum(1 for k in keys if k in self.timer.bound_at)

    def latencies_ms(self, keys: list[str]) -> list[float]:
        out = []
        for k in keys:
            t1 = self.timer.bound_at.get(k)
            if t1 is not None:
                out.append((t1 - self.submit_at[k]) * 1e3)
        return out

    def bound_counts(self, keys_by_tenant: dict[str, list[str]]
                     ) -> dict[str, int]:
        return {t: sum(1 for k in keys if k in self.timer.bound_at)
                for t, keys in keys_by_tenant.items()}

    def stop(self) -> None:
        if getattr(self, "_stopped", False):
            return
        self._stopped = True
        self.timer.stop()
        try:
            self.factory.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        self.api_srv.shutdown()
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _row(tenant: str, lat_ms: list[float], offered: int,
         floor_pct: float) -> dict:
    attained = sum(1 for v in lat_ms if v <= SLO_MS)
    return {
        "tenant": tenant,
        "pods": offered,
        "bound": len(lat_ms),
        "latency_ms": {
            "p50": round(_percentile(lat_ms, 50), 1),
            "p90": round(_percentile(lat_ms, 90), 1),
            "p99": round(_percentile(lat_ms, 99), 1),
            "max": round(max(lat_ms), 1) if lat_ms else 0.0,
        },
        "slo": {
            "slo_ms": SLO_MS,
            "attainment_pct": round(
                100.0 * attained / max(offered, 1), 2),
            "attainment_floor_pct": floor_pct,
        },
    }


def _drive_trickle(rig: _Rig, tenant: str, rate: float, duration: float,
                   seed: int = 7) -> list[str]:
    keys = []
    t0 = time.perf_counter()
    for offset, _ in poisson_arrivals(rate, duration, seed=seed):
        now = time.perf_counter() - t0
        if offset > now:
            time.sleep(offset - now)
        keys.append(f"{tenant}/{rig.submit(tenant, 1)[0]}")
    return keys


def collect(n_nodes: int = 400, trickle_rate: float = 20.0,
            trickle_s: float = 8.0, offered_per_tenant: int = 5000,
            quiet: bool = False, device: str = "cuda") -> dict:
    """All four phases on one rig; returns the TENANCY artifact.
    The JAX package's artifact scale is the default; tests run
    seconds-long toy sizes through the same code."""
    import threading

    from kubernetes_tpu_torch.engine import devicestats
    rig = _Rig(n_nodes, device=device)
    rig2 = None
    compiles0 = devicestats.post_prewarm_compiles()
    try:
        # -- phase 1: the trickle tenant alone (the interference base) --
        solo_keys = _drive_trickle(rig, "t-a", trickle_rate, trickle_s)
        rig.wait_bound(solo_keys)
        solo_lat = rig.latencies_ms(solo_keys)
        solo_row = _row("t-a", solo_lat, len(solo_keys), 100.0)
        if not quiet:
            print(f"tenancy[solo] t-a p99 "
                  f"{solo_row['latency_ms']['p99']}ms", file=sys.stderr)

        # -- phase 2: trickle + saturating noisy neighbor ---------------
        burst_keys: list[str] = []
        stop_bursts = threading.Event()

        def noisy():
            while not stop_bursts.is_set():
                burst_keys.extend(
                    f"t-b/{nm}" for nm in rig.submit("t-b", 200))
                stop_bursts.wait(0.4)
        burst_thread = threading.Thread(target=noisy, daemon=True)
        burst_thread.start()
        time.sleep(0.5)  # let the neighbor's backlog build first
        trickle_keys = _drive_trickle(rig, "t-a", trickle_rate,
                                      trickle_s * 1.25, seed=11)
        stop_bursts.set()
        burst_thread.join()
        rig.wait_bound(trickle_keys)
        rig.wait_bound(burst_keys)
        with_lat = rig.latencies_ms(trickle_keys)
        with_row = _row("t-a", with_lat, len(trickle_keys), 100.0)
        noisy_row = _row("t-b", rig.latencies_ms(burst_keys),
                         len(burst_keys), 0.0)
        ratio = with_row["latency_ms"]["p99"] / \
            max(solo_row["latency_ms"]["p99"], 1e-9)
        if not quiet:
            print(f"tenancy[noisy] t-a p99 "
                  f"{with_row['latency_ms']['p99']}ms (solo "
                  f"{solo_row['latency_ms']['p99']}ms, ratio "
                  f"{ratio:.2f}), t-b p99 "
                  f"{noisy_row['latency_ms']['p99']}ms", file=sys.stderr)

        # -- phase 3: adversarial tenant / fault isolation --------------
        trips0 = {t: metrics.TENANT_BREAKER_TRIPS.labels(tenant=t).value
                  for t in TENANTS}
        chaos = chaos_device.DeviceChaos([chaos_device.DeviceRule(
            fault="corrupt", every_nth=1, count=4, tenant="t-c")])
        chaos_device.install(chaos)
        try:
            iso_keys: dict[str, list[str]] = {}
            for tenant in TENANTS:
                iso_keys[tenant] = [
                    f"{tenant}/{nm}" for nm in rig.submit(tenant, 120)]
            for tenant in TENANTS:
                rig.wait_bound(iso_keys[tenant], timeout=60)
            # Poison exhausted (count=4): wait for the probe loop to
            # re-promote t-c to device.
            deadline = time.time() + 30
            while time.time() < deadline and \
                    rig.svc.tenant_mode("t-c") != "device":
                rig.submit("t-c", 1)
                time.sleep(0.5)
        finally:
            chaos_device.install(None)
        report = rig.svc.report()
        victim_trips = {
            t: metrics.TENANT_BREAKER_TRIPS.labels(tenant=t).value
            - trips0[t] for t in ("t-a", "t-b")}
        all_iso = [k for ks in iso_keys.values() for k in ks]
        iso_bound = rig.wait_bound(all_iso, timeout=60)
        isolation = {
            "adversarial_tenant": "t-c",
            "poison_batches": 4,
            "tenant_faults": {
                t: report["tenants"][t]["faults"] for t in TENANTS},
            "breaker_trips": {
                t: report["tenants"][t]["breakerTrips"]
                for t in TENANTS},
            "fault_splits": report["faultSplits"],
            "cross_tenant_faults":
                sum(sum(report["tenants"][t]["faults"].values())
                    for t in ("t-a", "t-b")),
            "cross_tenant_sanity_rejects":
                sum(report["tenants"][t]["faults"].get("corrupt", 0)
                    for t in ("t-a", "t-b")),
            "victim_breaker_trips": victim_trips,
            "victim_modes": {t: rig.svc.tenant_mode(t)
                             for t in ("t-a", "t-b")},
            # The tripped tenant's pods this package held and requeued
            # (the JAX package decides them on its host engine).
            "requeued_pods": {
                t: report["tenants"][t]["requeuedPods"] for t in TENANTS},
            "repromoted": rig.svc.tenant_mode("t-c") == "device",
            "all_bound": iso_bound == len(all_iso),
        }
        if not quiet:
            print(f"tenancy[isolation] faults "
                  f"{isolation['tenant_faults']}, cross-tenant "
                  f"{isolation['cross_tenant_faults']}, victims "
                  f"{isolation['victim_modes']}, repromoted "
                  f"{isolation['repromoted']}", file=sys.stderr)

        # -- phase 4: weighted fairness under a pre-loaded avalanche ----
        # A dedicated rig whose whole offered load is pending BEFORE
        # the daemon's first drain: saturation by construction (the
        # live-arrival phases above are paced by the watch feed and
        # never out-run the solver), so every drain is packed at the
        # cap and the observed shares are pure packer selection.
        rig.stop()
        deferred0 = {t: metrics.TENANT_DEFERRED.labels(tenant=t).value
                     for t in TENANTS}
        rig2 = _Rig(n_nodes, preload={t: offered_per_tenant
                                      for t in TENANTS}, device=device)
        total_offered = offered_per_tenant * len(TENANTS)
        sample_at = int(total_offered * 0.45)
        sampled: dict = {}
        sampler_stop = threading.Event()

        def sampler():
            # Capture the FIRST snapshot at or past the sample point —
            # a post-hoc read would overshoot into the frozen tail
            # where shares converge to equality because everything
            # eventually binds.
            while not sampler_stop.is_set():
                counts = rig2.bound_counts(rig2.preloaded)
                if sum(counts.values()) >= sample_at:
                    sampled.update(counts)
                    return
                sampler_stop.wait(0.02)
        sampler_thread = threading.Thread(target=sampler, daemon=True)
        sampler_thread.start()
        sampler_thread.join(timeout=240)
        sampler_stop.set()
        observed = dict(sampled)
        total_w = sum(WEIGHTS.values())
        expected = {t: WEIGHTS[t] / total_w for t in TENANTS}
        sample_total = sum(observed.values()) or 1
        shares = {t: observed.get(t, 0) / sample_total for t in TENANTS}
        rel_err = {t: abs(shares[t] - expected[t]) / expected[t]
                   for t in TENANTS}
        all_keys = [k for ks in rig2.preloaded.values() for k in ks]
        fair_bound = rig2.wait_bound(all_keys, timeout=240)
        deferred = {t: metrics.TENANT_DEFERRED.labels(tenant=t).value
                    - deferred0[t] for t in TENANTS}
        rig2.stop()
        if not quiet:
            print(f"tenancy[fairness] shares "
                  f"{ {t: round(s, 3) for t, s in shares.items()} } vs "
                  f"expected "
                  f"{ {t: round(e, 3) for t, e in expected.items()} } "
                  f"(deferred {deferred}, bound {fair_bound})",
                  file=sys.stderr)
        return {
            "harness": "kubernetes_tpu_torch/perf/tenancy.py (full daemon "
                       "over HTTP, KT_TENANTS embedded solver service: "
                       "solo trickle baseline, saturating noisy "
                       "neighbor, 3-tenant weighted saturation, "
                       "tenant-scoped poison-batch isolation)",
            **backend(device),
            "tenants": list(TENANTS),
            "weights": dict(WEIGHTS),
            "deadline_ms": DEADLINE_MS,
            "nodes": n_nodes,
            "rows": {
                "trickle_solo": solo_row,
                "trickle_with_neighbor": with_row,
                "noisy_neighbor": noisy_row,
            },
            "interference": {
                "trickle_solo_p99_ms": solo_row["latency_ms"]["p99"],
                "trickle_with_neighbor_p99_ms":
                    with_row["latency_ms"]["p99"],
                "ratio": round(ratio, 3),
                "bar": INTERFERENCE_BAR,
            },
            "fairness": {
                "offered_per_tenant": offered_per_tenant,
                "sampled_at_bound": sample_total,
                "bound_total": fair_bound,
                "weights": dict(WEIGHTS),
                "expected_shares": {t: round(e, 4)
                                    for t, e in expected.items()},
                "observed_shares": {t: round(s, 4)
                                    for t, s in shares.items()},
                "max_rel_error": round(max(rel_err.values()), 4),
                "bar": FAIRNESS_BAR,
                "deferred_pods": deferred,
            },
            "isolation": isolation,
            "device": {
                "post_prewarm_compiles":
                    devicestats.post_prewarm_compiles() - compiles0,
            },
        }
    finally:
        rig.stop()
        if rig2 is not None:
            rig2.stop()


def violations(rec: dict) -> list[str]:
    """Every bar the artifact ``rec`` misses, by name; [] when it passes
    them all."""
    out = []
    for name, row in rec["rows"].items():
        slo = row["slo"]
        if slo["attainment_pct"] < slo["attainment_floor_pct"]:
            out.append(f"{name}: SLO attainment {slo['attainment_pct']}% "
                       f"below its floor {slo['attainment_floor_pct']}%")
    inter = rec["interference"]
    if inter["ratio"] > inter["bar"]:
        out.append(f"interference ratio {inter['ratio']} above "
                   f"{inter['bar']}")
    fair = rec["fairness"]
    if fair["max_rel_error"] > fair["bar"]:
        out.append(f"fairness error {fair['max_rel_error']} above "
                   f"{fair['bar']}")
    if fair["bound_total"] != fair["offered_per_tenant"] * \
            len(rec["tenants"]):
        out.append(f"fairness rig bound {fair['bound_total']} of "
                   f"{fair['offered_per_tenant'] * len(rec['tenants'])}")
    iso = rec["isolation"]
    adv = iso["adversarial_tenant"]
    if iso["cross_tenant_faults"]:
        out.append(f"{iso['cross_tenant_faults']} cross-tenant faults")
    if not iso["breaker_trips"].get(adv):
        out.append(f"the poisoned tenant {adv} never tripped")
    if not iso["repromoted"]:
        out.append(f"the poisoned tenant {adv} was not re-promoted")
    if not iso["all_bound"]:
        out.append("isolation pods left unbound")
    if any(m != "device" for m in iso["victim_modes"].values()):
        out.append(f"a victim left device mode: {iso['victim_modes']}")
    if any(iso["victim_breaker_trips"].values()):
        out.append(f"a victim tripped: {iso['victim_breaker_trips']}")
    if rec["device"]["post_prewarm_compiles"]:
        out.append(f"{rec['device']['post_prewarm_compiles']} kernel "
                   f"builds after prewarm")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/TENANCY_cuda.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--trickle-rate", type=float, default=20.0)
    opts = ap.parse_args(argv)
    refuse_reference_artifact(opts.out, "TENANCY_r12.json")
    rec = collect(n_nodes=opts.nodes, trickle_rate=opts.trickle_rate,
                  device=opts.device)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"wrote {opts.out}: interference ratio "
          f"{rec['interference']['ratio']}, fairness error "
          f"{rec['fairness']['max_rel_error']}, cross-tenant faults "
          f"{rec['isolation']['cross_tenant_faults']}")
    missed = violations(rec)
    if missed:
        raise SystemExit("tenancy bars missed: " + "; ".join(missed))


if __name__ == "__main__":
    main()

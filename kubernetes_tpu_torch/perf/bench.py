"""Headline benchmark of the port: the north-star queue through the full
daemon, repeated, in process and over the wire, with medians, spreads and
stage splits.

Counterpart of the root ``bench.py`` (the JAX package's bench, which
stays as it is): ``python -m kubernetes_tpu_torch.perf.bench [--device
cpu] [--out build/BENCH_cuda.json] [--profile-dir DIR]``.  It reads the
same environment names: ``BENCH_NODES`` (5000), ``BENCH_PODS`` (30000),
``BENCH_PROFILE`` (mixed), ``BENCH_DENSITY_RUNS`` (5), ``BENCH_WIRE`` (1),
``BENCH_WIRE_RUNS`` (3), ``BENCH_JOINT`` (1), ``BENCH_WORKLOADS`` (1) and
``BENCH_SERVING`` (1); 0 skips a phase.

* **density**: ``BENCH_DENSITY_RUNS`` runs of ``perf/harness.density``
  for each setting (``stream``, ``one-shot``; ``harness.py`` says what
  each means), every run on a fresh rig with its own warm-up; every
  run, the best, the p50, the min/max spread, and the best run's stage
  breakdown, device columns and ``profile`` section.
* **wire**: ``BENCH_WIRE_RUNS`` runs of ``harness.density_wire`` for each
  setting; the median run, with zero-bound and failed runs counted,
  never dropped and never medianed as 0.
* **joint**: ``perf/workloads.joint_quality``; **workloads**: its
  ``collect()`` (written beside ``--out`` as ``WORKLOADS_<backend>.json``);
  **serving**: ``perf/serving.collect()`` (``SERVING_<backend>.json``).

The headline keys (``value``, ``runs``, ``median``, ``elapsed_s_*``,
``stages``, ``device``, ``profile``, ``wire``) are the ``stream``
setting's, the reference's choice off a TPU; ``settings`` holds both
settings' blocks.  A phase that fails fails the run: the artifact is
written, the failure named in it, and the exit status is non-zero.
The artifact names the device: ``"backend": "cpu"`` for a CPU run, and
on a card ``"backend": "cuda"`` with the card line (``nvidia-smi``), the
one-time kernel-library build and ``post_prewarm_compiles`` (``nvcc``
builds after each run's warm-up; it must be 0).

Left out, each named under ``left_out`` in the artifact: ``cold_vs_warm``
(the JAX persistent compile cache; the port has no per-shape compile),
``soak`` and ``tenancy`` (ROADMAP §A items 6 and 8), ``fleet`` (§A 8)
and the ``xray`` stamp (§A 7).  It never writes the JAX package's
records (``BENCH_r*.json``, ``BASELINE*``, ``SERVING_r*``, ...).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

LEFT_OUT = {
    "cold_vs_warm": "not applicable: it times the JAX persistent compile "
                    "cache; the port compiles nothing per shape and its "
                    "nvcc library is cached by a hash of its sources "
                    "(see library_build_s)",
    "soak": "waits for ROADMAP §A items 6 and 8 (shards, the chaos "
            "proxy, the controllers)",
    "tenancy": "waits for ROADMAP §A item 6 (tenancy)",
    "fleet": "waits for ROADMAP §A item 8 (controllers, hollow kubelet)",
    "xray": "waits for ROADMAP §A item 7 (the compile-surface manifest)",
}
BASELINE_PODS_PER_S = 8.0  # test/e2e/density.go:48 MinPodsPerSecondThroughput
_REFERENCE_RECORDS = ("BENCH_r", "BASELINE", "SERVING_r", "WORKLOADS_r",
                      "SOAK_r", "TENANCY_r", "MULTICHIP_r", "PARITY.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--profile-dir", default="",
                   help="write torch.profiler Chrome traces of every "
                        "solve here (also KT_PROFILE_DIR)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: exits non-zero "
                        "without a card; cpu must be asked for)")
    p.add_argument("--out", default="",
                   help="where the whole artifact is written (default "
                        "build/BENCH_<backend>.json: build/BENCH_cuda.json "
                        "on a card)")
    p.add_argument("--serving-trickle-s", type=float, default=20.0,
                   help="the serving phase's Poisson trickle window")
    return p


def _refuse(path: str) -> None:
    name = os.path.basename(path)
    if name.startswith(_REFERENCE_RECORDS):
        raise SystemExit(f"{name} is a record of the JAX package; write "
                         f"this package's artifact elsewhere (--out)")


def _p50(values: list) -> float:
    return sorted(values)[len(values) // 2]


def density_block(results: list) -> dict:
    """One setting's repeated density runs, in the reference's keys."""
    best = max(results, key=lambda r: r.pods_per_second)
    return {
        "setting": best.setting,
        "route": best.route,
        "value": round(best.pods_per_second, 3),
        "unit": "pods/s",
        "vs_baseline": round(best.pods_per_second / BASELINE_PODS_PER_S,
                             1),
        "runs": [round(r.pods_per_second, 3) for r in results],
        "median": round(_p50([r.pods_per_second for r in results]), 3),
        "elapsed_s_runs": [round(r.elapsed_s, 6) for r in results],
        "elapsed_s_p50": round(_p50([r.elapsed_s for r in results]), 6),
        "elapsed_s_spread": {
            "min": round(min(r.elapsed_s for r in results), 6),
            "max": round(max(r.elapsed_s for r in results), 6)},
        "scheduled_runs": [r.scheduled for r in results],
        "warm_s_runs": [round(r.warm_s, 6) for r in results],
        # Best run's breakdown, device columns and CPU attribution.
        "stages": best.stages,
        "device": best.device,
        "profile": best.profile,
    }


def wire_block(results: list, zero_bound: int, failed: int,
               errors: list) -> dict:
    """One setting's wire runs: the MEDIAN run (a best-of rule would
    enshrine outliers in either direction), failures counted."""
    out = {"metric": "same shape over HTTP: apiserver as a separate "
                     "process, daemon bound by list/watch/bind at "
                     "QPS/burst 5000",
           "zero_bound_runs": zero_bound, "failed_runs": failed,
           "errors": errors}
    if not results:
        out["runs"] = []
        return out
    ranked = sorted(results, key=lambda r: r.pods_per_second)
    med = ranked[len(ranked) // 2]
    out.update({
        "setting": med.setting,
        "route": med.route,
        "apiserver": med.apiserver,
        "pods_per_second": round(med.pods_per_second, 3),
        "elapsed_s": round(med.elapsed_s, 6),
        "scheduled": med.scheduled,
        "create_s": round(med.create_s, 6),
        "warm_compile_s": round(med.warm_s, 6),
        "runs": [round(r.pods_per_second, 3) for r in ranked],
        "median_pods_per_second": round(med.pods_per_second, 3),
        "elapsed_s_runs": [round(r.elapsed_s, 6) for r in results],
        "elapsed_s_spread": {
            "min": round(min(r.elapsed_s for r in results), 6),
            "max": round(max(r.elapsed_s for r in results), 6)},
        "scheduled_runs": [r.scheduled for r in results],
        "post_prewarm_compiles": sum(r.post_prewarm_compiles
                                     for r in results),
        "launches": med.launches,
        "stages": med.stages,
        "warm_breakdown": med.warm_breakdown,
        "profile": med.profile,
        "status_routes": results[0].status_routes,
    })
    return out


def main(argv=None) -> int:
    opts = build_parser().parse_args(argv)
    from kubernetes_tpu_torch.utils import device as device_mod
    try:
        dev = device_mod.resolve(opts.device)
    except RuntimeError as err:
        raise SystemExit(f"bench: {err}")
    device = str(dev)
    opts.out = opts.out or f"build/BENCH_{dev.type}.json"
    _refuse(opts.out)
    profile_dir = opts.profile_dir or os.environ.get("KT_PROFILE_DIR", "")
    if profile_dir:
        # Every solve the phases run is wrapped in device_trace; the flag
        # just arms the directory.
        from kubernetes_tpu_torch.utils.profiling import set_profile_dir
        set_profile_dir(profile_dir)
    n_nodes = int(os.environ.get("BENCH_NODES", "5000"))
    n_pods = int(os.environ.get("BENCH_PODS", "30000"))
    profile = os.environ.get("BENCH_PROFILE", "mixed")
    out_dir = os.path.dirname(opts.out) or "."

    from kubernetes_tpu_torch.engine import devicestats
    from kubernetes_tpu_torch.perf import harness
    from kubernetes_tpu_torch.perf.parity import backend
    stamp = backend(device)
    print(f"bench: {n_nodes} nodes x {n_pods} pods, profile={profile}, "
          f"backend={stamp['backend']} {stamp.get('card', '')}",
          file=sys.stderr)
    failures: list[str] = []
    library = None
    if dev.type == "cuda":
        # The one-time cost the JAX bench's cold_vs_warm measured as a
        # compile: the nvcc build (or, when this checkout built it
        # before, the load) of the kernel library.
        from kubernetes_tpu_torch.engine import kernels
        builds0 = devicestats.builds()
        t0 = time.perf_counter()
        kernels.library()
        library = {"seconds": round(time.perf_counter() - t0, 6),
                   "built": devicestats.builds() > builds0,
                   "path": str(kernels.library_path())}

    # -- density: repeated runs per setting, each on a fresh rig.
    runs_n = int(os.environ.get("BENCH_DENSITY_RUNS", "5"))
    settings: dict = {}
    launches_by_path: dict = {}
    cold_compile_s = None
    for setting in harness.SETTINGS:
        before = harness.kernel_launches()
        results = []
        for _ in range(runs_n):
            t0 = time.perf_counter()
            r = harness.density(n_nodes, n_pods, profile=profile,
                                setting=setting, device=device)
            if cold_compile_s is None:
                cold_compile_s = time.perf_counter() - t0 - r.elapsed_s
            results.append(r)
        launches_by_path[f"bench_density_{setting}"] = \
            harness.launches_since(before)
        settings[setting] = density_block(results)
        short = [r for r in results if r.scheduled != n_pods]
        if short:
            failures.append(f"density {setting}: {len(short)} run(s) "
                            f"bound fewer than {n_pods} pods")

    # -- wire: the same shape over HTTP, median of repeated runs.
    wire: dict = {}
    if os.environ.get("BENCH_WIRE", "1") != "0":
        wire_runs = int(os.environ.get("BENCH_WIRE_RUNS", "3"))
        for setting in harness.SETTINGS:
            before = harness.kernel_launches()
            results, zero_bound, failed, errors = [], 0, 0, []
            for i in range(wire_runs):
                try:
                    r = harness.density_wire(
                        n_nodes, n_pods, profile=profile, setting=setting,
                        device=device,
                        status_routes=("/debug/timeseries",
                                       "/debug/dashboard",
                                       "/debug/profile") if i == 0 else ())
                except harness.ZeroBoundError as err:
                    zero_bound += 1
                    errors.append(f"zero-bound: {err}")
                    continue
                except Exception as err:  # noqa: BLE001 — counted;
                    # the run then fails
                    failed += 1
                    errors.append(f"{type(err).__name__}: {err}")
                    continue
                results.append(r)
            launches_by_path[f"bench_wire_{setting}"] = \
                harness.launches_since(before)
            wire[setting] = wire_block(results, zero_bound, failed, errors)
            if zero_bound or failed:
                failures.append(f"wire {setting}: {zero_bound} zero-bound "
                                f"and {failed} failed run(s): "
                                f"{errors[0]}")
            short = [r for r in results if r.scheduled != n_pods]
            if short:
                failures.append(f"wire {setting}: {len(short)} run(s) "
                                f"bound fewer than {n_pods} pods")
            if results and min(r.pods_per_second for r in results) < \
                    max(r.pods_per_second for r in results) / 2:
                print(f"wire {setting} runs disagree >2x: "
                      f"{wire[setting]['runs']}; reporting the median run",
                      file=sys.stderr)

    # The wire daemons' prewarm armed the build watchdog process-wide;
    # the remaining phases build fresh rigs, so disarm.
    devicestats.disarm()

    joint = None
    if os.environ.get("BENCH_JOINT", "1") != "0":
        from kubernetes_tpu_torch.perf.workloads import joint_quality
        q = joint_quality(device=device)
        joint = {k: q[k] for k in ("metric", "greedy_placed",
                                   "joint_placed", "joint_vs_greedy")}
        print(f"joint quality: greedy placed {q['greedy_placed']}, joint "
              f"placed {q['joint_placed']}", file=sys.stderr)

    workloads = None
    if os.environ.get("BENCH_WORKLOADS", "1") != "0":
        from kubernetes_tpu_torch.perf import workloads as wl
        rec = wl.collect(device=device)
        path = os.path.join(out_dir, f"WORKLOADS_{stamp['backend']}.json")
        _write(path, rec)
        workloads = {
            "joint_vs_greedy": rec["joint_quality"]["joint_vs_greedy"],
            "joint_warm_s": rec["joint_quality"]["joint_warm_s"],
            "preemption_parity_pct":
                rec["preemption_parity"]["parity_pct"],
            "gang_warm_solve_s": rec["gang"]["warm_solve_s"],
            "partial_gangs_bound": rec["gang"]["partial_gangs_bound"],
            "record": path,
        }
        print(f"workloads: quality x{workloads['joint_vs_greedy']}, "
              f"preemption parity {workloads['preemption_parity_pct']}% "
              f"-> {path}", file=sys.stderr)

    serving = None
    if os.environ.get("BENCH_SERVING", "1") != "0":
        from kubernetes_tpu_torch.perf import serving as serving_mod
        before = harness.kernel_launches()
        rec = serving_mod.collect(trickle_s=opts.serving_trickle_s,
                                  device=device)
        launches_by_path["serving"] = harness.launches_since(before)
        path = os.path.join(out_dir, f"SERVING_{stamp['backend']}.json")
        _write(path, rec)
        rows = rec["workloads"]
        trickle = rows["poisson_trickle"]
        serving = {
            "deadline_ms": rec["deadline_ms"],
            "trickle_p50_ms": trickle["latency_ms"]["p50"],
            "trickle_p99_ms": trickle["latency_ms"]["p99"],
            "trickle_slo_attainment_pct":
                trickle["slo"]["attainment_pct"],
            "burst_p99_ms": rows["burst_replay"]["latency_ms"]["p99"],
            "goodput_pods_s": trickle["goodput_pods_s"],
            "trickle_s": rec["trickle"]["duration_s"],
            "rows": {name: {"pods": row["pods"], "bound": row["bound"],
                            "latency_ms": row["latency_ms"],
                            "slo": row["slo"]}
                     for name, row in rows.items()},
            "post_prewarm_compiles": rec["device"]["post_prewarm_compiles"],
            "record": path,
        }
        for name, row in rows.items():
            if row["unbound"]:
                failures.append(f"serving {name}: {row['unbound']} pods "
                                f"never bound")

    head = settings["stream"]
    post_prewarm = sum(r["device"]["post_prewarm_compiles"]
                       for r in settings.values()) + \
        sum(w.get("post_prewarm_compiles", 0) for w in wire.values())
    out = {
        "metric": f"scheduler throughput, {n_pods} pods onto {n_nodes} "
                  f"nodes (default policy, full daemon: queue->batched "
                  f"device solve->assume->bind)",
        **stamp,
        "value": head["value"],
        "unit": "pods/s",
        "vs_baseline": head["vs_baseline"],
        "cold_compile_s": round(cold_compile_s or 0.0, 1),
        "runs": head["runs"],
        "median": head["median"],
        "elapsed_s_runs": head["elapsed_s_runs"],
        "elapsed_s_p50": head["elapsed_s_p50"],
        "elapsed_s_spread": head["elapsed_s_spread"],
        "stages": head["stages"],
        "device": head["device"],
        "profile": head["profile"],
        "headline_setting": "stream",
        "settings": settings,
        "library_build_s": library,
        "post_prewarm_compiles": post_prewarm,
        "launches_by_path": launches_by_path,
        "left_out": LEFT_OUT,
    }
    if profile_dir:
        from kubernetes_tpu_torch.utils import profiling
        out["profile_dir"] = {"path": profile_dir, **profiling.stats()}
    if joint is not None:
        out["joint"] = joint
    if workloads is not None:
        out["workloads"] = workloads
    if wire:
        out["wire"] = dict(wire["stream"], settings=wire)
    if serving is not None:
        out["serving"] = serving
    if post_prewarm:
        failures.append(f"{post_prewarm} kernel builds after the warm-up")
    from kubernetes_tpu_torch.utils import profiler
    prof = profiler.get()
    if prof is not None:
        # The whole run's folded stacks (collapsed form), for reading
        # what each profile section's components are made of.
        path = os.path.join(out_dir, f"PROFILE_{stamp['backend']}.collapsed")
        with open(path, "w") as f:
            f.write(prof.collapsed())
        out["collapsed_stacks"] = path
    out["failures"] = failures
    _write(opts.out, out)
    headline = {k: v for k, v in out.items() if k not in ("settings",)}
    if "wire" in headline:
        headline["wire"] = {k: v for k, v in headline["wire"].items()
                            if k != "settings"}
    print(json.dumps(headline))
    if failures:
        print(f"bench: FAILED: {'; '.join(failures)}", file=sys.stderr)
        return 1
    return 0


def _write(path: str, rec: dict) -> None:
    _refuse(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    sys.exit(main())

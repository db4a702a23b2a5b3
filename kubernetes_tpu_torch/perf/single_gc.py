"""Where the single-pod decision's tail goes: cyclic garbage collection.

Run from the root of a checkout (on a card, or with ``--device cpu``)::

    python -m kubernetes_tpu_torch.perf.single_gc

It builds a ``mixed`` rig (5,000 nodes, 512 pods by default) and places
every pod with ``GenericScheduler.schedule`` then ``cache.assume_pod``,
timing each decision and its ``_compile``, and recording every cyclic
garbage collection (``gc.callbacks``) that ran inside it.  It does so
twice: once as a caller would, and once after ``gc.collect()`` and
``gc.freeze()`` move the rig's long-lived objects out of the collector's
reach.  It prints p50/p99/max per decision for each run and the slowest
decisions with the collections inside them.
"""

from __future__ import annotations

import argparse
import gc
import statistics
import time

import torch

from kubernetes_tpu_torch.perf import synth


def run(nodes: int, pods: int, device: str, freeze: bool) -> dict:
    events: list[tuple[float, int, float]] = []
    started = [0.0]

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            events.append((time.perf_counter(), info["generation"],
                           time.perf_counter() - started[0]))

    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device=device)
    compile_fn = sched._compile
    last_compile = [0.0]

    def timed_compile(*a, **k):
        t0 = time.perf_counter()
        out = compile_fn(*a, **k)
        if device == "cuda":
            torch.cuda.synchronize()
        last_compile[0] = time.perf_counter() - t0
        return out

    sched._compile = timed_compile
    if freeze:
        gc.collect()
        gc.freeze()
    gc.callbacks.append(on_gc)
    rows = []
    try:
        for pod in plist:
            t0 = time.perf_counter()
            dest = sched.schedule(pod)
            t1 = time.perf_counter()
            sched.cache.assume_pod(pod, dest)
            inside = [(g, d) for t, g, d in events if t0 <= t <= t1]
            rows.append((t1 - t0, last_compile[0], inside))
    finally:
        gc.callbacks.remove(on_gc)
        if freeze:
            gc.unfreeze()
    warm = rows[1:]
    lat = sorted(r[0] for r in warm)
    return {
        "p50_ms": lat[len(lat) // 2] * 1e3,
        "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
        "max_ms": lat[-1] * 1e3,
        "compile_p50_ms": statistics.median(r[1] for r in warm) * 1e3,
        "collections": len(events),
        "gen2": [d * 1e3 for _, g, d in events if g == 2],
        "slowest": sorted(warm, key=lambda r: r[0], reverse=True)[:5],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        print(f"device {torch.cuda.get_device_name(0)}")
    for freeze in (False, True):
        res = run(args.nodes, args.pods, args.device, freeze)
        gen2 = res["gen2"]
        print(f"single_gc: {args.device} {args.nodes} nodes x {args.pods} "
              f"decisions, gc.freeze {freeze}: p50 {res['p50_ms']:.3f} ms "
              f"p99 {res['p99_ms']:.3f} ms max {res['max_ms']:.3f} ms; "
              f"_compile p50 {res['compile_p50_ms']:.3f} ms; "
              f"{res['collections']} collections, {len(gen2)} of "
              f"generation 2 (median {statistics.median(gen2 or [0]):.3f} "
              f"ms, max {max(gen2 or [0]):.3f} ms)")
        for wall, comp, inside in res["slowest"]:
            gen2_ms = sum(d for g, d in inside if g == 2) * 1e3
            print(f"single_gc:   slow decision {wall * 1e3:.3f} ms "
                  f"(_compile {comp * 1e3:.3f} ms): {len(inside)} "
                  f"collections inside, generation 2 {gen2_ms:.3f} ms")


if __name__ == "__main__":
    main()

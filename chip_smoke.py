#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``kubernetes_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA GPU (Hopper: the kernels are built for ``sm_90a``) and ``nvcc``;
it imports nothing of JAX or of the JAX package.  Phases, each of which
fails the run with a non-zero exit:

1. card and build: the card's name and power limit (``nvidia-smi``),
   then the kernel library (select and scan kernels) built from
   ``kubernetes_tpu_torch/csrc`` with one ``nvcc`` command;
2. select kernel against plain: the CUDA select against
   ``select_plain`` on the card, bit for bit, over edge-case rows and
   counters (incl. the uint32 wrap), then both timed per call at
   N = 5,000 with CUDA events;
2b. scan kernel against plain: ``scan_chunk`` against the step loop on
   the card (``perf/scan_check.py``: choices, counter and every carried
   state tensor bit for bit, two chunks per case), then one 2,048-pod
   chunk at 5,000 nodes timed with CUDA events against its byte bound
   and the step loop;
3. card against CPU: the streamed drain of a reduced ``mixed`` rig
   (through the scan kernel) and of a ``rich`` rig (through the step
   loop and the select kernel) on ``cuda`` and on ``cpu`` must place
   every pod identically, with the same counter;
4. full width: the streamed drain of the north-star ``mixed`` rig
   (5,000 nodes x 30,000 pods, chunk 2048) through the scan kernel,
   checked for index range, node capacity and one kernel launch per
   chunk; a second drain splits its wall time into the host compile,
   the hoist plus the scan, and the readback;
5. profile: a drain of two chunks at full node width under
   torch.profiler, for the card's busy share and the kernels that take
   its time;
6. select_hosts kernel against plain: ``kt_select_hosts`` (the
   single-pod selectHost) against ``select_hosts_plain`` on the card,
   choices and counter identical, over N in {1, 31, 257, 5,000, 16,384},
   P in {1, 64}, infeasible rows, feasible -inf/+inf/NaN scores, ties
   across thread segments, counters 0/2^31/2^32-1/2^32 and rows mixing
   feasible and infeasible; then timed per call at N = 5,000, P = 1
   (CUDA-graph replay);
7. single pod at full width: ``schedule(pod)`` then ``assume_pod`` for
   the 512 pods of a 5,000-node ``mixed`` rig plus one pod that fits
   nowhere, on ``cuda`` and on ``cpu``: placements, counter and the
   FitError map identical; microseconds per decision on the card, the
   kernel's launches, a split of a decision into ``_compile``,
   evaluate and the select with its readback; ``explain_failures`` of
   64 pods, cuda against cpu;
8. extender sidecar: ``serve_in_thread(device="cuda")`` answers the
   reference latency test's workload over HTTP (5,000 ``mixed`` nodes
   with resourceVersions, 200 probes, a fresh template every 10th, one
   filter and one prioritize each), every response byte-identical to an
   ``ExtenderCore(device="cpu")``'s; then 64 of the exchanges replayed
   from 4 client threads at once, again identical; cold request, warm
   p50/p99 per verb and the share of device work;
9. daemon density: a ``Scheduler`` over 5,000 ``mixed`` nodes drains the
   30,000 north-star pods twice — (a) with the reference defaults (one
   one-shot solve) and (b) with ``STREAM_THRESHOLD = 4096`` (the
   overlapped stream) — each placing every pod exactly as phase 4's
   library drain did, no node over capacity, and from the daemon's own
   metrics 0 crashed pods, 0 device faults and 0 refused binds; wall,
   pods/s, assume/bind time and the kernels' launches of each run;
10. factory: ``ConfigFactory`` over a ``MemStore`` holding 5,000 nodes
   and 4,096 pods before ``run()``, on cuda and on cpu, every pod's
   nodeName identical, with the time from ``run()`` to the last bind and
   ``last_recovery``; then ``python -m kubernetes_tpu_torch.scheduler
   --device cuda --port 0`` answers /healthz and /configz and exits 0 on
   SIGTERM;
11. preemption: 5,000 nodes filled by low-priority pods, 16 priority
   pods that fit nowhere (and 2 that fit nowhere at all): decisions,
   bindings, evicted victims and requeued pods identical on cuda and
   cpu; ``victim_solve`` per call at N = 5,000, V = 16 against its byte
   bound;
12. device guard: a real CUDA out-of-memory error classifies as ``oom``;
   a ``KT_CHAOS_DEVICE`` cadence (an OOM, then a device loss) in a
   daemon drain of 4,096 pods: every pod binds as in the fault-free run,
   the fault counters match the injection, and no mode reads ``host``.

13. topology spread: (a) a ``mixed`` drain of 5,000 nodes x 4,096 pods,
   40% of them carrying a zone DoNotSchedule term (half of those also a
   hostname ScheduleAnyway term), on cuda and cpu, identical; (b) the
   north star with the same annotations: every choice inside its
   batch-start hard mask, no node over capacity, the largest zone skew
   after the drain, a split (planes, ``_compile``, scan, readback) and
   one chunk's planes timed against their bound; (c) 65
   ``schedule(pod)`` decisions with a hard term, one of them admitted by
   no domain, cuda against cpu incl. the FitError map;
14. the joint solve: (a) ``perf/workloads.joint_quality`` (500 nodes x
   6,000 pods, seed 7) on cuda and cpu, records and placements
   identical; (b) the north star through the daemon with the
   ``JointSolver`` gate on, one one-shot joint solve: every pod's node
   passes every predicate at batch start, no node over capacity, and a
   split (evaluate, 24 price iterations, order and permutation, the
   repair scan, readback, assume/bind);
15. harnesses: ``perf/parity.run_parity`` (1,000 x 10,000 ``rich``, 200
   sampled decisions) on the card with at least 99% agreement with the
   oracle, then ``run_preemption_parity`` and ``gang_bench`` at their
   defaults with no partial gang bound.

Phase 2b includes the f32 route of the joint repair and topology spread:
a non-integral score bias and an extra mask with all-false rows.  It
prints one ``{"kernels": [...]}`` line (with each kernel's launches on
its phase's path, in the two daemon runs of phase 9 and on the paths of
phases 13-15), then the card line, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor-core f32 rate and the int32 rate (half of it), for the
# least-time bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_per_call(fn, reps: int = 30, inner: int = 100,
                  warmup: int = 50) -> float:
    """Median over ``reps`` of the mean per-call time (ms) of ``inner``
    back-to-back eager calls, timed with CUDA events after a warm-up.
    For a call this small it measures how fast the host issues it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / inner)
    return statistics.median(per)


def device_time_per_call(fn, reps: int = 30, inner: int = 200) -> float:
    """The call's time on the card (ms): ``inner`` calls captured in one
    CUDA graph and replayed ``reps`` times, so no host gap separates
    them; the median over replays of the mean per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / inner)
    return statistics.median(per)


def synced(acc: dict, key: str, fn):
    """``fn`` wrapped so each call is synchronised before and after and
    its seconds are added to ``acc[key]``."""
    import torch

    def call(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return out
    return call


def select_cases(n: int, rng: np.random.RandomState) -> list[np.ndarray]:
    """Edge-case rows of width ``n`` for the select kernel."""
    neg = -np.inf
    rows = [np.full(n, neg, np.float32)]                  # nothing feasible
    one = np.full(n, neg, np.float32)
    one[rng.randint(n)] = 7.0                             # single feasible
    rows.append(one)
    ties = rng.randint(0, 3, n).astype(np.float32)        # many ties
    ties[rng.rand(n) < 0.4] = neg
    rows.append(ties)
    rows.append(np.full(n, 3.0, np.float32))              # every node ties
    pinf = rng.randint(0, 3, n).astype(np.float32)        # +inf max
    pinf[rng.randint(n)] = np.inf
    rows.append(pinf)
    rows.append(rng.randn(n).astype(np.float32))          # distinct values
    big = rng.randint(0, 100061, n).astype(np.float32)    # score-sized ints
    big[rng.rand(n) < 0.1] = neg
    rows.append(big)
    return rows


COUNTERS = (0, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7)
CHUNK = 2048          # the drain's chunk, as the daemon runs it
PROFILE_PODS = 4096   # scan steps in the profiled window (two chunks)


def phase_kernel(dev) -> dict:
    import torch
    from kubernetes_tpu_torch.engine import fused

    rng = np.random.RandomState(0)
    worst = 0
    n_rows = 0
    for n in (1, 8, 33, 1000, 5000, 5003):
        rows = select_cases(n, rng)
        masked = np.repeat(np.stack(rows), len(COUNTERS), axis=0)
        counter = np.tile(np.asarray(COUNTERS, np.int64), len(rows))
        m_d = torch.from_numpy(masked).to(dev)
        c_d = torch.from_numpy(counter).to(dev)
        got = fused.select_rows(m_d, c_d)
        want = fused.select_plain(m_d, c_d)
        # The scan's shape: one row at a time.
        for r in range(0, masked.shape[0], 5):
            one = fused.select_rows(m_d[r:r + 1].contiguous(),
                                    c_d[r:r + 1].contiguous())
            if not torch.equal(one, want[r:r + 1]):
                fail(f"select kernel (P=1) != plain at N={n} row {r}: "
                     f"{one.tolist()} vs {want[r:r + 1].tolist()}")
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
            fail(f"select kernel != plain at N={n}, rows {bad}: "
                 f"{got[bad].tolist()} vs {want[bad].tolist()}")
        n_rows += masked.shape[0]
    # Counter wrap through the scan's own update: 2^32-1 then +1.
    row = torch.full((1, 33), 1.0, device=dev)
    c = torch.tensor([2 ** 32 - 1], dtype=torch.int64, device=dev)
    before = fused.select_rows(row, c)
    c = (c + 1) & 0xFFFFFFFF
    after = fused.select_rows(row, c)
    if before[0, 0].item() != (2 ** 32 - 1) % 33 or after[0, 0].item() != 0:
        fail(f"counter wrap: {before.tolist()} then {after.tolist()}")
    print(f"phase 2: select kernel == select_plain on {n_rows} rows "
          f"(N in 1..5003, counters {COUNTERS}), max_abs_err {worst}")

    n = 5000
    m = torch.from_numpy(select_cases(n, rng)[2]).to(dev).reshape(1, n)
    c1 = torch.tensor([12345], dtype=torch.int64, device=dev)
    kernel = lambda: fused.select_rows(m, c1)  # noqa: E731
    plain = lambda: fused.select_plain(m, c1)  # noqa: E731
    # Device time (graph replay), in turns: kernel, plain, plain, kernel.
    k_ms = device_time_per_call(kernel)
    p_ms = device_time_per_call(plain)
    p2_ms = device_time_per_call(plain)
    k2_ms = device_time_per_call(kernel)
    k_eager = time_per_call(kernel)
    p_eager = time_per_call(plain)
    # Least time: read the row and the counter, write (choice, n); about
    # 3 f32 operations per element (max, compare, count).
    bytes_ms = (n * 4 + 8 + 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"phase 2: N={n} P=1 per call on the card (CUDA graph replay): "
          f"kernel {k_ms:.6f} / {k2_ms:.6f} ms, plain {p_ms:.6f} / "
          f"{p2_ms:.6f} ms; eager, host-issued: kernel {k_eager:.6f} ms, "
          f"plain {p_eager:.6f} ms; bound {bound_ms:.9f} ms")
    return {"max_abs_err": worst, "ms": statistics.median([k_ms, k2_ms]),
            "plain_ms": statistics.median([p_ms, p2_ms]),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def scan_bound(enc, kw: dict) -> tuple[float, str]:
    from kubernetes_tpu_torch.perf.scan_check import STATE

    """Least time (ms) of one ``scan_chunk`` call and what sets it: each
    input read once, the carried state read once and written once, the
    choices written once; against the operations every (pod, node) step
    needs (f32: the select's two compares, the template add, the spread
    score and its zone blend, one add per weighted term; int32: the
    resource fit)."""
    p, n = enc.shape
    nbytes = enc.numel() * enc.element_size() + p * 4
    for name, t in kw.items():
        if hasattr(t, "element_size"):
            once = t.numel() * t.element_size()
            nbytes += 2 * once if name in STATE else once
    f32 = 2
    if kw.get("d_plane") is not None:
        f32 += 1
    for name, _w, _aux in kw.get("terms", ()):
        if name in ("SelectorSpreadPriority", "ServiceSpreadingPriority"):
            f32 += 6 + (7 if kw.get("sp_zone") is not None else 0)
        else:
            f32 += 8
        f32 += 1
    int32 = 7 if kw.get("use_resources") else 0
    ops_ms = p * n * (f32 / F32_OPS_PER_S + int32 / INT32_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_scan(dev) -> dict:
    """scan_chunk against the step loop on every case of perf/scan_check,
    then one north-star chunk timed."""
    import torch
    from kubernetes_tpu_torch.engine import scan as scan_mod
    from kubernetes_tpu_torch.perf import scan_check

    worst = 0.0
    n_steps = 0
    for case in scan_check.cases(dev):
        t0 = time.perf_counter()
        try:
            res = scan_check.run_routes(case)
        except scan_check.ScanMismatch as err:
            fail(f"scan kernel != step loop: {err}")
        torch.cuda.synchronize()
        if case.infeasible != (res["placed"] == 0):
            fail(f"scan case {case.name!r} placed {res['placed']} pods")
        worst = max(worst, res["max_abs_err"])
        n_steps += res["steps"]
        print(f"phase 2b: {case.name}: scan kernel == step loop (choices, "
              f"counter, state bit for bit) over {res['steps']} steps in 2 "
              f"chunks, {res['placed']} placed, "
              f"{time.perf_counter() - t0:.3f} s")
    print(f"phase 2b: all scan cases agree, {n_steps} steps, "
          f"max_abs_err {worst}")

    # One north-star chunk: its kernel arguments captured, then the launch
    # alone (the state restored before each), the step loop and the kernel
    # route with its hoist, in turns.
    ns = scan_check.north_star_chunk(5000, CHUNK, dev)
    enc, kw, init = ns["enc"], ns["kw"], ns["init"]

    def chunk(route: str) -> float:
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        ns["sched"].solver._solve_scan(ns["db"], ns["dc"], counter, None,
                                       ns["flags"], None, None, None,
                                       route=route)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    def kernel_once() -> float:
        for k, v in init.items():
            kw[k].copy_(v)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        scan_mod.scan_chunk(enc, **kw)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    k_ms = [kernel_once() for _ in range(5)]
    p_ms = chunk("steps")
    h_ms = [chunk("kernel") for _ in range(3)]
    k_ms += [kernel_once() for _ in range(5)]
    p2_ms = chunk("steps")
    bound_ms, bound_by = scan_bound(enc, kw)
    p, n = enc.shape
    ms = statistics.median(k_ms)
    plain_ms = statistics.median([p_ms, p2_ms])
    print(f"phase 2b: one chunk of {p} pods x {n} nodes ({enc.dtype}): "
          f"kernel {ms:.6f} ms (median of {len(k_ms)}; min "
          f"{min(k_ms):.6f}, max {max(k_ms):.6f}) = "
          f"{ms / p * 1e3:.6f} us per step; with its hoist "
          f"{statistics.median(h_ms):.6f} ms; step loop {p_ms:.3f} / "
          f"{p2_ms:.3f} ms = {plain_ms / p * 1e3:.3f} us per step; bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def drain(sched, pods, chunk: int) -> tuple[list, float]:
    import torch
    t0 = time.perf_counter()
    out = [node for _, placed in sched.schedule_batch_stream(
        pods, chunk_size=chunk) for node in placed]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_parity(profile: str, nodes: int, pods: int, chunk: int) -> dict:
    """The same drain on cuda and on cpu: identical placements and
    counter.  Returns the cuda drain's kernel launches."""
    from kubernetes_tpu_torch.engine import fused, scan
    from kubernetes_tpu_torch.perf import synth

    placements = {}
    launches = {}
    for dev in ("cuda", "cpu"):
        sched, plist = synth.make_rig(nodes, pods, profile=profile,
                                      device=dev)
        fused.select_rows.launches = scan.scan_chunk.launches = 0
        out, secs = drain(sched, plist, chunk)
        if dev == "cuda":
            launches = {"select_rows": fused.select_rows.launches,
                        "scan_chunk": scan.scan_chunk.launches}
        placements[dev] = (out, int(sched.last_node_index))
        print(f"phase 3: {dev} drain {profile} {nodes} nodes x {pods} pods "
              f"(chunk {chunk}): {secs:.3f} s, placed "
              f"{sum(x is not None for x in out)}, last_node_index "
              f"{int(sched.last_node_index)}")
    if placements["cuda"] != placements["cpu"]:
        a, b = placements["cuda"][0], placements["cpu"][0]
        diff = [i for i in range(len(a)) if a[i] != b[i]][:5]
        fail(f"{profile}: cuda and cpu drains differ at pods {diff} "
             f"(counters {placements['cuda'][1]} vs {placements['cpu'][1]})")
    chunks = -(-pods // chunk)
    want = {"scan_chunk": chunks, "select_rows": 0} if profile == "mixed" \
        else {"scan_chunk": 0, "select_rows": chunks * chunk}
    if launches != want:
        fail(f"{profile} drain launched {launches}, expected {want}")
    print(f"phase 3: {profile}: cuda placements and counter == cpu; "
          f"kernel launches {launches}")
    return launches


def split_drain(nodes: int, pods: int, chunk: int) -> dict:
    """A drain whose wall time is split: ``_compile`` (host snapshot,
    feature compile and upload), each chunk's ``_solve_scan`` (the hoist
    plus the scan, synchronised so it is charged to the card's work), and
    the rest (the readback of each chunk's choices and the host code
    around it)."""
    from kubernetes_tpu_torch.perf import synth

    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device="cuda")
    acc = {"compile": 0.0, "scan": 0.0}
    solver = sched.solver
    sched._compile = synced(acc, "compile", sched._compile)
    solver._solve_scan = synced(acc, "scan", solver._solve_scan)
    try:
        _, secs = drain(sched, plist, chunk)
    finally:
        del solver._solve_scan
    acc["readback"] = secs - acc["compile"] - acc["scan"]
    acc["wall"] = secs
    return acc


def phase_full(nodes: int, pods: int, chunk: int, card: str) -> dict:
    import torch
    from kubernetes_tpu_torch.engine import fused, scan
    from kubernetes_tpu_torch.features import compiler as fc
    from kubernetes_tpu_torch.perf import synth

    warm, wpods = synth.make_rig(nodes, chunk, profile="mixed",
                                 device="cuda")
    _, wsecs = drain(warm, wpods, chunk)
    print(f"phase 4: warm-up drain {nodes} x {chunk}: {wsecs:.3f} s")

    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device="cuda")
    chunks = -(-pods // chunk)
    fused.select_rows.launches = scan.scan_chunk.launches = 0
    out, secs = drain(sched, plist, chunk)
    launches = scan.scan_chunk.launches
    if launches != chunks or fused.select_rows.launches != 0:
        fail(f"scan kernel launched {launches} times for {chunks} chunks, "
             f"select kernel {fused.select_rows.launches} times (want 0)")
    nt = sched.cache.snapshot()[0]
    idx = np.array([-1 if x is None else nt.name_to_idx[x] for x in out])
    if len(idx) != pods or idx.min() < -1 or idx.max() >= nodes:
        fail(f"choices out of range [-1, {nodes})")
    used = np.zeros((nodes, 4), np.int64)
    for pod, j in zip(plist, idx):
        if j >= 0:
            used[j] += fc.pod_resource_row(pod)
    over = used[:, [fc.RES_CPU, fc.RES_MEM, fc.RES_PODS]] > \
        nt.alloc[:, [fc.RES_CPU, fc.RES_MEM, fc.RES_PODS]]
    if over.any():
        fail(f"{int(over.any(axis=1).sum())} nodes over capacity")
    placed = int((idx >= 0).sum())
    print(f"phase 4: {card}: drain {nodes} nodes x {pods} pods "
          f"(mixed, chunk {chunk}): {secs:.3f} s wall, "
          f"{pods / secs:.1f} pods/s, placed {placed}, "
          f"scan kernel launches {launches} == chunks {chunks}, select "
          f"kernel launches 0, no node over capacity")
    split = split_drain(nodes, pods, chunk)
    print(f"phase 4: split drain {nodes} x {pods}: {split['wall']:.3f} s "
          f"wall = _compile {split['compile']:.3f} s + hoist and scan "
          f"{split['scan']:.3f} s + readback and the rest "
          f"{split['readback']:.3f} s ({pods / split['wall']:.1f} pods/s)")
    return {"launches": launches, "counter": int(sched.last_node_index),
            "placements": {pod.key: node for pod, node in zip(plist, out)
                           if node is not None}}


def phase_profile(nodes: int, pods: int) -> None:
    """Where a drain's time goes: one short streamed drain at full node
    width under torch.profiler — the card's busy time (sum of kernel
    times) against the wall time, kernel launches per scan step, and the
    kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.perf import synth

    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs = drain(sched, plist, CHUNK)
    rows = []
    for k in prof.key_averages():
        if getattr(k, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(k, "self_device_time_total",
                     getattr(k, "self_cuda_time_total", 0.0))
        rows.append((us, k.count, k.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    if busy_ms <= 0:
        print(f"phase 5: drain {nodes} x {pods} under the profiler: "
              f"{secs:.3f} s wall; device time not measured (the profiler "
              f"reported no kernel time)")
        return
    print(f"phase 5: drain {nodes} nodes x {pods} pods under the profiler: "
          f"{secs * 1e3:.3f} ms wall, card busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (secs * 1e3):.2f}% busy), {launches} kernel "
          f"launches = {launches / pods:.3f} per scan step")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"phase 5:   {us / 1e3:10.3f} ms  {count:7d} x  {key[:90]}")


def select_hosts_cases(p: int, n: int, rng: np.random.RandomState
                       ) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """(name, scores [p, n] f32, feasible [p, n] bool) edge cases for the
    single-pod select."""
    base = rng.randint(0, 3, (p, n)).astype(np.float32)
    half = rng.rand(p, n) < 0.5
    cases = [("infeasible", base, np.zeros((p, n), bool))]
    ninf = np.full((p, n), -np.inf, np.float32)
    cases.append(("feasible -inf", ninf, half))
    pinf = base.copy()
    pinf[rng.rand(p, n) < 0.02] = np.inf
    cases.append(("feasible +inf", pinf, half | (pinf == np.inf)))
    nan = base.copy()
    nan[rng.rand(p, n) < 0.02] = np.nan
    cases.append(("feasible NaN", nan, np.ones((p, n), bool)))
    # Equal scores on every 7th node: the ties fall in many threads'
    # segments, so the rank crosses the block scan.
    seventh = np.zeros((p, n), bool)
    seventh[:, ::7] = True
    cases.append(("ties across segments", np.ones((p, n), np.float32),
                  seventh))
    rows = half.copy()
    rows[::2] = False
    cases.append(("mixed rows", base, rows))
    cases.append(("distinct", rng.randn(p, n).astype(np.float32), half))
    return cases


HOSTS_COUNTERS = (0, 2 ** 31, 2 ** 32 - 1, 2 ** 32)


def phase_select_hosts(dev) -> dict:
    """kt_select_hosts against select_hosts_plain on the card, then the
    time per call at N = 5,000, P = 1."""
    import torch
    from kubernetes_tpu_torch.ops import combine

    rng = np.random.RandomState(6)
    calls = rows = 0
    for n in (1, 31, 257, 5000, 16384):
        for p in (1, 64):
            for name, scores, feasible in select_hosts_cases(p, n, rng):
                s_d = torch.from_numpy(scores).to(dev)
                f_d = torch.from_numpy(feasible).to(dev)
                for last in HOSTS_COUNTERS:
                    l_d = torch.tensor([last], dtype=torch.int64, device=dev)
                    got = combine.select_hosts(s_d, f_d, l_d)
                    want = combine.select_hosts_plain(s_d, f_d, l_d)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        bad = (got[0] != want[0]).nonzero()[:5]
                        bad = bad.flatten().tolist()
                        fail(f"select_hosts kernel != plain: N={n} P={p} "
                             f"{name!r} counter {last}: rows {bad}: "
                             f"{got[0][bad].tolist()} vs "
                             f"{want[0][bad].tolist()}, counter "
                             f"{got[1].tolist()} vs {want[1].tolist()}")
                    calls += 1
                    rows += p
    print(f"phase 6: select_hosts kernel == select_hosts_plain (choices "
          f"and counter) in {calls} calls over {rows} rows (N in 1..16384, "
          f"P in (1, 64), counters {HOSTS_COUNTERS}), max_abs_err 0")

    n = 5000
    scores = rng.randint(0, 60, (1, n)).astype(np.float32)
    feasible = rng.rand(1, n) < 0.6
    s1 = torch.from_numpy(scores).to(dev)
    f1 = torch.from_numpy(feasible).to(dev)
    last = torch.tensor([12345], dtype=torch.int64, device=dev)
    counter = last.clone()
    choice = torch.empty(1, dtype=torch.int32, device=dev)
    kernel = lambda: combine.launch(s1, f1, counter, choice)  # noqa: E731
    wrapper = lambda: combine.select_hosts(s1, f1, last)  # noqa: E731
    plain = lambda: combine.select_hosts_plain(s1, f1, last)  # noqa: E731
    k_ms = device_time_per_call(kernel)
    w_ms = device_time_per_call(wrapper)
    p_ms = device_time_per_call(plain)
    p2_ms = device_time_per_call(plain)
    w2_ms = device_time_per_call(wrapper)
    k2_ms = device_time_per_call(kernel)
    w_eager = time_per_call(wrapper)
    # Least time: read the score row (4 B per node), the feasible row
    # (1 B), the counter; write the choice and the new counter; about 3
    # f32 operations per node (mask, max, compare).
    bytes_ms = (n * 5 + 8 + 4 + 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"phase 6: N={n} P=1 per call on the card (CUDA graph replay): "
          f"kernel alone {k_ms:.6f} / {k2_ms:.6f} ms, select_hosts "
          f"(counter prep + kernel) {w_ms:.6f} / {w2_ms:.6f} ms, "
          f"select_hosts_plain {p_ms:.6f} / {p2_ms:.6f} ms; eager, "
          f"host-issued select_hosts {w_eager:.6f} ms; bound "
          f"{bound_ms:.9f} ms")
    return {"max_abs_err": 0, "ms": statistics.median([w_ms, w2_ms]),
            "kernel_ms": statistics.median([k_ms, k2_ms]),
            "plain_ms": statistics.median([p_ms, p2_ms]),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def unplaceable(api):
    return api.Pod(name="fits-nowhere", namespace="default", containers=[
        api.Container(name="c", requests={"cpu": "512", "memory": "1Ti"})])


def pct(values: list, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def single_split(nodes: int, pods: int) -> dict:
    """Per-decision split of ``schedule`` on the card: ``_compile``
    (snapshot, feature compile, upload, dirty-row scatter), evaluate,
    and the rest (select kernel, the one readback, the host code), each
    part synchronised so the parts add up."""
    import torch
    from kubernetes_tpu_torch.perf import synth

    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device="cuda")
    acc = {"compile": [], "evaluate": []}
    compile_fn, solver = sched._compile, sched.solver
    eval_fn = solver.evaluate

    def timed(key, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[key].append(time.perf_counter() - t0)
            return out
        return call

    sched._compile = timed("compile", compile_fn)
    solver.evaluate = timed("evaluate", eval_fn)
    walls = []
    try:
        for pod in plist:
            t0 = time.perf_counter()
            dest = sched.schedule(pod)
            walls.append(time.perf_counter() - t0)
            sched.cache.assume_pod(pod, dest)
    finally:
        del solver.evaluate
    rest = [w - c - e for w, c, e in zip(walls, acc["compile"],
                                         acc["evaluate"])]
    med = statistics.median
    return {"wall": med(walls), "compile": med(acc["compile"]),
            "evaluate": med(acc["evaluate"]), "rest": med(rest)}


def phase_single(nodes: int, pods: int, card: str) -> dict:
    """schedule(pod) + assume_pod over a full-width rig on cuda and cpu."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.engine import fused, scan
    from kubernetes_tpu_torch.engine.generic_scheduler import FitError
    from kubernetes_tpu_torch.ops import combine
    from kubernetes_tpu_torch.perf import synth

    out = {}
    for dev in ("cuda", "cpu"):
        sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                      device=dev)
        plist = plist[:pods // 2] + [unplaceable(api)] + plist[pods // 2:]
        decisions, lat = [], []
        fused.select_rows.launches = scan.scan_chunk.launches = 0
        combine.select_hosts.launches = 0
        t_all = time.perf_counter()
        for pod in plist:
            t0 = time.perf_counter()
            try:
                dest = sched.schedule(pod)
            except FitError as err:
                lat.append(time.perf_counter() - t0)
                decisions.append(("FitError", err.failed_predicates))
                continue
            lat.append(time.perf_counter() - t0)
            sched.cache.assume_pod(pod, dest)
            decisions.append(dest)
        secs = time.perf_counter() - t_all
        launches = {"select_hosts": combine.select_hosts.launches,
                    "select_rows": fused.select_rows.launches,
                    "scan_chunk": scan.scan_chunk.launches}
        explain = sched.explain_failures(plist[:63] + [unplaceable(api)])
        out[dev] = {"decisions": decisions, "lat": lat, "secs": secs,
                    "last": int(sched.last_node_index), "explain": explain,
                    "launches": launches}
        placed = sum(isinstance(d, str) for d in decisions)
        print(f"phase 7: {dev}: schedule + assume_pod of {len(plist)} pods "
              f"onto {nodes} nodes: {secs:.3f} s, placed {placed}, "
              f"FitErrors {len(plist) - placed}, last_node_index "
              f"{out[dev]['last']}, launches {launches}")
    c, h = out["cuda"], out["cpu"]
    if c["decisions"] != h["decisions"] or c["last"] != h["last"]:
        diff = [i for i, (a, b) in enumerate(zip(c["decisions"],
                                                 h["decisions"]))
                if a != b][:5]
        fail(f"schedule: cuda and cpu differ at pods {diff} (counters "
             f"{c['last']} vs {h['last']})")
    fit_errors = [d for d in c["decisions"] if isinstance(d, tuple)]
    if not fit_errors or len(fit_errors[0][1]) != nodes:
        fail("the unplaceable pod did not raise a FitError naming every "
             "node")
    if c["explain"] != h["explain"]:
        bad = [k for k in c["explain"] if c["explain"][k] != h["explain"][k]]
        fail(f"explain_failures: cuda and cpu differ for {bad[:5]}")
    want = {"select_hosts": len(c["decisions"]), "select_rows": 0,
            "scan_chunk": 0}
    if c["launches"] != want:
        fail(f"schedule launched {c['launches']}, expected {want}")
    warm = [x * 1e6 for x in c["lat"][1:]]
    print(f"phase 7: {card}: cuda == cpu: {len(c['decisions'])} decisions, "
          f"counter, the FitError map ({nodes} nodes) and explain_failures "
          f"of 64 pods; per decision on the card: cold "
          f"{c['lat'][0] * 1e6:.1f} us, warm p50 {pct(warm, 0.5):.1f} us, "
          f"p99 {pct(warm, 0.99):.1f} us (cpu p50 "
          f"{pct([x * 1e6 for x in h['lat'][1:]], 0.5):.1f} us, p99 "
          f"{pct([x * 1e6 for x in h['lat'][1:]], 0.99):.1f} us); "
          f"select_hosts launches {c['launches']['select_hosts']}")
    split = single_split(nodes, pods // 2)
    print(f"phase 7: split of a decision on the card (medians over "
          f"{pods // 2} decisions, each part synchronised): wall "
          f"{split['wall'] * 1e6:.1f} us = _compile "
          f"{split['compile'] * 1e6:.1f} us + evaluate "
          f"{split['evaluate'] * 1e6:.1f} us + select, readback and the "
          f"rest {split['rest'] * 1e6:.1f} us")
    return {"launches": c["launches"]["select_hosts"]}


def node_item(node, rv: int) -> dict:
    """One node of ExtenderArgs in the reference latency test's shape
    (tests/test_extender_perf.py)."""
    return {"metadata": {"name": node.name, "labels": dict(node.labels),
                         "resourceVersion": str(rv)},
            "status": {"allocatable": {
                "cpu": f"{node.allocatable_milli_cpu}m",
                "memory": str(node.allocatable_memory),
                "pods": str(node.allocatable_pods)},
                "conditions": [{"type": "Ready", "status": "True"}]}}


def post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def phase_extender(nodes: int, probes: int, card: str) -> None:
    """The extender sidecar on the card against an ExtenderCore on the
    CPU, byte for byte, sequentially and then from 4 threads at once."""
    import torch
    from kubernetes_tpu_torch.engine import solver as sv
    from kubernetes_tpu_torch.engine.generic_scheduler import GenericScheduler
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.server import extender as ext

    items = [node_item(nd, i + 1) for i, nd in enumerate(
        synth.make_nodes(nodes, profile="mixed", n_zones=4))]
    args = {"Pod": {"metadata": {"name": "probe", "namespace": "default"},
                    "spec": {"containers": [{
                        "name": "c",
                        "resources": {"requests": {"cpu": "100m"}}}]}},
            "Nodes": {"Items": items}}
    cpu_core = ext.ExtenderCore(device="cpu")
    # Device work of the card's requests, synchronised so it is charged
    # to the card: evaluate and masks (plus their readback, which follows
    # at once), and the host _compile with its upload.
    acc = {"device": 0.0, "compile": 0.0}
    orig = {"evaluate": sv.Solver.evaluate, "masks": sv.Solver.masks,
            "_compile": GenericScheduler._compile}

    def on_card(key, fn, is_cuda):
        def call(self, *a, **k):
            if not is_cuda(self, *a):
                return fn(self, *a, **k)
            t0 = time.perf_counter()
            res = fn(self, *a, **k)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return res
        return call

    def cluster_on_card(_self, _b, c, *rest):
        return c.alloc.device.type == "cuda"

    sv.Solver.evaluate = on_card("device", orig["evaluate"], cluster_on_card)
    sv.Solver.masks = on_card("device", orig["masks"], cluster_on_card)
    GenericScheduler._compile = on_card(
        "compile", orig["_compile"],
        lambda self, *a: self.device.type == "cuda")
    server = ext.serve_in_thread(port=0, device="cuda")
    base = f"http://127.0.0.1:{server.server_address[1]}/scheduler"
    lat = {"filter": [], "prioritize": []}
    replay = []
    try:
        for k in range(probes):
            args["Pod"]["metadata"]["name"] = f"probe-{k}"
            req = args["Pod"]["spec"]["containers"][0]["resources"][
                "requests"]
            req["cpu"] = f"{100 + k // 10}m" if k % 10 == 0 else "100m"
            body = json.dumps(args).encode()
            for verb in ("filter", "prioritize"):
                t0 = time.perf_counter()
                got = post(f"{base}/{verb}", body)
                lat[verb].append(time.perf_counter() - t0)
                if k == 0 and verb == "filter":
                    cold = dict(acc, wall=lat[verb][0])
                want = cpu_core.handle(verb, body)
                if got != want:
                    fail(f"extender {verb} of probe {k}: the card's "
                         f"response ({len(got)} B) != the cpu's "
                         f"({len(want)} B): {got[:200]!r} vs {want[:200]!r}")
                if k % 6 == 0 and len(replay) < 64:
                    replay.append((verb, body, want))
        warm_total = sum(lat["filter"][1:]) + sum(lat["prioritize"])
        warm_dev = acc["device"] - cold["device"]
        warm_compile = acc["compile"] - cold["compile"]
    finally:
        sv.Solver.evaluate = orig["evaluate"]
        sv.Solver.masks = orig["masks"]
        GenericScheduler._compile = orig["_compile"]
    n_resp = sum(len(v) for v in lat.values())
    print(f"phase 8: {card}: {n_resp} extender responses at {nodes} nodes "
          f"({probes} probes, a fresh template every 10th, filter then "
          f"prioritize) from the card == ExtenderCore(device='cpu'), byte "
          f"for byte")
    errors: list = []

    def client(part: list) -> None:
        for verb, body, want in part:
            got = post(f"{base}/{verb}", body)
            if got != want:
                errors.append((verb, len(got), len(want)))

    try:
        threads = [threading.Thread(target=client, args=(replay[i::4],))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        secs = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            fail("extender: a concurrent client did not finish")
    finally:
        server.shutdown()
        server.server_close()
    if errors or len(replay) != 64:
        fail(f"extender: concurrent replay of {len(replay)} exchanges from "
             f"4 threads differs from the cpu: {errors[:5]}")
    print(f"phase 8: concurrent replay: 64 exchanges from 4 client threads "
          f"in {secs:.3f} s, all identical to the cpu's responses")
    ms = {v: [x * 1e3 for x in lat[v][1 if v == "filter" else 0:]]
          for v in lat}
    print(f"phase 8: {card}: cold first filter (node-list parse, compile, "
          f"upload, evaluate) {cold['wall'] * 1e3:.3f} ms (_compile "
          f"{cold['compile'] * 1e3:.3f} ms, evaluate+masks "
          f"{cold['device'] * 1e3:.3f} ms); warm filter p50 "
          f"{pct(ms['filter'], 0.5):.3f} ms p99 "
          f"{pct(ms['filter'], 0.99):.3f} ms, prioritize p50 "
          f"{pct(ms['prioritize'], 0.5):.3f} ms p99 "
          f"{pct(ms['prioritize'], 0.99):.3f} ms (bars: p50 < 20, p99 < "
          f"100); of the warm time {warm_total * 1e3:.3f} ms, evaluate + "
          f"masks with readback on the card {warm_dev * 1e3:.3f} ms "
          f"({100 * warm_dev / warm_total:.2f}%), _compile "
          f"{warm_compile * 1e3:.3f} ms "
          f"({100 * warm_compile / warm_total:.2f}%), JSON parse, render "
          f"and HTTP the rest "
          f"({100 * (1 - (warm_dev + warm_compile) / warm_total):.2f}%)")


# -- the scheduler daemon (phases 9-12) --------------------------------------

def zero_counts() -> None:
    from kubernetes_tpu_torch.engine import fused, scan
    from kubernetes_tpu_torch.ops import combine
    fused.select_rows.launches = scan.scan_chunk.launches = 0
    combine.select_hosts.launches = 0


def kernel_counts() -> dict:
    from kubernetes_tpu_torch.engine import fused, scan
    from kubernetes_tpu_torch.ops import combine
    return {"scan_chunk": scan.scan_chunk.launches,
            "select_rows": fused.select_rows.launches,
            "select_hosts": combine.select_hosts.launches}


def counter_total(family, label: str = "") -> float:
    """The sum of a labelled counter's children (or one label's)."""
    return sum(c.value for k, c in family.children().items()
               if not label or k[0] == label)


def make_daemon(nodes: int, device: str, **attrs):
    """A synchronous-bind daemon over ``synth.make_rig(nodes, 0,
    "mixed")`` with an in-memory CAS binder."""
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
    from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                          SchedulerConfig)
    sched, _ = synth.make_rig(nodes, 0, profile="mixed", device=device)
    d = Scheduler(SchedulerConfig(algorithm=sched, binder=InMemoryBinder(),
                                  async_bind=False))
    for k, v in attrs.items():
        setattr(d, k, v)
    return d


def over_capacity(sched, bound: dict, pods: list) -> int:
    """Nodes whose bound pods exceed their cpu, memory or pod count."""
    from kubernetes_tpu_torch.features import compiler as fc
    nt = sched.cache.snapshot()[0]
    used = np.zeros(nt.alloc.shape, np.int64)
    for pod in pods:
        node = bound.get(pod.key)
        if node is not None:
            used[nt.name_to_idx[node]] += fc.pod_resource_row(pod)
    cols = [fc.RES_CPU, fc.RES_MEM, fc.RES_PODS]
    return int((used[:, cols] > nt.alloc[:, cols]).any(axis=1).sum())


def phase_daemon(nodes: int, pods: int, full: dict, card: str) -> dict:
    """The daemon's drain of the north-star avalanche, twice: (a) with the
    reference defaults (STREAM_THRESHOLD unset: one one-shot solve) and
    (b) with STREAM_THRESHOLD = 4096 (the overlapped stream of 4096-pod
    chunks).  Both must place every pod as phase 4's library drain did."""
    import torch
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.utils import metrics

    warm = make_daemon(nodes, "cuda")
    try:
        for p in synth.make_pods(CHUNK, profile="mixed", n_services=4,
                                 name_prefix="warm"):
            warm.enqueue(p)
        warm.schedule_pending(wait_first=False)
    finally:
        warm.stop()
    runs = {}
    for label, attrs, want_scan in (
            ("a", {}, 1),
            ("b", {"STREAM_THRESHOLD": 4096}, -(-pods // 4096))):
        d = make_daemon(nodes, "cuda", **attrs)
        try:
            plist = synth.make_pods(pods, profile="mixed", n_services=4)
            commit = [0.0]
            real = d._assume_and_bind_batch

            def timed(*a, _real=real, **k):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    commit[0] += time.perf_counter() - t0
            d._assume_and_bind_batch = timed
            for p in plist:
                d.enqueue(p)
            faults0 = counter_total(metrics.DEVICE_FAULTS)
            refused0 = metrics.GATE_REJECTED_BINDS.value
            errors0 = d.config.metrics.scheduling_attempts.labels(
                result="error").value
            zero_counts()
            t0 = time.perf_counter()
            drains = 0
            while len(d.queue):
                d.schedule_pending(wait_first=False)
                drains += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            bound = dict(d.config.binder._bound)
            crashed = d.config.metrics.scheduling_attempts.labels(
                result="error").value - errors0
            faults = counter_total(metrics.DEVICE_FAULTS) - faults0
            refused = metrics.GATE_REJECTED_BINDS.value - refused0
            if bound != full["placements"]:
                diff = sorted(set(bound.items()) ^
                              set(full["placements"].items()))[:5]
                fail(f"daemon run {label}: placements differ from the "
                     f"library drain of phase 4: {diff}")
            if int(d.config.algorithm.last_node_index) != full["counter"]:
                fail(f"daemon run {label}: counter "
                     f"{int(d.config.algorithm.last_node_index)} != "
                     f"{full['counter']}")
            over = over_capacity(d.config.algorithm, bound, plist)
            if over or crashed or faults or refused:
                fail(f"daemon run {label}: {over} nodes over capacity, "
                     f"{crashed} crashed pods, {faults} device faults, "
                     f"{refused} sanity-rejected binds")
            want = {"scan_chunk": want_scan, "select_rows": 0,
                    "select_hosts": 0}
            if counts != want:
                fail(f"daemon run {label} launched {counts}, expected "
                     f"{want}")
            runs[label] = {"wall": wall, "commit": commit[0],
                           "counts": counts}
            route = "one-shot" if label == "a" else \
                "stream of 4096-pod chunks, commit worker overlapping"
            print(f"phase 9: {card}: daemon run {label} ({route}): "
                  f"{len(bound)} of {pods} pods bound onto {nodes} nodes "
                  f"in {drains} drain(s), {wall:.3f} s wall, "
                  f"{len(bound) / wall:.1f} pods/s; assume/bind "
                  f"{commit[0]:.3f} s, solve side (wall minus assume/bind) "
                  f"{wall - commit[0]:.3f} s; launches {counts}; 0 nodes "
                  f"over capacity, 0 crashed, 0 device faults, 0 refused "
                  f"binds; placements and counter == phase 4")
        finally:
            d.stop()
    return runs


def wait_bound(store, n: int, seconds: float) -> float:
    """Seconds until ``n`` pods of ``store`` carry a nodeName."""
    t0 = time.perf_counter()
    while True:
        bound = sum(bool((o.get("spec") or {}).get("nodeName"))
                    for o in store.list("pods")[0])
        if bound >= n:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > seconds:
            fail(f"only {bound} of {n} pods bound within {seconds} s")
        time.sleep(0.05)


def phase_factory(nodes: int, pods: int, card: str) -> None:
    """The factory over a MemStore holding ``nodes`` nodes and ``pods``
    pods before ``run()``, on cuda and on cpu: every pod's nodeName equal;
    then the daemon binary on the card."""
    import signal
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory

    names = {}
    for dev in ("cuda", "cpu"):
        store = MemStore()
        for nd in synth.make_nodes(nodes, profile="mixed"):
            store.create("nodes", api.node_to_json(nd))
        for p in synth.make_pods(pods, profile="mixed", n_services=4):
            store.create("pods", api.pod_to_json(p))
        f = ConfigFactory(store, device=dev)
        try:
            t0 = time.perf_counter()
            f.run()
            secs = time.perf_counter() - t0 + wait_bound(store, pods, 600)
            names[dev] = {o["metadata"]["name"]: o["spec"]["nodeName"]
                          for o in store.list("pods")[0]}
            print(f"phase 10: {card if dev == 'cuda' else 'cpu'}: factory "
                  f"over a MemStore ({nodes} nodes, {pods} pods created "
                  f"before run()) on {dev}: every pod bound "
                  f"{secs:.3f} s after run(); last_recovery "
                  f"{f.last_recovery}")
        finally:
            f.stop()
    if names["cuda"] != names["cpu"]:
        diff = [k for k in names["cuda"]
                if names["cuda"][k] != names["cpu"].get(k)][:5]
        fail(f"factory: cuda and cpu bound pods differently: {diff}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
         "--device", "cuda", "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = json.loads(proc.stdout.readline())["port"]
        for path in ("/healthz", "/configz"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=60) as resp:
                body = resp.read()
            if resp.status != 200:
                fail(f"daemon binary {path} answered {resp.status}")
        if json.loads(body)["device"] != "cuda":
            fail(f"daemon binary /configz: {body[:200]!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            fail(f"daemon binary exited {rc} on SIGTERM: "
                 f"{proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"phase 10: cuda == cpu: all {pods} nodeNames; python -m "
          f"kubernetes_tpu_torch.scheduler --device cuda answered /healthz "
          f"and /configz and exited 0 on SIGTERM")


def victim_tables(n: int, v: int, dev) -> list:
    """victim_solve's inputs at (N, V) from a seed: [N,4] alloc and
    requested, [N] base row, [N,V,4] victim requests, [N,V] priorities
    and validity, the pod's [4] request, zero flag and priority."""
    import torch
    rng = np.random.RandomState(5)
    alloc = np.tile(np.array([[4000, 8192, 1, 110]], np.int32), (n, 1))
    host = [alloc, (alloc * rng.uniform(0.6, 1.0, (n, 1))).astype(np.int32),
            rng.rand(n) < 0.9,
            rng.randint(0, 900, (n, v, 4)).astype(np.int32),
            np.sort(rng.randint(0, 9, (n, v)), 1).astype(np.int32),
            rng.rand(n, v) < 0.8, np.array([1500, 3000, 0, 1], np.int32)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in host] + [torch.tensor(False, device=dev),
                              torch.tensor(8, dtype=torch.int32, device=dev)]


def phase_preemption(nodes: int, card: str) -> dict:
    """Every node filled by one low-priority pod (priority 0..3) leaving
    100m of cpu; 16 priority pods of 500m that fit nowhere without an
    eviction, and two of 1,000 cpus that fit nowhere even on an empty
    node (they requeue).  On cuda and on
    cpu the decisions, final bindings, evicted victims and requeued pods
    must be identical.  Then victim_solve alone at (N, 16)."""
    import torch
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.engine.workloads import preemption
    from kubernetes_tpu_torch.utils import metrics

    def pod(name, cpu, prio):
        return api.Pod(name=name, namespace="default",
                       annotations={api.PRIORITY_ANNOTATION_KEY: str(prio)},
                       containers=[api.Container(
                           name="c", requests={"cpu": cpu,
                                               "memory": "64Mi"})])

    out = {}
    for dev in ("cuda", "cpu"):
        d = make_daemon(nodes, dev)
        try:
            sched = d.config.algorithm
            nt = sched.cache.snapshot()[0]
            for i, name in enumerate(nt.names):
                low = pod(f"low-{i}", f"{int(nt.alloc[i, 0]) - 100}m", i % 4)
                low.node_name = name
                sched.cache.add_pod(low)
                d.config.binder.bind(low, name)
            decisions, per = [], []
            real = sched.find_preemptions

            def spy(pods, protected=frozenset(), _real=real):
                t0 = time.perf_counter()
                got = _real(pods, protected=protected)
                per.append((time.perf_counter() - t0) / max(len(got), 1))
                decisions.extend((x.pod_key, x.node, tuple(x.victims),
                                  x.prio_cost) for x in got)
                return got
            sched.find_preemptions = spy
            hi = [pod(f"hi-{j}", "500m", 10 + j % 3) for j in range(16)]
            hi += [pod(f"huge-{j}", "1000", 1) for j in range(2)]
            for p in hi:
                d.enqueue(p)
            executed0 = metrics.PREEMPTIONS.labels(result="executed").value
            d.schedule_pending(wait_first=False)
            bound = dict(d.config.binder._bound)
            with d._requeue_cv:
                requeued = sorted(p.key for _, _, p in d._requeue_heap)
            evicted = sorted(f"default/low-{i}"
                             for i in range(len(nt.names))
                             if f"default/low-{i}" not in bound)
            out[dev] = {"decisions": decisions, "bound": bound,
                        "evicted": evicted, "requeued": requeued,
                        "executed": metrics.PREEMPTIONS.labels(
                            result="executed").value - executed0,
                        "per": per}
        finally:
            d.stop()
    c, h = out["cuda"], out["cpu"]
    for key in ("decisions", "bound", "evicted", "requeued"):
        if c[key] != h[key]:
            fail(f"preemption: cuda and cpu {key} differ")
    victims = sorted({v for dec in c["decisions"] for v in dec[2]})
    if len(c["decisions"]) != 16 or not victims or \
            c["evicted"] != victims or \
            c["requeued"] != ["default/huge-0", "default/huge-1"] or \
            not all(f"default/hi-{j}" in c["bound"] for j in range(16)):
        fail(f"preemption: {len(c['decisions'])} decisions, "
             f"{len(c['evicted'])} evicted ({len(victims)} named), "
             f"requeued {c['requeued']}")
    dev = torch.device("cuda")
    v = preemption.padded_width()
    args = victim_tables(nodes, v, dev)
    want = preemption.victim_solve(*[a.cpu() for a in args])
    got = preemption.victim_solve(*args)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        fail("victim_solve on cuda != on cpu")
    eager_ms = time_per_call(lambda: preemption.victim_solve(*args))
    graph_ms = device_time_per_call(lambda: preemption.victim_solve(*args))
    nbytes = nodes * v * (16 + 4 + 1) + nodes * (16 + 16 + 1) + 16 + 1 + 4 \
        + nodes * (4 + 4 + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 11: {card}: preemption on {nodes} filled nodes: 16 "
          f"decisions (node, victims, cost) over {len(victims)} victims "
          f"(later decisions reuse a node a victim freed), bindings, "
          f"evicted victims and 2 requeued pods identical on cuda and "
          f"cpu; find_preemptions "
          f"{statistics.median(c['per']) * 1e6:.1f} us per decision on "
          f"cuda ({statistics.median(h['per']) * 1e6:.1f} us on cpu)")
    print(f"phase 11: {card}: victim_solve at N={nodes}, V={v}: "
          f"{eager_ms * 1e3:.3f} us per eager call (CUDA events, median), "
          f"{graph_ms * 1e3:.3f} us per call on the card (CUDA graph "
          f"replay); bound {bound_ms * 1e3:.3f} us ({nbytes} bytes at "
          f"{HBM_BYTES_PER_S:.3g} B/s); cuda == cpu exactly")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "bound_ms": bound_ms}


def phase_guard(nodes: int, pods: int, card: str) -> None:
    """A real CUDA out-of-memory error classifies as ``oom``; then a
    KT_CHAOS_DEVICE cadence injects an OOM (bisected onto the next
    ladder bucket) and a device loss (the breaker opens, the batch
    requeues, a probe closes it) into a daemon drain: every pod still
    binds as in the fault-free run, and no mode reads ``host``."""
    import torch
    from kubernetes_tpu_torch.chaos import device as chaos_device
    from kubernetes_tpu_torch.engine.guard import DeviceFault, DeviceGuard
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.utils import metrics

    free, total = torch.cuda.mem_get_info()
    guard = DeviceGuard()
    try:
        with guard.watch("oneshot", inject=False):
            torch.empty(free + (1 << 30), dtype=torch.uint8, device="cuda")
        fail("an allocation above the card's free memory did not raise")
    except DeviceFault as fault:
        if fault.kind != "oom" or \
                not isinstance(fault.orig, torch.cuda.OutOfMemoryError):
            fail(f"a real CUDA OOM classified as {fault.kind}: {fault}")
    torch.cuda.empty_cache()
    print(f"phase 12: {card}: torch.empty of {free + (1 << 30)} bytes "
          f"({free} free of {total}) inside guard.watch: "
          f"torch.OutOfMemoryError classified as oom")

    results = {}
    for label in ("fault-free", "chaos"):
        d = make_daemon(nodes, "cuda")
        try:
            guard = d.config.algorithm.guard
            guard.probe_period_s = 0.5
            modes = []
            real = guard.solve_mode

            def spy(_real=real):
                mode = _real()
                modes.append(mode)
                return mode
            guard.solve_mode = spy
            before = {k: counter_total(metrics.DEVICE_FAULTS, k)
                      for k in ("oom", "lost", "compile", "corrupt")}
            bisects = counter_total(metrics.SOLVE_FALLBACKS, "bisect")
            if label == "chaos":
                chaos_device.install(chaos_device.DeviceChaos(
                    chaos_device.parse_spec("oom@1:1,lost@2:1")))
            plist = synth.make_pods(pods, profile="mixed", n_services=4)
            for p in plist:
                d.enqueue(p)
            t0 = time.perf_counter()
            if label == "fault-free":
                while len(d.queue):
                    d.schedule_pending(wait_first=False)
            want = len(results["fault-free"]["bound"]) \
                if label == "chaos" else d.config.binder.count()
            while d.config.binder.count() < want:
                if time.perf_counter() - t0 > 120:
                    fail(f"{label}: only {d.config.binder.count()} of "
                         f"{want} pods bound within 120 s")
                d.schedule_pending(wait_first=True, timeout=0.1)
            secs = time.perf_counter() - t0
            chaos_device.install(None)
            results[label] = {
                "bound": dict(d.config.binder._bound), "modes": modes,
                "secs": secs, "mode": guard.mode,
                "faults": {k: counter_total(metrics.DEVICE_FAULTS, k) - v
                           for k, v in before.items()},
                "bisects": counter_total(metrics.SOLVE_FALLBACKS, "bisect")
                - bisects}
        finally:
            chaos_device.install(None)
            d.stop()
    ok, ch = results["fault-free"], results["chaos"]
    if ch["bound"] != ok["bound"]:
        fail("chaos drain bound pods differently from the fault-free run")
    if ch["faults"] != {"oom": 1, "lost": 1, "compile": 0, "corrupt": 0} \
            or ch["bisects"] != 1 or ok["faults"] != dict.fromkeys(
                ok["faults"], 0):
        fail(f"fault counters {ch['faults']} bisects {ch['bisects']} "
             f"(fault-free {ok['faults']})")
    if "host" in ch["modes"] or not set(ch["modes"]) <= {
            "device", "probe", "open"} or "probe" not in ch["modes"] or \
            ch["mode"] != "device":
        fail(f"guard modes {sorted(set(ch['modes']))}, final {ch['mode']}")
    print(f"phase 12: {card}: daemon drain of {pods} pods onto {nodes} "
          f"nodes under KT_CHAOS_DEVICE='oom@1:1,lost@2:1': all "
          f"{len(ch['bound'])} bound in {ch['secs']:.3f} s (fault-free "
          f"{ok['secs']:.3f} s), identical to the fault-free run; faults "
          f"{ch['faults']}, 1 bisect, modes seen "
          f"{sorted(set(ch['modes']))}, never host")


# -- topology spread, the joint solve, the harnesses (phases 13-15) ---------

def spread_rig(nodes: int, pods: int, device: str) -> tuple:
    """``synth.make_rig(nodes, pods, "mixed")`` with a seeded 40% of the
    pods carrying a zone DoNotSchedule term (half of them also a hostname
    ScheduleAnyway term)."""
    from kubernetes_tpu_torch.perf import synth
    sched, plist = synth.make_rig(nodes, pods, profile="mixed",
                                  device=device)
    return sched, synth.add_spread_constraints(plist)


def planes_bound(rows: int, n: int, t: int) -> tuple[float, str]:
    """Least time of one chunk's planes: read src [rows, T] and the term
    planes [T, N] (f32, two of them), write the mask [rows, N] (bool) and
    the score [rows, N] (f32); 2 x rows x T x N multiply-adds."""
    nbytes = rows * t + 2 * t * n * 4 + rows * n * 5
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4.0 * rows * t * n / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_topology(nodes: int, parity_pods: int, pods: int,
                   card: str) -> dict:
    """13 (a) a spread-annotated ``mixed`` drain on cuda and cpu,
    identical; (b) the north star with the same annotations, every
    choice inside its batch-start hard mask, no node over capacity, the
    largest skew after the drain and a split; (c) ``schedule(pod)`` with
    a hard term, cuda against cpu, incl. a pod no domain admits."""
    import torch
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.engine.generic_scheduler import FitError
    from kubernetes_tpu_torch.engine.workloads import topology

    # (a) cuda against cpu through the stream route.
    placements = {}
    for dev in ("cuda", "cpu"):
        sched, plist = spread_rig(nodes, parity_pods, dev)
        zero_counts()
        out, secs = drain(sched, plist, CHUNK)
        counts = kernel_counts()
        placements[dev] = (out, int(sched.last_node_index))
        print(f"phase 13a: {dev}: spread-annotated drain {nodes} x "
              f"{parity_pods} (chunk {CHUNK}): {secs:.3f} s, placed "
              f"{sum(x is not None for x in out)}, counter "
              f"{int(sched.last_node_index)}")
        if dev == "cuda":
            launches_a = counts
    if placements["cuda"] != placements["cpu"]:
        a, b = placements["cuda"][0], placements["cpu"][0]
        diff = [i for i in range(len(a)) if a[i] != b[i]][:5]
        fail(f"topology drain: cuda and cpu differ at pods {diff} "
             f"(counters {placements['cuda'][1]} vs "
             f"{placements['cpu'][1]})")
    want = {"scan_chunk": -(-parity_pods // CHUNK), "select_rows": 0,
            "select_hosts": 0}
    if launches_a != want:
        fail(f"topology drain launched {launches_a}, expected {want}")
    print(f"phase 13a: cuda placements and counter == cpu; launches "
          f"{launches_a}")

    # (b) the north star, annotated.
    sched, plist = spread_rig(nodes, pods, "cuda")
    _, _, dc, nt = sched._compile(plist)
    hard, _ = sched._topo_planes(dc).rows()
    zero_counts()
    out, wall = drain(sched, plist, CHUNK)
    launches_b = kernel_counts()
    idx = torch.tensor([-1 if x is None else nt.name_to_idx[x]
                        for x in out], device="cuda")
    placed = idx >= 0
    rows = torch.nonzero(placed)[:, 0]
    inside = hard[rows, idx[rows]]
    if not bool(inside.all()):
        bad = rows[~inside][:5].tolist()
        fail(f"topology: pods {bad} placed outside their batch-start hard "
             f"mask")
    bound = {p.key: x for p, x in zip(plist, out) if x is not None}
    over = over_capacity(sched, bound, plist)
    if over:
        fail(f"topology north star: {over} nodes over capacity")
    want = {"scan_chunk": -(-pods // CHUNK), "select_rows": 0,
            "select_hosts": 0}
    if launches_b != want:
        fail(f"topology north star launched {launches_b}, expected {want}")
    zcol = sched.cache.space.topo_keys.get(api.ZONE_LABEL)
    zones = nt.topo_val[:, zcol]
    live = sorted({int(z) for z, s in zip(zones, nt.schedulable)
                   if s and z >= 0})
    groups = {p.labels["app"] for p in plist
              if api.TOPOLOGY_SPREAD_ANNOTATION_KEY in p.annotations}
    skew = 0
    for g in groups:
        per = dict.fromkeys(live, 0)
        for p, x in zip(plist, out):
            if x is not None and p.labels.get("app") == g:
                z = int(zones[nt.name_to_idx[x]])
                if z in per:
                    per[z] += 1
        skew = max(skew, max(per.values()) - min(per.values()))
    n_hard = sum(1 for p in plist
                 if api.TOPOLOGY_SPREAD_ANNOTATION_KEY in p.annotations)
    print(f"phase 13b: {card}: spread-annotated north star {nodes} x "
          f"{pods} ({n_hard} pods with a zone DoNotSchedule term, "
          f"{len(groups)} groups): {wall:.3f} s wall, "
          f"{pods / wall:.1f} pods/s, placed {int(placed.sum())}; every "
          f"choice inside its batch-start hard mask; 0 nodes over "
          f"capacity; largest zone skew after the drain {skew} (the "
          f"constraint holds against batch-start counts); launches "
          f"{launches_b}")

    # The split: planes (term planes + each chunk's rows), _compile, the
    # hoist and scan, the readback and the rest.
    sched, plist = spread_rig(nodes, pods, "cuda")
    acc: dict = {}
    solver = sched.solver
    sched._compile = synced(acc, "compile", sched._compile)
    sched._topo_planes = synced(acc, "planes", sched._topo_planes)
    solver._solve_scan = synced(acc, "scan", solver._solve_scan)
    real_rows = topology.TermPlanes.rows
    topology.TermPlanes.rows = synced(acc, "planes", real_rows)
    try:
        _, secs = drain(sched, plist, CHUNK)
    finally:
        topology.TermPlanes.rows = real_rows
        del solver._solve_scan
    rest = secs - acc["compile"] - acc["planes"] - acc["scan"]
    print(f"phase 13b: split {nodes} x {pods}: {secs:.3f} s wall = "
          f"planes {acc['planes']:.3f} s + _compile {acc['compile']:.3f} s "
          f"+ hoist and scan {acc['scan']:.3f} s + readback and the rest "
          f"{rest:.3f} s")

    # One chunk's planes on the card (CUDA events), against its bound.
    terms = sched._topo_terms
    tp = topology.TermPlanes(terms, dc.topo_dom)
    t = terms.src.shape[1]

    def one_chunk():
        topology.TermPlanes(terms, dc.topo_dom).rows(0, CHUNK)

    planes_ms = time_per_call(one_chunk, reps=10, inner=10, warmup=3)
    rows_ms = time_per_call(lambda: tp.rows(0, CHUNK), reps=10, inner=10,
                            warmup=3)
    b_ms, b_by = planes_bound(CHUNK, nodes, t)
    print(f"phase 13b: {card}: planes of one {CHUNK}-pod chunk at {nodes} "
          f"nodes, T={t}: {planes_ms:.6f} ms with the term planes, "
          f"{rows_ms:.6f} ms for the rows alone (CUDA events); bound "
          f"{b_ms:.6f} ms ({b_by})")

    # (c) schedule(pod) with a hard term, plus one no domain admits.
    out = {}
    for dev in ("cuda", "cpu"):
        sched, plist = spread_rig(nodes, 64, dev)
        for p in plist:
            if api.TOPOLOGY_SPREAD_ANNOTATION_KEY not in p.annotations:
                p.labels.setdefault("app", "grp-x")
                p.annotations[api.TOPOLOGY_SPREAD_ANNOTATION_KEY] = \
                    json.dumps([{"maxSkew": 1,
                                 "topologyKey": api.ZONE_LABEL,
                                 "whenUnsatisfiable": "DoNotSchedule",
                                 "labelSelector": {"matchLabels": {
                                     "app": p.labels["app"]}}}])
        nowhere = api.Pod(
            name="no-domain", namespace="default", labels={"app": "r"},
            annotations={api.TOPOLOGY_SPREAD_ANNOTATION_KEY: json.dumps([{
                "maxSkew": 1, "topologyKey": "kt/rack",
                "whenUnsatisfiable": "DoNotSchedule",
                "labelSelector": {"matchLabels": {"app": "r"}}}])})
        zero_counts()
        decisions = []
        t0 = time.perf_counter()
        for pod in plist[:32] + [nowhere] + plist[32:]:
            try:
                dest = sched.schedule(pod)
            except FitError as err:
                decisions.append(("FitError", err.failed_predicates))
                continue
            sched.cache.assume_pod(pod, dest)
            decisions.append(dest)
        secs = time.perf_counter() - t0
        out[dev] = (decisions, int(sched.last_node_index), kernel_counts(),
                    secs)
    c, h = out["cuda"], out["cpu"]
    if c[:2] != h[:2]:
        fail("topology schedule(pod): cuda and cpu differ")
    errs = [d for d in c[0] if isinstance(d, tuple)]
    if len(errs) != 1 or len(errs[0][1]) != nodes or any(
            preds[-1] != "TopologySpread" for preds in errs[0][1].values()):
        fail("the pod no domain admits did not raise a FitError with "
             "TopologySpread last on every node")
    want = {"scan_chunk": 0, "select_rows": 0, "select_hosts": 65}
    if c[2] != want:
        fail(f"topology schedule(pod) launched {c[2]}, expected {want}")
    print(f"phase 13c: {card}: 65 schedule(pod) decisions with a zone "
          f"DoNotSchedule term at {nodes} nodes, cuda == cpu (decisions, "
          f"counter {c[1]}, the FitError map of the pod no domain admits, "
          f"TopologySpread last); cuda {c[3]:.3f} s, cpu {h[3]:.3f} s; "
          f"launches {c[2]}")
    return {"stream": launches_a["scan_chunk"] + launches_b["scan_chunk"],
            "single": c[2]["select_hosts"], "planes_ms": planes_ms,
            "rows_ms": rows_ms, "bound_ms": b_ms}


def price_bound(p: int, n: int, iters: int) -> tuple[float, str]:
    """Least time of ``_price_iterate`` after ``evaluate``: read the
    feasible and score planes once (5 bytes per pod and node), write the
    bias [P, N] f32 and the key [P]; per iteration and pod-node pair 3
    divisions, 3 multiply-adds, a subtraction, a select and the argmax's
    compare (about 12 f32 operations), once more for the final cost."""
    nbytes = p * n * 5 + p * n * 4 + p * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 12.0 * (iters + 1) * p * n / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_joint(nodes: int, pods: int, card: str) -> dict:
    """14 (a) ``joint_quality`` at its own configuration on cuda and cpu,
    identical placements; (b) the north star through the daemon with the
    JointSolver gate on: one one-shot joint solve at full width."""
    import torch
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.perf import workloads as wl
    from kubernetes_tpu_torch.utils import featuregate

    recs, placements = {}, {}
    for dev in ("cuda", "cpu"):
        recs[dev] = wl.joint_quality(500, 6000, seed=7, device=dev)
        s, plist = wl.joint_rig(500, 6000, seed=7, device=dev)
        zero_counts()
        placements[dev] = (s.schedule_batch(plist, joint=True),
                           int(s.last_node_index))
        if dev == "cuda":
            launches_a = kernel_counts()
    strip = [{k: v for k, v in r.items() if not k.endswith("_s")}
             for r in (recs["cuda"], recs["cpu"])]
    if strip[0] != strip[1] or placements["cuda"] != placements["cpu"]:
        fail(f"joint_quality: cuda {strip[0]} != cpu {strip[1]} or the "
             f"placements differ")
    want = {"scan_chunk": 1, "select_rows": 0, "select_hosts": 0}
    if launches_a != want:
        fail(f"joint_quality's joint solve launched {launches_a}, expected "
             f"{want}")
    r = recs["cuda"]
    print(f"phase 14a: {card}: joint_quality 500 nodes x 6000 pods (seed "
          f"7): greedy placed {r['greedy_placed']}, joint placed "
          f"{r['joint_placed']} (x{r['joint_vs_greedy']}); cuda == cpu "
          f"(records and placements); cuda greedy {r['greedy_s']} s, joint "
          f"{r['joint_cold_s']} / {r['joint_warm_s']} s; cpu joint "
          f"{recs['cpu']['joint_warm_s']} s; launches {launches_a}.  The "
          f"JAX package's CPU record (WORKLOADS_r06.json, for information "
          f"only): greedy 2726, joint 3087")

    # (b) the north star through the daemon, JointSolver on.
    old_gate = featuregate.DEFAULT_FEATURE_GATE
    featuregate.set_default(featuregate.FeatureGate.parse(
        "JointSolver=true"))
    d = make_daemon(nodes, "cuda")
    try:
        alg = d.config.algorithm
        solver = alg.solver
        plist = synth.make_pods(pods, profile="mixed", n_services=4)
        # Batch-start feasibility of every (pod, node): each placement
        # must pass every predicate against the state it started from.
        batch, db, dc, nt = alg._compile(plist)
        feasible, _ = solver.evaluate(db, dc)
        del db
        acc: dict = {}
        alg._compile = synced(acc, "compile", alg._compile)
        real_eval = solver.evaluate
        timed_price = synced(acc, "price", solver._price_iterate)

        def price(*a, **k):
            # evaluate timed only where the price iteration calls it.
            solver.evaluate = synced(acc, "evaluate", real_eval)
            try:
                return timed_price(*a, **k)
            finally:
                del solver.evaluate
        solver._price_iterate = price
        solver._solve_scan = synced(acc, "scan", solver._solve_scan)
        solver.solve_joint = synced(acc, "joint", solver.solve_joint)
        commit = [0.0]
        real = d._assume_and_bind_batch

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                commit[0] += time.perf_counter() - t0
        d._assume_and_bind_batch = timed
        for p in plist:
            d.enqueue(p)
        zero_counts()
        t0 = time.perf_counter()
        while len(d.queue):
            d.schedule_pending(wait_first=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_b = kernel_counts()
        for name in ("_price_iterate", "_solve_scan", "solve_joint"):
            delattr(solver, name)
        bound = dict(d.config.binder._bound)
        idx = torch.tensor([nt.name_to_idx[bound[p.key]] if p.key in bound
                            else -1 for p in plist], device="cuda")
        rows = torch.nonzero(idx >= 0)[:, 0]
        ok = feasible[rows, idx[rows]]
        if not bool(ok.all()):
            fail(f"joint: pods {rows[~ok][:5].tolist()} placed on a node "
                 f"that fails a predicate at batch start")
        over = over_capacity(alg, bound, plist)
        if over:
            fail(f"joint north star: {over} nodes over capacity")
        want = {"scan_chunk": 1, "select_rows": 0, "select_hosts": 0}
        if launches_b != want:
            fail(f"joint north star launched {launches_b}, expected {want}")
    finally:
        d.stop()
        featuregate.set_default(old_gate)
    price = acc["price"] - acc["evaluate"]
    order = acc["joint"] - acc["price"] - acc["scan"]
    rest = wall - acc["compile"] - acc["joint"] - commit[0]
    b_ms, b_by = price_bound(pods, nodes, 24)
    print(f"phase 14b: {card}: north star {nodes} x {pods} through the "
          f"daemon, JointSolver on: one one-shot joint solve, {len(bound)} "
          f"of {pods} placed (greedy, phase 9: {pods}), {wall:.3f} s wall "
          f"= _compile {acc['compile']:.3f} s + evaluate "
          f"{acc['evaluate']:.3f} s + 24 price iterations {price:.3f} s "
          f"+ order and permutation {order:.3f} s + repair scan "
          f"{acc['scan']:.3f} s + readback and the rest {rest:.3f} s + "
          f"assume/bind {commit[0]:.3f} s; every pod's node passes every "
          f"predicate at batch start, 0 nodes over capacity; launches "
          f"{launches_b}; price iteration bound {b_ms:.6f} ms ({b_by})")
    return {"quality": launches_a["scan_chunk"],
            "north": launches_b["scan_chunk"], "price_s": price,
            "evaluate_s": acc["evaluate"], "scan_s": acc["scan"],
            "price_bound_ms": b_ms}


def phase_harness(card: str) -> dict:
    """15: the oracle replay at 1,000 x 10,000 ``rich`` on the card, then
    the preemption parity and the gang bench at their defaults."""
    from kubernetes_tpu_torch.perf import parity, workloads

    zero_counts()
    rec = parity.run_parity(1000, 10000, seed=0, n_samples=200,
                            profile="rich", device="cuda")
    launches = kernel_counts()
    if rec["decision_agreement_pct"] < 99.0:
        fail(f"oracle agreement {rec['decision_agreement_pct']}% < 99%: "
             f"{rec['examples'][:3]}")
    want = {"scan_chunk": 0, "select_rows": 10000, "select_hosts": 0}
    if launches != want:
        fail(f"the parity drain launched {launches}, expected {want}")
    print(f"phase 15: {card}: oracle replay 1000 nodes x 10000 rich pods: "
          f"{rec['decision_agreement_pct']}% of {rec['sampled_decisions']} "
          f"sampled decisions agree (bar 99%; the JAX package's CPU record, "
          f"PARITY.json: 100.0%), placed {rec['placed']}, infeasible "
          f"choices {rec['infeasible_choices']}, drain {rec['drain_s']} s, "
          f"replay {rec['replay_s']} s; launches {launches}")
    pre = workloads.run_preemption_parity(device="cuda")
    gang = workloads.gang_bench(device="cuda")
    if pre["parity_pct"] < 99.0 or gang["partial_gangs_bound"] != 0:
        fail(f"preemption parity {pre['parity_pct']}% or partial gangs "
             f"{gang['partial_gangs_bound']}")
    print(f"phase 15: {card}: preemption parity {pre['parity_pct']}% of "
          f"{pre['judged']} (low pods bound {pre['low_pods_bound']}); gangs "
          f"admitted {gang['gangs_admitted']} of {gang['gangs_total']}, "
          f"partial gangs bound {gang['partial_gangs_bound']}, warm solve "
          f"{gang['warm_solve_s']} s")
    return {"parity": launches["select_rows"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--parity-nodes", type=int, default=5000)
    ap.add_argument("--parity-pods", type=int, default=4096)
    ap.add_argument("--rich-nodes", type=int, default=1000)
    ap.add_argument("--rich-pods", type=int, default=1024)
    ap.add_argument("--single-nodes", type=int, default=5000)
    ap.add_argument("--single-pods", type=int, default=512)
    ap.add_argument("--extender-nodes", type=int, default=5000)
    ap.add_argument("--extender-probes", type=int, default=200)
    ap.add_argument("--factory-nodes", type=int, default=5000)
    ap.add_argument("--factory-pods", type=int, default=4096)
    ap.add_argument("--topology-pods", type=int, default=4096)
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and run phases 2, 2b and 6 only; prints "
                         "no result lines")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.engine import kernels

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib, log = kernels.build(verbose=True)
    print(f"phase 1: built {lib.name} (one nvcc command: "
          f"{', '.join(src.name for src in kernels.SOURCES)}) in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in log.strip().splitlines():
        print(f"phase 1: nvcc: {line}")

    dev = torch.device("cuda")
    kstats = phase_kernel(dev)
    sstats = phase_scan(dev)
    hstats = phase_select_hosts(dev)
    if args.kernels_only:
        return 0
    phase_parity("mixed", args.parity_nodes, args.parity_pods, CHUNK)
    rich = phase_parity("rich", args.rich_nodes, args.rich_pods, 512)
    full = phase_full(args.nodes, args.pods, CHUNK, card)
    phase_profile(args.nodes, PROFILE_PODS)
    single = phase_single(args.single_nodes, args.single_pods, card)
    phase_extender(args.extender_nodes, args.extender_probes, card)
    daemon = phase_daemon(args.nodes, args.pods, full, card)
    phase_factory(args.factory_nodes, args.factory_pods, card)
    phase_preemption(args.nodes, card)
    phase_guard(args.nodes, args.factory_pods, card)
    topo = phase_topology(args.nodes, args.topology_pods, args.pods, card)
    joint = phase_joint(args.nodes, args.pods, card)
    harness = phase_harness(card)

    kernels_line = [{
        "name": "select_rows",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/select.cu",
        "replaces": "kubernetes_tpu/engine/fused.py:59",
        # Its path is now the step loop (the rich drain); on the main path
        # its body runs inlined in scan_chunk.
        "path": f"rich drain {args.rich_nodes} x {args.rich_pods}",
        "launches": rich["select_rows"],
        "daemon_launches": {run: daemon[run]["counts"]["select_rows"]
                            for run in ("a", "b")},
        "launches_by_path": {"topology": 0, "joint": 0,
                            "parity_rich": harness["parity"]},
        "max_abs_err": kstats["max_abs_err"],
        "ms": kstats["ms"],
        "plain_ms": kstats["plain_ms"],
        "bound_ms": kstats["bound_ms"],
        "bound_by": kstats["bound_by"],
        "library_ms": None,
    }, {
        "name": "scan_chunk",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/scan.cu",
        "replaces": "kubernetes_tpu/engine/solver.py:1397",
        "path": f"north-star drain {args.nodes} x {args.pods}",
        "launches": full["launches"],
        "daemon_launches": {run: daemon[run]["counts"]["scan_chunk"]
                            for run in ("a", "b")},
        "launches_by_path": {"topology": topo["stream"],
                            "joint": joint["quality"] + joint["north"],
                            "parity_rich": 0},
        "max_abs_err": sstats["max_abs_err"],
        "ms": sstats["ms"],
        "plain_ms": sstats["plain_ms"],
        "bound_ms": sstats["bound_ms"],
        "bound_by": sstats["bound_by"],
        "library_ms": None,
    }, {
        "name": "select_hosts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/select.cu",
        "replaces": "kubernetes_tpu/ops/combine.py:27",
        "path": f"schedule(pod) x {args.single_pods + 1} at "
                f"{args.single_nodes} nodes",
        "launches": single["launches"],
        "daemon_launches": {run: daemon[run]["counts"]["select_hosts"]
                            for run in ("a", "b")},
        "launches_by_path": {"topology": topo["single"], "joint": 0,
                            "parity_rich": 0},
        "max_abs_err": hstats["max_abs_err"],
        "ms": hstats["ms"],
        "kernel_ms": hstats["kernel_ms"],
        "plain_ms": hstats["plain_ms"],
        "bound_ms": hstats["bound_ms"],
        "bound_by": hstats["bound_by"],
        "library_ms": None,
    }]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

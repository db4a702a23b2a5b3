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
   state tensor bit for bit, two chunks per case, the ``mixed``, ``rich``
   and slice-seam cases, each at every cluster size its N allows, with
   each rig's term axes), then one 2,048-pod chunk at 5,000 nodes of the
   ``mixed`` and of the ``rich`` north-star rig, each timed with CUDA
   events (the launch alone at every cluster size in turns, with each
   size's plan printed; with its hoist and term lists; the step loop)
   against its bound, and each kernel route's result held against the
   step loop's bit for bit;
3. card against CPU: the streamed drain of a reduced ``mixed`` rig and
   of a ``rich`` rig, both through the scan kernel, on ``cuda`` and on
   ``cpu`` must place every pod identically, with the same counter;
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
   the 128 pods of a 5,000-node ``mixed`` rig plus one pod that fits
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
   and 1,024 pods before ``run()``, on cuda and on cpu, every pod's
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

13. topology spread: (a) a ``mixed`` drain of 5,000 nodes x 2,048 pods,
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
15. harnesses: ``perf/parity.run_parity`` (1,000 x 10,000 ``rich``, 100
   sampled decisions, one one-shot scan launch) on the card with at
   least 99% agreement with the oracle, then ``run_preemption_parity``
   and ``gang_bench`` at their defaults with no partial gang bound;
16. the ``rich`` north star: the streamed drain of 5,000 ``rich`` nodes
   x 30,000 ``rich`` pods (chunk 2048) through the scan kernel, one
   launch per chunk and no select launch; the safety checks (no node
   over its cpu, memory or pods, no host port twice on a node, no
   read-write disk shared on a node, no node over its EBS or GCE
   maximum, no two pods of one required anti-affinity group on one
   host: 0 of each allowed); a second drain split into ``_compile``,
   the hoist, the term lists, the scan and the readback; the term axes;
   and about 100 sampled decisions against the oracle (``perf/parity``,
   at least 99% agreement);
17. the daemon over the wire: (a) 5,000 ``mixed`` nodes and 4,096 pods
   created in ``python -m kubernetes_tpu_torch.apiserver`` before the
   daemon starts; ``ConfigFactory(url, device="cuda")`` binds every pod
   as a ``MemStore`` daemon on the card does (pod for pod), with the
   scan launches of each; (b) the north star over HTTP: the native
   apiserver built by ``apiserver/native.py`` (a failed build fails the
   phase), 5,000 nodes, the daemon warmed, then 4 creator threads POST
   30,000 pods in pre-serialised 1,000-pod List bodies; the clock runs
   from the first POST to the last bind, once with the stream of
   4,096-pod chunks and a 20 ms formation deadline and once on the
   one-shot route with a 3,000 ms one; wall, pods/s, create time,
   drains, launches, the stage split, bind requests and 409s, and 0
   unbound pods, 0 nodes over capacity and 0 pods whose nodeName
   changed after their first bind; (c) the apiserver binary and
   ``python -m kubernetes_tpu_torch.scheduler --api-server URL
   --leader-elect`` as processes: 2,048 pods onto 1,000 nodes bind,
   /configz says cuda, the lease names the daemon, SIGTERM exits both
   with 0;
18. the port's bench (``python -m kubernetes_tpu_torch.perf.bench``, its
   ``main`` called in process) at the north star, 5,000 ``mixed`` nodes
   x 30,000 pods, with only the repeats cut: 2 density runs and 1 wire
   run (the native apiserver) per setting (``stream``, ``one-shot``), its
   ``fleet`` phase off (``BENCH_FLEET=0``: phase 20b runs the fleet),
   the serving rows with a 5 s trickle, joint and workloads at the
   reference's sizes.  Every density and wire run binds all 30,000
   pods, 0 zero-bound and 0 failed wire runs, 0 kernel builds after a
   warm-up, the artifact names the card and ``"backend": "cuda"``; the
   serving rows' p50/p99 and SLO attainment against the reference's
   floors (99% trickle, 95% burst and ramp); /debug/timeseries,
   /debug/dashboard and /debug/profile answer 200 on the daemon's status
   mux during a wire run; the wire ``profile`` section splits the
   arrival path's CPU by component, with the unclassified share under
   the reference's 20% bar.  Then the bench again with ``--profile-dir``
   (one density run per setting and the joint phase): Chrome traces
   carrying the three solve sites' labels (``solve_stream_chunk``,
   ``solve_sequential``, ``solve_joint``) and ``scan.cu``'s kernel with
   device time;
19. the slice (HA shards, tenancy, defrag, the verifier), on the
   north-star cluster (5,000 ``mixed`` nodes): (a) the tenancy north
   star, 30,000 pods 2:1:1 over the tenant namespaces (t-a/t-b/t-c
   weighted 2:1:1) through a ``KT_TENANTS`` daemon over a ``MemStore``
   (with ``KT_DEFRAG`` and ``KT_VERIFY_PERIOD=0.5``, kept for c and d):
   all bound, 0 over capacity, the shares of the first packed solves
   within 10% of the weights; a 5,000 x 2,048 tenancy daemon on cuda and
   cpu, every placement identical; (c) biased churn (the smallest pod
   of every node deleted, 8 pods 100m larger than the freest node's
   free cpu, that node's pods under a PDB with no headroom), then defrag
   rounds whose probe is the joint solve: the large pods bound,
   migrations executed equal completed, 0 stranded, 0 lingering
   intents, 0 PDB violations, 0 double binds, 0 over capacity, 0
   verifier violations, with each round's pending count and the probe's
   wall and device time; (d) the verifier's passes with 0 violations,
   ``readback_rows`` µs per 64-row call, one corrupted row of the
   resident ``requested`` plane named as a ``device_row`` violation and
   healed, a clean next pass, and 2,048 follow-up pods placed as an
   uncorrupted twin daemon over the same state places them; (b) three
   ``python -m kubernetes_tpu_torch.scheduler --api-server``
   incarnations with ``KT_HA_SHARDS=8`` and a 0.45 s lease over the
   native apiserver, 30,000 pods over 12 namespaces, one SIGKILLed after
   a third bound: the survivors hold every shard in under 1 s, and 0
   double binds, 0 nodeName changes, 0 unbound, 0 over capacity, with
   each process's launches and device memory peak;
20. the kubemark control plane (kubemark-500: 500 hollow kubelets of 64
   CPU, 128 GiB and 110 pods, one RC of 2,000 replicas at 50m), every
   component joined through list/watch, in a fresh interpreter: (b) ``perf/harness.fleet_metrics
   (device="cuda")`` at the reference's defaults (a 10 s heartbeat), with
   the reference test's bars: all Running, at least 90% of the nodes
   used, at most 20 pods per node, full resync under 1,000 ms, idle dirty
   pass under 50 ms, 5-200 heartbeat writes/s, no node over capacity,
   scan launches; (a) a fleet of that shape whose seeded replication
   manager creates the replicas while no scheduler runs,
   drained by ``ConfigFactory(device="cuda")`` and, on a twin store
   holding a deep copy of the same objects, on the CPU: every pod's node
   and the round-robin counter identical; then one fleet-sized chunk
   (2,000 x 500) at the plan's cluster size timed with CUDA events
   against its bound and held against the step loop bit for bit; (c) on
   20a's fleet, its kubelets beating every 0.6 s, the node lifecycle
   controller on the reference fixture's clocks (grace 1.2 s, eviction
   1 s, sync 0.3 s), a Service with the
   endpoints controller and a hollow proxy; 50 kubelets stopped: their
   nodes Ready=Unknown, their pods evicted, replaced by the replication
   manager and bound by the daemon on the card to survivors, all 2,000
   Running again, none on a dead node, none over capacity, the Endpoints
   equal to the Running pods' addresses and the proxy's table to them;
   (d) the native apiserver, ``python -m kubernetes_tpu_torch.scheduler
   --api-server URL`` on the card, 8 ``python -m kubernetes_tpu_torch.
   kubelet`` and one ``python -m kubernetes_tpu_torch.proxy`` as
   processes, the replication manager and the node controller in this
   process over ``APIClient``: 200 replicas Running, one kubelet
   SIGKILLed and its pods rescheduled, the daemon's ``/debug/vars``
   counting its scan launches, every process stopped (also on failure).
21. the controller-manager, in a fresh interpreter: (a) kubemark-500's
   nodes (500 x 64 CPU, 128 GiB, 110 pods) with a DaemonSet, a Deployment
   of 2,000 replicas at 50m (maxSurge and maxUnavailable 25%) under a
   PodDisruptionBudget of 1,800 (90%) and a Job of parallelism 100,
   completions 200, driven round by round by the port's daemon set,
   deployment, replication, job and disruption controllers (suffix
   generators seeded) on a ``MemStore`` whose pending pods
   ``GenericScheduler(device="cuda")`` drains after each round, and on a
   twin store holding a deep copy of the same objects drained on the CPU:
   every round the same placements, stores and round-robin counter, no
   node over capacity, the daemon pods placed by their controller alone;
   then the Deployment rolled to a new template round by round, each
   round within maxSurge and maxUnavailable, the same on both sides;
   (b) the reference's multi-process story
   (``tests/test_multiprocess_e2e.py``) on the port's binaries: the
   Python apiserver with token auth and ABAC, the daemon on the card, two
   ``python -m kubernetes_tpu_torch.controller --leader-elect``, 8
   kubelet processes (0.6 s beats) and a proxy; through the port's
   kubectl (``main(argv, out)`` in process): ``apply -f`` of 40
   replicas with a budget of 36 and ``rollout status``, a changed
   template applied and ``rollout undo``, ``scale`` to 48, ``drain`` of
   the busiest node, first under a budget of 49 that refuses every
   eviction (429s, the drain gives up, every pod stays), then under one
   that lets one pod fewer go than the node holds (429s retried, the
   healthy replicas never under its floor, the replacements placed by
   the daemon on the card), ``explain pod`` naming the failing
   predicate of a pod that fits nowhere and the node of a placed one;
   then the leading controller-manager SIGKILLed and a scale to 52 that
   the standby carries out with no replica created twice; the daemon's
   ``/debug/vars`` counting its scan launches; every process stopped
   (also on failure).

Phase 2b includes the f32 route of the joint repair and topology spread:
a non-integral score bias and an extra mask with all-false rows.  It
prints one ``{"kernels": [...]}`` line (with each kernel's launches on
its phase's path, in the two daemon runs of phase 9 and on the paths of
phases 13-21; ``scan_chunk``'s carries phase 20a's fleet chunk), then the
card line, and last ``{"ok": true, "device": {...}}``.  ``--bench-only``
runs phases 1 and 18, ``--slice-only`` phases 1 and 19 (neither prints
the result lines), ``--fleet-only`` phases 1 and 20 and ``--cm-only``
phases 1 and 21, each printing the phase's record as its last line: the
whole smoke runs phases 20 and 21 so, each in a fresh interpreter.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor-core f32 rate, the int32 rate (half of it) and the
# non-tensor-core f64 rate, for the least-time bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
F64_OPS_PER_S = 34e12


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
    its seconds are added to ``acc[key]`` (its attributes, such as a
    launch count, carried over)."""
    import functools

    import torch

    @functools.wraps(fn)
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


def scan_bound(enc, kw: dict, init: dict | None = None,
               after: dict | None = None) -> tuple[float, str]:
    from kubernetes_tpu_torch.engine.scan import RICH_ARGS
    from kubernetes_tpu_torch.perf.scan_check import RICH_STATE, STATE

    """Least time (ms) of one ``scan_chunk`` call and what sets it: each
    input read once, the carried state read once and written once, the
    choices written once; against the operations every (pod, node) step
    needs (f32: the select's two compares, the template add, the spread
    score and its zone blend, one add per weighted term; int32: the
    resource fit).  The rich families count what this chunk's data needs:
    each term list read once, the dense per-pod tables at their listed
    entries, the carried planes in the rows and columns the lists name
    (read) and in the elements the launch changed (``init`` against
    ``after``, written); one int32 test per listed predicate term per
    node, an f64 multiply-add per listed priority term per node, five
    f32 operations per node for each service anti-affinity term and for
    each pod with inter-pod priority terms, and two int32 compares per
    node for each topology row the placed pods commit."""
    import torch

    p, n = enc.shape
    nbytes = enc.numel() * enc.element_size() + p * 4
    for name, t in kw.items():
        if hasattr(t, "element_size") and name not in RICH_ARGS:
            once = t.numel() * t.element_size()
            nbytes += 2 * once if name in STATE else once
    f32 = 2
    if kw.get("d_plane") is not None:
        f32 += 1
    for name, _w, _aux in kw.get("terms", ()):
        if name in ("SelectorSpreadPriority", "ServiceSpreadingPriority"):
            f32 += 6 + (7 if kw.get("sp_zone") is not None else 0)
        elif name not in ("InterPodAffinityPriority",
                          "ServiceAntiAffinityPriority"):
            f32 += 8
        f32 += 1
    int32 = 7 if kw.get("use_resources") else 0
    ops_s = p * n * (f32 / F32_OPS_PER_S + int32 / INT32_OPS_PER_S)

    def entries(key):
        lst = kw.get(key)
        if lst is None:
            return torch.zeros(0, dtype=torch.int32)
        off, idx = lst
        return idx[:int(off[-1])].cpu()

    lists = {k: entries(k) for k in kw if k.endswith("_list")}
    for key, (off, _idx) in ((k, kw[k]) for k in lists):
        nbytes += off.numel() * 4 + lists[key].numel() * 4
    nbytes += entries("aff_need_list").numel() + \
        entries("pref_list").numel() * 4
    # Rows (of [S, N] planes) and columns (of [N, C] planes) the chunk's
    # lists name, read once.
    named = {
        "match_cnt": ("aff_need_list", "anti_need_list", "pref_list",
                      "match_src_list"),
        "decl_reach": ("decl_match_list", "decl_src_list"),
        "sym_cnt": ("sym_match_list", "sym_src_list"),
        "ports_used": ("ports_list",), "vol_any": ("vol_rw_list",),
        "vol_rw": ("vol_ro_list", "vol_rw_list"),
        "pd_ebs": ("ebs_list",), "pd_gce": ("gce_list",)}
    for plane, keys in named.items():
        t = kw.get(plane)
        if t is None:
            continue
        rows = torch.unique(torch.cat([entries(k) for k in keys]))
        other = t.shape[1] if plane in ("match_cnt", "decl_reach",
                                        "sym_cnt") else t.shape[0]
        nbytes += rows.numel() * other * t.element_size()
    for name in ("match_total", "saa_cnt", "saa_num", "ebs_count",
                 "gce_count"):
        if kw.get(name) is not None:
            nbytes += kw[name].numel() * kw[name].element_size()
    for name in ("ebs_extra", "gce_extra", "ebs_node_extra",
                 "gce_node_extra", "ebs_node_err", "gce_node_err",
                 "node_dom", "match_key", "decl_key", "sym_key", "sym_w",
                 "schedulable", "saa_group", "saa_dom", "saa_labeled"):
        if kw.get(name) is not None:
            nbytes += kw[name].numel() * kw[name].element_size()
    if init is not None and after is not None:
        for name in RICH_STATE:
            if name in init and name in after:
                a, b = init[name], after[name]
                nbytes += int((a != b).sum()) * a.element_size()
    preds = sum(entries(k).numel() for k in (
        "ports_list", "vol_rw_list", "vol_ro_list", "ebs_list", "gce_list",
        "aff_need_list", "anti_need_list", "decl_match_list"))
    prio = entries("pref_list").numel() + entries("sym_match_list").numel()
    commits = sum(entries(k).numel() for k in (
        "match_src_list", "decl_src_list", "sym_src_list"))
    ip_pods = 0
    if kw.get("pref_list") is not None:
        per_pod = (kw["pref_list"][0].diff() + kw["sym_match_list"][0]
                   .diff()) > 0
        ip_pods = int(per_pod.sum())
    saa_terms = sum(1 for name, _w, _a in kw.get("terms", ())
                    if name == "ServiceAntiAffinityPriority")
    ops_s += n * ((preds + 2 * commits) / INT32_OPS_PER_S
                  + 2 * prio / F64_OPS_PER_S
                  + 5 * (ip_pods + p * saa_terms) / F32_OPS_PER_S)
    ops_ms = ops_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def time_chunk(dev, profile: str, batch_pods: int | None = None) -> dict:
    """One 2,048-pod chunk at 5,000 nodes of the ``profile`` north-star
    rig (the first chunk of a ``batch_pods`` queue compiled as one batch,
    when given): its kernel arguments captured, then the launch alone at
    every cluster size N allows (the state restored before each; five
    rounds in turns, each round C = 1, 2, ... then back), the step loop,
    and the kernel route with its hoist and term lists, at the plan's
    cluster size and forced at every other one.  Every run of a route
    starts from the same inputs, and each must give the first step
    loop's choices, counter and carried state bit for bit.  Returns the
    times (ms; ``ms`` at the plan's C, ``per_cluster_ms`` at each), the
    plans, the bound, the largest difference, the batch's term axes and
    the step loops' select launches."""
    import torch
    from kubernetes_tpu_torch.engine import fused
    from kubernetes_tpu_torch.engine import scan as scan_mod
    from kubernetes_tpu_torch.perf import scan_check

    ns = scan_check.north_star_chunk(5000, CHUNK, dev, profile=profile,
                                     batch_pods=batch_pods)
    enc, kw, init = ns["enc"], ns["kw"], ns["init"]
    p, n = enc.shape
    shape = dict(
        t=0 if kw.get("d_plane") is None else kw["d_plane"].shape[0],
        s=0 if kw.get("sp_node") is None else kw["sp_node"].shape[0],
        z=0 if kw.get("sp_zone") is None else kw["sp_zone"].shape[1],
        half=enc.dtype == torch.float16)
    chosen = scan_mod.cluster_plan(n, **shape)
    sizes = scan_mod.allowed_clusters(n)
    plans = {c: scan_mod.cluster_plan(n, **shape, cluster=c) for c in sizes}
    for c, plan in plans.items():
        print(f"phase 2b: {profile} chunk plan {plan.describe()}"
              f"{' (the rule)' if c == chosen.cluster else ''}")

    def chunk(route: str, cluster: int | None = None) -> tuple[float, tuple]:
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = ns["sched"].solver._solve_scan(
            ns["db"], ns["dc"], counter, None, ns["flags"], None, None,
            None, route=route, cluster=cluster)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop), out

    def kernel_once(cluster: int) -> float:
        for k, v in init.items():
            kw[k].copy_(v)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        scan_mod.scan_chunk(enc, **{**kw, "cluster": cluster})
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    per = {c: [] for c in sizes}
    turns = list(sizes) + list(reversed(sizes))
    for _ in range(5):
        for c in turns:
            per[c].append(kernel_once(c))
    after = {k: kw[k].clone() for k in init}
    before = fused.select_rows.launches
    p_ms, ref = chunk("steps")
    h_ms, runs = [], []
    for _ in range(3):
        ms, out = chunk("kernel")
        h_ms.append(ms)
        runs.append(("kernel", out))
    for c in sizes:
        runs.append((f"kernel@{c}", chunk("kernel", c)[1]))
    p2_ms, out = chunk("steps")
    runs.append(("steps", out))
    # The kernel routes launch no select kernel: these are the two step
    # loops' launches, counted.
    steps_select = fused.select_rows.launches - before
    worst = 0.0
    for i, (route, out) in enumerate(runs):
        try:
            worst = max(worst, scan_check.compare(
                f"{profile} north-star chunk, {route} run {i} vs the step "
                f"loop", out, ref))
        except scan_check.ScanMismatch as err:
            fail(f"scan kernel != step loop: {err}")
    bound_ms, bound_by = scan_bound(enc, kw, init, after)
    per_ms = {c: statistics.median(v) for c, v in per.items()}
    ms = per_ms[chosen.cluster]
    plain_ms = statistics.median([p_ms, p2_ms])
    axes = scan_check.axis_sizes(ns["db"])
    sweep = ", ".join(f"C={c} {per_ms[c]:.6f} ms (min {min(per[c]):.6f}, "
                      f"max {max(per[c]):.6f})" for c in sizes)
    print(f"phase 2b: one {profile} chunk of {p} pods x {n} nodes "
          f"({enc.dtype}; axes {axes}), the launch alone, median of "
          f"{len(per[sizes[0]])} in turns: {sweep}")
    print(f"phase 2b: one {profile} chunk: kernel at the rule's "
          f"C={chosen.cluster} {ms:.6f} ms = {ms / p * 1e3:.6f} us per "
          f"step (C=1: {per_ms[1]:.6f} ms); with its hoist and term lists "
          f"{statistics.median(h_ms):.6f} ms; step loop {p_ms:.3f} / "
          f"{p2_ms:.3f} ms = {plain_ms / p * 1e3:.3f} us per step; bound "
          f"{bound_ms:.6f} ms ({bound_by}); {len(runs) - 1} kernel routes "
          f"(every C) and the second step loop == the first step loop "
          f"(choices, counter, state bit for bit), max_abs_err {worst}; "
          f"{steps_select} select launches")
    return {"ms": ms, "cluster": chosen.cluster,
            "per_cluster_ms": {str(c): v for c, v in per_ms.items()},
            "plans": {str(c): pl.describe() for c, pl in plans.items()},
            "hoist_ms": statistics.median(h_ms),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "axes": axes, "max_abs_err": worst,
            "steps_select": steps_select}


def phase_scan(dev) -> dict:
    """scan_chunk against the step loop on every case of perf/scan_check,
    at every cluster size the case's N allows, then one mixed and one
    rich north-star chunk timed at every cluster size."""
    import torch
    from kubernetes_tpu_torch.engine import fused
    from kubernetes_tpu_torch.engine import scan
    from kubernetes_tpu_torch.perf import scan_check

    worst = 0.0
    n_steps = 0
    select_before = fused.select_rows.launches
    for case in scan_check.cases(dev):
        t0 = time.perf_counter()
        launches = scan.scan_chunk.launches
        try:
            res = scan_check.run_routes(case, ("steps", "kernel@*"))
        except scan_check.ScanMismatch as err:
            fail(f"scan kernel != step loop: {err}")
        torch.cuda.synchronize()
        if case.infeasible != (res["placed"] == 0):
            fail(f"scan case {case.name!r} placed {res['placed']} pods")
        if scan.scan_chunk.launches - launches != 2 * (len(res["routes"])
                                                      - 1):
            fail(f"scan case {case.name!r}: "
                 f"{scan.scan_chunk.launches - launches} launches for "
                 f"{len(res['routes']) - 1} kernel routes of 2 chunks")
        worst = max(worst, res["max_abs_err"])
        n_steps += res["steps"]
        print(f"phase 2b: {case.name}: scan kernel at "
              f"{', '.join(res['routes'][1:])} == step loop (choices, "
              f"counter, state bit for bit) over {res['steps']} steps in 2 "
              f"chunks, {res['placed']} placed, axes {res['axes']}, "
              f"{time.perf_counter() - t0:.3f} s")
    select_launches = fused.select_rows.launches - select_before
    print(f"phase 2b: all {len(scan_check.CASE_NAMES)} scan cases agree at "
          f"every cluster size, {n_steps} steps, max_abs_err {worst}; the "
          f"step loop launched the select kernel {select_launches} times")
    mixed = time_chunk(dev, "mixed")
    # The rich chunk is the first of the 30,000-pod queue compiled as one
    # batch, so its signature axes are the rich north star's.
    rich = time_chunk(dev, "rich", batch_pods=30000)
    worst = max(worst, mixed["max_abs_err"], rich["max_abs_err"])
    return {"max_abs_err": worst, "ms": mixed["ms"],
            "plain_ms": mixed["plain_ms"], "bound_ms": mixed["bound_ms"],
            "bound_by": mixed["bound_by"], "cluster": mixed["cluster"],
            "per_cluster_ms": mixed["per_cluster_ms"],
            "plans": mixed["plans"], "rich": rich,
            "select_launches": select_launches + mixed["steps_select"] +
            rich["steps_select"]}


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
    want = {"scan_chunk": chunks, "select_rows": 0}
    if launches != want:
        fail(f"{profile} drain launched {launches}, expected {want}")
    print(f"phase 3: {profile}: cuda placements and counter == cpu; "
          f"kernel launches {launches}")
    return launches


def split_drain(nodes: int, pods: int, chunk: int,
                profile: str = "mixed") -> dict:
    """A drain whose wall time is split: ``_compile`` (host snapshot,
    feature compile and upload), each chunk's ``_solve_scan`` (the hoist
    plus the scan, synchronised so it is charged to the card's work) with
    the rich families' term lists and the kernel launch inside it timed
    apart, and the rest (the readback of each chunk's choices and the
    host code around it)."""
    from kubernetes_tpu_torch.engine import scan as scan_mod
    from kubernetes_tpu_torch.perf import scan_check, synth

    sched, plist = synth.make_rig(nodes, pods, profile=profile,
                                  device="cuda")
    acc = {"compile": 0.0, "scan": 0.0, "lists": 0.0, "kernel": 0.0}
    solver = sched.solver
    real = {"term_lists": scan_mod.term_lists,
            "scan_chunk": scan_mod.scan_chunk}
    compiled = {}
    compile_batch = sched._compile

    def compile_and_keep(*a, **k):
        out = compile_batch(*a, **k)
        compiled["db"] = out[1]
        return out

    sched._compile = synced(acc, "compile", compile_and_keep)
    solver._solve_scan = synced(acc, "scan", solver._solve_scan)
    scan_mod.term_lists = synced(acc, "lists", real["term_lists"])
    scan_mod.scan_chunk = synced(acc, "kernel", real["scan_chunk"])
    try:
        _, secs = drain(sched, plist, chunk)
    finally:
        del solver._solve_scan
        scan_mod.term_lists = real["term_lists"]
        scan_mod.scan_chunk = real["scan_chunk"]
    acc["axes"] = scan_check.axis_sizes(compiled["db"])
    acc["hoist"] = acc["scan"] - acc["lists"] - acc["kernel"]
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
    scan.scan_chunk.plans.clear()


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


GUARD_PODS = 4096  # phase 12's daemon drain under the chaos cadence


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

    # Cached blocks of earlier phases would serve part of the request.
    torch.cuda.empty_cache()
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


# Phase 15's oracle sample: 100 decisions (200 took ~38 s to replay in
# one process), cut in depth to make room for phase 20.
HARNESS_SAMPLES = 100


def phase_harness(card: str) -> dict:
    """15: the oracle replay at 1,000 x 10,000 ``rich`` on the card, then
    the preemption parity and the gang bench at their defaults."""
    from kubernetes_tpu_torch.perf import parity, workloads

    zero_counts()
    rec = parity.run_parity(1000, 10000, seed=0, n_samples=HARNESS_SAMPLES,
                            profile="rich", device="cuda")
    launches = kernel_counts()
    if rec["decision_agreement_pct"] < 99.0:
        fail(f"oracle agreement {rec['decision_agreement_pct']}% < 99%: "
             f"{rec['examples'][:3]}")
    # schedule_batch solves the 10,000 pods in one one-shot scan.
    want = {"scan_chunk": 1, "select_rows": 0, "select_hosts": 0}
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
    return {"parity": launches["scan_chunk"]}


def rich_safety(sched, pods: list, out: list) -> dict:
    """Violations of a drain's placements, each counted once: nodes over
    their cpu, memory or pods; (node, host port) pairs held twice;
    (node, disk) pairs mounted twice with one mount read-write; nodes
    over their EBS or GCE maximum; (node, anti-affinity group) pairs
    holding two pods of a group with a required hostname term."""
    from collections import Counter

    from kubernetes_tpu_torch.features.compiler import FeatureSpace

    bound = {pod.key: node for pod, node in zip(pods, out)
             if node is not None}
    ports, disks = Counter(), {}
    ebs, gce, groups = {}, {}, Counter()
    for pod, node in zip(pods, out):
        if node is None:
            continue
        for port in pod.used_host_ports():
            ports[(node, port)] += 1
        for vol in pod.volumes:
            for token, ro in FeatureSpace.volume_tokens(vol):
                disks.setdefault((node, token), []).append(ro)
            if vol.aws_ebs_id:
                ebs.setdefault(node, set()).add(vol.aws_ebs_id)
            if vol.gce_pd_name:
                gce.setdefault(node, set()).add(vol.gce_pd_name)
        aff = pod.affinity()
        if aff is not None and aff.pod_anti_affinity is not None and \
                "kt/aa" in pod.labels:
            groups[(node, pod.labels["kt/aa"])] += 1
    extra = sched.solver.extra
    return {
        "over_capacity": over_capacity(sched, bound, pods),
        "host_port_twice": sum(1 for c in ports.values() if c > 1),
        "rw_disk_shared": sum(1 for ros in disks.values()
                              if len(ros) > 1 and not all(ros)),
        "over_max_ebs": sum(1 for v in ebs.values()
                            if len(v) > extra["max_ebs"]),
        "over_max_gce": sum(1 for v in gce.values()
                            if len(v) > extra["max_gce"]),
        "anti_affinity_group_twice": sum(1 for c in groups.values()
                                         if c > 1),
    }


# Phase 16's oracle sample: 100 decisions (200 took 170 s of the smoke's
# 1,200 s to replay; cut in depth to make room for phase 20).
RICH_SAMPLES = 100


def phase_rich(nodes: int, pods: int, chunk: int, card: str) -> dict:
    """16: the rich north star through the scan kernel: launches, the
    safety checks, a split drain, the term axes and sampled oracle
    agreement."""
    import os

    from kubernetes_tpu_torch.perf import parity, synth

    sched, plist = synth.make_rig(nodes, pods, profile="rich",
                                  device="cuda")
    chunks = -(-pods // chunk)
    zero_counts()
    out, secs = drain(sched, plist, chunk)
    launches = kernel_counts()
    want = {"scan_chunk": chunks, "select_rows": 0, "select_hosts": 0}
    if launches != want:
        fail(f"the rich north star launched {launches}, expected {want}")
    nt = sched.cache.snapshot()[0]
    if any(x is not None and x not in nt.name_to_idx for x in out) or \
            len(out) != pods:
        fail("rich north star: a choice names no node")
    checks = rich_safety(sched, plist, out)
    if any(checks.values()):
        fail(f"rich north star: safety checks {checks}")
    placed = sum(x is not None for x in out)
    print(f"phase 16: {card}: rich north star {nodes} nodes x {pods} pods "
          f"(chunk {chunk}): {secs:.3f} s wall, {pods / secs:.1f} pods/s, "
          f"placed {placed}; launches {launches}; safety checks {checks}")
    split = split_drain(nodes, pods, chunk, profile="rich")
    axes = split["axes"]
    print(f"phase 16: split drain {nodes} x {pods}: {split['wall']:.3f} s "
          f"wall = _compile {split['compile']:.3f} s + hoist "
          f"{split['hoist']:.3f} s + term lists {split['lists']:.3f} s + "
          f"scan {split['kernel']:.3f} s + readback and the rest "
          f"{split['readback']:.3f} s ({pods / split['wall']:.1f} pods/s); "
          f"term axes of the batch {axes}")
    workers = min(8, os.cpu_count() or 1)
    rec = parity.judge(synth.make_nodes(nodes, profile="rich", n_zones=4),
                       plist, synth.make_services(4), out, seed=0,
                       n_samples=RICH_SAMPLES, workers=workers)
    if rec["decision_agreement_pct"] < 99.0:
        fail(f"rich north star: oracle agreement "
             f"{rec['decision_agreement_pct']}% < 99%: "
             f"{rec['examples'][:3]}")
    print(f"phase 16: {card}: oracle replay of the rich north star: "
          f"{rec['decision_agreement_pct']}% of {rec['sampled_decisions']} "
          f"sampled decisions agree (bar 99%), infeasible choices "
          f"{rec['infeasible_choices']}, replay {rec['replay_s']} s in "
          f"{workers} processes")
    return {"launches": launches["scan_chunk"], "wall": secs,
            "split": split, "axes": axes,
            "agreement_pct": rec["decision_agreement_pct"]}


# -- the daemon over the wire (phase 17) --------------------------------------

LIST_ITEMS = 1000  # items per v1 List body, as the reference's rig posts


def wire_request(base: str, method: str, path: str, body: bytes = b"",
                 timeout: float = 120.0) -> tuple[int, bytes]:
    """One HTTP exchange on a fresh connection: (status, body)."""
    import http.client
    host, _, port = base.rpartition("/")[2].partition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        c.request(method, path, body or None,
                  {"Content-Type": "application/json"} if body else {})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


class Child:
    """A child process stopped by PID, whose stderr a thread drains into
    memory (a full pipe would stall the child)."""

    def __init__(self, cmd: list, stdout=subprocess.DEVNULL,
                 env: dict | None = None):
        self.proc = subprocess.Popen(cmd, stdout=stdout,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env)
        self.pid = self.proc.pid
        self.lines: list = []
        self._drain = threading.Thread(target=self._read, daemon=True)
        self._drain.start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            self.lines.append(line)

    def wait_line(self, needle: str, seconds: float = 120.0) -> str:
        t0 = time.perf_counter()
        while True:
            for line in list(self.lines):
                if needle in line:
                    return line
            if self.proc.poll() is not None or \
                    time.perf_counter() - t0 > seconds:
                self.stop()
                fail(f"{self.proc.args[:4]} printed no {needle!r}: "
                     f"{self.tail()}")
            time.sleep(0.05)

    def tail(self) -> str:
        return "".join(self.lines)[-2000:]

    def stop(self, seconds: float = 60.0) -> int:
        """SIGTERM by PID, SIGKILL past ``seconds``; the exit code."""
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=seconds)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._drain.join(timeout=10)
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        return self.proc.returncode


def wait_healthy(base: str, child: Child, seconds: float = 60.0) -> None:
    t0 = time.perf_counter()
    while True:
        try:
            if wire_request(base, "GET", "/healthz", timeout=5)[0] == 200:
                return
        except OSError:
            pass
        if child.proc.poll() is not None:
            fail(f"the apiserver at {base} exited {child.proc.returncode}: "
                 f"{child.tail()}")
        if time.perf_counter() - t0 > seconds:
            child.stop()
            fail(f"the apiserver at {base} never answered /healthz")
        time.sleep(0.05)


def start_python_apiserver() -> tuple:
    """``python -m kubernetes_tpu_torch.apiserver --port 0``; (child,
    base URL) once it answers."""
    child = Child([sys.executable, "-m", "kubernetes_tpu_torch.apiserver",
                   "--port", "0"])
    line = child.wait_line("listening on")
    base = "http://" + line.rsplit(" ", 1)[1].strip()
    wait_healthy(base, child)
    return child, base


def start_rig_apiserver() -> tuple:
    """The wire rig's apiserver (``apiserver/native.py:server_command``:
    the native binary unless ``KT_NATIVE_APISERVER=0``) on a port a
    socket bound to port 0 was handed (the native binary cannot report
    an ephemeral port); (child, base URL)."""
    import socket

    from kubernetes_tpu_torch.apiserver import native
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    child = Child(native.server_command(port))
    base = f"http://127.0.0.1:{port}"
    wait_healthy(base, child)
    return child, base


def list_bodies(objs: list) -> list:
    """Pre-serialised v1 List bodies of LIST_ITEMS items: (bytes, n)."""
    return [(json.dumps({"kind": "List",
                         "items": objs[i:i + LIST_ITEMS]}).encode(),
             len(objs[i:i + LIST_ITEMS]))
            for i in range(0, len(objs), LIST_ITEMS)]


def post_bodies(base: str, kind: str, bodies: list) -> None:
    """POST each List body on one keep-alive connection; every item must
    be created."""
    import http.client
    host, _, port = base.rpartition("/")[2].partition(":")
    c = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        for body, n in bodies:
            c.request("POST", f"/api/v1/{kind}", body,
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            got = r.read()
            if r.status != 200 or json.loads(got).get("created") != n:
                fail(f"POST {kind} List: {r.status} {got[:300]!r}")
    finally:
        c.close()


def wire_list(base: str, kind: str) -> list:
    status, body = wire_request(base, "GET", f"/api/v1/{kind}")
    if status != 200:
        fail(f"GET {kind}: {status}")
    return json.loads(body)["items"]


def pod_map(objs: list) -> dict:
    return {f"{o['metadata'].get('namespace', 'default')}/"
            f"{o['metadata']['name']}":
            (o.get("spec") or {}).get("nodeName") or "" for o in objs}


def wait_all_bound(read, n: int, seconds: float) -> dict:
    """Poll ``read()`` (a pod -> node map) until ``n`` pods are bound."""
    t0 = time.perf_counter()
    while True:
        got = read()
        bound = sum(bool(v) for v in got.values())
        if bound >= n:
            return got
        if time.perf_counter() - t0 > seconds:
            fail(f"only {bound} of {n} pods bound within {seconds} s")
        time.sleep(0.05)


def phase_wire_parity(nodes: int, pods: int, card: str,
                      dev: str = "cuda") -> dict:
    """17a: the parity rig over the wire.  5,000 nodes and 4,096 pods
    created in the port's Python apiserver before the daemon starts; the
    port's daemon over HTTP must bind every pod as the daemon over a
    MemStore does, both on the card."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory

    node_objs = [api.node_to_json(n) for n in
                 synth.make_nodes(nodes, profile="mixed", n_zones=4)]
    pod_objs = [api.pod_to_json(p) for p in
                synth.make_pods(pods, profile="mixed", n_services=4)]
    out = {}
    store = MemStore()
    for obj in node_objs:
        store.create("nodes", obj)
    for obj in pod_objs:
        store.create("pods", obj)
    zero_counts()
    f = ConfigFactory(store, device=dev)
    try:
        t0 = time.perf_counter()
        f.run()
        local = wait_all_bound(lambda: pod_map(store.list("pods")[0]), pods,
                               600)
        out["memstore"] = {"secs": time.perf_counter() - t0,
                           "counts": kernel_counts()}
    finally:
        f.stop()
    proc, base = start_python_apiserver()
    try:
        post_bodies(base, "nodes", list_bodies(node_objs))
        post_bodies(base, "pods", list_bodies(pod_objs))
        zero_counts()
        f = ConfigFactory(base, device=dev, qps=5000, burst=5000)
        try:
            t0 = time.perf_counter()
            f.run()
            wire = wait_all_bound(lambda: pod_map(wire_list(base, "pods")),
                                  pods, 600)
            out["wire"] = {"secs": time.perf_counter() - t0,
                           "counts": kernel_counts()}
        finally:
            f.stop()
    finally:
        rc = proc.stop()
    if rc != 0:
        fail(f"17a: the port's apiserver exited {rc} on SIGTERM")
    if wire != local:
        diff = sorted(k for k in local if wire.get(k) != local[k])[:5]
        fail(f"17a: the daemon over HTTP bound pods differently from the "
             f"MemStore daemon: {diff}")
    for side in ("memstore", "wire"):
        if out[side]["counts"]["scan_chunk"] < 1:
            fail(f"17a: the {side} daemon launched no scan kernel")
    print(f"phase 17a: {card}: parity over the wire ({nodes} mixed nodes, "
          f"{pods} pods created before the daemon, port's Python "
          f"apiserver): every pod's nodeName == the MemStore daemon's on "
          f"{dev}; run() to last bind: wire {out['wire']['secs']:.3f} s, "
          f"MemStore {out['memstore']['secs']:.3f} s; launches wire "
          f"{out['wire']['counts']}, MemStore {out['memstore']['counts']}")
    return out


def stage_snapshot() -> dict:
    from kubernetes_tpu_torch.utils.metrics import STAGE_LATENCY
    return {k[0]: (c.sum, c.count) for k, c in
            STAGE_LATENCY.children().items()}


def stage_split(before: dict, after: dict) -> dict:
    """Seconds per daemon stage between two snapshots; ``compile`` is the
    snapshot, the feature compile and the upload, ``scan`` the solve
    stage (the launches and, one-shot, the wait for them)."""
    def secs(*names):
        return sum(after.get(n, (0, 0))[0] - before.get(n, (0, 0))[0]
                   for n in names) / 1e6
    return {"compile": secs("snapshot", "compile", "transfer"),
            "scan": secs("solve"), "readback": secs("readback"),
            "assume": secs("assume"), "bind": secs("bind")}


class BindCounter:
    """Counts the bind requests a client sends and the 409s the
    apiserver answers them with (a wrapper around the client's two bind
    verbs; measurement only)."""

    def __init__(self, client):
        self.requests = self.conflicts = 0
        self._lock = threading.Lock()
        chunk, single = client._bind_list_chunk, client.bind

        def counted_chunk(bindings):
            res = chunk(bindings)
            with self._lock:
                self.requests += 1
                self.conflicts += sum(1 for r in res
                                      if r is not None and r[0] == 409)
            return res

        def counted_single(*a, **k):
            with self._lock:
                self.requests += 1
            try:
                return single(*a, **k)
            except Exception as err:
                if type(err).__name__ == "ConflictError":
                    with self._lock:
                        self.conflicts += 1
                raise
        client._bind_list_chunk = counted_chunk
        client.bind = counted_single


# A watcher of the pods in its own process (so that it takes no
# interpreter time from the daemon): each pod's first nodeName, and the
# pods whose nodeName later changed.  It exits once it has seen every
# pod bound and the stream has been quiet for a second, or on SIGTERM.
BIND_WATCH = r"""
import json, signal, sys, threading, time
from kubernetes_tpu_torch.client.http import APIClient
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
base, rv, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
w = APIClient(base, qps=0).watch("pods", rv)
print("watching", flush=True)
first, changed, died, last = {}, set(), False, time.monotonic()
while not stop.is_set():
    ev = w.next(timeout=0.1)
    if ev is None:
        if len(first) >= n and time.monotonic() - last > 1.0:
            break
        continue
    if ev.type == "ERROR":
        died = True
        break
    last = time.monotonic()
    node = (ev.object.get("spec") or {}).get("nodeName") or ""
    if node and first.setdefault(ev.key, node) != node:
        changed.add(ev.key)
w.stop()
print(json.dumps({"bound": len(first), "changed": sorted(changed),
                  "died": died}), flush=True)
"""


def start_bind_watch(base: str, n: int) -> "Child":
    from kubernetes_tpu_torch.client.http import APIClient
    rv = APIClient(base, qps=0).list("pods")[1]
    child = Child([sys.executable, "-c", BIND_WATCH, base, str(rv),
                   str(n)], stdout=subprocess.PIPE)
    if child.proc.stdout.readline().strip() != "watching":
        child.stop()
        fail(f"the bind watcher did not start: {child.tail()}")
    return child


def finish_bind_watch(child: "Child", seconds: float = 60.0) -> dict:
    """The watcher's report once it has seen every pod bound."""
    try:
        child.proc.wait(timeout=seconds)
    except subprocess.TimeoutExpired:
        import signal
        child.proc.send_signal(signal.SIGTERM)
    out = child.proc.stdout.read()
    child.stop()
    try:
        return json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        fail(f"the bind watcher reported nothing: {child.tail()}")


def wire_over_capacity(node_objs: list, pod_objs: list) -> int:
    """Nodes whose bound pods exceed their allocatable cpu, memory or pod
    count, from the apiserver's own lists (exact units)."""
    from kubernetes_tpu_torch.api import types as api
    alloc = {}
    for o in node_objs:
        nd = api.node_from_json(o)
        alloc[nd.name] = (nd.allocatable_milli_cpu, nd.allocatable_memory,
                          nd.allocatable_pods)
    used = {}
    for o in pod_objs:
        node = (o.get("spec") or {}).get("nodeName")
        if not node:
            continue
        r = api.pod_from_json(o).resource_request()
        cpu, mem, n = used.get(node, (0, 0, 0))
        used[node] = (cpu + r.milli_cpu, mem + r.memory, n + 1)
    return sum(1 for node, u in used.items()
               if node not in alloc or
               any(a > b for a, b in zip(u, alloc[node])))


# The two settings of the wire north star.  The reference's rig chooses
# by backend (kubernetes_tpu/perf/harness.py:520-540): off a TPU, the
# stream of 4,096-pod chunks with a 20 ms formation deadline; on a TPU,
# the whole burst with a 3,000 ms one.  "one-shot" is the second on the
# port's one-shot route: a STREAM_THRESHOLD above any drain keeps every
# drain of 4,096 pods or more one-shot while the bucket ladder carries
# the whole-burst bucket that the former's target needs.
WIRE_SETTINGS = ("stream", "one-shot")


def wire_run(server: str, nodes: int, pods: int, setting: str, card: str,
             dev: str = "cuda") -> dict:
    """One run of the wire north star on a fresh native apiserver: the
    daemon warmed before the clock, 4 creator threads POST the pods in
    pre-serialised List bodies, the clock runs from the first POST to
    the last bind."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    from kubernetes_tpu_torch.utils import metrics

    proc, base = start_rig_apiserver()
    factory = watch = None
    try:
        node_objs = [api.node_to_json(n) for n in
                     synth.make_nodes(nodes, profile="mixed", n_zones=4)]
        post_bodies(base, "nodes", list_bodies(node_objs))
        factory = ConfigFactory(base, device=dev, qps=5000, burst=5000)
        factory.run()
        daemon = factory.daemon
        whole = -(-pods // 2048) * 2048
        if setting == "stream":
            daemon.STREAM_THRESHOLD = 1
            daemon.stream_chunk = min(4096, whole)
            deadline_ms = 20.0
        else:
            daemon.STREAM_THRESHOLD = 1 << 40
            daemon.stream_chunk = whole
            deadline_ms = 3000.0
        daemon.pipeline.former.deadline_s = deadline_ms / 1e3
        daemon.pipeline.former._target = daemon.stream_chunk_size()
        t_warm = time.perf_counter()
        plist = synth.make_pods(pods, profile="mixed", n_services=4)
        factory.algorithm._compile(plist)
        daemon.prewarm(sample_pods=synth.make_pods(
            min(pods, 2 * daemon.stream_chunk_size()), profile="mixed",
            n_services=4, name_prefix="warm"))
        warm_s = time.perf_counter() - t_warm
        bodies = list_bodies([api.pod_to_json(p) for p in plist])
        binds = BindCounter(factory.store)
        watch = start_bind_watch(base, pods)
        stages0 = stage_snapshot()
        drains0 = metrics.BATCH_FORMATION_LATENCY.count
        forming0 = metrics.BATCH_FORMATION_LATENCY.sum
        decode0 = metrics.WATCH_DECODE_SECONDS.labels(kind="pods").value
        bound0 = daemon.config.metrics.binding_latency.count
        shards = [bodies[i::4] for i in range(4)]
        errors: list = []

        def create(shard):
            try:
                post_bodies(base, "pods", shard)
            except SystemExit as err:
                errors.append(str(err))
        threads = [threading.Thread(target=create, args=(s,), daemon=True)
                   for s in shards]
        zero_counts()
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        create_s = time.perf_counter() - start
        if errors:
            fail(f"17b {setting}: pod creation failed: {errors[0]}")
        while daemon.config.metrics.binding_latency.count - bound0 < pods:
            if time.perf_counter() - start > 600:
                fail(f"17b {setting}: only "
                     f"{daemon.config.metrics.binding_latency.count - bound0}"
                     f" of {pods} pods bound in 600 s")
            time.sleep(0.005)
        wall = time.perf_counter() - start
        daemon.wait_for_binds()
        counts = kernel_counts()
        split = stage_split(stages0, stage_snapshot())
        drains = metrics.BATCH_FORMATION_LATENCY.count - drains0
        forming = (metrics.BATCH_FORMATION_LATENCY.sum - forming0) / 1e6
        decode = metrics.WATCH_DECODE_SECONDS.labels(
            kind="pods").value - decode0
        seen, watch = finish_bind_watch(watch), None
        pod_objs = wire_list(base, "pods")
        unbound = sum(1 for o in pod_objs
                      if not (o.get("spec") or {}).get("nodeName"))
        over = wire_over_capacity(wire_list(base, "nodes"), pod_objs)
        changed = len(seen["changed"])
        if unbound or over or changed or len(pod_objs) != pods or \
                seen["died"] or seen["bound"] != pods:
            fail(f"17b {setting}: {len(pod_objs)} pods listed, {unbound} "
                 f"not bound, {over} nodes over capacity, {changed} pods "
                 f"whose nodeName changed after their first bind; the "
                 f"watch saw {seen['bound']} bound (stream died: "
                 f"{seen['died']})")
        if counts["scan_chunk"] < 1:
            fail(f"17b {setting}: no scan launch")
        run = {"wall": wall, "pods_per_s": pods / wall, "create": create_s,
               "warm": warm_s, "drains": drains, "forming": forming,
               "decode": decode, "counts": counts,
               "split": split, "bind_requests": binds.requests,
               "bind_409": binds.conflicts}
        print(f"phase 17b: {card}: wire north star, {setting} "
              f"(deadline {deadline_ms:g} ms, chunk "
              f"{daemon.stream_chunk_size()}): {pods} of {pods} pods bound "
              f"onto {nodes} nodes through the {server} in {wall:.3f} s "
              f"wall (first POST to last bind), "
              f"{pods / wall:.1f} pods/s; create {create_s:.3f} s; warm "
              f"{warm_s:.3f} s; {drains} drains, {forming:.3f} s forming "
              f"them; pods watch decode {decode:.3f} s; launches {counts}; "
              f"split "
              f"compile {split['compile']:.3f} s, scan "
              f"{split['scan']:.3f} s, readback {split['readback']:.3f} s, "
              f"assume {split['assume']:.3f} s, bind {split['bind']:.3f} s; "
              f"{binds.requests} bind requests, {binds.conflicts} bind "
              f"409s; 0 unbound, 0 nodes over capacity, 0 nodeName "
              f"changes")
        return run
    finally:
        if watch is not None:
            watch.stop()
        if factory is not None:
            factory.stop()
        proc.stop()


def phase_wire_north_star(nodes: int, pods: int, card: str,
                          dev: str = "cuda") -> dict:
    """17b: the north star over the wire, once per setting, through the
    native apiserver built by the port's native.py (a failed build fails
    the phase; nothing falls back to the Python server)."""
    from kubernetes_tpu_torch.apiserver import native
    from kubernetes_tpu_torch.utils import knobs
    server = "Python apiserver (KT_NATIVE_APISERVER=0)"
    if knobs.get_bool("KT_NATIVE_APISERVER"):
        t0 = time.perf_counter()
        try:
            server = f"native apiserver {native.build()}"
        except native.NativeBuildError as err:
            fail(f"17b: the native apiserver did not build: {err}")
        print(f"phase 17b: {server} ready in "
              f"{time.perf_counter() - t0:.3f} s")
    runs = {s: wire_run(server, nodes, pods, s, card, dev)
            for s in WIRE_SETTINGS}
    a, b = runs["stream"]["wall"], runs["one-shot"]["wall"]
    faster = "one-shot" if b < a else "stream"
    print(f"phase 17b: {card}: {faster} was faster: stream {a:.3f} s, "
          f"one-shot {b:.3f} s ({abs(a - b) / max(a, b) * 100:.1f}% less "
          f"wall)")
    return runs


def phase_wire_binaries(nodes: int, pods: int, card: str,
                        dev: str = "cuda") -> None:
    """17c: ``python -m kubernetes_tpu_torch.apiserver`` and ``python -m
    kubernetes_tpu_torch.scheduler --api-server URL --leader-elect`` as
    processes: every pod binds, /configz says the device, the lease
    names the daemon, SIGTERM exits both with 0."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.utils.leaderelection import (
        LEADER_ANNOTATION_KEY, LeaderElectionRecord)

    api_proc, base = start_python_apiserver()
    sched = None
    try:
        post_bodies(base, "nodes", list_bodies(
            [api.node_to_json(n) for n in
             synth.make_nodes(nodes, profile="mixed", n_zones=4)]))
        cmd = [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
               "--api-server", base, "--port", "0", "--leader-elect",
               "--leader-elect-lease-duration", "4",
               "--leader-elect-renew-deadline", "3",
               "--leader-elect-retry-period", "0.5",
               "--kube-api-qps", "5000", "--kube-api-burst", "5000"]
        if dev != "cuda":
            cmd += ["--device", dev]
        t0 = time.perf_counter()
        sched = Child(cmd, stdout=subprocess.PIPE)
        port = json.loads(sched.proc.stdout.readline() or "{}").get("port")
        if port is None:
            sched.stop()
            fail(f"17c: the daemon binary did not start: {sched.tail()}")
        post_bodies(base, "pods", list_bodies(
            [api.pod_to_json(p) for p in
             synth.make_pods(pods, profile="mixed", n_services=4)]))
        wait_all_bound(lambda: pod_map(wire_list(base, "pods")), pods, 600)
        secs = time.perf_counter() - t0
        status, body = wire_request(f"http://127.0.0.1:{port}", "GET",
                                    "/configz")
        cfg = json.loads(body)
        if status != 200 or cfg["device"] != dev or \
                cfg["apiServer"] != base or not cfg["leaderElect"]:
            fail(f"17c: /configz {status} {body[:300]!r}")
        status, body = wire_request(
            base, "GET",
            "/api/v1/namespaces/kube-system/endpoints/kube-scheduler")
        record = LeaderElectionRecord.from_json(json.loads(body)[
            "metadata"]["annotations"][LEADER_ANNOTATION_KEY])
        if not record.holder_identity.endswith(f"-{sched.pid}"):
            fail(f"17c: the lease names {record.holder_identity!r}, not "
                 f"the daemon (pid {sched.pid})")
        rc = sched.stop(120)
        if rc != 0:
            fail(f"17c: the daemon binary exited {rc} on SIGTERM: "
                 f"{sched.tail()}")
        sched = None
    finally:
        if sched is not None:
            sched.stop()
        api_rc = api_proc.stop()
    if api_rc != 0:
        fail(f"17c: the apiserver binary exited {api_rc} on SIGTERM: "
             f"{api_proc.tail()}")
    print(f"phase 17c: {card if dev == 'cuda' else dev}: python -m "
          f"kubernetes_tpu_torch.apiserver and python -m "
          f"kubernetes_tpu_torch.scheduler --api-server --leader-elect "
          f"(--device {dev}): {pods} pods onto {nodes} nodes bound "
          f"{secs:.3f} s after the daemon started; /configz device {dev}; "
          f"the lease names {record.holder_identity}; both exited 0 on "
          f"SIGTERM")


# -- the port's bench (phase 18) ---------------------------------------------

# The reference's SLO attainment floors (kubernetes_tpu/perf/serving.py:
# 299-313) and its bar on the profile's unclassified CPU share
# (tools/check_bench.py UNCLASSIFIED_BAR).
SERVING_FLOORS = {"poisson_trickle": 99.0, "burst_replay": 95.0,
                  "ramp": 95.0}
UNCLASSIFIED_BAR = 0.20
BENCH_PATHS = ("bench_density_stream", "bench_density_one-shot",
               "bench_wire_stream", "bench_wire_one-shot", "serving")


def run_bench(env: dict, argv: list) -> dict:
    """``perf/bench.main(argv)`` in this process under ``env``; returns
    its artifact (a non-zero exit fails the phase)."""
    import os
    from kubernetes_tpu_torch.perf import bench
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = bench.main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        art = json.load(f)
    if rc != 0:
        fail(f"18: the bench exited {rc}: {art.get('failures')}")
    return art


def phase_bench(nodes: int, pods: int, card: str,
                dev: str = "cuda") -> dict:
    """18: the bench at the north star, repeats cut; then a profiled
    run.  ``dev="cpu"`` is a rehearsal at a small size (no card, no
    kernel launches to hold it to)."""
    import glob
    import os
    import tempfile
    from kubernetes_tpu_torch.utils import profiling

    out_dir = os.path.join("build", "bench")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "BENCH_cuda.json")
    env = {"BENCH_NODES": str(nodes), "BENCH_PODS": str(pods),
           "BENCH_PROFILE": "mixed", "BENCH_DENSITY_RUNS": "2",
           "BENCH_WIRE": "1", "BENCH_WIRE_RUNS": "1", "BENCH_JOINT": "1",
           "BENCH_WORKLOADS": "1", "BENCH_SERVING": "1",
           # Phase 20b runs fleet_metrics at the same size: cut here so
           # the fleet does not run twice.
           "BENCH_FLEET": "0"}
    zero_counts()
    t0 = time.perf_counter()
    art = run_bench(env, ["--device", dev, "--out", out,
                          "--serving-trickle-s", "5"])
    secs = time.perf_counter() - t0
    counts = kernel_counts()
    want_card = card if dev == "cuda" else None
    if art.get("backend") != dev or art.get("card") != want_card:
        fail(f"18: the artifact names {art.get('backend')!r} "
             f"{art.get('card')!r}, not {dev} {want_card!r}")
    for setting, block in art["settings"].items():
        if block["scheduled_runs"] != [pods] * int(
                env["BENCH_DENSITY_RUNS"]):
            fail(f"18: density {setting} bound {block['scheduled_runs']}")
    wire = art["wire"]["settings"]
    for setting, block in wire.items():
        if block["zero_bound_runs"] or block["failed_runs"] or \
                block.get("scheduled_runs") != [pods]:
            fail(f"18: wire {setting}: {block['zero_bound_runs']} "
                 f"zero-bound, {block['failed_runs']} failed, bound "
                 f"{block.get('scheduled_runs')}: {block['errors']}")
        for route, (status, ctype) in block["status_routes"].items():
            if status != 200:
                fail(f"18: wire {setting}: {route} answered {status}")
    if art["post_prewarm_compiles"] or \
            art["serving"]["post_prewarm_compiles"]:
        fail(f"18: kernel builds after a warm-up: "
             f"{art['post_prewarm_compiles']} bench, "
             f"{art['serving']['post_prewarm_compiles']} serving")
    paths = art["launches_by_path"]
    for path in BENCH_PATHS:
        if dev == "cuda" and paths[path]["scan_chunk"] < 1:
            fail(f"18: no scan launch on {path}: {paths[path]}")
    for kernel, total in counts.items():
        if sum(v[kernel] for v in paths.values()) > total:
            fail(f"18: {kernel}: the bench's per-path launches "
                 f"{paths} exceed the {total} counted")
    lib = art["library_build_s"] or {"built": False, "seconds": 0.0}
    print(f"phase 18: {want_card or dev}: bench {nodes} nodes x {pods} "
          f"pods in {secs:.3f} s (library "
          f"{'built' if lib['built'] else 'loaded'} in "
          f"{lib['seconds']:.3f} s); launches {counts}")
    for setting, b in art["settings"].items():
        print(f"phase 18: density {setting} ({b['route']}): runs "
              f"{b['elapsed_s_runs']} s, p50 {b['elapsed_s_p50']} s, "
              f"spread {b['elapsed_s_spread']}, best {b['value']} pods/s, "
              f"median {b['median']} pods/s; warm {b['warm_s_runs']} s; "
              f"stages {json.dumps(b['stages'])}; launches "
              f"{b['device']['launches']}; post-prewarm builds 0")
    for setting, b in wire.items():
        print(f"phase 18: wire {setting} ({b['apiserver']} apiserver, "
              f"{b['route']}): {b['elapsed_s']} s, "
              f"{b['pods_per_second']} pods/s, create {b['create_s']} s, "
              f"warm {b['warm_compile_s']} s, launches {b['launches']}; "
              f"routes {b['status_routes']}; stages "
              f"{json.dumps(b['stages'])}")
        prof = b["profile"]
        cpu = prof.get("cpu_seconds", {})
        uf = prof.get("unclassified_fraction")
        print(f"phase 18: wire {setting} profile over {prof['wall_s']} s: "
              f"cpu s {json.dumps(cpu)}, unclassified {uf} (bar "
              f"{UNCLASSIFIED_BAR}), {prof.get('samples')} samples, "
              f"sampler {prof.get('sampler_self_cpu_s')} s; wire "
              f"{json.dumps(prof.get('wire'))}")
        if not prof.get("enabled") or uf is None or uf > UNCLASSIFIED_BAR:
            fail(f"18: wire {setting}: unclassified CPU share {uf} above "
                 f"the {UNCLASSIFIED_BAR} bar (or the profiler was off)")
    for name, row in art["serving"]["rows"].items():
        floor = SERVING_FLOORS[name]
        att = row["slo"]["attainment_pct"]
        print(f"phase 18: serving {name}: {row['bound']} of {row['pods']} "
              f"bound, p50 {row['latency_ms']['p50']} ms, p99 "
              f"{row['latency_ms']['p99']} ms, max "
              f"{row['latency_ms']['max']} ms, SLO "
              f"{row['slo']['slo_ms']} ms attained by {att}% (floor "
              f"{floor}%)")
        if row["bound"] != row["pods"] or att < floor:
            fail(f"18: serving {name}: {row['bound']}/{row['pods']} bound, "
                 f"attainment {att}% under its {floor}% floor")
    print(f"phase 18: joint {art['joint']}; workloads "
          f"{ {k: v for k, v in art['workloads'].items() if k != 'record'} }")

    # The profiled run: one density run per setting and the joint phase.
    trace_dir = tempfile.mkdtemp(prefix="kt_traces_")
    t0 = time.perf_counter()
    try:
        prof_art = run_bench(
            dict(env, BENCH_DENSITY_RUNS="1", BENCH_WIRE="0",
                 BENCH_WORKLOADS="0", BENCH_SERVING="0"),
            ["--device", dev, "--profile-dir", trace_dir, "--out",
             os.path.join(out_dir, "BENCH_cuda_profiled.json")])
    finally:
        profiling.set_profile_dir("")
    secs = time.perf_counter() - t0
    files = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    labels: set = set()
    kernel_us = 0.0
    kernel_events = 0
    for path in files:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            name = e.get("name", "")
            if name.startswith("solve_"):
                labels.add(name)
            if "scan_chunk_kernel" in name and \
                    e.get("cat", "").lower() == "kernel":
                kernel_events += 1
                kernel_us += float(e.get("dur", 0.0))
    want = {"solve_stream_chunk", "solve_sequential", "solve_joint"}
    if not files or not want <= labels or (dev == "cuda" and (
            kernel_events < 1 or kernel_us <= 0)):
        fail(f"18: profiled run wrote {len(files)} traces with labels "
             f"{sorted(labels)}, {kernel_events} scan_chunk_kernel events "
             f"({kernel_us:.1f} us)")
    print(f"phase 18: --profile-dir: {len(files)} Chrome traces in "
          f"{secs:.3f} s ({prof_art['profile_dir']}), labels "
          f"{sorted(labels)}, {kernel_events} scan_chunk_kernel events "
          f"with {kernel_us / 1e3:.3f} ms of device time; profiled density "
          f"stream {prof_art['settings']['stream']['elapsed_s_runs']} s, "
          f"one-shot {prof_art['settings']['one-shot']['elapsed_s_runs']} "
          f"s (unprofiled p50 "
          f"{art['settings']['stream']['elapsed_s_p50']} / "
          f"{art['settings']['one-shot']['elapsed_s_p50']} s)")
    for path in files:
        os.remove(path)
    os.rmdir(trace_dir)
    return {"paths": {k: paths[k] for k in BENCH_PATHS}, "art": art}


# -- the HA, tenancy, defrag and verifier slice (phase 19) --------------------

TENANTS = ("t-a", "t-b", "t-c")
TENANT_WEIGHTS = {"t-a": 2.0, "t-b": 1.0, "t-c": 1.0}
# The combined daemon of 19a, 19c and 19d: the tenancy service with the
# defragmenter (rounds driven by the phase: a period past the run) and
# the verifier every 0.5 s; the reference soak's backoff, gain and budget
# (kubernetes_tpu/perf/soak.py:1834-1845), and the knob's default of 8
# migrations a round (the soak's 4 would need two rounds for 8 pods).
SLICE_ENV = {"KT_TENANTS": ",".join(TENANTS),
             "KT_TENANT_WEIGHTS": "t-a:2,t-b:1,t-c:1",
             "KT_DEFRAG": "1", "KT_DEFRAG_PERIOD_S": "3600",
             "KT_DEFRAG_MAX_MIGRATIONS": "8", "KT_DEFRAG_MIN_GAIN": "0.2",
             "KT_DEFRAG_BUDGET": "16", "KT_VERIFY_PERIOD": "0.5",
             "KT_POD_BACKOFF_S": "0.1", "KT_POD_BACKOFF_MAX_S": "1"}
DEFRAG_LARGE = 8       # 19c's large pods
DEFRAG_ROUNDS = 10
FOLLOW_PODS = 2048     # 19d's follow-up drain
READBACK_ROWS = 64     # the verifier's sample (cache/verifier.py)
HA_SHARDS = 8          # SOAK_r17.json "ha": 8 shards, 3 incarnations,
HA_INCARNATIONS = 3    # 12 namespaces, a 0.45 s lease
HA_NAMESPACES = 12
HA_LEASE_S = 0.45
TAKEOVER_BAR_S = 1.0   # the reference soak's bar


class Env:
    """Environment knobs set for a block and restored after it."""

    def __init__(self, env: dict):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        import os
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        import os
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class BindWatch:
    """Every pod's node off a watch stream, in a thread of this process:
    binds, unbinds (a defrag evict-to-pending), double binds (a bound pod
    seen bound to another node), and unbinds of ``protected`` pods."""

    def __init__(self, watcher, protected: frozenset = frozenset()):
        self.nodes: dict = {}
        self.binds = self.unbinds = self.double_binds = 0
        self.double_keys: list = []
        self.protected = set(protected)
        self.protected_unbinds: list = []
        self._w = watcher
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t.start()

    def _pump(self) -> None:
        while not self._stop.is_set():
            ev = self._w.next(timeout=0.2)
            if ev is None or ev.type == "ERROR":
                continue
            if ev.type == "DELETED":
                self.nodes.pop(ev.key, None)
                continue
            node = (ev.object.get("spec") or {}).get("nodeName") or ""
            prev = self.nodes.get(ev.key, "")
            if node and not prev:
                self.binds += 1
            elif prev and not node:
                self.unbinds += 1
                if ev.key in self.protected:
                    self.protected_unbinds.append(ev.key)
            elif node and prev and node != prev:
                self.double_binds += 1
                self.double_keys.append((ev.key, prev, node))
            self.nodes[ev.key] = node

    def bound(self) -> int:
        return sum(1 for v in list(self.nodes.values()) if v)

    def stop(self) -> None:
        self._stop.set()
        self._w.stop()
        self._t.join(timeout=10)


def tenant_pods(n: int, prefix: str, seed: int = 1) -> list:
    """``n`` ``mixed`` pods split 2:1:1 over the tenant namespaces,
    interleaved in 250-pod runs (the order the tenancy bench loads its
    backlog in)."""
    from kubernetes_tpu_torch.perf import synth
    share = {"t-a": n // 2, "t-b": n // 4}
    share["t-c"] = n - share["t-a"] - share["t-b"]
    per = {t: synth.make_pods(k, seed=seed + i, profile="mixed",
                              n_services=4, namespace=t,
                              name_prefix=f"{prefix}-{t}")
           for i, (t, k) in enumerate(share.items())}
    out: list = []
    while any(per.values()):
        for t in TENANTS:
            out += per[t][:250]
            per[t] = per[t][250:]
    return out


def slice_daemon(nodes: int, pods: list, dev: str, env: dict) -> tuple:
    """A ``ConfigFactory`` over a ``MemStore`` holding ``nodes`` ``mixed``
    nodes and ``pods`` before ``run()``, built and run under ``env``;
    (factory, store, packs, watch, t_run): ``packs`` records each packed
    solve's tenant counts, ``watch`` every pod's node, ``t_run`` when the
    store was full and the factory's construction began."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    store = MemStore()
    for n in synth.make_nodes(nodes, profile="mixed", n_zones=4):
        store.create("nodes", api.node_to_json(n))
    for p in pods:
        store.create("pods", api.pod_to_json(p))
    watch = BindWatch(store.watch(["pods"], from_rv=store.list("pods")[1]))
    t_run = time.perf_counter()
    with Env(env):
        f = ConfigFactory(store, device=dev)
        packs: list = []
        svc = f.tenancy
        if svc is None:
            fail("19: KT_TENANTS built no solver service")
        real = svc.packer.pack

        def pack(batch, cap, now=None):
            sel, dfr = real(batch, cap, now=now)
            packs.append(svc.count_tenants(sel))
            return sel, dfr
        svc.packer.pack = pack
        f.run()
    return f, store, packs, watch, t_run


def time_verifier(f) -> dict:
    """Wrap the daemon's verifier pass to add up its count and seconds
    (read by the phase; the verifier itself is unchanged)."""
    acc = {"passes": 0, "seconds": 0.0}
    real = f.verifier.verify_once

    def timed():
        t0 = time.perf_counter()
        try:
            return real()
        finally:
            acc["passes"] += 1
            acc["seconds"] += time.perf_counter() - t0
    f.verifier.verify_once = timed
    return acc


def pause_verifier(f) -> None:
    """Stop the verifier's background loop (a pass in flight finishes);
    ``verify_once`` stays callable."""
    f.verifier.stop()
    for t in f._threads:
        if t.name == "cache-verifier":
            t.join(timeout=120)
    f.verifier._stop.clear()


def wait_watch_bound(watch: BindWatch, n: int, seconds: float,
                     what: str) -> float:
    t0 = time.perf_counter()
    while watch.bound() < n:
        if time.perf_counter() - t0 > seconds:
            fail(f"{what}: {watch.bound()} of {n} pods bound in "
                 f"{seconds} s")
        time.sleep(0.005)
    return time.perf_counter()


def phase_tenancy(nodes: int, pods: int, parity_pods: int, card: str,
                  dev: str = "cuda",
                  density_p50: float | None = None) -> dict:
    """19a: the tenancy north star through the slice's daemon (kept for
    19c and 19d), then cuda against cpu on a parity rig of the same
    shape.  (The tenancy bench, ``python -m
    kubernetes_tpu_torch.perf.tenancy``, runs on its own: it does not fit
    the smoke's time.)"""
    out: dict = {}
    label = card if dev == "cuda" else dev

    # The tenancy north star on the slice's daemon.
    plist = tenant_pods(pods, "ns")
    zero_counts()
    f, store, packs, watch, t0 = slice_daemon(nodes, plist, dev, SLICE_ENV)
    t_run = time.perf_counter()
    vtime = time_verifier(f)
    t_last = wait_watch_bound(watch, pods, 600, "19a")
    wall = t_last - t0
    out["north_star"] = kernel_counts()
    objs = store.list("pods")[0]
    unbound = sum(1 for o in objs
                  if not (o.get("spec") or {}).get("nodeName"))
    over = wire_over_capacity(store.list("nodes")[0], objs)
    if unbound or over or len(objs) != pods:
        fail(f"19a: {len(objs)} pods, {unbound} unbound, {over} nodes over "
             f"capacity")
    if dev == "cuda" and out["north_star"]["scan_chunk"] < 1:
        fail("19a: the tenancy north star launched no scan kernel")
    # The bound shares over the first packed solves (until 45% of the
    # backlog, where every tenant still saturates) against the weights.
    seen = {t: 0 for t in TENANTS}
    used = 0
    for p in packs:
        for t, k in p.items():
            seen[t] = seen.get(t, 0) + k
        used += 1
        if sum(seen.values()) >= 0.45 * pods:
            break
    total = sum(seen.values()) or 1
    wsum = sum(TENANT_WEIGHTS.values())
    err = max(abs(seen[t] / total - TENANT_WEIGHTS[t] / wsum) /
              (TENANT_WEIGHTS[t] / wsum) for t in TENANTS)
    if err > 0.10:
        fail(f"19a: shares over the first {used} packed solves {seen} "
             f"miss the weights {TENANT_WEIGHTS} by {err:.4f}")
    rep = f.tenancy.report()
    if any(r["mode"] != "device" for r in rep["tenants"].values()):
        fail(f"19a: a tenant left device mode: {rep}")
    context = (f"; phase 18's one-shot density p50 {density_p50} s for "
               f"context" if density_p50 is not None else "")
    print(f"phase 19a: {label}: tenancy north star {pods} pods 2:1:1 over "
          f"{list(TENANTS)} onto {nodes} nodes: all bound, 0 over "
          f"capacity, {wall:.3f} s from the factory's construction to the "
          f"last bind (run() returned after {t_run - t0:.3f} s), "
          f"{len(packs)} packed solves (cap "
          f"{f.daemon.degraded_drain_cap()}), launches "
          f"{out['north_star']}; first {used} solves bound {seen} = "
          f"shares "
          f"{ {t: round(seen[t] / total, 4) for t in TENANTS} } against "
          f"{ {t: round(TENANT_WEIGHTS[t] / wsum, 4) for t in TENANTS} } "
          f"(max relative error {err:.4f}, bar 0.10); the verifier "
          f"(every 0.5 s) ran {f.verifier.passes} passes, "
          f"{vtime['passes']} of them after run() taking "
          f"{vtime['seconds']:.3f} s{context}")
    out["ctx"] = {"factory": f, "store": store, "watch": watch,
                  "verifier_time": vtime}

    # cuda against cpu on the parity rig of the same shape.
    if parity_pods:
        maps = {}
        secs = {}
        for d in (dev, "cpu") if dev == "cuda" else (dev,):
            ppods = tenant_pods(parity_pods, "par")
            t0 = time.perf_counter()
            g, gstore, _, gwatch, _ = slice_daemon(
                nodes, ppods, d, {k: SLICE_ENV[k] for k in (
                    "KT_TENANTS", "KT_TENANT_WEIGHTS")})
            try:
                # Settled: every pod decided once (bound or failed) and
                # nothing queued.
                attempts = g.daemon.config.metrics.scheduling_attempts
                deadline = time.perf_counter() + 900
                while len(g.daemon.queue) or \
                        counter_total(attempts) < parity_pods:
                    if time.perf_counter() > deadline:
                        fail(f"19a parity {d}: "
                             f"{counter_total(attempts)} of {parity_pods} "
                             f"pods decided in 900 s")
                    time.sleep(0.05)
                maps[d] = pod_map(gstore.list("pods")[0])
                secs[d] = time.perf_counter() - t0
            finally:
                gwatch.stop()
                g.stop()
        if dev == "cuda" and maps["cuda"] != maps["cpu"]:
            diff = [k for k in maps["cpu"] if maps["cpu"][k] !=
                    maps["cuda"].get(k)]
            fail(f"19a: the parity rig's placements differ on "
                 f"{len(diff)} pods, e.g. {diff[:5]}")
        bound = sum(map(bool, maps[dev].values()))
        print(f"phase 19a: parity rig {nodes} x {parity_pods} (2:1:1): "
              f"{bound} bound, identical on "
              f"{' and '.join(maps)} ({', '.join(f'{d} {s:.3f} s' for d, s in secs.items())})")
    return out


def shard_leases(conn) -> dict:
    """shard -> (holder, acquire stamp) of its live lease record, off the
    apiserver over one keep-alive connection (holder "" when released or
    never held).  The stamp is the acquirer's ``time.monotonic()`` when
    it took the lease: one clock for every process on the host."""
    from kubernetes_tpu_torch.scheduler.shards import shard_lock_name
    from kubernetes_tpu_torch.utils.leaderelection import (
        LEADER_ANNOTATION_KEY, LeaderElectionRecord)
    out = {}
    for s in range(HA_SHARDS):
        conn.request("GET", f"/api/v1/namespaces/kube-system/endpoints/"
                     f"{shard_lock_name(s)}")
        r = conn.getresponse()
        body = r.read()
        out[s] = ("", 0.0)
        if r.status != 200:
            continue
        raw = ((json.loads(body).get("metadata") or {})
               .get("annotations") or {}).get(LEADER_ANNOTATION_KEY)
        if raw:
            rec = LeaderElectionRecord.from_json(raw)
            if rec.lease_duration_seconds > 0:
                out[s] = (rec.holder_identity, rec.acquire_time)
    return out


def debug_vars(port: int) -> dict:
    status, body = wire_request(f"http://127.0.0.1:{port}", "GET",
                                "/debug/vars", timeout=30)
    if status != 200:
        fail(f"/debug/vars on {port} answered {status}")
    return json.loads(body)


def phase_ha(nodes: int, pods: int, card: str, dev: str = "cuda") -> dict:
    """19b: three ``python -m kubernetes_tpu_torch.scheduler
    --api-server`` incarnations sharded over one native apiserver (the
    reference soak's HA wave); one SIGKILLed after a third of the pods
    bound; the survivors take its shards and finish."""
    import http.client
    import os
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client.http import APIClient
    from kubernetes_tpu_torch.perf import synth

    label = card if dev == "cuda" else dev
    api_proc, base = start_rig_apiserver()
    kids: dict = {}
    watch = None
    try:
        node_objs = [api.node_to_json(n) for n in
                     synth.make_nodes(nodes, profile="mixed", n_zones=4)]
        post_bodies(base, "nodes", list_bodies(node_objs))
        env = dict(os.environ)
        env.update({"KT_HA_SHARDS": str(HA_SHARDS),
                    "KT_HA_LEASE_S": str(HA_LEASE_S),
                    "KT_HA_RENEW_S": str(HA_LEASE_S * 0.75),
                    "KT_HA_RETRY_S": str(HA_LEASE_S / 8),
                    "KT_PREWARM": "1",
                    "KT_POD_BACKOFF_S": "0.1",
                    "KT_POD_BACKOFF_MAX_S": "2"})
        t0 = time.perf_counter()
        for i in range(HA_INCARNATIONS):
            name = f"inc-{i}"
            cmd = [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
                   "--api-server", base, "--port", "0",
                   "--kube-api-qps", "5000", "--kube-api-burst", "5000"]
            if dev != "cuda":
                cmd += ["--device", dev]
            child = Child(cmd, stdout=subprocess.PIPE, env=dict(
                env, KT_INCARNATION=name))
            kids[name] = child
        ports = {}
        for name, child in kids.items():
            port = json.loads(child.proc.stdout.readline() or "{}") \
                .get("port")
            if port is None:
                fail(f"19b: {name} did not start: {child.tail()}")
            ports[name] = port
        # Ready: every incarnation holds a shard and together all of them.
        deadline = time.perf_counter() + 300
        while True:
            owned = {n: (debug_vars(p).get("ha") or {}).get(
                "shardsOwned", []) for n, p in ports.items()}
            held = set().union(*map(set, owned.values()))
            if all(owned.values()) and held == set(range(HA_SHARDS)):
                break
            for name, child in kids.items():
                if child.proc.poll() is not None:
                    fail(f"19b: {name} exited {child.proc.returncode}: "
                         f"{child.tail()}")
            if time.perf_counter() > deadline:
                fail(f"19b: shards never balanced: {owned}")
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        before = dict(owned)
        # Launches counted from here (each process's prewarm is its own).
        base_launches = {n: debug_vars(p)["kernelLaunches"]
                         for n, p in ports.items()}
        objs = []
        for i, p in enumerate(synth.make_pods(pods, profile="mixed",
                                              n_services=4)):
            obj = api.pod_to_json(p)
            obj["metadata"]["namespace"] = f"ha-ns-{i % HA_NAMESPACES}"
            objs.append(obj)
        bodies = list_bodies(objs)
        rv = APIClient(base, qps=0).list("pods")[1]
        watch = BindWatch(APIClient(base, qps=0).watch("pods", rv))
        zero_counts()
        shards = [bodies[i::4] for i in range(4)]
        errors: list = []

        def create(shard):
            try:
                post_bodies(base, "pods", shard)
            except SystemExit as err:
                errors.append(str(err))
        threads = [threading.Thread(target=create, args=(s,), daemon=True)
                   for s in shards]
        start = time.perf_counter()
        for t in threads:
            t.start()
        victim = "inc-0"
        # A third bound, as a survivor's cache counts them (this
        # process's own watch decodes every event and lags the burst).
        while True:
            bound_at_kill = debug_vars(ports["inc-1"])["cachedPods"]
            if bound_at_kill >= pods // 3:
                break
            if time.perf_counter() - start > 600:
                fail(f"19b: {watch.bound()} of {pods} bound before the "
                     f"kill in 600 s")
            time.sleep(0.05)
        last = {victim: debug_vars(ports[victim])}
        host, port = base.rpartition("/")[2].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        held = {s for s, (h, _) in shard_leases(conn).items()
                if h == victim}
        # The takeover clock: monotonic, the clock of the leases' stamps.
        t_kill = time.monotonic()
        kids[victim].proc.kill()
        survivors = {n for n in kids if n != victim}
        taken: dict = {}
        while True:
            leases = shard_leases(conn)
            for s in held:
                h, stamp = leases[s]
                if s not in taken and h in survivors:
                    taken[s] = stamp
            if all(h in survivors for h, _ in leases.values()):
                break
            if time.monotonic() - t_kill > 60:
                fail(f"19b: survivors never held every shard: {leases}")
            time.sleep(0.005)
        polled = time.monotonic() - t_kill
        conn.close()
        # When the last of the victim's shards was taken, by the stamp its
        # taker wrote (the poll adds this process's own delay on top).
        stamped = max((taken[s] for s in held), default=t_kill) - t_kill
        takeover = stamped if 0.0 <= stamped <= polled else polled
        for t in threads:
            t.join()
        if errors:
            fail(f"19b: pod creation failed: {errors[0]}")
        t_last = wait_watch_bound(watch, pods, 600, "19b")
        wall = t_last - start
        kids[victim].proc.wait()
        # The survivors' own views, once they agree (a rebalance between
        # them can be mid-handoff at any one read).
        deadline = time.perf_counter() + 60
        while True:
            for n in sorted(survivors):
                last[n] = debug_vars(ports[n])
            after = {n: last[n]["ha"]["shardsOwned"]
                     for n in sorted(survivors)}
            owned = [s for v in after.values() for s in v]
            if sorted(owned) == list(range(HA_SHARDS)):
                break
            if time.perf_counter() > deadline:
                fail(f"19b: the survivors hold {after}")
            time.sleep(0.1)
        listed = wire_list(base, "pods")
        unbound = sum(1 for o in listed
                      if not (o.get("spec") or {}).get("nodeName"))
        over = wire_over_capacity(wire_list(base, "nodes"), listed)
        time.sleep(0.5)  # late watch events of the last binds
        if unbound or over or len(listed) != pods or \
                watch.double_binds or watch.unbinds:
            fail(f"19b: {len(listed)} pods, {unbound} unbound, {over} "
                 f"nodes over capacity, {watch.double_binds} double binds "
                 f"{watch.double_keys[:3]}, {watch.unbinds} nodeName "
                 f"changes after a bind")
        if takeover >= TAKEOVER_BAR_S:
            fail(f"19b: takeover took {takeover:.3f} s (bar "
                 f"{TAKEOVER_BAR_S} s; stamped {stamped:.3f} s, polled "
                 f"{polled:.3f} s; shards {sorted(held)} taken at "
                 f"{ {s: round(t - t_kill, 3) for s, t in taken.items()} }"
                 f" s; {bound_at_kill} bound at the kill)")
        launches = {n: {k: c - base_launches[n][k]
                        for k, c in v["kernelLaunches"].items()}
                    for n, v in last.items()}
        if dev == "cuda" and any(v["scan_chunk"] < 1
                                 for v in launches.values()):
            fail(f"19b: an incarnation launched no scan kernel: {launches}")
        recoveries = {n: len(last[n].get("shardRecoveries") or [])
                      for n in sorted(survivors)}
        print(f"phase 19b: {label}: {HA_INCARNATIONS} incarnations "
              f"(KT_HA_SHARDS={HA_SHARDS}, lease {HA_LEASE_S} s) over the "
              f"native apiserver, {nodes} nodes, {pods} pods over "
              f"{HA_NAMESPACES} namespaces: ready in {ready_s:.3f} s; "
              f"shards before {before}; {victim} SIGKILLed with "
              f"{bound_at_kill} pods in a survivor's cache; the survivors "
              f"held all "
              f"{HA_SHARDS} shards {takeover:.3f} s later by the leases' "
              f"stamps (polled {polled:.3f} s; bar {TAKEOVER_BAR_S} s; its "
              f"shards {sorted(held)} taken at "
              f"{ {s: round(t - t_kill, 3) for s, t in sorted(taken.items())} }"
              f" s); after {after}; takeover reconciles "
              f"{recoveries}; the last bind {wall:.3f} s after the first "
              f"POST; 0 double binds, 0 nodeName changes, 0 unbound, 0 "
              f"over capacity; scan launches "
              f"{ {n: v['scan_chunk'] for n, v in launches.items()} }, "
              f"device memory peak "
              f"{ {n: v['hbmPeakBytes'] for n, v in last.items()} } "
              f"bytes")
        total = {k: sum(v[k] for v in launches.values())
                 for k in ("scan_chunk", "select_rows", "select_hosts")}
        return {"launches": total, "takeover_s": takeover, "wall": wall}
    finally:
        if watch is not None:
            watch.stop()
        for child in kids.values():
            child.stop(30)
        api_proc.stop()


def pod_free(store) -> tuple[dict, dict]:
    """(node -> [free milli-cpu, free memory, free pod slots], node ->
    [(key, obj, request)] of its bound pods), off the store."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.scheduler.defrag import _node_capacity
    free = {}
    for n in store.list("nodes")[0]:
        cap = _node_capacity(n)
        if cap is not None:
            free[api.key_from_json(n)] = cap
    by_node: dict = {}
    for o in store.list("pods")[0]:
        node = (o.get("spec") or {}).get("nodeName") or ""
        if not node or node not in free:
            continue
        req = MemStore._pod_requests(o)
        for i in range(3):
            free[node][i] -= req[i]
        by_node.setdefault(node, []).append((api.key_from_json(o), o, req))
    return free, by_node


def phase_defrag(ctx: dict, card: str, dev: str = "cuda") -> dict:
    """19c: biased churn on the bound north star (the smallest pod of
    every node deleted, then large pods that fit no node's free space,
    the freest node's pods under a PDB with no headroom), then defrag
    rounds whose probe is the solver service's joint solve."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.client import cas_update

    f, store, watch = ctx["factory"], ctx["store"], ctx["watch"]
    ctrl = f.defrag
    label = card if dev == "cuda" else dev
    # The verifier's passes hold the cache lock for seconds at this size:
    # parked during the rounds (their probe's time is the phase's
    # measurement), then one explicit pass checks the end state.
    pause_verifier(f)
    zero_counts()
    free, by_node = pod_free(store)
    deleted = 0
    for node, plist in by_node.items():
        if len(plist) > 1:
            key = min(plist, key=lambda c: (c[2][0], c[0]))[0]
            store.delete("pods", key)
            deleted += 1
    free, by_node = pod_free(store)
    top = max(free, key=lambda n: (free[n][0], n))
    protected = sorted(k for k, _, _ in by_node[top])
    for key in protected:
        obj = store.get("pods", key)
        obj["metadata"].setdefault("labels", {})["kt/defrag"] = "protected"
        cas_update(store, "pods", obj)
    # A PDB is namespaced: one per namespace of the protected pods.
    for ns in sorted({k.split("/")[0] for k in protected}):
        count = sum(1 for k in protected if k.startswith(ns + "/"))
        store.create("poddisruptionbudgets", {
            "metadata": {"name": "defrag-pdb", "namespace": ns},
            "spec": {"minAvailable": count,
                     "selector": {"kt/defrag": "protected"}},
            "status": {"disruptionAllowed": False, "currentHealthy": count,
                       "desiredHealthy": count, "expectedPods": count}})
    watch.protected = set(protected)
    large_cpu = free[top][0] + 100
    large = []
    for k in range(DEFRAG_LARGE):
        name = f"df-large-{k}"
        store.create("pods", {
            "metadata": {"name": name, "namespace": "t-a"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": f"{large_cpu}m",
                             "memory": "64Mi"}}}]}})
        large.append(f"t-a/{name}")
    if any(v[0] >= large_cpu for v in free.values()):
        fail("19c: a large pod fits some node's free space")
    rounds = []
    real_probe = ctrl.probe
    acts = [ProfilerActivity.CUDA] if dev == "cuda" else \
        [ProfilerActivity.CPU]
    # The profiler's first session in a process pays its own start-up;
    # pay it here, outside the probes.
    with profile(activities=acts):
        (torch.ones(8, device=dev) + 1).sum().item()
    engine = f.algorithm
    real_batch = engine.schedule_batch
    solve_s = [0.0]

    def timed_batch(*a, **k):
        t0 = time.perf_counter()
        try:
            return real_batch(*a, **k)
        finally:
            solve_s[0] += time.perf_counter() - t0

    def timed_probe(pend):
        solve_s[0] = 0.0
        engine.schedule_batch = timed_batch
        t0 = time.perf_counter()
        try:
            with profile(activities=acts) as prof:
                out = real_probe(pend)
                if dev == "cuda":
                    torch.cuda.synchronize()
        finally:
            engine.schedule_batch = real_batch
        wall = time.perf_counter() - t0
        dev_us = sum(getattr(k, "self_device_time_total", 0.0)
                     for k in prof.key_averages()
                     if getattr(k, "device_type", None) == DeviceType.CUDA)
        rounds[-1].update(pending=len(pend), probe_s=wall,
                          solve_s=solve_s[0], device_ms=dev_us / 1e3)
        return out
    ctrl.probe = timed_probe
    t_start = time.perf_counter()
    try:
        for rnd in range(1, DEFRAG_ROUNDS + 1):
            rounds.append({"round": rnd})
            rep = ctrl.run_once()
            rounds[-1].update(rep)
            # The live drain rebinds the migrants and, with luck, the
            # anchors; wait for the queue to empty and every migrant to
            # land (a blocked anchor backs off for at most 1 s).
            deadline = time.perf_counter() + 60
            while True:
                inflight = ctrl.report()["inflight"]
                migrants = [k for k in list(ctrl._inflight)
                            if not watch.nodes.get(k)]
                if not len(f.daemon.queue) and not migrants:
                    break
                if time.perf_counter() > deadline:
                    fail(f"19c round {rnd}: {inflight} migrations never "
                         f"rebound: {migrants[:5]}")
                time.sleep(0.02)
            time.sleep(1.2)  # a blocked anchor's backoff retry
            r = rounds[-1]
            print(f"phase 19c: round {rnd}: pending P "
                  f"{r.get('pending', 0)}, probe "
                  f"{r.get('probe_s', 0.0) * 1e3:.3f} ms wall (the joint "
                  f"solve {r.get('solve_s', 0.0) * 1e3:.3f} ms of it, the "
                  f"rest waiting for the engine), "
                  f"{r.get('device_ms', 0.0):.3f} ms device at "
                  f"{r.get('pending', 0)} x {len(free)}, blocked "
                  f"{rep['blocked']}, planned {rep['planned']}, "
                  f"migrations {rep['executed']} executed"
                  f"{', veto ' + rep['veto'] if rep['veto'] else ''}")
            if all(watch.nodes.get(k) for k in large) and \
                    not ctrl.report()["inflight"]:
                break
        # One more round settles the last migrations (intents cleared,
        # unblocked credited).
        rounds.append({"round": len(rounds) + 1})
        ctrl.run_once()
    finally:
        ctrl.probe = real_probe
    secs = time.perf_counter() - t_start
    counts = kernel_counts()
    stats = ctrl.report()
    objs = store.list("pods")[0]
    unbound = [k for k, n in pod_map(objs).items() if not n]
    intents = [api.key_from_json(o) for o in objs
               if api.DEFRAG_MIGRATION_ANNOTATION_KEY in
               ((o.get("metadata") or {}).get("annotations") or {})]
    over = wire_over_capacity(store.list("nodes")[0], objs)
    f.verifier.verify_once()
    problems = []
    if not all(watch.nodes.get(k) for k in large):
        problems.append(f"large pods unbound: "
                        f"{[k for k in large if not watch.nodes.get(k)]}")
    if stats["migrations_executed"] != stats["migrations_completed"] or \
            not stats["migrations_executed"]:
        problems.append(f"migrations executed "
                        f"{stats['migrations_executed']}, completed "
                        f"{stats['migrations_completed']}")
    if unbound:
        problems.append(f"{len(unbound)} stranded: {unbound[:5]}")
    if intents:
        problems.append(f"lingering intents: {intents[:5]}")
    if watch.protected_unbinds:
        problems.append(f"PDB violations: {watch.protected_unbinds}")
    if watch.double_binds:
        problems.append(f"double binds: {watch.double_keys[:5]}")
    if over:
        problems.append(f"{over} nodes over capacity")
    if f.verifier.violations_total:
        problems.append(f"verifier violations "
                        f"{f.verifier.violations_total}")
    if dev == "cuda" and counts["scan_chunk"] < 1:
        problems.append("no scan launch")
    if problems:
        fail(f"19c: {'; '.join(problems)}; stats {stats}")
    print(f"phase 19c: {label}: churn deleted {deleted} small pods, "
          f"{DEFRAG_LARGE} pods of {large_cpu}m (100m more than the "
          f"freest node's {free[top][0]}m; its {len(protected)} pods "
          f"under a PDB with no headroom) bound after "
          f"{len(rounds) - 1} rounds in {secs:.3f} s; migrations "
          f"{stats['migrations_executed']} executed = "
          f"{stats['migrations_completed']} completed, "
          f"{stats['vetoed_pdb']} PDB vetoes, {stats['unblocked']} "
          f"unblocked; 0 stranded, 0 lingering intents, 0 PDB "
          f"violations, 0 double binds ({watch.unbinds} evict-to-pending "
          f"unbinds), 0 over capacity, verifier "
          f"{f.verifier.passes} passes 0 violations; launches {counts}")
    return {"launches": counts, "rounds": rounds}


def phase_verifier(ctx: dict, card: str, dev: str = "cuda") -> dict:
    """19d: the slice daemon's verifier (passes, 0 violations), the
    readback's µs per call, one corrupted resident row named and healed,
    a clean next pass, and a follow-up drain placing as an uncorrupted
    daemon over the same state does."""
    import torch
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.cache import verifier as vmod
    from kubernetes_tpu_torch.engine.generic_scheduler import \
        GenericScheduler
    from kubernetes_tpu_torch.perf import synth
    from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
    from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                          SchedulerConfig)

    f, store, watch = ctx["factory"], ctx["store"], ctx["watch"]
    label = card if dev == "cuda" else dev
    v = f.verifier
    if v.passes < 1 or v.violations_total:
        fail(f"19d: verifier {v.passes} passes, {v.violations_total} "
             f"violations before the corruption")
    # The background loop is parked (19c): the passes below are the
    # phase's own.
    pause_verifier(f)
    passes0 = v.passes
    alg = f.algorithm
    cache = alg.cache
    # A clean pass first: the resident mirror in sync.
    if v.verify_once():
        fail("19d: a violation before the corruption")
    with cache.lock:
        if not alg.resident.in_sync(cache._nt, cache.space,
                                    cache.tensor_epoch):
            # A solve syncs the mirror (the placement is not assumed).
            alg.schedule_batch(synth.make_pods(1, name_prefix="sync"))
        n = len(cache._node_order)
        rng = np.random.RandomState(19)
        idx = rng.choice(n, size=min(READBACK_ROWS, n), replace=False)
        alg.resident.readback_rows(idx)
        if dev == "cuda":
            torch.cuda.synchronize()
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            alg.resident.readback_rows(idx)
        readback_us = (time.perf_counter() - t0) / reps * 1e6
        row = min(set(range(n)) - cache._dirty_rows)
        node = cache._node_order[row]
        dc = alg.resident.dc
        req = dc.requested.clone()
        req[row, 0] += 999
        alg.resident.dc = dc._replace(requested=req)
    v.sample = n
    viol = v.verify_once()
    v.sample = vmod.DEFAULT_SAMPLE
    named = [x for x in viol if x.kind == "device_row" and node in x.detail]
    if not named or alg.resident.dc is not None:
        fail(f"19d: the corrupted row of {node} was not named and healed: "
             f"{[str(x) for x in viol]}, mirror "
             f"{'dropped' if alg.resident.dc is None else 'kept'}")
    # The uncorrupted twin: a daemon over the same state, built from the
    # store, with the same round-robin counter.
    twin_eng = GenericScheduler(device=dev)
    for o in store.list("nodes")[0]:
        twin_eng.cache.add_node(api.node_from_json(o))
    for o in store.list("pods")[0]:
        if (o.get("spec") or {}).get("nodeName"):
            twin_eng.cache.add_pod(api.pod_from_json(o))
    twin_eng.last_node_index = alg.last_node_index
    twin = Scheduler(SchedulerConfig(algorithm=twin_eng,
                                     binder=InMemoryBinder(),
                                     async_bind=False))
    follow = synth.make_pods(FOLLOW_PODS, seed=19, profile="mixed",
                             n_services=4, namespace="t-a",
                             name_prefix="follow")
    zero_counts()
    bound0 = watch.bound()
    t0 = time.perf_counter()
    for p in follow:
        store.create("pods", api.pod_to_json(p))
    deadline = time.perf_counter() + 300
    keys = [p.key for p in follow]
    while not all(watch.nodes.get(k) for k in keys) or len(f.daemon.queue):
        if time.perf_counter() > deadline:
            fail(f"19d: the follow-up drain bound "
                 f"{watch.bound() - bound0} of {FOLLOW_PODS}")
        time.sleep(0.01)
    drain_s = time.perf_counter() - t0
    counts = kernel_counts()
    got = {k: watch.nodes[k] for k in keys}
    try:
        for p in synth.make_pods(FOLLOW_PODS, seed=19, profile="mixed",
                                 n_services=4, namespace="t-a",
                                 name_prefix="follow"):
            twin.enqueue(p)
        while len(twin.queue):
            twin.schedule_pending(wait_first=False)
        want = dict(twin.config.binder._bound)
    finally:
        twin.stop()
    if got != want:
        diff = [k for k in keys if got[k] != want.get(k)]
        fail(f"19d: the healed daemon placed {len(diff)} follow-up pods "
             f"unlike the uncorrupted twin, e.g. "
             f"{[(k, got[k], want.get(k)) for k in diff[:3]]}")
    clean = v.verify_once()
    if clean:
        fail(f"19d: the pass after the heal found {[str(x) for x in clean]}")
    if dev == "cuda" and counts["scan_chunk"] < 1:
        fail("19d: the follow-up drain launched no scan kernel")
    print(f"phase 19d: {label}: verifier {passes0} passes and 0 "
          f"violations through 19a-19c; readback_rows of "
          f"{len(idx)} rows {readback_us:.3f} us per call; the corrupted "
          f"requested row of {node} named ({named[0].detail}) and healed "
          f"(mirror dropped, re-uploaded by the next drain); the next "
          f"pass clean; {FOLLOW_PODS} follow-up pods placed in "
          f"{drain_s:.3f} s exactly as the uncorrupted twin daemon "
          f"placed them; launches {counts}")
    return {"launches": counts, "readback_us": readback_us}


# 19a's cuda-against-cpu tenancy rig: 1,024 pods (at 4,096 its cpu side
# took 29-43 s, at 2,048 28 s), cut in depth for phases 20 and 21.
TENANCY_PARITY_PODS = 1024


def phase_slice(args, card: str, dev: str = "cuda",
                density_p50: float | None = None) -> dict:
    """19: the slice on the card, 19a-19d."""
    t0 = time.perf_counter()

    def done(what: str) -> None:
        print(f"phase 19: {what} done {time.perf_counter() - t0:.3f} s "
              f"into the phase", flush=True)

    out = {}
    a = phase_tenancy(args.nodes, args.pods, TENANCY_PARITY_PODS, card, dev,
                      density_p50=density_p50)
    ctx = a.pop("ctx")
    try:
        out["tenancy_north_star"] = a["north_star"]
        done("19a")
        out["defrag"] = phase_defrag(ctx, card, dev)["launches"]
        done("19c")
        out["verifier"] = phase_verifier(ctx, card, dev)["launches"]
        done("19d")
    finally:
        ctx["watch"].stop()
        ctx["factory"].stop()
    out["ha"] = phase_ha(args.nodes, args.pods, card, dev)["launches"]
    done("19b")
    print(f"phase 19: all of 19a-19d passed in "
          f"{time.perf_counter() - t0:.3f} s")
    return out


# -- the kubemark control plane (phase 20) -----------------------------------

# kubemark-500 (docs/proposals/kubemark.md, upstream's kubemark-500 job; the
# reference's perf/harness.py:fleet_metrics defaults): 500 hollow nodes of
# 64 CPU, 128 GiB and 110 pods, one RC of 2,000 replicas at 50m.
FLEET_NODES = 500
FLEET_REPLICAS = 2000
FLEET_RC = "fleet-load"
FLEET_SEED = 20          # 20a's replication manager's suffix generator
FLEET_DEAD = 50          # 20c's stopped kubelets
FLEET_HEARTBEAT_S = 10.0  # fleet_metrics' heartbeat (20a)
# The reference control-plane fixture's fast clocks (tests/
# test_control_plane_e2e.py:45-60): grace 1.2 s, eviction 1 s, syncs
# every 0.3 s, for 20c and 20d.  Their kubelets beat every 0.6 s: under
# the grace with room, and half the fixture's 0.3 s, whose 1,667 writes/s
# from 500 kubelets in one interpreter slowed its host work 5-25x in
# earlier runs (PERF.md, section 6).
DEATH_HEARTBEAT_S = 0.6
NODE_GRACE_S = 1.2
NODE_EVICTION_S = 1.0
NODE_SYNC_S = 0.3
WIRE_KUBELETS = 8        # 20d's kubelet processes
WIRE_REPLICAS = 200
# The reference test's bars (tests/test_control_plane_e2e.py:296-363).
FLEET_USED_SHARE = 0.9
FLEET_PER_NODE = 20
FLEET_FULL_RESYNC_MS = 1000.0
FLEET_IDLE_PASS_MS = 50.0
FLEET_HEARTBEATS_PER_S = (5.0, 200.0)


def fleet_node(api, name: str):
    """``perf/harness.fleet_metrics``' node."""
    return api.Node(name=name, labels={api.HOSTNAME_LABEL: name},
                    allocatable_milli_cpu=64000,
                    allocatable_memory=128 * 1024 ** 3,
                    allocatable_pods=110,
                    conditions=[api.NodeCondition("Ready", "True")])


def fleet_rc(replicas: int) -> dict:
    """``perf/harness.fleet_metrics``' RC."""
    return {"metadata": {"name": FLEET_RC, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"run": FLEET_RC},
                     "template": {
                         "metadata": {"labels": {"run": FLEET_RC}},
                         "spec": {"containers": [{
                             "name": "c",
                             "resources": {"requests": {"cpu": "50m"}}}]}}}}


def labelled(objs: list, key: str, value: str) -> list:
    return [o for o in objs
            if ((o.get("metadata") or {}).get("labels") or {}).get(key)
            == value]


def fleet_pods(objs: list) -> list:
    """The RC's live pods among ``objs``."""
    return [o for o in labelled(objs, "run", FLEET_RC)
            if not (o.get("metadata") or {}).get("deletionTimestamp")]


def running(pods: list) -> list:
    return [o for o in pods if (o.get("status") or {}).get("phase")
            == "Running" and (o.get("spec") or {}).get("nodeName")]


def ready_status(node: dict) -> str:
    return next((c.get("status") for c in
                 (node.get("status") or {}).get("conditions") or ()
                 if c.get("type") == "Ready"), "")


def fleet_check(what: str, pods: list, n: int, nodes: list,
                dead: frozenset = frozenset()) -> dict:
    """All ``n`` pods Running, none on a ``dead`` node, no node over its
    cpu, memory or pod count; returns {node: pods}."""
    from kubernetes_tpu_torch.api import types as api
    live = running(pods)
    if len(live) != n or len(pods) != n:
        fail(f"{what}: {len(live)} of {n} replicas Running "
             f"({len(pods)} live pods)")
    alloc = {o["metadata"]["name"]: api.node_from_json(o) for o in nodes}
    per: dict = {}
    for o in live:
        node = o["spec"]["nodeName"]
        if node in dead:
            fail(f"{what}: {o['metadata']['name']} is Running on the dead "
                 f"node {node}")
        if node not in alloc:
            fail(f"{what}: {o['metadata']['name']} is on {node}, no node")
        req = api.pod_from_json(o).resource_request()
        cpu, mem, cnt = per.get(node, (0, 0, 0))
        per[node] = (cpu + req.milli_cpu, mem + req.memory, cnt + 1)
    over = [nd for nd, (cpu, mem, cnt) in per.items()
            if cpu > alloc[nd].allocatable_milli_cpu
            or mem > alloc[nd].allocatable_memory
            or cnt > alloc[nd].allocatable_pods]
    if over:
        fail(f"{what}: {len(over)} nodes over capacity: {over[:5]}")
    return {nd: cnt for nd, (_c, _m, cnt) in per.items()}


def wait_for(what: str, cond, seconds: float, period: float = 0.1):
    t0 = time.perf_counter()
    while True:
        v = cond()
        if v:
            return v
        if time.perf_counter() - t0 > seconds:
            fail(f"{what} not within {seconds} s")
        time.sleep(period)


class Gen2Pauses:
    """While installed (``with``): the collections of the oldest
    generation, their count, total and longest seconds."""

    def __init__(self):
        self.n, self.total, self.longest = 0, 0.0, 0.0
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            d = time.perf_counter() - self._t0
            self.n, self.total = self.n + 1, self.total + d
            self.longest = max(self.longest, d)

    def __enter__(self) -> "Gen2Pauses":
        import gc
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        import gc
        gc.callbacks.remove(self)

    def describe(self) -> str:
        return (f"{self.n} generation-2 collections, {self.total:.3f} s, "
                f"longest {self.longest:.3f} s")


def plans_since(before: dict) -> list:
    from kubernetes_tpu_torch.engine import scan
    return [{"n": n, "C": c, "K": k, "launches": m - before.get((n, c, k), 0)}
            for (n, c, k), m in sorted(scan.scan_chunk.plans.items())
            if m > before.get((n, c, k), 0)]


def phase_fleet_metrics(nodes: int, replicas: int, card: str,
                        dev: str = "cuda") -> dict:
    """20b: ``perf/harness.fleet_metrics(device=dev)`` and the reference
    test's bars; its store is kept (the replication manager's constructor
    records it) to count the pods per node."""
    from kubernetes_tpu_torch.controller.replication import (
        ReplicationManager)
    from kubernetes_tpu_torch.perf import harness

    label = card if dev == "cuda" else dev
    stores: list = []
    real = ReplicationManager.__init__

    def init(self, source, *a, **k):
        real(self, source, *a, **k)
        stores.append(self.store)

    ReplicationManager.__init__ = init
    zero_counts()
    try:
        rec = harness.fleet_metrics(nodes, replicas, device=dev)
    finally:
        ReplicationManager.__init__ = real
    counts = kernel_counts()
    store = stores[0]
    per = fleet_check("20b", fleet_pods(store.list("pods")[0]), replicas,
                      store.list("nodes")[0])
    if rec["running"] != replicas:
        fail(f"20b: {rec['running']} of {replicas} Running")
    if len(per) < FLEET_USED_SHARE * nodes:
        fail(f"20b: only {len(per)} of {nodes} nodes used")
    if max(per.values()) > FLEET_PER_NODE:
        fail(f"20b: {max(per.values())} pods on one node")
    if rec["rc_full_resync_ms"] >= FLEET_FULL_RESYNC_MS:
        fail(f"20b: full resync {rec['rc_full_resync_ms']} ms")
    if rec["rc_idle_dirty_pass_ms"] >= FLEET_IDLE_PASS_MS:
        fail(f"20b: idle dirty pass {rec['rc_idle_dirty_pass_ms']} ms")
    lo, hi = FLEET_HEARTBEATS_PER_S
    if not lo <= rec["heartbeat_writes_per_s"] <= hi:
        fail(f"20b: {rec['heartbeat_writes_per_s']} heartbeat writes/s")
    if rec["launches"] != counts:
        fail(f"20b: fleet_metrics counted {rec['launches']}, the wrappers "
             f"{counts}")
    if dev == "cuda" and counts["scan_chunk"] < 1:
        fail("20b: the fleet's drains launched no scan kernel")
    print(f"phase 20b: {label}: fleet_metrics(device={dev!r}) {nodes} "
          f"hollow kubelets x {replicas} replicas: settle_s "
          f"{rec['settle_s']} (the JAX package's CPU run: 54.9 s, "
          f"BENCH_r16.json), {rec['running']} Running on {len(per)} nodes "
          f"(at most {max(per.values())} per node), full resync "
          f"{rec['rc_full_resync_ms']} ms, idle dirty pass "
          f"{rec['rc_idle_dirty_pass_ms']} ms, heartbeat writes "
          f"{rec['heartbeat_writes_per_s']}/s; launches {counts}; cluster "
          f"plans {rec['cluster_plans']}; 0 nodes over capacity")
    return {"counts": counts, "record": rec}


def start_fleet(nodes: int, replicas: int) -> dict:
    """``nodes`` hollow kubelets (fleet_metrics' node, heartbeats every
    FLEET_HEARTBEAT_S) and a replication manager with a seeded suffix
    generator on one ``MemStore``; the RC's replicas created while no
    scheduler runs.  Returns the rig (``stop_fleet`` stops it)."""
    import random
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.controller.replication import (
        ReplicationManager)
    from kubernetes_tpu_torch.kubelet.kubelet import HollowKubelet

    store = MemStore(share_events=True)
    ctx = {"store": store, "kubelets": [], "others": []}
    try:
        for i in range(nodes):
            ctx["kubelets"].append(HollowKubelet(
                store, fleet_node(api, f"fm-{i:03d}"),
                heartbeat_period=FLEET_HEARTBEAT_S).run())
        rm = ReplicationManager(store, sync_period=0.5)
        rm._rand = random.Random(FLEET_SEED)
        ctx["others"].append(rm.run())
        store.create("replicationcontrollers", fleet_rc(replicas))
        wait_for(f"20a: {replicas} pending replicas", lambda: len(
            fleet_pods(store.list("pods")[0])) == replicas, 120)
    except BaseException:
        stop_fleet(ctx)
        raise
    return ctx


def stop_fleet(ctx: dict) -> None:
    for obj in reversed(ctx["others"]):
        obj.stop()
    for k in ctx["kubelets"]:
        k.stop()
    ctx["others"].clear()


def time_fleet_chunk(node_objs: list, pod_objs: list, dev) -> dict:
    """One fleet-sized chunk (every pending pod of 20a x its nodes) as the
    solver hands it to the kernel, at the plan's cluster size: the launch
    alone with CUDA events (median of 10, the carried state restored
    before each), against its bound and against the step loop on the
    card (choices, counter and state bit for bit)."""
    import torch
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.engine import scan as scan_mod
    from kubernetes_tpu_torch.engine.generic_scheduler import (
        GenericScheduler)
    from kubernetes_tpu_torch.perf import scan_check

    sched = GenericScheduler(device=dev)
    for o in node_objs:
        sched.cache.add_node(api.node_from_json(o))
    pods = [api.pod_from_json(o) for o in pod_objs]
    ns = scan_check.north_star_chunk(pods=len(pods), device=dev,
                                     rig=(sched, pods))
    enc, kw, init = ns["enc"], ns["kw"], ns["init"]
    p, n = enc.shape
    plan = scan_mod.cluster_plan(
        n, t=0 if kw.get("d_plane") is None else kw["d_plane"].shape[0],
        s=0 if kw.get("sp_node") is None else kw["sp_node"].shape[0],
        z=0 if kw.get("sp_zone") is None else kw["sp_zone"].shape[1],
        half=enc.dtype == torch.float16)

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

    times = [kernel_once() for _ in range(10)]
    after = {k: kw[k].clone() for k in init}

    def chunk(route: str) -> tuple[float, tuple]:
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ns["sched"].solver._solve_scan(
            ns["db"], ns["dc"], counter, None, ns["flags"], None, None,
            None, route=route)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    plain_ms, ref = chunk("steps")
    _ms, out = chunk("kernel")
    try:
        worst = scan_check.compare("the fleet chunk, kernel vs the step "
                                   "loop", out, ref)
    except scan_check.ScanMismatch as err:
        fail(f"20a: scan kernel != step loop on the fleet chunk: {err}")
    bound_ms, bound_by = scan_bound(enc, kw, init, after)
    ms = statistics.median(times)
    print(f"phase 20a: the fleet chunk, {p} pods x {n} nodes ({enc.dtype}), "
          f"plan {plan.describe()}: the launch alone {ms:.6f} ms (median "
          f"of 10, min {min(times):.6f}, max {max(times):.6f}) = "
          f"{ms / p * 1e3:.6f} us per step; bound {bound_ms:.6f} ms "
          f"({bound_by}); the step loop on the card {plain_ms:.3f} ms; "
          f"kernel == step loop (choices, counter, state bit for bit), "
          f"max_abs_err {worst}")
    return {"pods": p, "nodes": n, "cluster": plan.cluster, "k": plan.k,
            "plan": plan.describe(), "ms": ms,
            "min_ms": min(times), "max_ms": max(times),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": worst}


def phase_fleet_parity(nodes: int, replicas: int, card: str,
                       dev: str = "cuda") -> dict:
    """20a: the fleet's pending replicas drained by ``ConfigFactory`` on
    ``dev`` and, on a twin store holding a deep copy of the same nodes
    and pending pods, on the CPU: the same node for every pod and the
    same round-robin counter.  Returns the rig, its daemon running, for
    20c."""
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.engine import scan
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory

    label = card if dev == "cuda" else dev
    t0 = time.perf_counter()
    ctx = start_fleet(nodes, replicas)
    try:
        store = ctx["store"]
        node_objs = store.list("nodes")[0]
        pending = fleet_pods(store.list("pods")[0])
        if any((o.get("spec") or {}).get("nodeName") for o in pending):
            fail("20a: a replica was bound before the daemon started")
        # Every kind the daemon reads (the RC feeds SelectorSpread), in
        # the store's order.
        twin = MemStore()
        for kind in ("nodes", "services", "replicationcontrollers",
                     "replicasets", "persistentvolumes",
                     "persistentvolumeclaims", "pods"):
            for o in store.list(kind)[0]:
                twin.create(kind, o)
        ready_s = time.perf_counter() - t0
        zero_counts()
        plans0 = dict(scan.scan_chunk.plans)
        t1 = time.perf_counter()
        f = ConfigFactory(store, device=dev)
        ctx["others"].append(f.run())
        # A list deep-copies every pod under the store's lock: poll at
        # 0.25 s so the poll does not slow the binds it waits for.
        wait_for(f"20a: {replicas} replicas bound on {dev}", lambda: sum(
            bool((o.get("spec") or {}).get("nodeName")) for o in
            store.list("pods")[0]) >= replicas, 300, 0.25)
        secs = time.perf_counter() - t1
        counts = kernel_counts()
        plans = plans_since(plans0)
        maps = {dev: {o["metadata"]["name"]: o["spec"]["nodeName"]
                      for o in fleet_pods(store.list("pods")[0])}}
        counters = {dev: int(f.algorithm.last_node_index)}
        cpu = ConfigFactory(twin, device="cpu")
        try:
            t1 = time.perf_counter()
            cpu.run()
            cpu_s = time.perf_counter() - t1 + wait_bound(twin, replicas,
                                                          900)
            maps["cpu"] = {o["metadata"]["name"]: o["spec"]["nodeName"]
                           for o in twin.list("pods")[0]}
            counters["cpu"] = int(cpu.algorithm.last_node_index)
        finally:
            cpu.stop()
        if maps[dev] != maps["cpu"]:
            diff = [k for k in maps[dev] if maps[dev][k] != maps["cpu"]
                    .get(k)][:5]
            fail(f"20a: {dev} and cpu placed pods differently: {diff}")
        if counters[dev] != counters["cpu"]:
            fail(f"20a: round-robin counter {counters}")
        if dev == "cuda" and counts["scan_chunk"] < 1:
            fail("20a: the drain launched no scan kernel")
        print(f"phase 20a: {label}: {nodes} hollow kubelets (heartbeats "
              f"every {FLEET_HEARTBEAT_S} s) and {replicas} pending "
              f"replicas of a seeded replication manager in {ready_s:.3f} "
              f"s; ConfigFactory on {dev} bound every replica "
              f"{secs:.3f} s after its construction, the cpu twin "
              f"{cpu_s:.3f} s after its run(); every pod's node and the "
              f"round-robin counter ({counters[dev]}) identical; launches "
              f"{counts}; cluster plans {plans}")
        out = {"counts": counts, "plans": plans, "ctx": ctx}
        if dev == "cuda":
            out["chunk"] = time_fleet_chunk(node_objs, pending, dev)
        return out
    except BaseException:
        stop_fleet(ctx)
        raise


def phase_fleet_death(ctx: dict, nodes: int, replicas: int, card: str,
                      dev: str = "cuda") -> dict:
    """20c: on 20a's fleet, the node lifecycle controller on the fast
    clocks, a Service with the endpoints controller and a hollow proxy;
    FLEET_DEAD kubelets stopped: their nodes Ready=Unknown, their pods
    evicted, replaced and bound to survivors, all Running again, none on
    a dead node, no node over capacity, the Endpoints equal to the
    Running pods' addresses and the proxy's table to the Endpoints."""
    from kubernetes_tpu_torch.controller.endpoints import EndpointsController
    from kubernetes_tpu_torch.controller.node import NodeLifecycleController
    from kubernetes_tpu_torch.proxy.proxy import HollowProxy

    label = card if dev == "cuda" else dev
    store = ctx["store"]
    wait_for(f"20c: {replicas} replicas Running", lambda: len(running(
        fleet_pods(store.list("pods")[0]))) == replicas, 120, 0.5)
    # The kubelets' loops read their period after each wait: one more
    # old period and every kubelet beats at the new one.
    for k in ctx["kubelets"]:
        k.heartbeat_period = DEATH_HEARTBEAT_S
    time.sleep(FLEET_HEARTBEAT_S + DEATH_HEARTBEAT_S)
    store.create("services", {
        "metadata": {"name": "fleet-svc", "namespace": "default"},
        "spec": {"selector": {"run": FLEET_RC}}})
    ctx["others"].append(EndpointsController(store, sync_period=0.2).run())
    proxy = HollowProxy(store).run()
    ctx["others"].append(proxy)
    ctx["others"].append(NodeLifecycleController(
        store, monitor_grace=NODE_GRACE_S, eviction_timeout=NODE_EVICTION_S,
        sync_period=NODE_SYNC_S).run())
    # Several grace periods with every kubelet alive: no node may go
    # Unknown before the stop.
    time.sleep(3 * NODE_GRACE_S)
    unknown = [o["metadata"]["name"] for o in store.list("nodes")[0]
               if ready_status(o) != "True"]
    if unknown:
        fail(f"20c: {len(unknown)} live nodes not Ready before the stop: "
             f"{unknown[:5]}")
    n_dead = max(1, nodes * FLEET_DEAD // FLEET_NODES)
    victims = ctx["kubelets"][::nodes // n_dead][:n_dead]
    dead = frozenset(k.node.name for k in victims)
    before = {o["metadata"]["name"]: o["spec"]["nodeName"]
              for o in fleet_pods(store.list("pods")[0])}
    on_dead = {p for p, nd in before.items() if nd in dead}
    zero_counts()
    t0 = time.perf_counter()
    for k in victims:
        k.stop()

    def all_unknown():
        objs = {o["metadata"]["name"]: o for o in store.list("nodes")[0]}
        return all(ready_status(objs[nd]) == "Unknown" for nd in dead)
    wait_for("20c: the dead nodes Ready=Unknown", all_unknown, 60)
    unknown_s = time.perf_counter() - t0

    def recovered():
        pods = fleet_pods(store.list("pods")[0])
        live = running(pods)
        return len(pods) == replicas and len(live) == replicas and not any(
            o["spec"]["nodeName"] in dead for o in live)
    wait_for("20c: every replica Running off the dead nodes", recovered,
             300, 0.25)
    settle_s = time.perf_counter() - t0
    counts = kernel_counts()
    pods = fleet_pods(store.list("pods")[0])
    node_objs = store.list("nodes")[0]
    per = fleet_check("20c", pods, replicas, node_objs, dead)
    after = {o["metadata"]["name"] for o in pods}
    if on_dead & after:
        fail(f"20c: pods of dead nodes not evicted: "
             f"{sorted(on_dead & after)[:5]}")
    moved = [p for p, nd in before.items() if p not in after
             and nd not in dead]
    not_ready = [o["metadata"]["name"] for o in node_objs
                 if o["metadata"]["name"] not in dead
                 and ready_status(o) != "True"]

    def endpoints():
        ips = sorted(o["status"]["podIP"] for o in running(fleet_pods(
            store.list("pods")[0])))
        ep = store.get("endpoints", "default/fleet-svc") or {}
        got = sorted(a["ip"] for s in ep.get("subsets") or ()
                     for a in s.get("addresses") or ())
        return len(ips) == replicas and got == ips and \
            proxy.backends("default", "fleet-svc") == got
    wait_for("20c: the Endpoints and the proxy's table equal to the "
             "Running pods' addresses", endpoints, 60, 0.2)
    if dev == "cuda" and counts["scan_chunk"] < 1:
        fail("20c: the replacements' drains launched no scan kernel")
    print(f"phase 20c: {label}: {len(dead)} of {nodes} kubelets stopped: "
          f"their nodes Ready=Unknown {unknown_s:.3f} s after the first "
          f"stop; {len(on_dead)} pods evicted, replaced and Running on "
          f"{len(per)} survivors {settle_s:.3f} s after the first stop "
          f"(none on a dead node, 0 over capacity; {len(moved)} pods of "
          f"live nodes evicted, {len(not_ready)} live nodes not Ready); "
          f"the Endpoints and the proxy's table hold the {replicas} "
          f"Running pods' addresses; launches {counts}")
    return {"counts": counts, "settle_s": settle_s}


def phase_fleet_wire(card: str, dev: str = "cuda") -> dict:
    """20d: the native apiserver, ``python -m kubernetes_tpu_torch.
    scheduler --api-server URL`` on ``dev``, WIRE_KUBELETS ``python -m
    kubernetes_tpu_torch.kubelet`` and one ``python -m kubernetes_tpu_torch.
    proxy`` as processes; the replication manager and the node controller
    in this process over ``APIClient``.  An RC of WIRE_REPLICAS reaches
    Running; one kubelet SIGKILLed: its node Ready=Unknown and its pods
    rescheduled to survivors; the daemon's ``/debug/vars`` counts its
    scan launches.  Every process is stopped, also on failure."""
    from kubernetes_tpu_torch.client.http import APIClient
    from kubernetes_tpu_torch.controller.node import NodeLifecycleController
    from kubernetes_tpu_torch.controller.replication import (
        ReplicationManager)

    label = card if dev == "cuda" else dev
    t0 = time.perf_counter()
    api_proc, base = start_rig_apiserver()
    children: dict = {}
    ctrls: list = []
    codes: dict = {}
    try:
        cmd = [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
               "--api-server", base, "--port", "0",
               "--kube-api-qps", "5000", "--kube-api-burst", "5000"]
        if dev != "cuda":
            cmd += ["--device", dev]
        sched = children["scheduler"] = Child(cmd, stdout=subprocess.PIPE)
        port = json.loads(sched.proc.stdout.readline() or "{}").get("port")
        if port is None:
            fail(f"20d: the daemon binary did not start: {sched.tail()}")
        for i in range(WIRE_KUBELETS):
            children[f"wk-{i}"] = Child(
                [sys.executable, "-m", "kubernetes_tpu_torch.kubelet",
                 "--api-server", base, "--node-name", f"wk-{i}",
                 "--cpu", "64000", "--memory-gib", "128", "--pods", "110",
                 "--heartbeat-period", str(DEATH_HEARTBEAT_S)])
        children["proxy"] = Child([sys.executable, "-m",
                                   "kubernetes_tpu_torch.proxy",
                                   "--api-server", base])
        children["proxy"].wait_line("hollow kube-proxy running")
        wait_for(f"20d: {WIRE_KUBELETS} kubelet processes registered and "
                 f"Ready", lambda: sum(ready_status(o) == "True" for o in
                                       wire_list(base, "nodes"))
                 == WIRE_KUBELETS, 120, 0.2)
        ready_s = time.perf_counter() - t0
        client = APIClient(base, qps=5000, burst=5000)
        ctrls.append(ReplicationManager(client, sync_period=0.3).run())
        t1 = time.perf_counter()
        client.create("replicationcontrollers", fleet_rc(WIRE_REPLICAS))
        wait_for(f"20d: {WIRE_REPLICAS} replicas Running over HTTP",
                 lambda: len(running(fleet_pods(wire_list(base, "pods"))))
                 == WIRE_REPLICAS, 180, 0.2)
        run_s = time.perf_counter() - t1
        ctrls.append(NodeLifecycleController(
            client, monitor_grace=NODE_GRACE_S,
            eviction_timeout=NODE_EVICTION_S,
            sync_period=NODE_SYNC_S).run())
        time.sleep(3 * NODE_GRACE_S)
        if any(ready_status(o) != "True" for o in wire_list(base, "nodes")):
            fail("20d: a live kubelet's node went not Ready")
        pods = fleet_pods(wire_list(base, "pods"))
        victim = max(sorted({o["spec"]["nodeName"] for o in pods}),
                     key=lambda nd: sum(o["spec"]["nodeName"] == nd
                                        for o in pods))
        on_victim = {o["metadata"]["name"] for o in pods
                     if o["spec"]["nodeName"] == victim}
        t2 = time.perf_counter()
        children[victim].proc.kill()
        children[victim].proc.wait()
        codes[victim] = "SIGKILL"

        def victim_unknown():
            return any(o["metadata"]["name"] == victim
                       and ready_status(o) == "Unknown"
                       for o in wire_list(base, "nodes"))
        wait_for(f"20d: {victim} Ready=Unknown", victim_unknown, 60, 0.2)

        def rescheduled():
            pods = fleet_pods(wire_list(base, "pods"))
            live = running(pods)
            return len(pods) == len(live) == WIRE_REPLICAS and not any(
                o["spec"]["nodeName"] == victim or o["metadata"]["name"]
                in on_victim for o in live)
        wait_for(f"20d: {victim}'s pods rescheduled and Running",
                 rescheduled, 180, 0.2)
        resched_s = time.perf_counter() - t2
        fleet_check("20d", fleet_pods(wire_list(base, "pods")),
                    WIRE_REPLICAS, wire_list(base, "nodes"),
                    frozenset({victim}))
        launches = debug_vars(port)["kernelLaunches"]
        if dev == "cuda" and launches["scan_chunk"] < 1:
            fail(f"20d: the daemon process launched no scan kernel: "
                 f"{launches}")
    finally:
        for c in ctrls:
            c.stop()
        for name, child in children.items():
            if name not in codes:
                codes[name] = child.stop()
        # The native binary ends on SIGTERM's default action (-15), as
        # the other phases that stop it leave it.
        api_proc.stop()
    bad = {k: v for k, v in codes.items() if v not in (0, "SIGKILL")}
    if bad:
        fail(f"20d: processes exited non-zero on SIGTERM: {bad}")
    print(f"phase 20d: {label}: the native apiserver, the daemon binary on "
          f"{dev}, {WIRE_KUBELETS} kubelet processes and a proxy process "
          f"ready in {ready_s:.3f} s; {WIRE_REPLICAS} replicas Running over "
          f"HTTP {run_s:.3f} s after the RC's POST; {victim} SIGKILLed: "
          f"Ready=Unknown and its {len(on_victim)} pods rescheduled and "
          f"Running {resched_s:.3f} s later, none on it, 0 over capacity; "
          f"the daemon's /debug/vars kernelLaunches {launches}; every "
          f"other process exited 0 on SIGTERM")
    return {"counts": launches}


def process_state() -> str:
    """This process's threads (the most common names), resident memory
    and the host's 1-minute load average."""
    import collections
    import os
    import re
    names = collections.Counter(re.sub(r"[-_]?\d+$", "", t.name)
                                for t in threading.enumerate())
    rss = next((ln.split()[1] for ln in open("/proc/self/status")
                if ln.startswith("VmRSS:")), "?")
    return (f"{sum(names.values())} threads (most: "
            f"{names.most_common(4)}), RSS {rss} kB, load average "
            f"{os.getloadavg()[0]:.2f}")


def phase_fleet(args, card: str, dev: str = "cuda") -> dict:
    """20: the kubemark control plane on the card, 20a-20d (20b first:
    fleet_metrics builds and stops its own fleet, and 20c runs on 20a's)."""
    t0 = time.perf_counter()

    def done(what: str) -> None:
        print(f"phase 20: {what} done {time.perf_counter() - t0:.3f} s "
              f"into the phase", flush=True)

    # Each sub-phase reports the collections of the oldest generation
    # (the fleets' host work allocates fast).
    out = {}
    with Gen2Pauses() as gc2:
        out["b"] = phase_fleet_metrics(args.fleet_nodes,
                                       args.fleet_replicas, card,
                                       dev)["counts"]
    done(f"20b ({gc2.describe()})")
    with Gen2Pauses() as gc2:
        a = phase_fleet_parity(args.fleet_nodes, args.fleet_replicas,
                               card, dev)
    out["a"], chunk = a["counts"], a.get("chunk")
    done(f"20a ({gc2.describe()})")
    try:
        with Gen2Pauses() as gc2:
            out["c"] = phase_fleet_death(a["ctx"], args.fleet_nodes,
                                         args.fleet_replicas, card,
                                         dev)["counts"]
    finally:
        stop_fleet(a["ctx"])
    done(f"20c ({gc2.describe()})")
    with Gen2Pauses() as gc2:
        out["d"] = phase_fleet_wire(card, dev)["counts"]
    done(f"20d ({gc2.describe()})")
    print(f"phase 20: all of 20a-20d passed in "
          f"{time.perf_counter() - t0:.3f} s")
    return {"paths": out, "chunk": chunk}


# -- phase 21: the controller-manager ------------------------------------

CM_NODES = FLEET_NODES        # 21a: kubemark-500's hollow nodes
CM_REPLICAS = 2000            # 21a's Deployment, 50m each
CM_JOB = (100, 200)           # 21a's Job: parallelism, completions
CM_SEED = 21                  # the controllers' suffix generators (21a)
CM_SURGE = CM_UNAVAILABLE = "25%"   # the Deployments' rolling bounds
CM_ROLL_STEPS = 12            # 21a's steps per phase, at most
# 21b's Deployment, scaled by 1.2, then 1.3: cut from the 200 of 20d.
# The controller-manager's clients run at the reference's 5 requests/s
# (restclient's default; the binary has no flag for it), so a rollout
# of N replicas is ~2N requests; 21b's times at 200 and at 60 are in
# PERF.md, section 6 (at 60 the whole smoke came within 40 s of its
# time limit).
CM_WIRE_REPLICAS = 40
CM_LEASE = ("2.0", "1.5", "0.3")   # tests/test_multiprocess_e2e.py:97-103
# The PodDisruptionBudgets ask for 90% of the Deployment as an integer:
# a percentage is resolved against the scale of each pod's owning
# controllers, and a Deployment's pod has two (its ReplicaSet and the
# Deployment itself select it), which both packages' disruption
# controllers treat as the reference's failsafe (no eviction allowed).
CM_PDB_SHARE = 0.9
# tests/test_multiprocess_e2e.py:40-51: tokens and ABAC lines.
CM_TOKENS = ("admin-token,admin,1\nsched-token,scheduler,2\n"
             "cm-token,controller-manager,3\nkubelet-token,kubelet,4\n"
             "proxy-token,proxy,5\nviewer-token,viewer,6,readonly\n")
CM_ABAC = "\n".join([
    '{"user": "admin"}', '{"user": "scheduler"}',
    '{"user": "controller-manager"}', '{"user": "kubelet"}',
    '{"user": "proxy"}', '{"group": "readonly", "readonly": true}']) + "\n"


def cm_deployment(name: str, replicas: int, version: str = "v1") -> dict:
    return {"kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"app": name}},
                     "strategy": {"type": "RollingUpdate",
                                  "rollingUpdate": {
                                      "maxSurge": CM_SURGE,
                                      "maxUnavailable": CM_UNAVAILABLE}},
                     "template": {
                         "metadata": {"labels": {"app": name,
                                                 "version": version}},
                         "spec": {"containers": [{
                             "name": "app", "image": f"app:{version}",
                             "resources": {"requests": {"cpu": "50m"}}}]}}}}


def cm_pdb(name: str, replicas: int) -> dict:
    return {"metadata": {"name": f"{name}-pdb", "namespace": "default"},
            "spec": {"minAvailable": int(CM_PDB_SHARE * replicas),
                     "selector": {"app": name}}}


def cm_bounds(replicas: int) -> tuple[int, int]:
    """maxSurge (rounded up) and maxUnavailable (rounded down) of
    CM_SURGE / CM_UNAVAILABLE at ``replicas``."""
    import math
    return (math.ceil(float(CM_SURGE[:-1]) / 100 * replicas),
            math.floor(float(CM_UNAVAILABLE[:-1]) / 100 * replicas))


def alive(o: dict) -> bool:
    return not (o.get("metadata") or {}).get("deletionTimestamp") and \
        (o.get("status") or {}).get("phase") not in ("Succeeded", "Failed")


class CMSide:
    """21a, one side: the daemon set, deployment, replication, job and
    disruption controllers of the port on a ``MemStore`` (suffix
    generators seeded), their watch events replayed in store order, and a
    ``GenericScheduler`` on ``dev`` that drains every pending pod after
    each round of syncs.  The kubelet's part is played by the step: a
    bound pod without a phase becomes Running and Ready, a Job's pod
    Succeeded (the hollow kubelet's run-duration)."""

    def __init__(self, store, dev: str):
        import random
        from kubernetes_tpu_torch.api import types as api
        from kubernetes_tpu_torch.controller import (daemonset, deployment,
                                                     disruption, job,
                                                     replication)
        from kubernetes_tpu_torch.engine.generic_scheduler import (
            GenericScheduler)
        self.store, self.dev, self.api = store, dev, api
        self.ds = daemonset.DaemonSetController(store)
        self.dep = deployment.DeploymentController(store)
        self.rm = replication.ReplicationManager(store)
        self.job = job.JobController(store)
        self.pdb = disruption.DisruptionController(store)
        for i, c in enumerate((self.ds, self.rm, self.job)):
            c._rand = random.Random(CM_SEED + i)
        self.watches = [
            (store.watch(tuple(h), 0), h) for h in (
                {"daemonsets": self.ds._on_ds, "nodes": self.ds._on_node,
                 "pods": self.ds._on_pod},
                {"deployments": self.dep._on_deployment,
                 "replicasets": self.dep._on_rs, "pods": self.dep._on_pod},
                {"replicasets": lambda t, o: self.rm._on_rc(
                    "replicasets", t, o), "pods": self.rm._on_pod},
                {"jobs": self.job._on_job, "pods": self.job._on_pod},
                {"poddisruptionbudgets": self.pdb._on_pdb,
                 "pods": self.pdb._on_pod,
                 **{k: self.pdb._owner_handler(k)
                    for k in self.pdb._owners}})]
        self.sched = GenericScheduler(device=dev)
        for o in store.list("nodes")[0]:
            self.sched.cache.add_node(api.node_from_json(o))
        self.cached: dict = {}

    def stop(self) -> None:
        for w, _ in self.watches:
            w.stop()

    def feed(self) -> None:
        for w, handlers in self.watches:
            while (ev := w.next(timeout=0)) is not None:
                handlers[ev.kind](ev.type, ev.object)

    def sync_cache(self) -> None:
        """The scheduler cache holds every live bound pod of the store."""
        live = {}
        for o in self.store.list("pods")[0]:
            if alive(o) and (o.get("spec") or {}).get("nodeName"):
                live[f"{o['metadata']['namespace']}/"
                     f"{o['metadata']['name']}"] = o
        for key in [k for k in self.cached if k not in live]:
            self.sched.cache.remove_pod(self.cached.pop(key))
        for key, o in live.items():
            if key not in self.cached:
                pod = self.api.pod_from_json(o)
                self.sched.cache.add_pod(pod)
                self.cached[key] = pod

    def step(self) -> dict:
        """One round: the controllers' syncs, the drain of every pending
        pod (in name order), the binds and the kubelet's part.  Returns
        what the round placed, by pod key."""
        self.feed()
        self.ds.sync_all()
        self.dep.sync_all()
        self.feed()
        self.rm.sync_all()
        self.job.sync_all()
        self.pdb.sync_all()
        self.feed()
        # The rolling bounds are read here, between the controllers'
        # writes and the kubelet's: the ReplicaSets' replicas and the
        # Running pods of each app.
        pods = self.store.list("pods")[0]
        self.mid = {
            "rs_total": collections.Counter(), "running": collections.Counter(
                ((o["metadata"].get("labels") or {}).get("app")
                 for o in running([o for o in pods if alive(o)])))}
        for o in self.store.list("replicasets")[0]:
            self.mid["rs_total"][(o["metadata"].get("labels") or {})
                                 .get("app")] += int(o["spec"].get(
                                     "replicas", 0))
        self.sync_cache()
        pending = sorted((o for o in self.store.list("pods")[0]
                          if alive(o) and not (o.get("spec") or {})
                          .get("nodeName")),
                         key=lambda o: (o["metadata"]["namespace"],
                                        o["metadata"]["name"]))
        self.sched.listers.replica_sets = [
            self.api.rs_from_json(o)
            for o in self.store.list("replicasets")[0]]
        pods = [self.api.pod_from_json(o) for o in pending]
        placed = [n for _, pl in self.sched.schedule_batch_stream(
            pods, chunk_size=min(CHUNK, len(pods))) for n in pl] \
            if pods else []
        out = {}
        for pod, node in zip(pods, placed):
            out[pod.key] = node
            if node is not None:
                self.store.bind(pod.namespace, pod.name, node)
        for o in sorted(self.store.list("pods")[0],
                        key=lambda o: o["metadata"]["name"]):
            if (o.get("spec") or {}).get("nodeName") and \
                    not (o.get("status") or {}).get("phase"):
                if ((o["metadata"].get("labels") or {}).get("job-name")):
                    o["status"] = {"phase": "Succeeded"}
                else:
                    o["status"] = {"phase": "Running", "conditions": [
                        {"type": "Ready", "status": "True"}]}
                self.store.update("pods", o)
        self.sync_cache()
        self.feed()
        return out

    def state(self) -> dict:
        """The store's pods (node, phase), ReplicaSets' replicas and the
        Job's, Deployment's and budget's status, for the twin check."""
        def status(kind):
            return {o["metadata"]["name"]: {
                k: v for k, v in (o.get("status") or {}).items()
                if k != "completionTime"} for o in self.store.list(kind)[0]}
        return {"pods": {o["metadata"]["name"]: (
                    (o.get("spec") or {}).get("nodeName"),
                    (o.get("status") or {}).get("phase"))
                    for o in self.store.list("pods")[0]},
                "replicasets": {o["metadata"]["name"]: o["spec"]["replicas"]
                                for o in self.store.list("replicasets")[0]},
                "jobs": status("jobs"), "deployments": status("deployments"),
                "poddisruptionbudgets": status("poddisruptionbudgets"),
                "counter": int(self.sched.last_node_index)}


def cm_check_step(what: str, side: CMSide, name: str, replicas: int,
                  rolling: bool) -> dict:
    """No node over capacity; in a rollout, between the controllers'
    writes and the kubelet's, the ReplicaSets' replicas sum to at most
    replicas + maxSurge and at least replicas - maxUnavailable of the
    Deployment's pods are Running.  Returns those two counts."""
    pods = side.store.list("pods")[0]
    over = wire_over_capacity(side.store.list("nodes")[0],
                              [o for o in pods if alive(o)])
    if over:
        fail(f"{what}: {over} nodes over capacity")
    surge, unavail = cm_bounds(replicas)
    total = side.mid["rs_total"][name]
    up = side.mid["running"][name]
    if rolling and total > replicas + surge:
        fail(f"{what}: the ReplicaSets ask for {total} replicas, over "
             f"{replicas} + maxSurge {surge}")
    if rolling and up < replicas - unavail:
        fail(f"{what}: {up} replicas Running, under {replicas} - "
             f"maxUnavailable {unavail}")
    return {"rs_total": total, "running": up}


def phase_cm_twins(nodes: int, replicas: int, card: str,
                   dev: str = "cuda") -> dict:
    """21a: kubemark-500's nodes with a DaemonSet, a Deployment of
    ``replicas`` at 50m under a PodDisruptionBudget and a Job, driven
    round by round by the port's controllers on a ``MemStore`` whose
    pending pods ``GenericScheduler(device=dev)`` drains, and on a twin
    store (a deep copy of the same objects) drained on the CPU: every
    round the same placements, the same stores and the same round-robin
    counter, no node over capacity; then the Deployment rolled to a new
    template round by round within its bounds, the same on both sides."""
    import copy
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.apiserver.memstore import MemStore

    label = card if dev == "cuda" else dev
    name = "cm-web"
    t0 = time.perf_counter()
    store = MemStore()
    for i in range(nodes):
        store.create("nodes", api.node_to_json(fleet_node(api,
                                                          f"cm-{i:03d}")))
    store.create("daemonsets", {
        "metadata": {"name": "cm-logd", "namespace": "default"},
        "spec": {"template": {
            "metadata": {"labels": {"app": "cm-logd"}},
            "spec": {"containers": [{"name": "logd", "resources": {
                "requests": {"cpu": "10m", "memory": "32Mi"}}}]}}}})
    store.create("deployments", cm_deployment(name, replicas))
    store.create("poddisruptionbudgets", cm_pdb(name, replicas))
    parallelism, completions = CM_JOB
    store.create("jobs", {
        "metadata": {"name": "cm-batch", "namespace": "default"},
        "spec": {"parallelism": parallelism, "completions": completions,
                 "template": {
                     "metadata": {"labels": {"app": "cm-batch"},
                                  "annotations": {
                                      "kubemark.kubernetes.io/"
                                      "run-duration": "0.1"}},
                     "spec": {"containers": [{"name": "c", "resources": {
                         "requests": {"cpu": "100m"}}}]}}}})
    twin = MemStore()
    for kind in ("nodes", "daemonsets", "deployments",
                 "poddisruptionbudgets", "jobs"):
        for o in store.list(kind)[0]:
            twin.create(kind, copy.deepcopy(o))
    # The side on ``dev`` and its twin on the CPU (keys apart from the
    # devices, so a CPU rehearsal runs two sides too).
    sides = {"main": CMSide(store, dev), "twin": CMSide(twin, "cpu")}
    secs = {"main": 0.0, "twin": 0.0}
    rounds: list = []
    scheduled: set = set()      # every pod the scheduler placed

    def round_(what: str, rolling: bool) -> dict:
        placed = {}
        for d, side in sides.items():
            t1 = time.perf_counter()
            placed[d] = side.step()
            secs[d] += time.perf_counter() - t1
        states = {d: side.state() for d, side in sides.items()}
        if placed["main"] != placed["twin"] or \
                states["main"] != states["twin"]:
            diff = [k for k in placed["main"]
                    if placed["main"][k] != placed["twin"].get(k)][:5]
            keys = [k for k in states["main"]
                    if states["main"][k] != states["twin"][k]]
            fail(f"21a: {what}: {dev} and cpu differ (placements {diff}, "
                 f"state {keys}, counters {states['main']['counter']} / "
                 f"{states['twin']['counter']})")
        if any(n is None for n in placed["main"].values()):
            fail(f"21a: {what}: a pending pod fit no node")
        scheduled.update(placed["main"])
        counts = cm_check_step(f"21a: {what}", sides["main"], name,
                               replicas, rolling)
        rounds.append({"what": what, "placed": len(placed["main"]),
                       **counts})
        return states["main"]

    zero_counts()
    try:
        state = {}
        for i in range(CM_ROLL_STEPS):
            state = round_(f"bring-up round {i}", False)
            dep = state["deployments"][name]
            job = state["jobs"]["cm-batch"]
            if dep.get("availableReplicas") == replicas and \
                    job.get("succeeded") == completions:
                break
        else:
            fail(f"21a: not up after {CM_ROLL_STEPS} rounds: {state}")
        pods = store.list("pods")[0]
        daemons = labelled(pods, "daemonset-name", "cm-logd")
        if sorted(o["spec"]["nodeName"] for o in daemons) != sorted(
                o["metadata"]["name"] for o in store.list("nodes")[0]):
            fail(f"21a: {len(daemons)} daemon pods, not one per node")
        if any(f"default/{o['metadata']['name']}" in scheduled
               for o in daemons):
            fail("21a: the scheduler placed a daemon pod")
        first = dict(rounds[0])
        for d, side in sides.items():
            side.store.update("deployments", {
                **side.store.get("deployments", f"default/{name}"),
                "spec": cm_deployment(name, replicas, "v2")["spec"]})
        for i in range(CM_ROLL_STEPS):
            state = round_(f"rollout round {i}", True)
            rs = state["replicasets"]
            dep = state["deployments"][name]
            if sorted(rs.values()) == [0, replicas] and \
                    dep.get("updatedReplicas") == replicas and \
                    dep.get("availableReplicas") == replicas:
                break
        else:
            fail(f"21a: the rollout not done after {CM_ROLL_STEPS} rounds")
        counts = kernel_counts()
        if dev == "cuda" and counts["scan_chunk"] < 1:
            fail("21a: the drains launched no scan kernel")
        job = state["jobs"]["cm-batch"]
        pdb = state["poddisruptionbudgets"][f"{name}-pdb"]
    finally:
        for side in sides.values():
            side.stop()
    rolled = [r for r in rounds if r["what"].startswith("rollout")]
    print(f"phase 21a: {label}: {nodes} nodes, a DaemonSet, a Deployment "
          f"of {replicas} at 50m (maxSurge {CM_SURGE}, maxUnavailable "
          f"{CM_UNAVAILABLE}) under a budget of {pdb['desiredHealthy']} "
          f"and a Job of parallelism {parallelism}, completions "
          f"{completions}: up in {len(rounds) - len(rolled)} rounds "
          f"({len(daemons)} daemon pods placed by their controller, one "
          f"per node; the first round's drain {first['placed']} pods; the "
          f"Job {job}); rolled to v2 in {len(rolled)} rounds, the "
          f"ReplicaSets' replicas at most "
          f"{max(r['rs_total'] for r in rolled)} and Running at least "
          f"{min(r['running'] for r in rolled)} per round; budget "
          f"{pdb}; every round's placements, stores and counter "
          f"({state['counter']}) equal on {dev} and cpu, 0 nodes over "
          f"capacity; drains and syncs {secs['main']:.3f} s on {dev}, "
          f"{secs['twin']:.3f} s on cpu, {time.perf_counter() - t0:.3f} s "
          f"in all; launches {counts}")
    return {"counts": counts, "rounds": len(rounds), "secs": secs}


def cm_kubectl(base: str, *argv: str, ok: bool = True) -> tuple:
    """The port's kubectl in process, as the admin: (exit code, output)."""
    import contextlib
    import io
    from kubernetes_tpu_torch.kubectl.__main__ import main as kubectl
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = kubectl(["--server", base, "--token", "admin-token", *argv],
                     out=out)
    if ok and rc != 0:
        fail(f"21b: kubectl {' '.join(argv)} exited {rc}: "
             f"{out.getvalue()[-1000:]} {err.getvalue()[-1000:]}")
    return rc, out.getvalue() + err.getvalue()


def cm_leader(client) -> str:
    """The controller-manager lease's holder (``hostname-pid``)."""
    ep = client.get("endpoints", "kube-system/kube-controller-manager") \
        or {}
    ann = ((ep.get("metadata") or {}).get("annotations") or {}).get(
        "control-plane.alpha.kubernetes.io/leader")
    return json.loads(ann).get("holderIdentity", "") if ann else ""


def phase_cm_wire(replicas: int, card: str, dev: str = "cuda") -> dict:
    """21b: the reference's multi-process story on the port's binaries:
    the Python apiserver with token auth and ABAC, the daemon on
    ``dev``, two controller-managers under ``--leader-elect``,
    WIRE_KUBELETS kubelets and a proxy, driven through the port's kubectl:
    apply and roll out a Deployment under a budget, roll a new template
    out and back, scale, drain the busiest node, explain a pod that fits
    nowhere and a placed one; then the leading controller-manager
    SIGKILLed and a scale the standby carries out.  Every process is
    stopped, also on failure."""
    import tempfile
    from kubernetes_tpu_torch.client.http import APIClient, APIError
    from kubernetes_tpu_torch.controller.deployment import (HASH_LABEL,
                                                            template_hash)

    label = card if dev == "cuda" else dev
    name = "cm-wire"
    scaled, failover = int(replicas * 1.2), int(replicas * 1.3)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="kt_cm_")
    with open(f"{tmp}/tokens.csv", "w") as f:
        f.write(CM_TOKENS)
    with open(f"{tmp}/abac.jsonl", "w") as f:
        f.write(CM_ABAC)
    children: dict = {}
    codes: dict = {}
    times: dict = {}

    def mark(what: str) -> None:
        # Progress, so a failed run still shows where its time went.
        print(f"phase 21b: {what} at {time.perf_counter() - t0:.3f} s",
              flush=True)

    try:
        api_child = children["apiserver"] = Child([
            sys.executable, "-m", "kubernetes_tpu_torch.apiserver",
            "--port", "0", "--token-auth-file", f"{tmp}/tokens.csv",
            "--authorization-policy-file", f"{tmp}/abac.jsonl"])
        line = api_child.wait_line("listening on")
        base = "http://" + line.rsplit(" ", 1)[1].strip()
        admin = APIClient(base, qps=5000, burst=5000, token="admin-token")
        wait_for("21b: the authenticated apiserver", lambda: admin.list(
            "nodes")[1] >= 0, 60)
        cmd = [sys.executable, "-m", "kubernetes_tpu_torch.scheduler",
               "--api-server", base, "--kube-api-token", "sched-token",
               "--port", "0", "--kube-api-qps", "5000",
               "--kube-api-burst", "5000"]
        if dev != "cuda":
            cmd += ["--device", dev]
        sched = children["scheduler"] = Child(cmd, stdout=subprocess.PIPE)
        port = json.loads(sched.proc.stdout.readline() or "{}").get("port")
        if port is None:
            fail(f"21b: the daemon binary did not start: {sched.tail()}")
        for i in range(2):
            children[f"cm-{i}"] = Child([
                sys.executable, "-m", "kubernetes_tpu_torch.controller",
                "--api-server", base, "--kube-api-token", "cm-token",
                "--port", "-1", "--leader-elect",
                "--leader-elect-lease-duration", CM_LEASE[0],
                "--leader-elect-renew-deadline", CM_LEASE[1],
                "--leader-elect-retry-period", CM_LEASE[2]])
        for i in range(WIRE_KUBELETS):
            children[f"ck-{i}"] = Child([
                sys.executable, "-m", "kubernetes_tpu_torch.kubelet",
                "--api-server", base, "--node-name", f"ck-{i}",
                "--kube-api-token", "kubelet-token",
                "--cpu", "64000", "--memory-gib", "128", "--pods", "110",
                "--heartbeat-period", str(DEATH_HEARTBEAT_S)])
        children["proxy"] = Child([
            sys.executable, "-m", "kubernetes_tpu_torch.proxy",
            "--api-server", base, "--kube-api-token", "proxy-token"])
        children["proxy"].wait_line("hollow kube-proxy running")
        wait_for(f"21b: {WIRE_KUBELETS} kubelet processes Ready", lambda:
                 sum(ready_status(o) == "True" for o in admin.list(
                     "nodes")[0]) == WIRE_KUBELETS, 120, 0.2)
        pids = {c.pid: k for k, c in children.items()
                if k.startswith("cm-")}
        leader = wait_for("21b: a controller-manager holds the lease",
                          lambda: cm_leader(admin), 60, 0.1)
        lead = pids.get(int(leader.rsplit("-", 1)[1]))
        if lead is None:
            fail(f"21b: the lease holder {leader!r} is none of {pids}")
        times["ready"] = time.perf_counter() - t0
        mark("ready")

        def pods() -> list:
            return labelled([o for o in admin.list("pods")[0] if alive(o)],
                            "app", name)

        def rollout(what: str) -> None:
            rc, text = cm_kubectl(base, "rollout", "status", "deploy", name,
                                  "--timeout", "180", ok=False)
            if rc != 0:
                fail(f"21b: rollout status of {what} exited {rc}: "
                     f"{text[-1000:]}")

        # apply -f, then the budget and a rollout.
        manifest = f"{tmp}/{name}.json"
        with open(manifest, "w") as f:
            json.dump(cm_deployment(name, replicas), f)
        t1 = time.perf_counter()
        cm_kubectl(base, "apply", "-f", manifest)
        admin.create("poddisruptionbudgets", cm_pdb(name, replicas))
        rollout("v1")
        times["apply_to_running"] = time.perf_counter() - t1
        mark("v1 rolled out")
        v1 = template_hash(cm_deployment(name, replicas)["spec"]
                           ["template"])
        # A changed template: rolled out, then undone.
        with open(manifest, "w") as f:
            json.dump(cm_deployment(name, replicas, "v2"), f)
        t1 = time.perf_counter()
        cm_kubectl(base, "apply", "-f", manifest)
        wait_for("21b: the v2 ReplicaSet", lambda: len(labelled(
            admin.list("replicasets")[0], "app", name)) == 2, 60, 0.1)
        rollout("v2")
        if {o["metadata"]["labels"]["version"] for o in pods()} != {"v2"}:
            fail("21b: v2 rolled out, but not every pod is v2")
        times["roll_v2"] = time.perf_counter() - t1
        mark("v2 rolled out")
        t1 = time.perf_counter()
        cm_kubectl(base, "rollout", "undo", "deploy", name)

        def undone():
            ps = pods()
            return len(ps) == replicas and all(
                o["metadata"]["labels"].get(HASH_LABEL) == v1 and
                (o.get("status") or {}).get("phase") == "Running"
                for o in ps)
        wait_for("21b: rollout undo back to v1", undone, 180, 0.2)
        rollout("undo")
        times["undo"] = time.perf_counter() - t1
        mark("undone")
        _rc, history = cm_kubectl(base, "rollout", "history", "deploy",
                                  name)
        # scale
        t1 = time.perf_counter()
        cm_kubectl(base, "scale", "deploy", name, "--replicas",
                   str(scaled))
        wait_for(f"21b: {scaled} Running after kubectl scale", lambda: len(
            running(pods())) == scaled == len(pods()), 180, 0.2)
        times["scale"] = time.perf_counter() - t1
        mark("scaled")
        # drain the busiest node under the budget, twice.  The disruption
        # controller allows an eviction while currentHealthy >=
        # desiredHealthy (disruption.go:568).  First a minAvailable over
        # the healthy count: every eviction is refused, and the drain
        # gives up at its --timeout.  Then scaled - k + 2, which lets
        # k - 1 of the node's k pods go: the healthy replicas may fall to
        # scaled - k + 1 and no lower, and the last eviction waits for a
        # replacement unless one is Ready by then.
        ps = pods()
        victim = max(sorted({o["spec"]["nodeName"] for o in ps}),
                     key=lambda nd: sum(o["spec"]["nodeName"] == nd
                                        for o in ps))
        on_victim = {o["metadata"]["name"] for o in ps
                     if o["spec"]["nodeName"] == victim}
        min_available = scaled - len(on_victim) + 2
        floor = min_available - 1
        pdb_key = f"default/{name}-pdb"

        def budget() -> dict:
            return admin.get("poddisruptionbudgets",
                             pdb_key).get("status") or {}

        def budget_to(least: int) -> None:
            def written() -> bool:
                pdb = admin.get("poddisruptionbudgets", pdb_key)
                pdb["spec"]["minAvailable"] = least
                try:
                    admin.update("poddisruptionbudgets", pdb)
                except APIError as err:
                    if err.status != 409:  # the controller's status write
                        raise
                    return False
                return True
            wait_for(f"21b: the budget's minAvailable {least} written",
                     written, 30)
            wait_for(f"21b: the budget's status at minAvailable {least}",
                     lambda: budget() == {
                         "disruptionAllowed": scaled >= least,
                         "currentHealthy": scaled, "desiredHealthy": least,
                         "expectedPods": scaled}, 30)
        # The evictions the budget refused: kubectl retries a 429 until
        # its --timeout and prints only the evictions granted.
        refused: list = []
        evict = APIClient.evict

        def evict_counted(client, namespace: str, pod: str) -> None:
            try:
                evict(client, namespace, pod)
            except APIError as err:
                refused.append(err.status)
                raise
        APIClient.evict = evict_counted
        try:
            budget_to(scaled + 1)
            rc, held = cm_kubectl(base, "drain", victim, "--timeout", "1",
                                  ok=False)
        finally:
            APIClient.evict = evict
        still = {o["metadata"]["name"] for o in pods()
                 if o["spec"]["nodeName"] == victim}
        if rc != 1 or " evicted" in held or still != on_victim or \
                set(refused) != {429} or len(refused) < len(on_victim):
            fail(f"21b: a budget of {scaled + 1} over {scaled} healthy "
                 f"replicas did not hold the drain: exit {rc}, "
                 f"{len(on_victim - still)} pods gone, refused {refused}: "
                 f"{held[-500:]}")
        held_429 = len(refused)
        refused.clear()
        budget_to(min_available)
        healthy: list = []
        counted: list = []      # the budget status' currentHealthy
        stop_sampling = threading.Event()

        def sample() -> None:
            while not stop_sampling.is_set():
                healthy.append(sum(
                    1 for o in pods()
                    if (o.get("status") or {}).get("phase") == "Running"
                    and any(c.get("type") == "Ready" and
                            c.get("status") == "True" for c in
                            (o.get("status") or {}).get("conditions")
                            or ())))
                counted.append(budget().get("currentHealthy", scaled))
                stop_sampling.wait(0.1)
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t1 = time.perf_counter()
        APIClient.evict = evict_counted
        try:
            _rc, drained = cm_kubectl(base, "drain", victim, "--timeout",
                                      "120")

            def replaced():
                ps = pods()
                return len(ps) == scaled and len(running(ps)) == scaled \
                    and not any(o["spec"]["nodeName"] == victim or
                                o["metadata"]["name"] in on_victim
                                for o in ps)
            wait_for(f"21b: {victim}'s pods replaced off it", replaced,
                     180, 0.2)
        finally:
            APIClient.evict = evict
            stop_sampling.set()
            sampler.join(timeout=10)
        times["drain"] = time.perf_counter() - t1
        mark("drained")
        evicted = drained.count(" evicted")
        if evicted != len(on_victim):
            fail(f"21b: the drain evicted {evicted} of {len(on_victim)} "
                 f"pods: {drained[-500:]}")
        if set(refused) != {429}:
            fail(f"21b: the drain's refused evictions {refused}, not one "
                 f"or more 429s from the budget")
        if min(healthy) < floor:
            fail(f"21b: {min(healthy)} healthy replicas during the drain, "
                 f"under the budget's floor {floor} (minAvailable "
                 f"{min_available})")
        if not floor <= min(counted) < scaled:
            fail(f"21b: the budget's status counted down to "
                 f"{min(counted)} healthy, not between its floor {floor} "
                 f"and {scaled - 1}")
        # explain: a pod that fits no node, and a placed one.
        admin.create("pods", {
            "metadata": {"name": "cm-huge", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "100"}}}]}})
        sched_url = f"http://127.0.0.1:{port}"

        def explained():
            rc, text = cm_kubectl(base, "explain", "pod", "cm-huge",
                                  "--scheduler", sched_url, ok=False)
            return text if rc == 0 else None
        why = wait_for("21b: kubectl explain of the pod that fits nowhere",
                       explained, 60, 0.5)
        if "PodFitsResources" not in why or "unschedulable" not in why:
            fail(f"21b: explain names no failing predicate: {why}")
        # A placed pod's decision, while the recorder's ring still holds
        # it: a pod of its own, explained as soon as it is bound.
        admin.create("pods", {
            "metadata": {"name": "cm-probe", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "50m"}}}]}})
        node = wait_for("21b: the probe pod bound", lambda: (admin.get(
            "pods", "default/cm-probe").get("spec") or {}).get("nodeName"),
            60, 0.1)
        _rc, where = cm_kubectl(base, "explain", "pod", "cm-probe",
                                "--scheduler", sched_url)
        if f"Node:\t{node}" not in where:
            fail(f"21b: explain does not name the pod's node: {where}")
        admin.delete("pods", "default/cm-huge")
        admin.delete("pods", "default/cm-probe")
        mark("explain")
        # failover: SIGKILL the leader, then scale; the standby carries it.
        t1 = time.perf_counter()
        children[lead].proc.kill()
        children[lead].proc.wait()
        codes[lead] = "SIGKILL"
        standby = next(k for k in pids.values() if k != lead)
        cm_kubectl(base, "scale", "deploy", name, "--replicas",
                   str(failover))
        most = [0]

        def carried():
            ps = pods()
            most[0] = max(most[0], len(ps))
            holder = cm_leader(admin)
            return holder and pids.get(int(holder.rsplit("-", 1)[1])) \
                == standby and len(running(ps)) == failover == len(ps)
        wait_for(f"21b: the standby takes the lease and reaches "
                 f"{failover} Running", carried, 120, 0.1)
        takeover_s = time.perf_counter() - t1
        for _ in range(20):          # two seconds of the standby's syncs
            most[0] = max(most[0], len(pods()))
            time.sleep(0.1)
        if most[0] != failover or len(pods()) != failover:
            fail(f"21b: {most[0]} replicas seen after the failover, "
                 f"{failover} asked (a replica double-created)")
        over = wire_over_capacity(admin.list("nodes")[0],
                                  [o for o in admin.list("pods")[0]
                                   if alive(o)])
        if over:
            fail(f"21b: {over} nodes over capacity")
        launches = debug_vars(port)["kernelLaunches"]
        if dev == "cuda" and launches["scan_chunk"] < 1:
            fail(f"21b: the daemon process launched no scan kernel: "
                 f"{launches}")
    finally:
        for key, child in reversed(list(children.items())):
            if key not in codes:
                codes[key] = child.stop()
    bad = {k: v for k, v in codes.items() if v not in (0, "SIGKILL")}
    if bad:
        fail(f"21b: processes exited non-zero on SIGTERM: {bad}")
    print(f"phase 21b: {label}: the Python apiserver (token auth, ABAC), "
          f"the daemon binary on {dev}, two controller-managers under "
          f"--leader-elect (lease {'/'.join(CM_LEASE)} s), "
          f"{WIRE_KUBELETS} kubelet processes and a proxy ready in "
          f"{times['ready']:.3f} s; kubectl apply -f of {replicas} "
          f"replicas Running (rollout status) {times['apply_to_running']:.3f}"
          f" s after the apply; v2 rolled out in {times['roll_v2']:.3f} s "
          f"and undone in {times['undo']:.3f} s (history "
          f"{' '.join(history.split()[2:])}); scaled to {scaled} in "
          f"{times['scale']:.3f} s; {victim}'s drain held by minAvailable "
          f"{scaled + 1} ({held_429} evictions refused with 429 in its 1 "
          f"s), then drained under minAvailable "
          f"{min_available} ({evicted} evictions granted, {len(refused)} "
          f"refused with 429 and retried; at least {min(healthy)} healthy "
          f"replicas against the floor {floor}, the budget's status down "
          f"to {min(counted)}) and its pods replaced in "
          f"{times['drain']:.3f} s; "
          f"explain named PodFitsResources and the placed pod's node; the "
          f"leader SIGKILLed: the standby holds the lease and {failover} "
          f"replicas Running {takeover_s:.3f} s after the kill, at most "
          f"{most[0]} seen, 0 over capacity; the daemon's /debug/vars "
          f"kernelLaunches {launches}; every other process exited 0 on "
          f"SIGTERM")
    return {"counts": launches, "times": times, "takeover_s": takeover_s}


def phase_cm(card: str, dev: str = "cuda") -> dict:
    """21: the controller-manager on the card, 21a then 21b."""
    t0 = time.perf_counter()
    with Gen2Pauses() as gc2:
        a = phase_cm_twins(CM_NODES, CM_REPLICAS, card, dev)
    print(f"phase 21: 21a done {time.perf_counter() - t0:.3f} s into the "
          f"phase ({gc2.describe()})", flush=True)
    with Gen2Pauses() as gc2:
        b = phase_cm_wire(CM_WIRE_REPLICAS, card, dev)
    print(f"phase 21: 21b done {time.perf_counter() - t0:.3f} s into the "
          f"phase ({gc2.describe()})", flush=True)
    print(f"phase 21: 21a and 21b passed in "
          f"{time.perf_counter() - t0:.3f} s")
    return {"paths": {"a": a["counts"], "b": b["counts"]}}


def phase_child(flag: str, key: str, phase: str, *opts: str) -> dict:
    """A phase in a fresh interpreter (``chip_smoke.py --<flag>``): after
    phases 1-19 this process's host work ran many times slower than the
    same fleet alone (PERF.md, section 6).  Its lines are echoed; its last
    line is the phase's record.  The child is stopped on any failure."""
    print(f"phase {phase}: the smoke's process before the child: "
          f"{process_state()}", flush=True)
    cmd = [sys.executable, __file__, f"--{flag}", *opts]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    last = ""
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            last = line
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    if rc != 0:
        fail(f"{phase}: python3 chip_smoke.py --{flag} exited {rc}")
    return json.loads(last)[key]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--parity-nodes", type=int, default=5000)
    ap.add_argument("--parity-pods", type=int, default=4096)
    ap.add_argument("--rich-nodes", type=int, default=1000)
    ap.add_argument("--rich-pods", type=int, default=1024)
    ap.add_argument("--single-nodes", type=int, default=5000)
    ap.add_argument("--single-pods", type=int, default=128)
    ap.add_argument("--extender-nodes", type=int, default=5000)
    ap.add_argument("--extender-probes", type=int, default=200)
    ap.add_argument("--factory-nodes", type=int, default=5000)
    ap.add_argument("--factory-pods", type=int, default=1024)
    ap.add_argument("--topology-pods", type=int, default=2048)
    ap.add_argument("--binary-nodes", type=int, default=1000)
    ap.add_argument("--binary-pods", type=int, default=2048)
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and run phases 2, 2b and 6 only; prints "
                         "no result lines")
    ap.add_argument("--bench-only", action="store_true",
                    help="build and run phase 18 only; prints no result "
                         "lines")
    ap.add_argument("--slice-only", action="store_true",
                    help="build and run phase 19 only; prints no result "
                         "lines")
    ap.add_argument("--fleet-nodes", type=int, default=FLEET_NODES)
    ap.add_argument("--fleet-replicas", type=int, default=FLEET_REPLICAS)
    ap.add_argument("--fleet-only", action="store_true",
                    help="build and run phase 20 only; prints no result "
                         "lines")
    ap.add_argument("--cm-only", action="store_true",
                    help="build and run phase 21 only; prints no result "
                         "lines")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from kubernetes_tpu_torch.engine import kernels
    except ImportError as err:
        print(f"chip_smoke: the kubernetes_tpu_torch package is not "
              f"importable ({err}); run the script from the root of a "
              f"checkout", file=sys.stderr)
        return 2

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    # --fleet-only and --cm-only load a library their parent smoke built
    # (they build one if there is none); every other run rebuilds, for
    # ptxas's report.
    lib, log = kernels.build(verbose=not (args.fleet_only or args.cm_only))
    print(f"phase 1: built {lib.name} (one nvcc command: "
          f"{', '.join(src.name for src in kernels.SOURCES)}) in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in log.strip().splitlines():
        print(f"phase 1: nvcc: {line}")

    dev = torch.device("cuda")
    if args.bench_only:
        phase_bench(args.nodes, args.pods, card)
        return 0
    if args.slice_only:
        phase_slice(args, card)
        return 0
    if args.fleet_only:
        # The last line: the phase's record, for a parent smoke to read.
        print(json.dumps({"fleet": phase_fleet(args, card)}))
        return 0
    if args.cm_only:
        # The last line: the phase's record, for a parent smoke to read.
        print(json.dumps({"cm": phase_cm(card)}))
        return 0
    def stamp(done: str) -> None:
        print(f"chip_smoke: {done} done at "
              f"{time.perf_counter() - t_start:.3f} s", flush=True)

    kstats = phase_kernel(dev)
    sstats = phase_scan(dev)
    hstats = phase_select_hosts(dev)
    stamp("phases 1-2b, 6")
    if args.kernels_only:
        return 0
    phase_parity("mixed", args.parity_nodes, args.parity_pods, CHUNK)
    rich = phase_parity("rich", args.rich_nodes, args.rich_pods, 512)
    full = phase_full(args.nodes, args.pods, CHUNK, card)
    phase_profile(args.nodes, PROFILE_PODS)
    single = phase_single(args.single_nodes, args.single_pods, card)
    phase_extender(args.extender_nodes, args.extender_probes, card)
    stamp("phases 3-8")
    daemon = phase_daemon(args.nodes, args.pods, full, card)
    phase_factory(args.factory_nodes, args.factory_pods, card)
    phase_preemption(args.nodes, card)
    phase_guard(args.nodes, GUARD_PODS, card)
    stamp("phases 9-12")
    topo = phase_topology(args.nodes, args.topology_pods, args.pods, card)
    joint = phase_joint(args.nodes, args.pods, card)
    harness = phase_harness(card)
    rich16 = phase_rich(args.nodes, args.pods, CHUNK, card)
    stamp("phases 13-16")
    wire17 = phase_wire_parity(args.parity_nodes, args.parity_pods, card)
    wire17.update(phase_wire_north_star(args.nodes, args.pods, card))
    phase_wire_binaries(args.binary_nodes, args.binary_pods, card)
    stamp("phase 17")
    bench18 = phase_bench(args.nodes, args.pods, card)
    stamp("phase 18")
    slice19 = phase_slice(
        args, card, density_p50=bench18["art"]["settings"]["one-shot"]
        ["elapsed_s_p50"])
    stamp("phase 19")
    fleet20 = phase_child("fleet-only", "fleet", "20",
                          "--fleet-nodes", str(args.fleet_nodes),
                          "--fleet-replicas", str(args.fleet_replicas))
    stamp("phase 20")
    cm21 = phase_child("cm-only", "cm", "21")
    stamp("phase 21")

    def wire_launches(kernel: str) -> dict:
        out = {f"wire_{run}": wire17[run]["counts"][kernel]
               for run in ("memstore", "wire", "stream", "one-shot")}
        out.update({path: counts[kernel]
                    for path, counts in bench18["paths"].items()})
        # Phase 19's paths: 19a's bench and north star, 19b's three
        # incarnations (summed), 19c's rounds, 19d's follow-up drain.
        out.update({f"slice_{path}": counts[kernel] if counts else 0
                    for path, counts in slice19.items()})
        # Phase 20's paths: 20a's drain, 20b's fleet, 20c's replacements,
        # 20d's daemon process.
        out.update({f"fleet_20{sub}": counts[kernel]
                    for sub, counts in fleet20["paths"].items()})
        # Phase 21's paths: 21a's rounds in process, 21b's daemon process.
        out.update({f"cm_21{sub}": counts[kernel]
                    for sub, counts in cm21["paths"].items()})
        return out

    kernels_line = [{
        "name": "select_rows",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/select.cu",
        "replaces": "kubernetes_tpu/engine/fused.py:59",
        # Its path is the step loop, the steps side of phase 2b; on the
        # main path its body runs inlined in scan_chunk.
        "path": "phase 2b step loop (every scan_check case and the two "
                "timed chunks)",
        "launches": sstats["select_launches"],
        "daemon_launches": {run: daemon[run]["counts"]["select_rows"]
                            for run in ("a", "b")},
        "launches_by_path": {"topology": 0, "joint": 0,
                            "rich_drain": rich["select_rows"],
                            "parity_rich": 0, "rich_north_star": 0,
                            **wire_launches("select_rows")},
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
                            "rich_drain": rich["scan_chunk"],
                            "parity_rich": harness["parity"],
                            "rich_north_star": rich16["launches"],
                            **wire_launches("scan_chunk")},
        "max_abs_err": sstats["max_abs_err"],
        "ms": sstats["ms"],
        "plain_ms": sstats["plain_ms"],
        "bound_ms": sstats["bound_ms"],
        "bound_by": sstats["bound_by"],
        "library_ms": None,
        "cluster": sstats["cluster"],
        "per_cluster_ms": sstats["per_cluster_ms"],
        "plans": sstats["plans"],
        "rich_chunk": {k: sstats["rich"][k] for k in (
            "ms", "cluster", "per_cluster_ms", "plans", "hoist_ms",
            "plain_ms", "bound_ms", "bound_by", "axes", "max_abs_err")},
        "fleet_chunk": fleet20["chunk"],
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
                            "parity_rich": 0,
                            **wire_launches("select_hosts")},
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

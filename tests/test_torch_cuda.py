"""Tests of the PyTorch port that need the card: the CUDA select kernel
against its plain version, the scan kernel against its plain version (the
step loop) on every case of ``perf/scan_check.py`` at the plan's cluster
size and at one CTA, the single-pod
select kernel (``kt_select_hosts``) against ``select_hosts_plain``, and
drains, single-pod decisions, extender responses, the scheduler daemon
(also over HTTP against the port's apiserver, pod for pod against the
daemon over a ``MemStore``), the bench's density rig, the preemption victim solve, the topology spread planes and drain, the
joint solve's price iteration and placements, the rich sums
(ImageLocality, the inter-pod priority counts, ``Solver.evaluate`` and a
rich drain) at f32 matmul precision "highest" and "high", a
``KT_TENANTS`` daemon and a defragmenter round with the joint probe, on
``cuda`` against the same on ``cpu``, the resident cluster's row
readback against the host arrays, and a real CUDA out-of-memory error
through the device guard.  They skip themselves where
there is no CUDA device; on the card run ``python -m pytest
tests/test_torch_cuda.py -m cuda -q --noconftest``.  This file imports no
JAX, so it also runs where only the port's dependencies are installed.
Tolerance: exact equality (integer outputs; the scan's float state bit
for bit)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.engine import fused, scan
from kubernetes_tpu_torch.ops import combine
from kubernetes_tpu_torch.perf import scan_check, synth

COUNTERS = (0, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(n: int, rng: np.random.RandomState) -> np.ndarray:
    neg = -np.inf
    one = np.full(n, neg, np.float32)
    one[rng.randint(n)] = 5.0
    ties = rng.randint(0, 3, n).astype(np.float32)
    ties[rng.rand(n) < 0.4] = neg
    pinf = rng.randint(0, 3, n).astype(np.float32)
    pinf[rng.randint(n)] = np.inf
    return np.stack([np.full(n, neg, np.float32), one, ties,
                     np.full(n, 2.0, np.float32), pinf])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 5000, 5003])
def test_cuda_kernel_matches_plain(cuda, n):
    rows = _rows(n, np.random.RandomState(n))
    masked = np.repeat(rows, len(COUNTERS), axis=0)
    counters = np.tile(np.asarray(COUNTERS, np.int64), len(rows))
    m = torch.from_numpy(masked).to(cuda)
    c = torch.from_numpy(counters).to(cuda)
    before = fused.select_rows.launches
    got = fused.select_rows(m, c)
    assert fused.select_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused.select_plain(m, c))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    m = torch.zeros((2, 8), device=cuda)
    c = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fused.select_rows(m.half(), c)
    with pytest.raises(ValueError):
        fused.select_rows(m, c.int())
    with pytest.raises(ValueError):
        fused.select_rows(m.t(), c)
    with pytest.raises(ValueError):
        fused.select_rows(m, c.cpu())


@pytest.mark.cuda
def test_cuda_drain_matches_cpu_drain(cuda):
    """A rich stream drain: every chunk one scan launch on the card, no
    select launch, and the placements of the CPU's step loop."""
    out = {}
    for dev in ("cuda", "cpu"):
        eng, pods = synth.make_rig(48, 200, profile="rich", device=dev)
        fused.select_rows.launches = scan.scan_chunk.launches = 0
        placed = [n for _, pl in eng.schedule_batch_stream(
            pods, chunk_size=64) for n in pl]
        out[dev] = (placed, int(eng.last_node_index))
        if dev == "cuda":
            assert scan.scan_chunk.launches == 4
            assert fused.select_rows.launches == 0
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["mixed", "rich"])
def test_cuda_drain_in_chunks_off_the_4_byte_grid_matches_cpu(cuda, profile):
    """Chunks of 125 pods: every chunk after the first hands the kernel
    bool tables (zero_request, spread_incr) that start off the 4-byte
    grid; every third pod requests nothing."""
    out = {}
    for dev in ("cuda", "cpu"):
        eng, pods = synth.make_rig(300, 500, profile=profile, n_services=1,
                                   device=dev)
        for pod in pods[::3]:
            for ctr in pod.containers:
                ctr.requests = {}
        scan.scan_chunk.launches = 0
        placed = [n for _, pl in eng.schedule_batch_stream(
            pods, chunk_size=125) for n in pl]
        out[dev] = (placed, int(eng.last_node_index))
        if dev == "cuda":
            assert scan.scan_chunk.launches == 4
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", scan_check.CASE_NAMES)
def test_cuda_scan_kernel_matches_step_loop(cuda, name):
    """At the plan's cluster size and at C = 1."""
    case = scan_check.case(name, cuda)
    before = scan.scan_chunk.launches
    res = scan_check.run_routes(case, ("steps", "kernel", "kernel@1"))
    torch.cuda.synchronize()
    assert scan.scan_chunk.launches == before + 4  # one per chunk and route
    assert res["max_abs_err"] == 0.0
    assert (res["placed"] == 0) is case.infeasible


@pytest.mark.cuda
def test_cuda_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p, n = 4, 8
    args = dict(
        request=torch.zeros((p, 4), dtype=torch.int32, device=cuda),
        nonzero=torch.zeros((p, 2), dtype=torch.int32, device=cuda),
        zero_request=torch.zeros(p, dtype=torch.bool, device=cuda),
        alloc=torch.ones((n, 4), dtype=torch.int32, device=cuda),
        packed=torch.zeros((n, 6), dtype=torch.int32, device=cuda),
        counter=torch.zeros(1, dtype=torch.int64, device=cuda))
    enc = torch.zeros((p, n), device=cuda)
    before = scan.scan_chunk.launches
    with pytest.raises(ValueError):
        scan.scan_chunk(enc.double(), **args)
    with pytest.raises(ValueError):
        scan.scan_chunk(enc, **{**args, "packed": args["packed"].cpu()})
    with pytest.raises(ValueError):
        scan.scan_chunk(enc, **{**args, "alloc": args["alloc"].t()})
    assert scan.scan_chunk.launches == before
    choices = scan.scan_chunk(enc, **args)
    torch.cuda.synchronize()
    assert scan.scan_chunk.launches == before + 1
    assert choices.tolist() == [0, 1, 2, 3]  # all tie; counter walks
    assert int(args["counter"][0]) == 4


@pytest.mark.cuda
def test_cuda_mixed_drain_runs_one_scan_launch_per_chunk(cuda):
    out = {}
    for dev in ("cuda", "cpu"):
        eng, pods = synth.make_rig(300, 200, profile="mixed", device=dev)
        fused.select_rows.launches = scan.scan_chunk.launches = 0
        placed = [n for _, pl in eng.schedule_batch_stream(
            pods, chunk_size=64) for n in pl]
        out[dev] = (placed, int(eng.last_node_index))
        if dev == "cuda":
            assert scan.scan_chunk.launches == 4
            assert fused.select_rows.launches == 0
    assert out["cuda"] == out["cpu"]


def _hosts_cases(p: int, n: int, rng: np.random.RandomState) -> list:
    """(scores, feasible) edge cases of the single-pod select."""
    base = rng.randint(0, 3, (p, n)).astype(np.float32)
    half = rng.rand(p, n) < 0.5
    nan, pinf = base.copy(), base.copy()
    nan[rng.rand(p, n) < 0.05] = np.nan
    pinf[rng.rand(p, n) < 0.05] = np.inf
    seventh = np.zeros((p, n), bool)
    seventh[:, ::7] = True
    rows = half.copy()
    rows[::2] = False
    return [(base, np.zeros((p, n), bool)),
            (np.full((p, n), -np.inf, np.float32), half),
            (pinf, half), (nan, np.ones((p, n), bool)),
            (np.ones((p, n), np.float32), seventh), (base, rows)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 257, 5000])
@pytest.mark.parametrize("p", [1, 64])
def test_cuda_select_hosts_matches_plain(cuda, n, p):
    for scores, feasible in _hosts_cases(p, n, np.random.RandomState(n)):
        s = torch.from_numpy(scores).to(cuda)
        f = torch.from_numpy(feasible).to(cuda)
        for last in (0, 2 ** 31, 2 ** 32 - 1, 2 ** 32):
            lt = torch.tensor([last], dtype=torch.int64, device=cuda)
            before = combine.select_hosts.launches
            got = combine.select_hosts(s, f, lt)
            assert combine.select_hosts.launches == before + 1
            want = combine.select_hosts_plain(s, f, lt)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_select_hosts_wrapper_rejects_what_it_does_not_take(cuda):
    s = torch.zeros((2, 8), device=cuda)
    f = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    last = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = combine.select_hosts.launches
    with pytest.raises(ValueError):
        combine.select_hosts(s.half(), f, last)
    with pytest.raises(ValueError):
        combine.select_hosts(s, f, last.cpu())
    with pytest.raises(ValueError):
        combine.select_hosts(torch.zeros((8, 2), device=cuda).t(), f, last)
    assert combine.select_hosts.launches == before


@pytest.mark.cuda
def test_cuda_schedule_matches_cpu_schedule(cuda):
    from kubernetes_tpu_torch.engine.generic_scheduler import FitError

    out = {}
    for dev in ("cuda", "cpu"):
        eng, pods = synth.make_rig(200, 64, profile="rich", device=dev)
        huge = api.Pod(name="huge", namespace="default", containers=[
            api.Container(name="c", requests={"cpu": "512"})])
        decisions = []
        before = combine.select_hosts.launches
        for pod in pods[:32] + [huge] + pods[32:]:
            try:
                dest = eng.schedule(pod)
            except FitError as err:
                decisions.append(err.failed_predicates)
                continue
            eng.cache.assume_pod(pod, dest)
            decisions.append(dest)
        if dev == "cuda":
            assert combine.select_hosts.launches == before + 65
        out[dev] = (decisions, int(eng.last_node_index),
                    eng.explain_failures(pods[:8] + [huge]))
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_cuda_extender_core_matches_cpu(cuda):
    import json

    from kubernetes_tpu_torch.server.extender import ExtenderCore

    items = [api.node_to_json(nd) for nd in synth.make_nodes(
        300, profile="rich", n_zones=4)]
    cores = {dev: ExtenderCore(device=dev) for dev in ("cuda", "cpu")}
    for k, pod in enumerate(synth.make_pods(12, profile="rich",
                                            n_services=4)):
        body = json.dumps({"Pod": api.pod_to_json(pod),
                           "Nodes": {"Items": items}}).encode()
        for verb in ("filter", "prioritize"):
            assert cores["cuda"].handle(verb, body) == \
                cores["cpu"].handle(verb, body), (k, verb)


def _daemon(dev: str, n_nodes: int, **attrs):
    from kubernetes_tpu_torch.scheduler.binder import InMemoryBinder
    from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                          SchedulerConfig)
    eng, _ = synth.make_rig(n_nodes, 0, profile="mixed", device=dev)
    d = Scheduler(SchedulerConfig(algorithm=eng, binder=InMemoryBinder(),
                                  async_bind=False))
    for k, v in attrs.items():
        setattr(d, k, v)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("attrs", [{}, {"STREAM_THRESHOLD": 256,
                                        "stream_chunk": 256},
                                   {"_PAD_LIMIT": 512}])
def test_cuda_daemon_matches_cpu_daemon(cuda, attrs):
    out = {}
    for dev in ("cuda", "cpu"):
        d = _daemon(dev, 300, **attrs)
        try:
            pods = synth.make_pods(700, profile="mixed", n_services=4)
            for p in pods:
                d.enqueue(p)
            while len(d.queue):
                d.schedule_pending(wait_first=False)
            out[dev] = (dict(d.config.binder._bound),
                        int(d.config.algorithm.last_node_index))
        finally:
            d.stop()
    assert out["cuda"] == out["cpu"]
    assert len(out["cuda"][0]) > 600


@pytest.mark.cuda
def test_cuda_out_of_memory_classifies_as_oom(cuda):
    from kubernetes_tpu_torch.engine.guard import DeviceFault, DeviceGuard
    # Blocks the caching allocator holds from earlier tests would serve
    # part of the request: release them, so the request exceeds what the
    # card can give.
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    g = DeviceGuard()
    with pytest.raises(DeviceFault) as err:
        with g.watch("oneshot", inject=False):
            torch.empty(free + (1 << 30), dtype=torch.uint8, device=cuda)
    assert err.value.kind == "oom"
    assert isinstance(err.value.orig, torch.cuda.OutOfMemoryError)


@pytest.mark.cuda
def test_cuda_victim_solve_matches_cpu(cuda):
    from kubernetes_tpu_torch.engine.workloads import preemption
    rng = np.random.RandomState(3)
    n, v = 5000, 16
    t = dict(
        alloc=np.tile(np.array([[4000, 8192, 1, 8]], np.int32), (n, 1)),
        requested=rng.randint(2000, 4100, (n, 4)).astype(np.int32),
        base_ok=rng.rand(n) < 0.9,
        vic_req=rng.randint(0, 900, (n, v, 4)).astype(np.int32),
        vic_prio=np.sort(rng.randint(0, 9, (n, v)), 1).astype(np.int32),
        vic_valid=rng.rand(n, v) < 0.8,
        pod_req=np.array([1500, 3000, 0, 1], np.int32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(t[k]).to(dev) for k in
                ("alloc", "requested", "base_ok", "vic_req", "vic_prio",
                 "vic_valid", "pod_req")]
        got = preemption.victim_solve(
            *args, torch.tensor(False, device=dev),
            torch.tensor(8, dtype=torch.int32, device=dev))
        out[dev.type] = [x.cpu() for x in got]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


# -- topology spread and the joint solve -------------------------------------

def _precision(precision: str):
    """Set the f32 matmul precision; returns the restore callback."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    return lambda: torch.set_float32_matmul_precision(old)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_cuda_topology_planes_match_cpu(cuda, precision):
    """Term tables with counts past 2,048 (TF32 would round them) and a
    spread-annotated stream drain: planes, placements and counter
    identical on cuda and cpu at either matmul precision."""
    from kubernetes_tpu_torch.engine.workloads import topology
    rng = np.random.RandomState(11)
    t, d, n, p = 8, 64, 5000, 512
    terms = topology.SpreadTerms(
        key_col=rng.randint(0, 3, t).astype(np.int32),
        max_skew=rng.randint(1, 4, t).astype(np.float32),
        hard=rng.rand(t) < 0.5,
        counts=rng.randint(0, 30000, (t, d)).astype(np.float32),
        valid=rng.rand(t, d) < 0.8, src=rng.rand(p, t) < 0.4,
        any_hard=True, any_soft=True)
    topo_dom = rng.randint(-1, d, (n, 3)).astype(np.int32)
    restore = _precision(precision)
    try:
        planes = []
        for dev in (cuda, torch.device("cpu")):
            tp = topology.TermPlanes(terms,
                                     torch.from_numpy(topo_dom).to(dev))
            planes.append([x.cpu() for x in tp.rows(0, p + 64)])
        out = {}
        for dev in ("cuda", "cpu"):
            eng, pods = synth.make_rig(300, 700, profile="mixed",
                                       device=dev)
            synth.add_spread_constraints(pods)
            got = [x for _, ch in eng.schedule_batch_stream(
                pods, chunk_size=256) for x in ch]
            out[dev] = (got, int(eng.last_node_index))
    finally:
        restore()
    for a, b in zip(*planes):
        assert torch.equal(a, b)
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_cuda_solve_joint_matches_cpu(cuda, precision):
    """The price iteration's bias and key bit for bit, and the joint
    solve's placements and counter, on cuda against cpu."""
    restore = _precision(precision)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            eng, pods = synth.make_rig(200, 1500, profile="mixed",
                                       device=dev)
            synth.add_spread_constraints(pods)
            _, db, dc, _ = eng._compile(pods)
            bias, key = eng.solver._price_iterate(db, dc, 24)
            got = eng.schedule_batch(pods, joint=True)
            out[dev] = (bias.cpu().view(torch.int32),
                        key.cpu().view(torch.int32), got,
                        int(eng.last_node_index))
    finally:
        restore()
    c, h = out["cuda"], out["cpu"]
    assert torch.equal(c[0], h[0]) and torch.equal(c[1], h[1])
    assert c[2:] == h[2:]


def _tf32_rig(dev: str):
    """A rich rig whose sums TF32 would round: every third node holds a
    123,597 KiB copy of the pods' image (ImageLocality bucket 2; TF32
    rounds the size to 123,584 KiB, bucket 1), and 2,101 existing
    ``svc-0`` pods sit in zone-0, so the preferred-affinity counts toward
    ``svc-0`` pass 2,048 with an odd count."""
    from kubernetes_tpu_torch.cache.scheduler_cache import SchedulerCache
    from kubernetes_tpu_torch.engine.generic_scheduler import (
        GenericScheduler, Listers)
    nodes = synth.make_nodes(64, profile="rich", n_zones=4)
    for nd in nodes[::3]:
        nd.images = [api.ContainerImage(names=("kubernetes/pause:go",),
                                        size_bytes=123597 * 1024)]
    cache = SchedulerCache()
    for nd in nodes:
        cache.add_node(nd)
    zone0 = [nd.name for nd in nodes
             if nd.labels.get(api.ZONE_LABEL) == "zone-0"]
    for k, pod in enumerate(synth.make_pods(2101, seed=9,
                                            name_prefix="old")):
        pod.labels = {"app": "svc-0"}
        pod.node_name = zone0[k % len(zone0)]
        cache.add_pod(pod)
    eng = GenericScheduler(cache=cache,
                           listers=Listers(services=synth.make_services(4)),
                           device=dev)
    pods = synth.make_pods(256, profile="rich", n_services=4)
    for pod in pods[::8]:
        pod.annotations[api.AFFINITY_ANNOTATION_KEY] = (
            '{"podAffinity": {"preferredDuringSchedulingIgnoredDuring'
            'Execution": [{"weight": 7, "podAffinityTerm": {"labelSelector":'
            ' {"matchLabels": {"app": "svc-0"}}, "topologyKey": "failure-'
            'domain.beta.kubernetes.io/zone"}}]}}')
    return eng, pods


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_cuda_rich_sums_match_cpu(cuda, precision):
    """ImageLocality at a 123,597 KiB image, the inter-pod priority counts
    of a zone holding 2,101 matching pods (an odd count past 2,048, which
    TF32 rounds), ``Solver.evaluate`` and a rich stream drain: cuda equal
    to cpu at either f32 matmul precision (the port sums both in
    float64)."""
    from kubernetes_tpu_torch.ops import interpod
    from kubernetes_tpu_torch.ops import priorities as prio
    restore = _precision(precision)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            eng, pods = _tf32_rig(dev)
            _, db, dc, _ = eng._compile(pods)
            a = db.aff
            counts = interpod.priority_counts(a.pref_w, a.match_cnt,
                                              a.sym_match, a.sym_w,
                                              a.sym_cnt)
            image = prio.image_locality(db.images, dc.image_kib)
            feasible, scores = eng.solver.evaluate(db, dc)
            placed = [x for _, ch in eng.schedule_batch_stream(
                pods, chunk_size=128) for x in ch]
            out[dev] = (counts.cpu().view(torch.int32), image.cpu(),
                        feasible.cpu(), scores.cpu().view(torch.int32),
                        placed, int(eng.last_node_index))
    finally:
        restore()
    c, h = out["cuda"], out["cpu"]
    for x, y in zip(c[:4], h[:4]):
        assert torch.equal(x, y)
    assert c[4:] == h[4:]
    assert float(h[0].view(torch.float32).max()) > 2048
    assert float(h[1].max()) == 2.0



@pytest.mark.cuda
def test_cuda_daemon_over_http_matches_memstore_daemon(cuda):
    """The port's daemon on cuda over HTTP against the port's apiserver
    (``mixed`` 1,000 nodes x 2,048 pods, created before the daemon
    starts) binds every pod as the daemon over a ``MemStore`` on cuda."""
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.apiserver.server import serve
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    from torch_wire import (create_lists, pod_nodes, store_nodes,
                            wait_bound, wait_settled)
    nodes = [api.node_to_json(n)
             for n in synth.make_nodes(1000, profile="mixed", n_zones=4)]
    pods = [api.pod_to_json(p)
            for p in synth.make_pods(2048, profile="mixed", n_services=4)]
    store = MemStore()
    for obj in nodes:
        store.create("nodes", obj)
    for obj in pods:
        store.create("pods", obj)
    f = ConfigFactory(store, device="cuda").run()
    try:
        local = wait_settled(lambda: store_nodes(store), 300)
    finally:
        f.stop()
    want = sum(map(bool, local.values()))
    assert want > len(pods) // 2
    wire_store = MemStore()
    srv = serve(wire_store, port=0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        create_lists(base, "nodes", nodes)
        create_lists(base, "pods", pods)
        f = ConfigFactory(base, device="cuda", qps=5000, burst=5000).run()
        try:
            wait_bound(base, want, 300)
            assert f.algorithm.device.type == "cuda"
        finally:
            f.stop()
        assert pod_nodes(base) == local
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["stream", "one-shot"])
def test_cuda_bench_density_matches_cpu(cuda, monkeypatch, setting):
    """The bench's density rig (``perf/harness.density``) at 1,000
    ``mixed`` nodes x 4,096 pods: the card binds every pod where the CPU
    does, the steady-state waves included, with 0 kernel builds after
    the warm-up and the scan kernel launched in the timed drain."""
    from kubernetes_tpu_torch.perf import harness
    made = []
    real = harness._make_daemon

    def make(*a, **k):
        made.append(real(*a, **k))
        return made[-1]
    monkeypatch.setattr(harness, "_make_daemon", make)
    runs = {dev: harness.density(1000, 4096, profile="mixed", quiet=True,
                                 setting=setting, device=dev)
            for dev in ("cuda", "cpu")}
    assert runs["cuda"].scheduled == runs["cpu"].scheduled == 4096
    assert made[0].config.binder._bound == made[1].config.binder._bound
    assert runs["cuda"].device["post_prewarm_compiles"] == 0
    assert runs["cuda"].device["launches"]["scan_chunk"] >= 1
    assert runs["cpu"].device["launches"]["scan_chunk"] == 0


@pytest.mark.cuda
def test_cuda_tenancy_daemon_matches_cpu(cuda, monkeypatch):
    """A ``KT_TENANTS`` daemon over a ``MemStore`` (``mixed`` 500 nodes
    x 1,026 pods over three tenant namespaces, weighted 2:1:1, pending
    before the first drain: over-popped, packed at 256 pods, deferred)
    binds every pod on ``cuda`` where it does on ``cpu``.  Unschedulable
    pods back off for longer than the test runs."""
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.scheduler.factory import ConfigFactory
    from torch_wire import store_nodes, wait_settled
    monkeypatch.setenv("KT_TENANTS", "t-a,t-b,t-c")
    monkeypatch.setenv("KT_TENANT_WEIGHTS", "t-a:2,t-b:1,t-c:1")
    monkeypatch.setenv("KT_POD_BACKOFF_S", "600")
    nodes = [api.node_to_json(n)
             for n in synth.make_nodes(500, profile="mixed", n_zones=4)]
    pods = []
    for i, t in enumerate(("t-a", "t-b", "t-c")):
        pods += [api.pod_to_json(p) for p in synth.make_pods(
            342, seed=i + 1, profile="mixed", n_services=4, namespace=t)]
    out = {}
    for dev in ("cuda", "cpu"):
        store = MemStore()
        for obj in nodes:
            store.create("nodes", obj)
        for obj in pods:
            store.create("pods", obj)
        f = ConfigFactory(store, device=dev)
        f.daemon.degraded_drain_cap = lambda: 256
        f.run()
        try:
            # Settled: the queue is empty and the bound count has not
            # moved for a while (a 256-pod drain on the CPU takes about
            # a second).
            out[dev] = wait_settled(
                lambda: store_nodes(store) if not len(f.daemon.queue)
                else {}, 600, quiet=3.0)
            assert f.tenancy.report()["packedSolves"] == 0
            assert all(r["mode"] == "device" for r in
                       f.tenancy.report()["tenants"].values())
        finally:
            f.stop()
    assert out["cuda"] == out["cpu"]
    assert sum(map(bool, out["cuda"].values())) > len(pods) // 2


@pytest.mark.cuda
def test_cuda_readback_rows_match_the_host_arrays(cuda):
    """``ResidentCluster.readback_rows`` on the card returns the host
    arrays' rows after a drain's assumes were scattered in."""
    eng, pods = synth.make_rig(2000, 3000, profile="mixed", device="cuda")
    for pod, dest in zip(pods, eng.schedule_batch(pods)):
        if dest is not None:
            eng.cache.assume_pod(pod, dest)
    eng.schedule_batch(pods[:16])
    c = eng.cache
    assert eng.resident.in_sync(c._nt, c.space, c.tensor_epoch)
    idx = np.random.RandomState(1).choice(2000, size=64, replace=False)
    got = eng.resident.readback_rows(idx)
    host = {"schedulable": c._nt.schedulable, "alloc": c._nt.alloc,
            "requested": c._agg.requested, "nonzero": c._agg.nonzero}
    for f in host:
        assert np.array_equal(got[f], np.asarray(host[f])[idx]), f


@pytest.mark.cuda
def test_cuda_defrag_round_matches_cpu(cuda):
    """A defragmenter round whose probe is the solver service's joint
    solve (24 price steps, then the repair through the scan kernel) on a
    fragmented fleet — 400 1-cpu nodes each full with two 300m pods, 24
    pending 600m pods — reports and evicts on ``cuda`` exactly as on
    ``cpu``."""
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    from kubernetes_tpu_torch.engine.generic_scheduler import \
        GenericScheduler
    from kubernetes_tpu_torch.scheduler.defrag import DefragController
    from kubernetes_tpu_torch.scheduler.factory import MemStoreBinder
    from kubernetes_tpu_torch.scheduler.scheduler import (Scheduler,
                                                          SchedulerConfig)
    from kubernetes_tpu_torch.tenancy.service import SolverService

    def pod_json(name, cpu, node=""):
        d = {"metadata": {"name": name, "namespace": "default"},
             "spec": {"containers": [{"name": "c", "resources": {
                 "requests": {"cpu": cpu}}}]}}
        if node:
            d["spec"]["nodeName"] = node
        return d

    out = {}
    for dev in ("cuda", "cpu"):
        store = MemStore()
        algo = GenericScheduler(device=dev)
        for i in range(400):
            node = {"metadata": {"name": f"n{i}", "labels": {
                        "kubernetes.io/hostname": f"n{i}"}},
                    "status": {"allocatable": {"cpu": "1",
                                               "memory": "64Gi",
                                               "pods": "110"},
                               "conditions": [{"type": "Ready",
                                               "status": "True"}]}}
            store.create("nodes", node)
            algo.cache.add_node(api.node_from_json(node))
            for j in range(2):
                obj = pod_json(f"s{i}-{j}", "300m", f"n{i}")
                store.create("pods", obj)
                algo.cache.add_pod(api.pod_from_json(obj))
        for b in range(24):
            store.create("pods", pod_json(f"big{b}", "600m"))
        d = Scheduler(SchedulerConfig(algorithm=algo,
                                      binder=MemStoreBinder(store),
                                      async_bind=False))
        svc = SolverService(engine=algo, tenants=["default"])
        ctrl = DefragController(
            d, store,
            probe=lambda p, svc=svc: svc.submit_background(p, joint=True))
        try:
            rep = ctrl.run_once()
            pods = {o["metadata"]["name"]: o["spec"].get("nodeName", "")
                    for o in store.list("pods")[0]}
            out[dev] = (rep, ctrl.report(), pods)
        finally:
            d.stop()
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0]["blocked"] == 24
    assert out["cuda"][0]["executed"] >= 1

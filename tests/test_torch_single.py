"""The port's single-pod path against the JAX package's, both on the same
synthetic rigs (the port on the CPU): ``Solver.evaluate`` / ``masks``,
``GenericScheduler.schedule`` with ``assume_pod`` between decisions, the
``FitError`` map, ``explain_failures``, and ``schedule`` /
``schedule_batch`` through two policy extenders served by one in-test
fake extender (healthy, then with every breaker open).

Tolerance: exact equality — placements, the uint32 round-robin counter,
the feasibility and per-predicate masks, the f32 score planes bit for
bit, the FitError maps and the explain reports (whose scores are those
planes' values)."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from kubernetes_tpu.api import policy as ref_policy_mod
from kubernetes_tpu.api import types as ref_api
from kubernetes_tpu.engine import generic_scheduler as ref_gs
from kubernetes_tpu.engine import solver as ref_sv
from kubernetes_tpu_torch.api import policy as t_policy_mod
from kubernetes_tpu_torch.api import types as t_api
from kubernetes_tpu_torch.engine import generic_scheduler as t_gs
from kubernetes_tpu_torch.engine import solver as t_sv

from torch_parity import both, host_inputs, ref_rig, same, torch_rig

N_NODES = 48

PLANE_RIGS = {"mixed": ("mixed", "default"), "rich": ("rich", "default"),
              "wide": ("mixed", "wide")}


def _pair(profile: str, n_pods: int, policy: str = "default",
          n_existing: int = 60, n_nodes: int = N_NODES):
    r_eng, r_pods, placements = ref_rig(profile, n_nodes, n_pods,
                                        n_existing=n_existing, policy=policy)
    t_eng, t_pods = torch_rig(profile, n_nodes, n_pods, placements,
                              policy=policy)
    return r_eng, r_pods, t_eng, t_pods


@pytest.mark.parametrize("rig", sorted(PLANE_RIGS))
def test_evaluate_and_masks_match_reference(rig):
    profile, policy = PLANE_RIGS[rig]
    r_eng, r_pods, t_eng, _ = _pair(profile, 24, policy)
    batch, hb, hc, _ = host_inputs(r_eng, r_pods)
    jb, jc, tb, tc = both(hb, hc)
    flags = ref_sv.batch_flags(batch)
    assert tuple(t_sv.batch_flags(hb)) == tuple(flags)
    for fl in (flags, ref_sv.ALL_ON_FLAGS):
        feas_j, scores_j = r_eng.solver.evaluate(jb, jc, fl)
        feas_t, scores_t = t_eng.solver.evaluate(tb, tc, t_sv.BatchFlags(*fl))
        assert same(feas_t, feas_j)
        assert same(scores_t, scores_j)
        assert feas_t.is_contiguous() and scores_t.is_contiguous()
        assert feas_t.any() and not feas_t.all()
    masks_j = r_eng.solver.masks(jb, jc)
    masks_t = t_eng.solver.masks(tb, tc)
    assert list(masks_t) == list(masks_j)
    for name in masks_j:
        assert same(masks_t[name], masks_j[name]), name


def _schedule_all(eng, pods, fit_error) -> list:
    out = []
    for pod in pods:
        try:
            dest = eng.schedule(pod)
        except fit_error as err:
            out.append(("FitError", err.failed_predicates))
            continue
        eng.cache.assume_pod(pod, dest)
        out.append(dest)
    return out


def _huge(api_mod, name: str = "huge"):
    return api_mod.Pod(name=name, namespace="default", containers=[
        api_mod.Container(name="c", requests={"cpu": "512", "memory": "1Ti"})])


@pytest.mark.parametrize("rig", ["mixed", "rich"])
def test_schedule_with_assume_matches_reference(rig):
    r_eng, r_pods, t_eng, t_pods = _pair(rig, 100, n_nodes=16)
    r_eng.last_node_index = np.uint32(2 ** 32 - 3)
    t_eng.last_node_index = np.uint32(2 ** 32 - 3)
    r_pods.insert(50, _huge(ref_api))
    t_pods.insert(50, _huge(t_api))
    want = _schedule_all(r_eng, r_pods, ref_gs.FitError)
    got = _schedule_all(t_eng, t_pods, t_gs.FitError)
    assert got == want
    assert int(t_eng.last_node_index) == int(r_eng.last_node_index)
    # The counter wrapped, and the 16 nodes filled up: later pods fail.
    assert int(t_eng.last_node_index) < 100
    assert ("FitError" in [x[0] for x in got if isinstance(x, tuple)])
    assert t_eng.resident.stats["row_syncs"] > 0


def test_fit_error_lists_failing_predicates_per_schedulable_node():
    r_eng, _, t_eng, _ = _pair("rich", 0)
    with pytest.raises(ref_gs.FitError) as want:
        r_eng.schedule(_huge(ref_api))
    with pytest.raises(t_gs.FitError) as got:
        t_eng.schedule(_huge(t_api))
    assert got.value.failed_predicates == want.value.failed_predicates
    assert str(got.value) == str(want.value)
    fails = got.value.failed_predicates
    # Unschedulable (NotReady) nodes are not listed; every listed node
    # fails at least PodFitsResources.
    assert 0 < len(fails) < N_NODES
    assert all("PodFitsResources" in v for v in fails.values())
    assert int(t_eng.last_node_index) == 0


def test_schedule_on_an_empty_cluster_raises_fit_error():
    eng = t_gs.GenericScheduler(device="cpu")
    with pytest.raises(t_gs.FitError) as err:
        eng.schedule(_huge(t_api))
    assert err.value.failed_predicates == {}


def test_non_finite_score_plane_raises(monkeypatch):
    _, _, t_eng, t_pods = _pair("mixed", 1)
    real = t_eng.solver.evaluate

    def poisoned(b, c, flags):
        feasible, scores = real(b, c, flags)
        scores[0, 3] = float("nan")
        return feasible, scores

    monkeypatch.setattr(t_eng.solver, "evaluate", poisoned)
    with pytest.raises(t_gs.ScoreGateError, match="NaN/inf"):
        t_eng.schedule(t_pods[0])
    assert int(t_eng.last_node_index) == 0


def test_explain_failures_matches_reference():
    r_eng, r_pods, t_eng, t_pods = _pair("rich", 6)
    r_pods = r_pods + [_huge(ref_api)]
    t_pods = t_pods + [_huge(t_api)]
    want = r_eng.explain_failures(r_pods)
    got = t_eng.explain_failures(t_pods)
    assert got == want
    assert got["default/huge"]["failed_predicates"]["PodFitsResources"] > 0
    assert t_eng.explain_failures([]) == {}
    empty = t_gs.GenericScheduler(device="cpu")
    assert empty.explain_failures(t_pods[:1]) == \
        ref_gs.GenericScheduler().explain_failures(r_pods[:1])


# -- extenders ----------------------------------------------------------


class _FakeExtender(BaseHTTPRequestHandler):
    """Filter keeps nodes whose index is not a multiple of 3 (the rest
    fail with a message); prioritize scores node i as i % 4."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        args = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        items = args["nodes"]["items"]
        idx = [int(it["metadata"]["name"].rsplit("-", 1)[1]) for it in items]
        if self.path.endswith("/filter"):
            body = {"nodes": {"items": [it for it, i in zip(items, idx)
                                        if i % 3]},
                    "failedNodes": {it["metadata"]["name"]: "fake: i % 3"
                                    for it, i in zip(items, idx)
                                    if not i % 3}}
        else:
            body = [{"host": it["metadata"]["name"], "score": i % 4}
                    for it, i in zip(items, idx)]
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def fake_extender():
    server = HTTPServer(("127.0.0.1", 0), _FakeExtender)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _with_extenders(eng, policy_mod, url: str, **kw):
    policy = policy_mod.default_provider()
    policy.extenders = [
        policy_mod.ExtenderConfig(url_prefix=f"{url}/a", filter_verb="filter",
                                  prioritize_verb="prioritize", weight=2),
        policy_mod.ExtenderConfig(url_prefix=f"{url}/b",
                                  prioritize_verb="prioritize", weight=1)]
    return type(eng)(policy=policy, cache=eng.cache, listers=eng.listers,
                     **kw)


def _extender_pair(url: str, n_pods: int):
    r_eng, r_pods, t_eng, t_pods = _pair("mixed", n_pods, n_nodes=12)
    r_eng = _with_extenders(r_eng, ref_policy_mod, url)
    t_eng = _with_extenders(t_eng, t_policy_mod, url, device="cpu")
    return r_eng, r_pods, t_eng, t_pods


@pytest.mark.parametrize("breaker", ["healthy", "open"])
def test_schedule_through_extenders_matches_reference(fake_extender,
                                                      breaker):
    r_eng, r_pods, t_eng, t_pods = _extender_pair(fake_extender, 30)
    if breaker == "open":
        for eng in (r_eng, t_eng):
            for ext in eng.extenders:
                for _ in range(3):
                    ext.breaker.record_failure()
                assert not ext.breaker.allow()
    want = _schedule_all(r_eng, r_pods, ref_gs.FitError)
    got = _schedule_all(t_eng, t_pods, t_gs.FitError)
    assert got == want
    assert int(t_eng.last_node_index) == int(r_eng.last_node_index)
    placed = [x for x in got if isinstance(x, str)]
    assert placed
    on_third = [x for x in placed if int(x.rsplit("-", 1)[1]) % 3 == 0]
    # The healthy filter keeps every third node empty; with the breakers
    # open the built-in predicates alone decide.
    assert (not on_third) == (breaker == "healthy")


def test_schedule_batch_goes_through_extenders(fake_extender):
    r_eng, r_pods, t_eng, t_pods = _extender_pair(fake_extender, 12)
    want = r_eng.schedule_batch(r_pods)
    got = t_eng.schedule_batch(t_pods)
    assert got == want and any(got)
    assert int(t_eng.last_node_index) == int(r_eng.last_node_index)
    # The temporary assumes are forgotten again.
    assert not any(t_eng.cache.is_assumed(p.key) for p in t_pods)
    # With extenders the reference takes the per-pod path whatever the
    # mode, so joint=True does too.
    assert t_eng.schedule_batch(t_pods, joint=True) == \
        r_eng.schedule_batch(r_pods, joint=True)

"""The port's bench (``kubernetes_tpu_torch/perf/{harness,bench}.py``)
against the JAX package's ``perf/harness.py`` and root ``bench.py``, on
the CPU.

* ``density`` at 64 ``mixed`` nodes x 300 pods, with and without 100
  pre-existing pods, binds the same count and the same pod -> node map
  (the steady-state waves included) as the JAX package's ``density`` on
  the same seeds, for both settings; the stage breakdown has the JAX
  package's keys, and the result records its setting.
* ``density_wire`` at 32 x 128 against the port's Python apiserver
  binds every pod; a rig that binds nothing raises ``ZeroBoundError``.
* The bench's artifact carries the JAX package's artifact keys
  (``BENCH_r16.json``), less the ones it names as left out; its
  ``backend`` is ``cpu`` on the CPU; ``--device cuda`` without a card
  exits non-zero; the JAX package's record names are refused.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from kubernetes_tpu.perf import harness as ref_harness
from kubernetes_tpu_torch.perf import harness

REPO = Path(__file__).resolve().parents[1]


def _capture(monkeypatch, mod) -> list:
    made = []
    real = mod._make_daemon

    def make(*a, **k):
        d = real(*a, **k)
        made.append(d)
        return d
    monkeypatch.setattr(mod, "_make_daemon", make)
    return made


@pytest.mark.parametrize("setting,preexisting", [
    ("stream", 0), ("one-shot", 100)])
def test_density_places_as_the_reference(monkeypatch, setting,
                                         preexisting):
    port_made = _capture(monkeypatch, harness)
    ref_made = _capture(monkeypatch, ref_harness)
    got = harness.density(64, 300, profile="mixed",
                          preexisting=preexisting, quiet=True,
                          setting=setting, device="cpu")
    want = ref_harness.density(64, 300, profile="mixed",
                               preexisting=preexisting, quiet=True)
    assert got.scheduled == want.scheduled == 300
    assert port_made[0].config.binder._bound == \
        ref_made[0].config.binder._bound
    assert set(got.stages) == set(want.stages)
    assert got.setting == setting and got.route["setting"] == setting
    assert got.route["stream_threshold"] == \
        (4096 if setting == "stream" else 1 << 62)
    assert set(got.device) >= set(want.device)
    assert got.device["post_prewarm_compiles"] == 0
    assert got.device["engine_mode_final"] == "device"
    # The split's fractions appear once the window saw CPU (data-driven).
    base = {"wall_s", "enabled", "samples", "cpu_seconds",
            "sampler_self_cpu_s"}
    assert base <= set(got.profile) and base <= set(want.profile)
    assert set(got.profile) - base <= {"cpu_fraction",
                                       "unclassified_fraction"}


def test_stage_breakdown_diffs_two_snapshots():
    before = {"solve": (10.0, 1), "bind": (5.0, 2)}
    after = {"solve": (2_000_010.0, 3), "bind": (5.0, 2),
             "assume": (7.0, 1)}
    assert harness.stage_breakdown(before, after) == \
        ref_harness.stage_breakdown(before, after) == {
            "assume": {"seconds": 7e-06, "count": 1},
            "solve": {"seconds": 2.0, "count": 2}}


def test_density_wire_binds_every_pod_over_the_python_apiserver(
        monkeypatch):
    monkeypatch.setenv("KT_NATIVE_APISERVER", "0")
    monkeypatch.setenv("KT_WIRE_CHUNK", "256")
    r = harness.density_wire(32, 128, profile="mixed", quiet=True,
                             device="cpu",
                             status_routes=("/debug/timeseries",))
    assert (r.scheduled, r.num_pods, r.apiserver) == (128, 128, "python")
    assert r.setting == "stream" and r.route["stream_chunk"] == 256
    assert r.route["formation_deadline_ms"] == 20.0
    assert r.status_routes == {"/debug/timeseries":
                               [200, "application/json"]}
    assert r.post_prewarm_compiles == 0
    assert r.profile["enabled"] and r.profile["wire"]["decode"]["events"]
    assert r.elapsed_s > 0 and r.timeline[-1][1] == 128
    assert set(r.stages) >= {"compile", "solve", "bind"}


def test_density_wire_raises_on_a_rig_that_binds_nothing(monkeypatch):
    monkeypatch.setenv("KT_NATIVE_APISERVER", "0")
    with pytest.raises(harness.ZeroBoundError, match="bound 0/8"):
        harness.density_wire(0, 8, quiet=True, device="cpu",
                             setting="one-shot", timeout_s=1.0)


def test_settings_are_checked():
    with pytest.raises(ValueError, match="setting"):
        harness.density(4, 4, setting="tpu", device="cpu")


def test_the_artifact_carries_the_reference_keys(tmp_path, monkeypatch):
    from kubernetes_tpu_torch.perf import bench, serving, workloads
    for k, v in {"BENCH_NODES": "16", "BENCH_PODS": "48",
                 "BENCH_DENSITY_RUNS": "2", "BENCH_WIRE_RUNS": "1",
                 "BENCH_WL_NODES": "20", "BENCH_WL_PODS": "80",
                 "KT_NATIVE_APISERVER": "0", "KT_WIRE_CHUNK": "256"
                 }.items():
        monkeypatch.setenv(k, v)
    real_joint = workloads.joint_quality

    def small_joint(*_shape, device="cuda"):
        return real_joint(20, 80, device=device)
    monkeypatch.setattr(workloads, "joint_quality", small_joint)

    def small_serving(trickle_s, device):
        row = serving.run_workload(
            "poisson", serving.poisson_arrivals(20.0, 0.5), n_nodes=8,
            stream_chunk=256, quiet=True, device=device)
        return {"deadline_ms": 100.0, "trickle": {"duration_s": trickle_s},
                "workloads": {"poisson_trickle": row, "burst_replay": row,
                              "ramp": row},
                "device": {"post_prewarm_compiles": 0}}
    monkeypatch.setattr(serving, "collect", small_serving)
    out = tmp_path / "BENCH_cpu.json"
    assert bench.main(["--device", "cpu", "--out", str(out),
                       "--serving-trickle-s", "0.5"]) == 0
    art = json.loads(out.read_text())
    ref = json.loads((REPO / "BENCH_r16.json").read_text())["parsed"]
    assert set(ref) - set(art) == set(bench.LEFT_OUT) & set(ref)
    assert set(bench.LEFT_OUT) == {"cold_vs_warm", "soak", "tenancy",
                                   "fleet", "xray"}
    assert set(art["wire"]) >= set(ref["wire"])
    assert set(art["joint"]) == set(ref["joint"])
    assert set(art["device"]) >= set(ref["device"])
    assert set(art["profile"]) >= set(ref["profile"])
    assert art["backend"] == "cpu" and "card" not in art
    assert set(art["serving"]) >= {"deadline_ms", "trickle_p50_ms",
                                   "trickle_p99_ms",
                                   "trickle_slo_attainment_pct",
                                   "burst_p99_ms", "goodput_pods_s"}
    assert set(art["workloads"]) >= {"joint_vs_greedy", "joint_warm_s",
                                     "preemption_parity_pct",
                                     "gang_warm_solve_s",
                                     "partial_gangs_bound"}
    assert set(art["settings"]) == {"stream", "one-shot"}
    for block in art["settings"].values():
        assert len(block["runs"]) == 2
        assert block["elapsed_s_spread"]["min"] <= block["elapsed_s_p50"]
    assert art["wire"]["zero_bound_runs"] == 0
    assert art["wire"]["failed_runs"] == 0
    assert art["post_prewarm_compiles"] == 0 and art["failures"] == []
    assert (tmp_path / "WORKLOADS_cpu.json").exists()
    assert (tmp_path / "SERVING_cpu.json").exists()


def test_the_bench_refuses_a_missing_card_and_reference_records():
    from kubernetes_tpu_torch.perf import bench
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as err:
            bench.main(["--device", "cuda"])
        assert err.value.code not in (0, None)
        assert "no CUDA device" in str(err.value.code)
    with pytest.raises(SystemExit, match="record of the JAX package"):
        bench.main(["--device", "cpu", "--out", "BENCH_r16.json"])

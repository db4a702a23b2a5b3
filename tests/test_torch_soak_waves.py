"""The soak's waves beside the churn run (``kubernetes_tpu_torch/perf/
soak.py``), each at a toy size on the port with ``device="cpu"``, each
passing ``soak.violations`` for its section: the near-capacity wave, the
tenancy poison wave, the apiserver-kill wave (a ``python -m
kubernetes_tpu_torch.apiserver --storage-dir`` SIGKILLed
mid-avalanche), the overload wave, the defrag wave and the in-process HA
wave; and the record ``collect`` assembles from them, each wave's
seconds and kernel launches under ``waves``."""

from __future__ import annotations

from kubernetes_tpu_torch.perf import soak


def _passes(section: str, rec: dict) -> None:
    missed = soak.violations({section: rec})
    assert missed == [], missed


def test_capacity_wave():
    rec = soak.run_capacity_wave(n_nodes=6, pods_per_node=5, quiet=True,
                                 device="cpu")
    _passes("capacity", rec)
    assert rec["overcommit_probes"] > 0
    assert rec["bind_capacity_rejects"] >= rec["overcommit_probes"]
    assert rec["bound"] == rec["offered"]


def test_tenancy_poison_wave():
    rec = soak.run_tenancy_poison_wave(n_nodes=12, pods_per_tenant=20,
                                       quiet=True, device="cpu")
    _passes("tenancy_poison", rec)
    assert rec["bound"] == rec["offered"] == 60 and rec["repromoted"]


def test_apiserver_kill_wave():
    rec = soak.run_apiserver_kill_wave(n_nodes=20, avalanche_pods=300,
                                       kill_at_bound=40, quiet=True,
                                       device="cpu")
    _passes("apiserver_kill", rec)
    assert rec["acked_creates"] == 300 and rec["wal_records_audited"] > 0


def test_overload_wave():
    """Its scheduler runs as a ``python -m kubernetes_tpu_torch.scheduler
    --device cpu`` process, its storm's 48 clients in two processes."""
    rec = soak.run_overload_wave(n_nodes=20, calibration_pods=60,
                                 storm_threads=48, attempts_per_thread=60,
                                 quiet=True, device="cpu")
    _passes("overload", rec)
    assert rec["goodput_pods_per_s"] > 0 and rec["leases_held_final"] == 4
    assert rec["daemon_launches"] == {"scan_chunk": 0, "select_rows": 0,
                                      "select_hosts": 0}


def test_defrag_wave():
    rec = soak.run_defrag_wave(quiet=True, device="cpu")
    _passes("defrag", rec)
    assert rec["blocked_larges_bound"] == rec["large_pods"] == 3


def test_ha_wave_in_process():
    rec = soak.run_ha_wave(n_nodes=8, n_shards=4, n_incarnations=2,
                           n_namespaces=6, seed_pods=30, storm_waves=2,
                           wave_pods=20, kill_wave_pods=30, lease_s=0.4,
                           stream_chunk=64, settle_timeout=60.0,
                           processes=False, quiet=True, device="cpu")
    _passes("ha", rec)
    assert rec["pods_bound"] == rec["pods_created"]
    assert rec["lease_handoffs"] >= 1


def test_collect_records_each_wave(monkeypatch):
    """``collect`` with every wave beside the churn run switched off
    but the capacity wave: the record holds both waves' seconds and
    launches (0 on the CPU), the device and profile sections."""
    for name in ("HA", "TENANCY_POISON", "KILL", "OVERLOAD", "DEFRAG"):
        monkeypatch.setenv(f"BENCH_SOAK_{name}", "0")
    rec = soak.collect(device="cpu", n_nodes=6, duration_s=0.5,
                       seed_pods=12, storm_pods=20, rolling_waves=1,
                       wave_size=6, drain_nodes=1, kill_burst=10,
                       high_watermark=16, stream_chunk=64,
                       heartbeat_period=0.5, verify_period=0.5,
                       settle_timeout=120, parity_samples=4,
                       restart=False, device_chaos=False, quiet=True)
    assert set(rec["waves"]) == {"soak", "capacity"}
    for wave in rec["waves"].values():
        assert wave["seconds"] > 0
        assert wave["launches"] == {"scan_chunk": 0, "select_rows": 0,
                                    "select_hosts": 0}
    assert "capacity" in rec and "ha" not in rec
    assert {"transfer_bytes", "bytes_per_pod",
            "hbm_peak_bytes_process"} <= set(rec["device"])
    assert "profile" in rec and rec["locktrace"]["lock_inversions"] == 0
    assert soak.violations(rec) == []


def test_soak_repeat_summarises_each_run(monkeypatch, tmp_path, capsys):
    """``perf/soak_repeat.py`` runs the wave N times (here a stand-in
    that returns one clean and one failing overload record) and exits 1
    when a run misses a bar."""
    import json

    from kubernetes_tpu_torch.perf import soak_repeat
    clean = {"shed_429": 9, "goodput_pods_per_s": 40.0, "queue_limit": 16,
             "max_queue_depth": 16, "debug_vars_samples": 30,
             "debug_vars_errors": 0, "offered_multiple": 6.0,
             "daemon_launches": {"scan_chunk": 3}}
    records = iter([clean, dict(clean, debug_vars_errors=1)])
    monkeypatch.setattr(soak, "run_overload_wave",
                        lambda quiet, device: next(records))
    out = tmp_path / "overload.json"
    assert soak_repeat.main(["--wave", "overload", "--runs", "2",
                             "--device", "cpu", "--out", str(out)]) == 1
    runs = json.loads(out.read_text())["runs"]
    assert [r["violations"] for r in runs] == [
        [], ["overload: /debug/vars answered 30 samples with 1 errors"]]
    assert runs[0]["daemon_launches"] == {"scan_chunk": 3}
    assert len(capsys.readouterr().out.splitlines()) == 2

"""The port's churn soak (``kubernetes_tpu_torch/perf/soak.py``) against
the JAX package's, on the CPU.

* The mini soak of ``tests/test_soak_recovery.py`` (the same arguments,
  ``device="cpu"`` on the port) runs on both packages: the JAX package's
  in a child interpreter, the port's here, at once.  Both records show
  0 invariant violations, 0 reconciliation faults and 100% restart
  parity; their key sets are the same apart from the fields
  ``soak.DIFFERENCES`` names (the breaker adaptation); the port's
  device-lost wave opened the breaker and re-promoted the card, and its
  record passes ``soak.violations``.
* ``violations`` passes a clean record and fires on a record that
  misses each bar.
* Every wave, ``collect`` and ``main`` raise without a card when no
  ``device`` is given, before they start anything.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.perf import soak

REPO = Path(__file__).resolve().parents[1]

MINI = dict(n_nodes=10, duration_s=2.0, seed_pods=30, storm_pods=80,
            rolling_waves=1, wave_size=15, drain_nodes=2, kill_burst=40,
            high_watermark=40, stream_chunk=256, heartbeat_period=0.5,
            verify_period=0.5, settle_timeout=120, parity_samples=8,
            quiet=True)

_REFERENCE = r"""
import json, sys
from kubernetes_tpu.perf.soak import run_soak
rec = run_soak(**json.loads(sys.argv[1]))
print(json.dumps(rec, default=str))
"""


def _reference_soak() -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             json.dumps(MINI)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _renamed(path: str) -> str:
    """The JAX record's name of a port field (``DIFFERENCES``)."""
    for d in soak.DIFFERENCES:
        if d["field"] == path:
            return d["reference"]
    return path


# Sections whose keys are data (fault kinds, stage names), not fields.
_DATA_KEYED = ("device_faults", "solve_fallbacks", "stages")


def _key_paths(rec: dict) -> set[str]:
    """Top-level keys and the keys of each top-level section."""
    out = set()
    for k, v in rec.items():
        out.add(k)
        if isinstance(v, dict) and k not in _DATA_KEYED:
            out |= {f"{k}.{kk}" for kk in v}
    return out


def test_mini_soak_on_both_packages():
    proc = _reference_soak()
    try:
        rec = soak.run_soak(device="cpu", **MINI)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    for r in (rec, ref):
        assert r["invariant_violations"] == 0
        assert set(r["reconciliation"].values()) - {0} == \
            {r["reconciliation"]["pods_bound"]}
        assert r["restart_parity"]["decision_parity_pct"] == 100.0
        assert r["restart"]["killed_mid_drain"] is True
        assert r["queue_depth"]["monotonic_growth"] is False
        assert r["scale"]["pods_scheduled_total"] >= 30
        assert r["verifier_passes"] >= 1
    assert soak.violations(rec) == []
    assert rec["device_lost_wave"] == {"tripped": True, "repromoted": True}
    assert rec["engine_mode_final"] == "device"
    assert rec["breaker_open_seconds"] > 0 and rec["requeued_pods"] > 0
    assert rec["backend"] == "cpu"
    # The same key set apart from the named differences.
    port_keys = {_renamed(k) for k in _key_paths(rec)} - {"differences"}
    assert port_keys == _key_paths(ref)
    assert {d["field"] for d in rec["differences"]} == {
        "requeued_pods", "breaker_open_seconds", "device_lost_wave.tripped"}
    assert {d["reference"] for d in rec["differences"]} <= \
        _key_paths(ref)


def _clean() -> dict:
    """A record that passes every bar, with every section present."""
    return {
        "invariant_violations": 0,
        "reconciliation": {"pods_bound": 10, "stranded_pending": 0,
                           "orphaned_assumes": 0, "double_binds": 0,
                           "bound_to_missing_node": 0},
        "queue_depth": {"monotonic_growth": False,
                        "steady_window_slope_pods_per_s": 0.1},
        "restart_parity": {"samples": 8, "decision_parity_pct": 100.0},
        "sanity_gate": {"rejects": 0, "rejected_binds": 0},
        "engine_mode_final": "device",
        "device_lost_wave": {"tripped": True, "repromoted": True},
        "capacity": {"overcommitted_nodes": 0, "stranded_pending": 0},
        "tenancy_poison": {"offered": 9, "bound": 9, "repromoted": True},
        "locktrace": {"lock_inversions": 0, "long_holds": 0},
        "ha": {"double_binds": 0, "stranded_pending": 0,
               "invariant_violations": 0,
               "takeover": {"takeover_settle_s": 0.6}},
        "apiserver_kill": {"acked_writes_lost": 0, "double_binds": 0,
                           "stranded_pending": 0,
                           "killed_mid_avalanche": True,
                           "bound_at_kill": 150, "pending_at_kill": 600,
                           "relists": 20},
        "overload": {"shed_429": 100, "lease_expiries": 0,
                     "system_rejected": 0, "stranded_pending": 0,
                     "max_queue_depth": 16, "queue_limit": 16,
                     "goodput_pods_per_s": 20.0, "debug_vars_samples": 40,
                     "debug_vars_errors": 0, "offered_multiple": 5.0},
        "defrag": {"defrag_gain": 0.75, "migrations_executed": 4,
                   "pdb_violations": 0, "stranded": 0,
                   "lingering_intents": 0, "double_binds": 0,
                   "double_capacity": 0, "invariant_violations": 0,
                   "migration_cap": 4, "max_batch": 2,
                   "killed_mid_migration": True,
                   "migrations_recovered": 1},
    }


# (path into the record, the value that misses the bar, words of the
# violation it must raise)
BARS = [
    ("invariant_violations", 1, "invariant violation"),
    ("reconciliation.double_binds", 1, "double_binds"),
    ("reconciliation.stranded_pending", 2, "stranded_pending"),
    ("reconciliation.orphaned_assumes", 1, "orphaned_assumes"),
    ("reconciliation.bound_to_missing_node", 1, "bound_to_missing_node"),
    ("queue_depth.monotonic_growth", True, "grew monotonically"),
    ("restart_parity.decision_parity_pct", 87.5, "restart parity"),
    ("sanity_gate.rejected_binds", 1, "gate-rejected"),
    ("engine_mode_final", "open", "'open'"),
    ("device_lost_wave.repromoted", False, "never re-promoted"),
    ("capacity.overcommitted_nodes", 1, "overcommitted"),
    ("capacity.stranded_pending", 1, "capacity: 1 pod(s) stranded"),
    ("tenancy_poison.bound", 8, "bound 8 of 9"),
    ("tenancy_poison.repromoted", False, "not re-promoted"),
    ("locktrace.lock_inversions", 1, "inversion"),
    ("locktrace.long_holds", 1, "long lock hold"),
    ("ha.double_binds", 1, "ha: 1 double_binds"),
    ("ha.stranded_pending", 1, "ha: 1 stranded_pending"),
    ("ha.invariant_violations", 1, "ha: 1 invariant_violations"),
    ("ha.takeover.takeover_settle_s", 1.2, "takeover settled"),
    ("apiserver_kill.acked_writes_lost", 1, "acked_writes_lost"),
    ("apiserver_kill.double_binds", 1, "apiserver kill: 1 double_binds"),
    ("apiserver_kill.stranded_pending", 1, "kill: 1 stranded_pending"),
    ("apiserver_kill.killed_mid_avalanche", False, "mid-avalanche"),
    ("apiserver_kill.relists", 0, "0 reflector relists"),
    ("overload.shed_429", 0, "0 shed"),
    ("overload.lease_expiries", 1, "lease_expiries"),
    ("overload.system_rejected", 1, "system_rejected"),
    ("overload.stranded_pending", 1, "overload: 1 stranded_pending"),
    ("overload.max_queue_depth", 17, "past its limit"),
    ("overload.goodput_pods_per_s", 0.0, "zero goodput"),
    ("overload.debug_vars_errors", 1, "/debug/vars"),
    ("overload.debug_vars_samples", 0, "/debug/vars"),
    ("overload.offered_multiple", 2.5, "bar: >= 3x"),
    ("defrag.defrag_gain", 0.0, "defrag: gain"),
    ("defrag.migrations_executed", 0, "0 migrations executed"),
    ("defrag.pdb_violations", 1, "pdb_violations"),
    ("defrag.stranded", 1, "defrag: 1 stranded"),
    ("defrag.lingering_intents", 1, "lingering_intents"),
    ("defrag.double_binds", 1, "defrag: 1 double_binds"),
    ("defrag.double_capacity", 1, "double_capacity"),
    ("defrag.invariant_violations", 1, "defrag: 1 invariant_violations"),
    ("defrag.max_batch", 5, "past the cap"),
    ("defrag.killed_mid_migration", False, "mid-migration"),
    ("defrag.migrations_recovered", 0, "requeued no migrant"),
]


def test_a_clean_record_passes_and_an_empty_one_holds_no_bar():
    assert soak.violations(_clean()) == []
    assert soak.violations({}) == []


@pytest.mark.parametrize("path,value,words", BARS,
                         ids=[b[0] for b in BARS])
def test_violations_fire_for_each_bar(path, value, words):
    rec = copy.deepcopy(_clean())
    *parents, leaf = path.split(".")
    node = rec
    for key in parents:
        node = node[key]
    node[leaf] = value
    missed = soak.violations(rec)
    assert len(missed) == 1 and words in missed[0], missed


def test_ha_without_a_takeover_is_a_violation():
    rec = _clean()
    rec["ha"]["takeover"] = {}
    assert soak.violations(rec) == ["ha: no takeover_settle_s (the kill "
                                    "never ran)"]


WAVES = ["run_soak", "run_ha_wave", "run_capacity_wave",
         "run_tenancy_poison_wave", "run_apiserver_kill_wave",
         "run_overload_wave", "run_defrag_wave", "collect"]


@pytest.mark.parametrize("name", WAVES)
def test_every_wave_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(soak, name)(quiet=True)
    assert threading.active_count() == threads  # nothing was started


def test_main_exits_non_zero_without_a_card_and_refuses_reference_names():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as err:
            soak.main([])
        assert "no CUDA device" in str(err.value.code)
    with pytest.raises(SystemExit, match="record of the JAX package"):
        soak.main(["--device", "cpu", "--out", "SOAK_r17.json"])

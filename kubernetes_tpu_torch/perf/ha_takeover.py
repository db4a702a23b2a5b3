"""The HA takeover of ``chip_smoke.py`` 19b, run N times, with records of
the incarnations' lease threads.

Each run is ``chip_smoke.phase_ha``: three ``python -m
kubernetes_tpu_torch.scheduler --api-server`` incarnations over the
native apiserver (``KT_HA_SHARDS=8``, a 0.45 s lease), the north star's
pods posted, one incarnation SIGKILLed at a third bound, the takeover
timed by the leases' stamps against its 1 s bar.  Every incarnation
starts with ``<out>`` first on its ``PYTHONPATH``, where this module
writes a ``sitecustomize.py`` that records, into
``<out>/run<i>/<incarnation>.jsonl``, each shard-lease round trip, each
shard-manager tick, each ownership change, each takeover or sweep
relist, and each collection of 5 ms or more or of generation 2.  The
summary gives, per survivor within a second of the kill, the longest
collection, lease round trip and tick, and the relists.

Run from the root of a checkout, on the card::

    python -m kubernetes_tpu_torch.perf.ha_takeover --runs 5 \\
        --out chiprun_out/ha

``--device cpu --nodes 60 --pods 600`` rehearses it without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

SITE = '''
import os
if os.environ.get("KT_HA_RECORDS") and os.environ.get("KT_INCARNATION"):
    import gc, json, sys, threading, time
    _out = open(os.path.join(os.environ["KT_HA_RECORDS"],
                             os.environ["KT_INCARNATION"] + ".jsonl"),
                "w", buffering=1)
    _mu = threading.Lock()

    def rec(**kw):
        kw["t"] = round(time.monotonic(), 4)
        kw["th"] = threading.current_thread().name[:24]
        with _mu:
            _out.write(json.dumps(kw) + "\\n")

    _gc = {}

    def _gccb(phase, info):
        if phase == "start":
            _gc["t"] = time.monotonic()
            return
        d = time.monotonic() - _gc.get("t", time.monotonic())
        if d > 0.005 or info["generation"] == 2:
            rec(ev="gc", gen=info["generation"], d=round(d, 4))
    gc.callbacks.append(_gccb)

    def _patch():
        mods = ["kubernetes_tpu_torch.scheduler." + m
                for m in ("shards", "recovery")]
        while not all(m in sys.modules for m in mods):
            time.sleep(0.02)
        sh, rc = (sys.modules[m] for m in mods)
        SM = sh.ShardManager
        tick0, try0, tr0 = SM.tick, SM._try_lease, SM._transition
        list0 = rc.list_pending

        def tick(self):
            t = time.monotonic()
            tick0(self)
            rec(ev="tick", start=round(t, 4),
                d=round(time.monotonic() - t, 4))

        def _try_lease(self, shard, el):
            t = time.monotonic()
            held = self.owns_shard(shard)
            ok = try0(self, shard, el)
            rec(ev="try", s=shard, held=held, ok=ok,
                h=el.observed_holder(), rem=round(el.lease_remaining(), 3),
                d=round(time.monotonic() - t, 4))
            return ok

        def _transition(self, shard, owned, handoff=False):
            rec(ev="own" if owned else "lose", s=shard)
            return tr0(self, shard, owned, handoff)

        def list_pending(store):
            t = time.monotonic()
            items = list0(store)
            rec(ev="relist", start=round(t, 4), n=len(items),
                d=round(time.monotonic() - t, 4))
            return items
        SM.tick, SM._try_lease, SM._transition = tick, _try_lease, \\
            _transition
        rc.list_pending = list_pending
    threading.Thread(target=_patch, daemon=True).start()
'''


def summarize(records: dict, t_kill: float, window: float = 1.0) -> dict:
    """Per incarnation, within ``window`` s after ``t_kill`` (and 0.2 s
    before it): the longest collection, lease round trip and tick, and
    the relists (start after the kill, items, s)."""
    out = {}
    for name, events in sorted(records.items()):
        near = [e for e in events
                if t_kill - 0.2 <= e["t"] <= t_kill + window]
        out[name] = {
            "gc_max_s": max((e["d"] for e in near if e["ev"] == "gc"),
                            default=0.0),
            "round_trip_max_s": max(
                (e["d"] for e in near if e["ev"] == "try"), default=0.0),
            "tick_max_s": max((e["d"] for e in near if e["ev"] == "tick"),
                              default=0.0),
            "relists": [(round(e["start"] - t_kill, 3), e["n"], e["d"])
                        for e in near if e["ev"] == "relist"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.perf.ha_takeover",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/ha")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    (out / "sitecustomize.py").write_text(SITE)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(out)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    if args.device == "cuda":
        from kubernetes_tpu_torch.engine import kernels
        kernels.build()
        card = cs.card_line()
    else:
        card = "cpu"
    print(f"ha_takeover: {card}, {args.nodes} nodes x {args.pods} pods, "
          f"{args.runs} runs", flush=True)
    kills: list = []
    leases = cs.shard_leases

    def shard_leases(conn):
        # phase_ha reads the leases once right before the kill.
        if not kills:
            kills.append(time.monotonic())
        return leases(conn)
    cs.shard_leases = shard_leases
    failed = 0
    for i in range(args.runs):
        run = out / f"run{i}"
        run.mkdir(exist_ok=True)
        os.environ["KT_HA_RECORDS"] = str(run)
        kills.clear()
        try:
            res = cs.phase_ha(args.nodes, args.pods, card, args.device)
            verdict = f"takeover {res['takeover_s']:.3f} s"
        except SystemExit as err:
            failed += 1
            verdict = f"failed: {err}"
        records = {f.stem: [json.loads(line) for line in open(f)]
                   for f in sorted(run.glob("*.jsonl"))}
        near = summarize(records, kills[0]) if kills else {}
        print(f"ha_takeover: run {i}: {verdict}; near the kill "
              f"{json.dumps(near)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

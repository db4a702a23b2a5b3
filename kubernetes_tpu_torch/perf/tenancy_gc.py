"""What the daemon's startup heap freeze does to the tenancy bench's tail.

Run from the root of a checkout (on a card, or with ``--device cpu``)::

    python -m kubernetes_tpu_torch.perf.tenancy_gc --pairs 3

``ConfigFactory.run()`` collects and freezes the heap before the drain
loop starts (``gc.freeze``), so a generation-2 collection no longer walks
the few hundred thousand objects of torch, this package and the synced
cache.  This script runs the tenancy bench (``perf/tenancy.collect`` at
its defaults) in fresh processes, in pairs, alternating which runs first:
once as the daemon runs, and once with ``gc.freeze`` replaced by a no-op
in that process (nothing else there calls it).  Each run records every
generation-2 collection (``gc.callbacks``) and prints the trickle rows'
p99, the interference ratio and the collections' count and longest
pause.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import gc, json, sys, time
freeze = sys.argv[1] == "on"
if not freeze:
    gc.freeze = lambda: None
pauses = []
start = [0.0]

def on_gc(phase, info):
    if info["generation"] != 2:
        return
    if phase == "start":
        start[0] = time.perf_counter()
    else:
        pauses.append(time.perf_counter() - start[0])

gc.callbacks.append(on_gc)
from kubernetes_tpu_torch.perf import tenancy
rec = tenancy.collect(device=sys.argv[2], quiet=True)
rows = rec["rows"]
print(json.dumps({
    "freeze": freeze,
    "solo_p99_ms": rows["trickle_solo"]["latency_ms"]["p99"],
    "with_neighbor_p99_ms": rows["trickle_with_neighbor"]["latency_ms"]["p99"],
    "noisy_p99_ms": rows["noisy_neighbor"]["latency_ms"]["p99"],
    "ratio": rec["interference"]["ratio"],
    "fairness_error": rec["fairness"]["max_rel_error"],
    "gen2_collections": len(pauses),
    "gen2_max_ms": round(max(pauses or [0.0]) * 1e3, 3),
    "gen2_total_ms": round(sum(pauses) * 1e3, 3)}), flush=True)
"""


def run(freeze: bool, device: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD, "on" if freeze else "off", device],
        capture_output=True, text=True, check=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for i in range(args.pairs):
        order = (False, True) if i % 2 == 0 else (True, False)
        for freeze in order:
            res = run(freeze, args.device)
            print(f"tenancy_gc: pair {i + 1} {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    main()

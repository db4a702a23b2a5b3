"""What the sampling CPU profiler costs the wire path: ``density_wire``
runs with the profiler on (``KT_PROF=1``) and off (``KT_PROF=0``), in
turns, each in a fresh process (the knob is read at import).

``python -m kubernetes_tpu_torch.perf.profiler_cost [--pairs 2]
[--nodes 5000] [--pods 30000] [--settings stream,one-shot] [--device
cuda]`` prints one JSON line per run and a summary line: per setting,
the wall seconds of every run with the profiler on and off, in the
order they ran (on, off, off, on, ...).  With it off the bench's
``profile`` section carries no CPU split; the wire accounting counters
(decode, handler, serialize) are kept either way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = r"""
import json, sys
from kubernetes_tpu_torch.perf import harness
r = harness.density_wire(int(sys.argv[1]), int(sys.argv[2]),
                         profile="mixed", setting=sys.argv[3],
                         device=sys.argv[4], quiet=True)
print(json.dumps({"elapsed_s": r.elapsed_s, "scheduled": r.scheduled,
                  "apiserver": r.apiserver,
                  "samples": r.profile.get("samples"),
                  "enabled": r.profile.get("enabled")}))
"""


def run_once(nodes: int, pods: int, setting: str, device: str,
             prof: bool) -> dict:
    env = dict(os.environ, KT_PROF="1" if prof else "0")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, str(nodes), str(pods), setting,
         device], env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"density_wire ({setting}, KT_PROF="
                         f"{int(prof)}) failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["scheduled"] != pods:
        raise SystemExit(f"density_wire bound {out['scheduled']} of "
                         f"{pods} pods")
    return dict(out, setting=setting, prof=prof)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--settings", default="stream,one-shot")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    summary: dict = {}
    for setting in opts.settings.split(","):
        row = summary.setdefault(setting, {"on": [], "off": [],
                                           "order": []})
        for i in range(opts.pairs):
            # Alternate which side runs first.
            for prof in ((True, False) if i % 2 == 0 else (False, True)):
                r = run_once(opts.nodes, opts.pods, setting, opts.device,
                             prof)
                print(json.dumps(r), flush=True)
                row["on" if prof else "off"].append(r["elapsed_s"])
                row["order"].append("on" if prof else "off")
    print(json.dumps({"profiler_cost": summary}))


if __name__ == "__main__":
    main()

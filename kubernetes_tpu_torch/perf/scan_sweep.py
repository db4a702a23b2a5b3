"""The scan kernel's chunk time across cluster sizes and node counts.

Run on a card from the root of a checkout::

    python -m kubernetes_tpu_torch.perf.scan_sweep [--reps 5]

For each point (profile, nodes, pods) it captures the kernel's arguments
for the first chunk of that rig as the solver hands them over
(``perf/scan_check.py:north_star_chunk``), then times the launch alone
with CUDA events at every cluster size the node count allows, in turns
(each round C = 1, 2, ... then back), the carried state restored before
every launch.  Every launch must leave the same choices and state as the
first.  The points are those the smoke and the drains run: N <= 320 (the
rule's C = 1), 500 (the joint quality check), 1,000 (the single-pod and
parity rigs; ``rich`` 1,000 x 10,000 is the oracle-parity drain, one
launch), 1,025 (the seam cases), 2,000 and 3,000 (between them and the
north star), the two 5,000-node north-star chunks and the largest
cluster, 16,384 nodes.

A package whose ``scan_chunk`` takes no ``cluster`` (the one-CTA kernel
before the cluster design) is timed at its one configuration, so to time
an older checkout's kernel on the same inputs, run this file from that
checkout's root with ``PYTHONPATH=.``.  Each point prints one JSON line
(times in ms, median / min / max; ``digest``: a hash of the choices, the
same for every kernel that makes the same decisions).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys

import torch

from kubernetes_tpu_torch.engine import scan as scan_mod
from kubernetes_tpu_torch.perf import scan_check

# (profile, nodes, pods, pods compiled as one batch or None).
POINTS = (
    ("mixed", 64, 2048, None),
    ("mixed", 320, 2048, None),
    ("mixed", 500, 2048, None),
    ("mixed", 1000, 2048, None),
    ("mixed", 1025, 2048, None),
    ("mixed", 2000, 2048, None),
    ("mixed", 3000, 2048, None),
    ("mixed", 5000, 2048, None),
    ("mixed", 16384, 2048, None),
    ("rich", 320, 2048, None),
    ("rich", 1000, 2048, None),
    ("rich", 1000, 10000, None),
    ("rich", 2000, 2048, None),
    ("rich", 5000, 2048, 30000),
)


def sweep_point(profile: str, nodes: int, pods: int, batch: int | None,
                reps: int) -> dict:
    ns = scan_check.north_star_chunk(nodes, pods, profile=profile,
                                     batch_pods=batch)
    enc, kw, init = ns["enc"], ns["kw"], ns["init"]
    takes_cluster = "cluster" in inspect.signature(
        scan_mod.scan_chunk).parameters
    sizes = scan_mod.allowed_clusters(nodes) if takes_cluster else (None,)
    kw.pop("cluster", None)
    ref = {}

    def once(c) -> float:
        for k, v in init.items():
            kw[k].copy_(v)
        extra = {} if c is None else {"cluster": c}
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        choices = scan_mod.scan_chunk(enc, **kw, **extra)
        stop.record()
        stop.synchronize()
        got = (choices, {k: kw[k].clone() for k in init})
        if not ref:
            ref["out"] = got
        elif not (torch.equal(got[0], ref["out"][0]) and all(
                torch.equal(got[1][k], ref["out"][1][k]) for k in init)):
            raise AssertionError(f"{profile} {nodes} x {pods}: the launch "
                                 f"at C={c} differs from the first")
        return start.elapsed_time(stop)

    times = {c: [] for c in sizes}
    turns = list(sizes) + list(reversed(sizes))
    for _ in range(reps):
        for c in turns:
            times[c].append(once(c))
    out = {"profile": profile, "nodes": nodes, "pods": pods,
           "digest": hashlib.sha1(
               ref["out"][0].cpu().numpy().tobytes()).hexdigest()[:16]}
    if takes_cluster:
        shape = dict(
            t=0 if kw.get("d_plane") is None else kw["d_plane"].shape[0],
            s=0 if kw.get("sp_node") is None else kw["sp_node"].shape[0],
            z=0 if kw.get("sp_zone") is None else kw["sp_zone"].shape[1],
            half=enc.dtype == torch.float16)
        out["rule"] = scan_mod.cluster_plan(nodes, **shape).cluster
    out["ms"] = {"one CTA" if c is None else f"C={c}": [
        statistics.median(v), min(v), max(v)] for c, v in times.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"scan_sweep: {card}; {args.reps} rounds in turns per point",
          flush=True)
    for profile, nodes, pods, batch in POINTS:
        print(json.dumps(sweep_point(profile, nodes, pods, batch,
                                     args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

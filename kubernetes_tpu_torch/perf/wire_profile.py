"""What the wire run's unclassified CPU is made of.

``python -m kubernetes_tpu_torch.perf.wire_profile [--device cpu]
[--runs 5] [--nodes 5000] [--pods 30000] [--out FILE]`` runs
``perf/harness.density_wire`` for each setting (``stream``,
``one-shot``) ``--runs`` times, as the bench's wire phase runs it (the
native apiserver unless ``KT_NATIVE_APISERVER=0``, the status routes
fetched mid-drain), with the process profiler replaced by one that
keeps each sampled stack under the name of the thread it ran on.  For
every run it records the run's profile section (the unclassified share
the bench holds to its bar) and the stacks that ``utils/profiler``'s
rules leave in ``other``: the top frames by CPU seconds (the innermost
frame and the first frame of this package on the stack, with the thread)
and the top whole stacks, over the run's timed window (the edges at which
``density_wire`` snapshots the profiler).  ``--bar`` (0.20, the bench's) makes the exit
status non-zero when a run's share is above it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BAR = 0.20
_ROUTES = ("/debug/timeseries", "/debug/dashboard", "/debug/profile")


def _thread_profiler():
    """A ``utils.profiler.Profiler`` whose folded stacks start with the
    sampled thread's label (the tick notes the thread, then its stack)."""
    from kubernetes_tpu_torch.utils import profiler

    class ThreadProfiler(profiler.Profiler):
        _label = "?"

        def _note_thread_locked(self, name: str, dcpu: float) -> None:
            ThreadProfiler._label = profiler._NUM_SUFFIX.sub("", name) \
                or name
            super()._note_thread_locked(name, dcpu)

        def _note_stack_locked(self, folded: str, dcpu: float) -> None:
            super()._note_stack_locked(f"[{self._label}];{folded}", dcpu)

    return ThreadProfiler


def classify_folded(folded: str) -> str:
    """The component ``utils.profiler.classify_stack`` gives the stack a
    folded line names (root first; ``[thread]`` first when present)."""
    from kubernetes_tpu_torch.utils import profiler
    names = folded.split(";")
    for name in reversed(names):
        if name.startswith("["):
            continue
        path, _, func = name.rpartition(":")
        comp = profiler.classify_frame(path, func)
        if comp is not None:
            return comp
    thread = names[0][1:-1] if names[0].startswith("[") else ""
    return profiler.classify_thread(thread) or "other"


def other_frames(delta: dict, top: int = 10) -> dict:
    """The ``other`` stacks of ``delta`` ({folded: cpu s}) by frame:
    innermost frame, first frame of this package from the leaf, thread."""
    total = sum(delta.values()) or 1.0
    by_leaf: dict = {}
    by_pkg: dict = {}
    stacks = []
    other = 0.0
    for folded, cpu in delta.items():
        if classify_folded(folded) != "other":
            continue
        other += cpu
        names = folded.split(";")
        thread = names[0][1:-1] if names[0].startswith("[") else "?"
        frames = [n for n in names if not n.startswith("[")]
        leaf = frames[-1] if frames else "?"
        pkg = next((n for n in reversed(frames)
                    if n.startswith("kubernetes_tpu_torch/")), "(none)")
        by_leaf[(leaf, thread)] = by_leaf.get((leaf, thread), 0.0) + cpu
        by_pkg[(pkg, thread)] = by_pkg.get((pkg, thread), 0.0) + cpu
        stacks.append((cpu, thread, ";".join(frames[-12:])))

    def rank(table):
        return [{"frame": f, "thread": t, "cpu_s": round(c, 6),
                 "share_of_all": round(c / total, 6)}
                for (f, t), c in sorted(table.items(),
                                        key=lambda kv: -kv[1])[:top]]

    stacks.sort(key=lambda s: -s[0])
    return {"other_cpu_s": round(other, 6),
            "all_cpu_s": round(sum(delta.values()), 6),
            "by_leaf": rank(by_leaf), "by_package_frame": rank(by_pkg),
            "top_stacks": [{"cpu_s": round(c, 6), "thread": t, "stack": s}
                           for c, t, s in stacks[:top]]}


def _runs(opts, device: str, prof, edges: list) -> tuple[list, float]:
    """Each setting's wire run, ``opts.runs`` times: its profile row and
    its ``other`` frames over the timed window."""
    from kubernetes_tpu_torch.perf import harness
    runs, worst = [], 0.0
    for i in range(opts.runs):
        for setting in harness.SETTINGS:
            edges.clear()
            t0 = time.perf_counter()
            r = harness.density_wire(
                opts.nodes, opts.pods, profile=opts.profile,
                setting=setting, device=device, status_routes=_ROUTES)
            before, after = edges[-2], edges[-1]
            delta = {k: v - before.get(k, 0.0) for k, v in after.items()
                     if v - before.get(k, 0.0) > 0}
            uf = r.profile.get("unclassified_fraction")
            worst = max(worst, uf if uf is not None else 1.0)
            row = {"run": i, "setting": setting,
                   "unclassified_fraction": uf,
                   "cpu_seconds": r.profile.get("cpu_seconds"),
                   "samples": r.profile.get("samples"),
                   "elapsed_s": round(r.elapsed_s, 6),
                   "scheduled": r.scheduled,
                   "wall_s": round(time.perf_counter() - t0, 3),
                   "stacks_truncated_s": round(prof._stacks_truncated, 6),
                   **other_frames(delta)}
            runs.append(row)
            top = [(f["frame"], f["thread"], f["cpu_s"])
                   for f in row["by_leaf"][:3]]
            print(f"wire_profile: run {i} {setting}: unclassified {uf} "
                  f"(bar {opts.bar}), {r.scheduled} bound in "
                  f"{r.elapsed_s:.3f} s; top other frames {top}",
                  file=sys.stderr)
    return runs, worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--profile", default="mixed")
    ap.add_argument("--bar", type=float, default=BAR)
    ap.add_argument("--out", default="")
    opts = ap.parse_args(argv)

    from kubernetes_tpu_torch.utils import device as device_mod
    dev = device_mod.resolve(opts.device)
    from kubernetes_tpu_torch.perf import harness
    from kubernetes_tpu_torch.utils import profiler
    if not profiler.enabled():
        raise SystemExit("wire_profile: the profiler is off (KT_PROF=0)")
    if dev.type == "cuda":
        from kubernetes_tpu_torch.engine import kernels
        kernels.library()
    prof = _thread_profiler()()
    # Room for every (thread, stack) of the runs: the ring bounds only
    # the folded-stack table, not the component split the bar reads.
    prof.ring = 1 << 20
    profiler._CELL[:] = [prof.start()]
    # density_wire snapshots the profiler at the edges of its timed
    # window (harness._profile_snapshot): keep the stack table at each.
    edges: list = []
    snapshot = harness._profile_snapshot

    def edge_snapshot(*args, **kwargs):
        snap = snapshot(*args, **kwargs)
        with prof._lock:
            edges.append(dict(prof._stacks))
        return snap

    harness._profile_snapshot = edge_snapshot
    try:
        runs, worst = _runs(opts, str(dev), prof, edges)
    finally:
        prof.stop()
        harness._profile_snapshot = snapshot
    rec = {"nodes": opts.nodes, "pods": opts.pods,
           "device": str(dev), "bar": opts.bar,
           "unclassified": [r["unclassified_fraction"] for r in runs],
           "runs": runs}
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({"unclassified": rec["unclassified"],
                      "worst": worst, "bar": opts.bar}))
    return 1 if worst > opts.bar else 0


if __name__ == "__main__":
    sys.exit(main())

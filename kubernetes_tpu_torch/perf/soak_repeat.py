"""One soak wave, run N times in one process, one summary line each.

``python -m kubernetes_tpu_torch.perf.soak_repeat --wave overload --runs 4
[--device cpu] [--out chiprun_out/overload.json]``: the overload wave's
goodput, ``/debug/vars`` answers and errors, offered multiple and the
scheduler process's launches, or (``--wave soak``) the churn soak at a
20 s duration floor: its invariant violations, restart time, breaker
and seconds.  Each line also counts the generation-2 collections in the
run (and the longest).  It spreads what one smoke's phase 22 shows once
(``chip_smoke.py``); it exits 1 when a run misses a bar of
``soak.violations``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from kubernetes_tpu_torch.perf import soak

_KEEP = {
    "overload": ("goodput_pods_per_s", "debug_vars_samples",
                 "debug_vars_errors", "storm_window_s", "offered_multiple",
                 "lease_expiries", "stranded_pending", "daemon_launches"),
    "soak": ("invariant_violations", "settle_s", "restart_parity",
             "requeued_pods", "breaker_open_seconds", "engine_mode_final",
             "queue_peak_depth", "duration_s"),
}


class _Gen2:
    """The generation-2 collections while installed: count, seconds and
    the longest."""

    def __init__(self):
        self.n, self.total, self.longest, self._t0 = 0, 0.0, 0.0, None

    def __call__(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            d = time.perf_counter() - self._t0
            self.n, self.total = self.n + 1, self.total + d
            self.longest = max(self.longest, d)


def run(wave: str, device: str) -> dict:
    gen2 = _Gen2()
    gc.callbacks.append(gen2)
    t0 = time.perf_counter()
    try:
        if wave == "overload":
            rec = soak.run_overload_wave(quiet=True, device=device)
            section = {"overload": rec}
        else:
            rec = soak.run_soak(duration_s=20.0, quiet=True, device=device)
            section = rec
    finally:
        gc.callbacks.remove(gen2)
    out = {k: rec.get(k) for k in _KEEP[wave]}
    out.update(seconds=round(time.perf_counter() - t0, 3),
               gen2=[gen2.n, round(gen2.total, 3), round(gen2.longest, 3)],
               violations=soak.violations(section))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wave", choices=sorted(_KEEP), default="overload")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    opts = ap.parse_args(argv)
    runs = []
    for i in range(opts.runs):
        runs.append(run(opts.wave, opts.device))
        print(json.dumps({"run": i, **runs[-1]}), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"wave": opts.wave, "runs": runs}, f, indent=1)
    return 1 if any(r["violations"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Feature gates — the ``--feature-gates Name=true,Other=false`` surface.

The reference threads ``config.DefaultFeatureGate`` through every binary
(plugin/cmd/kube-scheduler/app/options/options.go:76; pkg/util/config/
feature_gate.go): a registry of named booleans with defaults, set from one
comma-separated flag, rejecting unknown names.  These gates control REAL
alternate code paths in this framework — they are not decorative:

* ``BatchBindings`` — bind decisions through the batch bindings
  subresource (one request per solved chunk) vs per-pod POSTs through the
  fallback pool.  Default on; off reproduces the reference's per-bind
  goroutine wire behavior.
* ``StreamingDrain`` — the chunked double-buffered drain (device scans
  chunk N+1 while chunk N's binds commit) vs one whole-queue solve per
  drain.  Default on.
* ``JointSolver`` — replace the decision-parity sequential scan with the
  LP-priced global assignment on full-queue drains.  Default off
  (alpha: better aggregate placement, no per-pod order parity).
* ``Preemption`` — unschedulable priority-carrying pods trigger the
  batched victim solve and the evict->assume->bind path
  (engine/workloads/preemption.py).  Default on; off reproduces the
  pre-priority behavior (priority still orders the queue).
* ``GangScheduling`` — the all-or-nothing gang admission reduction for
  ``scheduling.kt.io/gang`` batches (engine/workloads/gang.py).  Default
  on; off treats gang members as independent pods.
"""

from __future__ import annotations

import threading

KNOWN_GATES: dict[str, bool] = {
    "BatchBindings": True,
    "StreamingDrain": True,
    "JointSolver": False,
    "Preemption": True,
    "GangScheduling": True,
}


class FeatureGate:
    """A parsed gate set.  ``enabled(name)`` answers default-or-override;
    unknown names are rejected at parse time like the reference's
    fmt.Errorf("unrecognized key") (feature_gate.go Set)."""

    def __init__(self, overrides: dict[str, bool] | None = None):
        self._overrides = dict(overrides or {})

    @classmethod
    def parse(cls, spec: str) -> "FeatureGate":
        overrides: dict[str, bool] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, val = part.partition("=")
            name = name.strip()
            if not sep:
                raise ValueError(f"missing '=' in {part!r}")
            if name not in KNOWN_GATES:
                raise ValueError(f"unrecognized feature gate {name!r} "
                                 f"(known: {', '.join(sorted(KNOWN_GATES))})")
            v = val.strip().lower()
            if v not in ("true", "false"):
                raise ValueError(f"{name}: want true/false, got {val!r}")
            overrides[name] = v == "true"
        return cls(overrides)

    def enabled(self, name: str) -> bool:
        if name not in KNOWN_GATES:
            raise KeyError(f"unknown feature gate {name!r}")
        return self._overrides.get(name, KNOWN_GATES[name])

    def as_dict(self) -> dict[str, bool]:
        return {name: self.enabled(name) for name in sorted(KNOWN_GATES)}


# The process-wide default, mutated once at daemon startup from the flag
# (the reference's config.DefaultFeatureGate singleton).
_lock = threading.Lock()
DEFAULT_FEATURE_GATE = FeatureGate()


def set_default(gate: FeatureGate) -> None:
    global DEFAULT_FEATURE_GATE
    with _lock:
        DEFAULT_FEATURE_GATE = gate

"""Device fault injection: the guard's fault injector.

Every guarded solve site (``engine/guard.py`` wraps the one-shot,
stream-chunk, single-pod and preemption-victim solves) consults the
installed ``DeviceChaos`` before running and before returning its
readback, so a rule set can make the card misbehave on a deterministic
cadence without touching CUDA:

* ``oom``     — raise a CUDA out-of-memory-shaped error at the solve
  launch (the allocation-failure shape);
* ``compile`` — raise an ``nvcc``-failure-shaped error (the kernel
  library failing to build);
* ``lost``    — raise a sticky-CUDA-error-shaped error (an illegal
  memory access: the context is unusable until the process restarts);
* ``corrupt`` — poison the solve's READBACK instead of raising: the
  returned assignment vector comes back as NaN-laced floats and
  out-of-range indices, what a silently corrupting transfer produces.
  The post-solve sanity gate must catch it.

Rules match on the solve ``path`` label (regex over
stream/oneshot/joint/single_pod/victim), fire deterministically on every
``every_nth`` matching solve (or probabilistically), at most ``count``
times.  The simulated errors carry the texts real CUDA faults carry, so
the guard's classifier exercises the same string matching.

Install programmatically (``install(DeviceChaos([...]))``) or from the
environment: ``KT_CHAOS_DEVICE="oom@7,lost@50:1,corrupt@9/stream"``
reads as "OOM every 7th solve, one device-lost on the 50th, corrupt
every 9th stream-chunk readback".
"""

from __future__ import annotations

import random
import re
import threading
from dataclasses import dataclass, field

FAULT_OOM = "oom"
FAULT_COMPILE = "compile"
FAULT_LOST = "lost"
FAULT_CORRUPT = "corrupt"

_FAULTS = (FAULT_OOM, FAULT_COMPILE, FAULT_LOST, FAULT_CORRUPT)

# The texts real CUDA faults carry (torch.OutOfMemoryError, a sticky
# launch error, engine/kernels.py's nvcc failure) — the classifier in
# engine/guard.py keys on these tokens, so injection exercises the
# production match.
_MESSAGES = {
    FAULT_OOM: ("CUDA out of memory. Tried to allocate 288.00 GiB. "
                "[injected by chaos.device]"),
    FAULT_COMPILE: ("nvcc failed (1): kernel library build "
                    "[injected by chaos.device]"),
    FAULT_LOST: ("CUDA error: an illegal memory access was encountered "
                 "[injected by chaos.device]"),
}


class SimulatedDeviceError(RuntimeError):
    """Stands in for a CUDA runtime error: classified by message
    content, like the real thing."""


# The tenant set of the solve currently in flight, published by the
# drain pipeline / solver service around each dispatch so tenant-scoped
# rules can target one tenant's batches.  Process-global rather than
# thread-local ON PURPOSE: a deferred-readback chunk's poisoning happens
# on the commit worker thread, which must still see the drain thread's
# context (injection rigs run one drain at a time).
_tenant_ctx: frozenset = frozenset()


import contextlib as _contextlib  # noqa: E402 — local to the context helper


@_contextlib.contextmanager
def tenant_context(tenants):
    """Publish the in-flight solve's tenant set for rule matching."""
    global _tenant_ctx
    prev = _tenant_ctx
    _tenant_ctx = frozenset(tenants or ())
    try:
        yield
    finally:
        _tenant_ctx = prev


def current_tenants() -> frozenset:
    return _tenant_ctx


@dataclass
class DeviceRule:
    fault: str = FAULT_OOM
    path: str = ""            # regex over the solve path label ("" = any)
    every_nth: int = 0        # fire on every Nth matching solve (0 = off)
    probability: float = 1.0
    count: int = -1           # max fires; -1 = unlimited
    # Tenant-scoped chaos (the multi-tenant isolation drills): the rule
    # fires only for solves whose batch carries this tenant's rows —
    # the adversarial-tenant poison batch, injectable without touching
    # the victims' solves.  "" = any tenant (the pre-tenancy behavior).
    tenant: str = ""
    seen: int = 0
    fired: int = 0
    _pattern: re.Pattern | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.fault not in _FAULTS:
            raise ValueError(f"unknown device fault {self.fault!r}")
        self._pattern = re.compile(self.path) if self.path else None

    def matches(self, path: str) -> bool:
        if self._pattern is not None and \
                not self._pattern.search(path):
            return False
        return not self.tenant or self.tenant in current_tenants()

    def to_json(self) -> dict:
        return {"fault": self.fault, "path": self.path,
                "every_nth": self.every_nth,
                "probability": self.probability, "count": self.count,
                "tenant": self.tenant,
                "seen": self.seen, "fired": self.fired}


def parse_spec(spec: str) -> list[DeviceRule]:
    """``KT_CHAOS_DEVICE`` grammar: comma-separated
    ``fault@every_nth[:count][/path-regex]`` entries, e.g.
    ``oom@7,lost@50:1,corrupt@9/stream``."""
    rules: list[DeviceRule] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        path = ""
        if "/" in entry:
            entry, path = entry.split("/", 1)
        fault, _, cadence = entry.partition("@")
        count = -1
        if ":" in cadence:
            cadence, _, count_s = cadence.partition(":")
            count = int(count_s)
        rules.append(DeviceRule(fault=fault.strip(),
                                every_nth=int(cadence or "1"),
                                count=count, path=path))
    return rules


class DeviceChaos:
    """A rule set over the guarded solve sites.  One instance is
    process-global (``install``); the guard consults it via
    ``maybe_fail``/``maybe_corrupt`` and pays a single None-check when
    nothing is installed."""

    def __init__(self, rules: list[DeviceRule] | None = None):
        self._lock = threading.Lock()
        self._rules: list[DeviceRule] = list(rules or [])
        self.solves_seen = 0
        self.injected_total = 0

    def add_rule(self, rule: DeviceRule | None = None, **kw) -> DeviceRule:
        rule = rule or DeviceRule(**kw)
        with self._lock:
            self._rules.append(rule)
        return rule

    def add_rules(self, rules: list[DeviceRule]) -> None:
        for rule in rules:
            self.add_rule(rule)

    def clear(self) -> int:
        with self._lock:
            n = len(self._rules)
            self._rules = []
            return n

    def stats(self) -> dict:
        with self._lock:
            return {"solves": self.solves_seen,
                    "injected": self.injected_total,
                    "rules": [r.to_json() for r in self._rules]}

    def _fire(self, path: str, corrupt: bool) -> DeviceRule | None:
        """First matching rule that fires for this solve.  ``corrupt``
        selects between the raise-at-launch faults and the
        readback-poisoning one — they are consulted at different points
        of the solve, so their cadences count separately."""
        with self._lock:
            if not corrupt:
                self.solves_seen += 1
            for rule in self._rules:
                want_corrupt = rule.fault == FAULT_CORRUPT
                if want_corrupt != corrupt or rule.count == 0 or \
                        not rule.matches(path):
                    continue
                rule.seen += 1
                if rule.every_nth and rule.seen % rule.every_nth:
                    continue
                if rule.probability < 1.0 and \
                        random.random() >= rule.probability:
                    continue
                if rule.count > 0:
                    rule.count -= 1
                rule.fired += 1
                self.injected_total += 1
                return rule
        return None

    def maybe_fail(self, path: str) -> None:
        """Raise the configured device fault for this solve, if a
        launch-fault rule fires."""
        rule = self._fire(path, corrupt=False)
        if rule is not None:
            raise SimulatedDeviceError(_MESSAGES[rule.fault])

    def maybe_corrupt(self, path: str, rows):
        """Poison a readback if a corrupt rule fires: the assignment
        vector comes back as floats with NaN rows and one out-of-range
        index — both shapes the sanity gate must reject."""
        rule = self._fire(path, corrupt=True)
        if rule is None:
            return rows
        import numpy as np
        bad = np.asarray(rows).astype(np.float64).copy()
        if bad.size:
            bad.flat[0] = np.nan
            if bad.size > 1:
                bad.flat[bad.size // 2] = 2 ** 31 - 7  # out of node range
        return bad


_active: DeviceChaos | None = None
_env_checked = False


def install(chaos: DeviceChaos | None) -> DeviceChaos | None:
    """Install (or, with None, remove) the process-global rule set."""
    global _active, _env_checked
    _active = chaos
    _env_checked = True  # explicit install wins over the env spec
    return chaos


def active() -> DeviceChaos | None:
    """The installed rule set, lazily seeded from ``KT_CHAOS_DEVICE`` on
    first use (the soak/bench rigs set the env before daemon start)."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        _env_checked = True
        from kubernetes_tpu_torch.utils import knobs
        spec = knobs.get("KT_CHAOS_DEVICE")
        if spec:
            _active = DeviceChaos(parse_spec(spec))
    return _active


def _reset_for_tests() -> None:
    global _active, _env_checked
    _active = None
    _env_checked = False

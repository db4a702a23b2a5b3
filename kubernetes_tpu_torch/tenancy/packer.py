"""Cross-tenant batch packing: weighted fairness with deadline-aware
admission, deficit-round-robin over atomic gang units.

The single-owner drain solves whatever the queue holds; a SHARED solver
must decide whose pods ride each solve.  The packer makes that decision
in one place, with three rules:

* **Deadline preempts — within a budget.**  A pod whose queue age has
  crossed the urgency threshold (its formation deadline — the serving
  SLO's front half) is admitted FIRST, oldest first, regardless of
  share: a trickle tenant's 100 ms-deadline pod never waits behind a
  noisy neighbor's backlog.  Urgent admission is capped at a quarter of
  the drain and CHARGED against the tenant's deficit, so a saturating
  tenant (whose whole backlog is "urgent" by age) cannot launder its
  flood through the urgency lane — what it takes urgently it repays in
  later drains, and long-run shares still converge to the weights.
* **Weighted shares under saturation.**  Remaining capacity is filled
  by deficit round robin (DRR) over the tenants: each cycle a tenant
  earns quantum proportional to its ``KT_TENANT_WEIGHTS`` share and
  spends it admitting its oldest units; deficits persist across drains
  (bounded), so long-run admitted-pod shares converge to the weights
  even when drains are small.  A tenant with nothing pending earns
  nothing (no banked credit for idle tenants — classic DRR reset).
* **Gangs are atomic.**  A gang's members form ONE unit: admitted
  together or deferred together — the packer can never split a gang
  across solves (the all-or-nothing reduction's precondition).  A gang
  larger than the whole cap is admitted alone rather than starved.

Deferred pods return to the queue (their first-seen stamps survive — the
SLO clock keeps running) and count in
``scheduler_tenant_deferred_pods_total{tenant=}``: the fairness story's
observable — a noisy tenant's deferrals grow while its share is capped.
"""

from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch.scheduler.batchformer import first_seen
from kubernetes_tpu_torch.utils import knobs
from kubernetes_tpu_torch.utils import metrics as metrics_mod

# Deficit carried across drains is clamped to this many drains' worth of
# quantum: enough memory for shares to converge, not enough for a tenant
# idle-then-bursting to monopolize one drain.
_DEFICIT_CLAMP_DRAINS = 2.0


class TenantPacker:
    """Selects and orders one drain's worth of pods across tenants.

    ``tenant_of`` maps a pod to its tenant; ``weights`` are the
    configured shares; ``urgent_s`` is the queue age past which a pod
    preempts the packing order (default: the formation deadline via
    ``urgent_s_fn``, falling back to ``KT_TENANT_URGENT_MS``)."""

    def __init__(self, tenant_of: Callable, weights: dict[str, float],
                 urgent_s_fn: Optional[Callable[[], float]] = None):
        self.tenant_of = tenant_of
        self.weights = dict(weights)
        self.urgent_s_fn = urgent_s_fn
        env = knobs.get("KT_TENANT_URGENT_MS")
        self._urgent_override = float(env) / 1e3 if env else None
        self._deficit: dict[str, float] = {}

    def urgent_s(self) -> float:
        if self._urgent_override is not None:
            return self._urgent_override
        if self.urgent_s_fn is not None:
            return max(self.urgent_s_fn() or 0.0, 0.0)
        return 0.0

    def _weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    @staticmethod
    def _units(pods: list) -> list[list]:
        """Atomic admission units in arrival order: single pods, or the
        whole gang for annotated members (grouped at the FIRST member's
        position — the queue released them contiguously, but a chaos
        requeue can interleave)."""
        units: list[list] = []
        gang_unit: dict[str, list] = {}
        for pod in pods:
            name = getattr(pod, "gang", "")
            if name and getattr(pod, "gang_size", 0) > 1:
                unit = gang_unit.get(name)
                if unit is None:
                    unit = gang_unit[name] = []
                    units.append(unit)
                unit.append(pod)
            else:
                units.append([pod])
        return units

    def pack(self, pods: list, cap: int,
             now: Optional[float] = None) -> tuple[list, list]:
        """(selected, deferred): at most ``cap`` pods chosen urgency-
        first then by weighted DRR, FIFO within tenant; the remainder is
        the caller's to re-queue.  ``cap <= 0`` selects everything (the
        packer still orders: urgent units lead, tenants interleave by
        share — chunked streaming then serves the tail-latency-critical
        rows first)."""
        if not pods:
            return [], []
        import time as _time
        now = _time.perf_counter() if now is None else now
        units = self._units(pods)
        if cap <= 0:
            cap = sum(len(u) for u in units)
        urgent_s = self.urgent_s()

        def unit_age(unit) -> float:
            seen = [first_seen(p) for p in unit]
            seen = [s for s in seen if s is not None]
            return now - min(seen) if seen else 0.0

        selected: list = []
        space = cap
        per_tenant: dict[str, list] = {}
        urgent: list[tuple[float, int, list]] = []
        for i, unit in enumerate(units):
            age = unit_age(unit)
            if urgent_s > 0 and age >= urgent_s:
                urgent.append((-age, i, unit))
            else:
                tenant = self.tenant_of(unit[0])
                per_tenant.setdefault(tenant, []).append(unit)
        # Urgent units first, oldest first, within the urgency budget
        # (a quarter of the drain) and CHARGED to the tenant's deficit;
        # overflow rejoins the tenant's DRR queue in age order.  A unit
        # that no longer fits is deferred (never split) unless NOTHING
        # was admitted yet — one oversized gang must make progress
        # rather than starve.
        deferred: list = []
        urgent_budget = max(cap // 4, 1)
        overflow: dict[str, list] = {}
        for _, _, unit in sorted(urgent):
            tenant = self.tenant_of(unit[0])
            if len(unit) <= min(space, urgent_budget) or not selected:
                selected.extend(unit)
                space -= len(unit)
                urgent_budget -= len(unit)
                self._deficit[tenant] = \
                    self._deficit.get(tenant, 0.0) - len(unit)
            else:
                overflow.setdefault(tenant, []).append(unit)
        # Budget overflow rejoins the tenant's DRR queue AHEAD of its
        # non-urgent units (overflow is older by definition, and within
        # itself already age-sorted) — FIFO within tenant holds.
        for tenant, units_o in overflow.items():
            per_tenant[tenant] = units_o + per_tenant.get(tenant, [])
        # Weighted DRR over the non-urgent backlog.  Quantum scales to
        # the remaining space so one full cycle roughly fills the drain.
        pending = {t: us for t, us in per_tenant.items() if us}
        if pending and space > 0:
            total_w = sum(self._weight(t) for t in pending) or 1.0
            # Quantum covers the FULL cap, not just the post-urgency
            # remainder: urgent admissions were charged to their
            # tenants' deficits above, so the earn side must account
            # for the same capacity or every urgency lane user would be
            # under-paid its share.
            quantum = max(cap / total_w, 1.0)
            clamp = quantum * _DEFICIT_CLAMP_DRAINS
            while space > 0 and pending:
                progress = False
                for tenant in sorted(pending):
                    units_t = pending.get(tenant)
                    if not units_t:
                        continue
                    w = self._weight(tenant)
                    # Clamped both ways: banked credit is bounded (an
                    # idle-then-bursting tenant cannot monopolize), and
                    # urgency debt is bounded (a starving repayment
                    # spiral cannot lock a tenant out forever).
                    self._deficit[tenant] = min(
                        max(self._deficit.get(tenant, 0.0) + w * quantum,
                            -2.0 * cap),
                        w * clamp)
                    while units_t and space > 0:
                        unit = units_t[0]
                        size = len(unit)
                        if size > space and selected:
                            break  # doesn't fit this drain: defer whole
                        if self._deficit[tenant] < size and selected:
                            break  # share spent: wait for more quantum
                        units_t.pop(0)
                        selected.extend(unit)
                        space -= size
                        self._deficit[tenant] -= size
                        progress = True
                    if not units_t:
                        # DRR reset: an emptied queue banks no credit.
                        pending.pop(tenant, None)
                        self._deficit.pop(tenant, None)
                if not progress:
                    break
        deferred_tenants = set()
        for tenant, units_t in pending.items():
            if units_t:
                deferred_tenants.add(tenant)
            for unit in units_t:
                deferred.extend(unit)
        # Empty-queue debt forgiveness (the DRR reset, extended to the
        # urgency lane): a tenant whose backlog fully drained is not
        # saturating — carrying its urgency overdraft forward would
        # lock a trickle tenant out of a future burst it has not
        # earned... against credit it also never banks.
        for tenant in list(self._deficit):
            if tenant not in deferred_tenants and \
                    self._deficit[tenant] < 0:
                self._deficit[tenant] = 0.0
        if deferred:
            counts: dict[str, int] = {}
            for pod in deferred:
                t = self.tenant_of(pod)
                counts[t] = counts.get(t, 0) + 1
            for t, n in counts.items():
                metrics_mod.TENANT_DEFERRED.labels(tenant=t).inc(n)
        return selected, deferred

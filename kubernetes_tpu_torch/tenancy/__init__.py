"""Multi-tenant solver service: tenant identity and share configuration.

Counterpart of ``kubernetes_tpu/tenancy/`` over the port's engine.

The production story ("millions of users") is a FLEET of virtual
control planes sharing scarce accelerators, not one giant cluster.  The
``tenancy`` package is the solver-service layer that lets N scheduler
daemons (or one daemon serving N tenants' namespaces) share ONE device:

* this module — tenant identity (``KT_TENANTS``) and weighted shares
  (``KT_TENANT_WEIGHTS``), read once per daemon like every other knob;
* ``tenancy/packer.py`` — cross-tenant batch packing with weighted
  fairness and deadline-aware admission (a noisy tenant's burst queues
  behind its share; a trickle tenant's deadline batch preempts the
  packing order; gangs are never split);
* ``tenancy/service.py`` — the ``SolverService`` boundary: per-tenant
  circuit breakers and probe re-promotion (one tenant's poison batch
  opens THAT tenant's breaker — its pods requeue until a probe succeeds,
  where the JAX package decides them on its host engine — while the
  service and the other tenants stay on device), packed multi-request
  solves, and the HTTP exposure for out-of-process submitters.

Tenant identity follows the HA namespace-shard rule (scheduler/shards.py): a namespace that
IS a configured tenant name maps to itself; every other namespace maps
onto the tenant ring by crc32 — cross-process deterministic, so N
daemons (and the apiserver-side accounting) agree on who owns what
without coordination.
"""

from __future__ import annotations

import os
import zlib


def tenant_names() -> list[str]:
    """The configured tenant set (``KT_TENANTS="t-a,t-b,t-c"``); empty
    list = tenancy disabled (the single-owner engine, byte-for-byte the
    pre-tenancy behavior)."""
    from kubernetes_tpu_torch.utils import knobs
    raw = knobs.get("KT_TENANTS")
    if not raw:
        return []
    return [t.strip() for t in raw.split(",") if t.strip()]


def enabled() -> bool:
    return bool(tenant_names())


def tenant_weights(tenants: list[str] | None = None) -> dict[str, float]:
    """Weighted shares from ``KT_TENANT_WEIGHTS="t-a:3,t-b:1"`` (default
    1.0 each; unknown names and bad numbers are ignored — a typo must
    not zero a tenant's share)."""
    if tenants is None:
        tenants = tenant_names()
    weights = {t: 1.0 for t in tenants}
    from kubernetes_tpu_torch.utils import knobs
    raw = knobs.get("KT_TENANT_WEIGHTS")
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry or ":" not in entry:
            continue
        name, _, val = entry.rpartition(":")
        name = name.strip()
        if name not in weights:
            continue
        try:
            w = float(val)
        except ValueError:
            continue
        if w > 0:
            weights[name] = w
    return weights


def tenant_of(namespace: str, tenants: list[str]) -> str:
    """Deterministic namespace -> tenant mapping: an exact tenant-name
    namespace maps to itself; everything else lands on the tenant ring
    by crc32 (the HA shard hash — stable across processes, so every
    daemon and the service agree)."""
    if not tenants:
        return ""
    if namespace in tenants:
        return namespace
    return tenants[zlib.crc32(namespace.encode("utf-8")) % len(tenants)]


def pod_tenant(pod, tenants: list[str]) -> str:
    return tenant_of(pod.namespace, tenants)

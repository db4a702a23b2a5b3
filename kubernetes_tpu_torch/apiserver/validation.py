"""Object validation + admission for the apiserver write path.

The reference runs every write through structural validation
(``pkg/api/validation/validation.go`` — ValidatePod/ValidateNode collect
field errors) and then a configured admission chain
(``pkg/admission``, plugins under ``plugin/pkg/admission/*``) before the
object reaches the registry.  This module is that slice for the
scheduler-relevant resources: malformed pods/nodes bounce with 422 and the
collected reasons; admission plugins can veto with 403.

Validation collects ALL errors (field.ErrorList behavior) rather than
stopping at the first.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.quantity import parse_quantity
from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS

# pkg/api/validation/name.go: DNS-1123 subset — enough to catch junk
# without re-implementing the full RFC grammar.
_NAME_OK = set("abcdefghijklmnopqrstuvwxyz0123456789.-")

def _check_name(meta: dict, errors: list[str], what: str) -> None:
    name = meta.get("name", "")
    if not name or not isinstance(name, str):
        errors.append(f"{what}.metadata.name: required")
        return
    if len(name) > 253:
        errors.append(f"{what}.metadata.name: must be <= 253 chars")
    if not all(c in _NAME_OK for c in name):
        # DNS-1123 is lowercase-only: 'MyPod' is invalid, not normalized.
        errors.append(f"{what}.metadata.name: invalid characters in "
                      f"{name!r}")


def _check_quantity(val, path: str, errors: list[str]) -> None:
    try:
        q = parse_quantity(val)
    except (ValueError, TypeError, ArithmeticError):
        errors.append(f"{path}: unparseable quantity {val!r}")
        return
    if q < 0:
        errors.append(f"{path}: must be non-negative, got {val!r}")


def validate_pod(obj: dict) -> list[str]:
    """ValidatePod (validation.go): name present, containers named and
    unique, resource requests/limits parseable and non-negative."""
    errors: list[str] = []
    meta = obj.get("metadata") or {}
    _check_name(meta, errors, "pod")
    spec = obj.get("spec") or {}
    containers = spec.get("containers")
    if not isinstance(containers, list) or not containers:
        errors.append("pod.spec.containers: at least one container required")
        containers = []
    seen = set()
    for i, c in enumerate(containers):
        if not isinstance(c, dict):
            errors.append(f"pod.spec.containers[{i}]: not an object")
            continue
        cname = c.get("name", "")
        if not cname:
            errors.append(f"pod.spec.containers[{i}].name: required")
        elif cname in seen:
            errors.append(f"pod.spec.containers[{i}].name: duplicate "
                          f"{cname!r}")
        seen.add(cname)
        res = c.get("resources") or {}
        for kind in ("requests", "limits"):
            for rname, val in (res.get(kind) or {}).items():
                _check_quantity(
                    val, f"pod.spec.containers[{i}].resources."
                    f"{kind}[{rname}]", errors)
    return errors


def validate_node(obj: dict) -> list[str]:
    """ValidateNode (validation.go): name present, allocatable/capacity
    quantities parseable and non-negative, condition entries well-formed."""
    errors: list[str] = []
    meta = obj.get("metadata") or {}
    _check_name(meta, errors, "node")
    status = obj.get("status") or {}
    for fieldname in ("allocatable", "capacity"):
        for rname, val in (status.get(fieldname) or {}).items():
            _check_quantity(val, f"node.status.{fieldname}[{rname}]", errors)
    for i, cond in enumerate(status.get("conditions") or ()):
        if not isinstance(cond, dict):
            errors.append(f"node.status.conditions[{i}]: not an object")
            continue
        # Unknown condition TYPES are allowed (the reference's ValidateNode
        # doesn't restrict them; consumers ignore types they don't read) —
        # only the shape is enforced.
        if not cond.get("type", ""):
            errors.append(f"node.status.conditions[{i}].type: required")
        if cond.get("status") not in ("True", "False", "Unknown"):
            errors.append(f"node.status.conditions[{i}].status: must be "
                          f"True/False/Unknown")
    return errors


def validate_limit_range(obj: dict) -> list[str]:
    """ValidateLimitRange: every quantity in every limit item parseable —
    a stored garbage quantity would poison every later pod admission in
    the namespace."""
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "limitrange")
    items = ((obj.get("spec") or {}).get("limits")) or []
    if not isinstance(items, list):
        return ["limitrange.spec.limits: not a list"]
    for i, item in enumerate(items):
        if not isinstance(item, dict):
            errors.append(f"limitrange.spec.limits[{i}]: not an object")
            continue
        for fieldname in ("default", "defaultRequest", "min", "max"):
            vals = item.get(fieldname) or {}
            if not isinstance(vals, dict):
                errors.append(
                    f"limitrange.spec.limits[{i}].{fieldname}: not a map")
                continue
            for rname, val in vals.items():
                _check_quantity(
                    val, f"limitrange.spec.limits[{i}].{fieldname}"
                    f"[{rname}]", errors)
    return errors


def validate_resource_quota(obj: dict) -> list[str]:
    """ValidateResourceQuota: hard caps parseable and non-negative."""
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "resourcequota")
    hard = ((obj.get("spec") or {}).get("hard")) or {}
    if not isinstance(hard, dict):
        return ["resourcequota.spec.hard: not a map"]
    for rname, val in hard.items():
        _check_quantity(val, f"resourcequota.spec.hard[{rname}]", errors)
    return errors


def validate_hpa(obj: dict) -> list[str]:
    """ValidateHorizontalPodAutoscaler (pkg/apis/autoscaling/validation):
    maxReplicas required and >= 1, and >= minReplicas.  Without this an
    HPA missing maxReplicas would silently disable all scale-up in the
    controller."""
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "horizontalpodautoscaler")
    spec = obj.get("spec") or {}
    maxr = spec.get("maxReplicas")
    if not isinstance(maxr, int) or maxr < 1:
        errors.append("horizontalpodautoscaler.spec.maxReplicas: must be "
                      "an integer >= 1")
    minr = spec.get("minReplicas")
    if minr is None:
        minr = 1  # optional; unset/null defaults to 1 like the controller
    if not isinstance(minr, int) or minr < 1:
        errors.append("horizontalpodautoscaler.spec.minReplicas: must be "
                      "an integer >= 1")
    elif isinstance(maxr, int) and maxr < minr:
        errors.append("horizontalpodautoscaler.spec.maxReplicas: must be "
                      ">= minReplicas")
    if not spec.get("scaleTargetRef"):
        errors.append("horizontalpodautoscaler.spec.scaleTargetRef: "
                      "required")
    return errors


def validate_pdb(obj: dict) -> list[str]:
    """ValidatePodDisruptionBudget (pkg/apis/policy/validation):
    minAvailable is an int >= 0 or a percentage string."""
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "poddisruptionbudget")
    ma = (obj.get("spec") or {}).get("minAvailable", 0)
    if isinstance(ma, bool) or not isinstance(ma, (int, str)):
        errors.append("poddisruptionbudget.spec.minAvailable: must be an "
                      "integer or a percentage string")
    elif isinstance(ma, int) and ma < 0:
        errors.append("poddisruptionbudget.spec.minAvailable: must be "
                      "non-negative")
    elif isinstance(ma, str):
        if not ma.endswith("%"):
            errors.append("poddisruptionbudget.spec.minAvailable: string "
                          "form must be a percentage, e.g. '30%'")
        else:
            try:
                pct = float(ma[:-1])
            except ValueError:
                errors.append("poddisruptionbudget.spec.minAvailable: "
                              f"unparseable percentage {ma!r}")
            else:
                if pct < 0:
                    # A negative percentage silently disables the budget
                    # (desiredHealthy <= 0 allows every eviction).
                    errors.append("poddisruptionbudget.spec."
                                  "minAvailable: must be non-negative")
    return errors


def validate_scheduled_job(obj: dict) -> list[str]:
    """ValidateScheduledJob (pkg/apis/batch/validation): the schedule
    must parse, the concurrency policy must be a known value, and a job
    template must exist — a stored garbage schedule would wedge the
    controller's every sync."""
    from kubernetes_tpu_torch.utils import cron
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "scheduledjob")
    spec = obj.get("spec") or {}
    try:
        cron.parse(spec.get("schedule", ""))
    except ValueError as err:
        errors.append(f"scheduledjob.spec.schedule: {err}")
    if spec.get("concurrencyPolicy", "Allow") not in (
            "Allow", "Forbid", "Replace"):
        errors.append("scheduledjob.spec.concurrencyPolicy: must be "
                      "Allow, Forbid or Replace")
    if not isinstance(spec.get("jobTemplate"), dict):
        errors.append("scheduledjob.spec.jobTemplate: required")
    return errors


def validate_petset(obj: dict) -> list[str]:
    """ValidatePetSet (pkg/apis/apps/validation): non-negative replicas
    and a pod template."""
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "petset")
    spec = obj.get("spec") or {}
    reps = spec.get("replicas", 1)
    if isinstance(reps, bool) or not isinstance(reps, int) or reps < 0:
        errors.append("petset.spec.replicas: must be a non-negative "
                      "integer")
    if not isinstance(spec.get("template"), dict):
        errors.append("petset.spec.template: required")
    return errors


def validate_cluster_role_binding(obj: dict) -> list[str]:
    """pkg/apis/rbac/validation: a ClusterRoleBinding's roleRef must name
    a ClusterRole — stored otherwise it would either silently grant
    nothing (our authorizer skips it) or, resolved naively, grant
    cluster-wide authority from a namespaced Role."""
    errors: list[str] = []
    _check_name(obj.get("metadata") or {}, errors, "clusterrolebinding")
    ref = obj.get("roleRef") or {}
    if ref.get("kind", "Role") != "ClusterRole":
        errors.append("clusterrolebinding.roleRef.kind: must be "
                      "'ClusterRole'")
    if not ref.get("name"):
        errors.append("clusterrolebinding.roleRef.name: required")
    return errors


VALIDATORS = {"pods": validate_pod, "nodes": validate_node,
              "limitranges": validate_limit_range,
              "resourcequotas": validate_resource_quota,
              "horizontalpodautoscalers": validate_hpa,
              "clusterrolebindings": validate_cluster_role_binding,
              "poddisruptionbudgets": validate_pdb,
              "scheduledjobs": validate_scheduled_job,
              "petsets": validate_petset}


class AdmissionError(Exception):
    """A plugin vetoed the write (admission.Handler denial -> 403)."""


class LimitPodHardAntiAffinityTopology:
    """plugin/pkg/admission/antiaffinity: reject pods whose REQUIRED
    anti-affinity uses a topology key other than the hostname label —
    cluster-wide hard anti-affinity lets one pod fence off whole zones."""

    name = "LimitPodHardAntiAffinityTopology"

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if kind != "pods":
            return
        import json as _json
        ann = (obj.get("metadata") or {}).get("annotations") or {}
        raw = ann.get("scheduler.alpha.kubernetes.io/affinity", "")
        if not raw:
            return
        try:
            aff = _json.loads(raw) if isinstance(raw, str) else raw
        except ValueError:
            return  # malformed affinity is the engine's concern, not ours
        terms = ((aff.get("podAntiAffinity") or {})
                 .get("requiredDuringSchedulingIgnoredDuringExecution")) or ()
        for term in terms:
            key = term.get("topologyKey", "")
            if key and key != "kubernetes.io/hostname":
                raise AdmissionError(
                    f"{self.name}: required pod anti-affinity with topology "
                    f"key {key!r} is not allowed (hostname only)")


def _pod_containers(obj: dict) -> list[dict]:
    spec = obj.get("spec") or {}
    cs = spec.get("containers")
    return [c for c in cs if isinstance(c, dict)] \
        if isinstance(cs, list) else []


def _milli(val) -> int | None:
    """Quantity -> milli-units for comparison (requestLimitEnforcedValues
    does milli-precision comparison when values allow).  None for garbage:
    admission runs BEFORE validation in the chain, so an unparseable
    quantity must fall through to the validator's 422, not crash the
    connection — and a stored-by-other-means garbage LimitRange/quota
    value must not brick the namespace."""
    try:
        return int(parse_quantity(val) * 1000)
    except (ValueError, TypeError, ArithmeticError):
        return None


class LimitRanger:
    """plugin/pkg/admission/limitranger/admission.go: apply the namespace's
    LimitRange Container-type defaults to unset container requests/limits
    (defaultContainerResourceRequirements :190-209, merge :212-247), then
    enforce Min/Max constraints (PodLimitFunc :422-520).  Runs BEFORE
    ResourceQuota, as in the reference plugin order — quota must count the
    post-default requests.

    On a real cluster most pods get their scheduler-visible requests HERE,
    not from their authors; without this plugin the scheduler packs by the
    100m/200Mi nonzero fallback instead of namespace policy."""

    name = "LimitRanger"

    def __init__(self, store=None):
        self._store = store

    def _ranges(self, namespace: str) -> list[dict]:
        if self._store is None:
            return []
        items, _ = self._store.list(
            "limitranges",
            lambda o: (o.get("metadata") or {})
            .get("namespace", "default") == namespace)
        return items

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if kind != "pods":
            return
        ns = (obj.get("metadata") or {}).get("namespace") or "default"
        violations: list[str] = []
        for lr in self._ranges(ns):
            limits = ((lr.get("spec") or {}).get("limits")) or []
            # Defaults first (mergePodResourceRequirements), then Min/Max
            # against the merged values.
            dreq: dict = {}
            dlim: dict = {}
            for item in limits:
                if item.get("type", "Container") != "Container":
                    continue
                dreq.update(item.get("defaultRequest") or {})
                dlim.update(item.get("default") or {})
            applied: list[str] = []
            for c in _pod_containers(obj):
                res = c.get("resources")
                if not isinstance(res, dict):
                    res = {}       # explicit null: default the whole block
                    c["resources"] = res
                req = res.get("requests")
                if not isinstance(req, dict):
                    req = {}
                    res["requests"] = req
                lim = res.get("limits")
                if not isinstance(lim, dict):
                    lim = {}
                    res["limits"] = lim
                set_r = [k for k in dreq if k not in req]
                set_l = [k for k in dlim if k not in lim]
                for k in set_r:
                    req[k] = dreq[k]
                for k in set_l:
                    lim[k] = dlim[k]
                if set_r:
                    applied.append(f"{', '.join(sorted(set_r))} request for "
                                   f"container {c.get('name', '')}")
                if set_l:
                    applied.append(f"{', '.join(sorted(set_l))} limit for "
                                   f"container {c.get('name', '')}")
            if applied:
                ann = (obj.setdefault("metadata", {})
                       .setdefault("annotations", {}))
                ann["kubernetes.io/limit-ranger"] = \
                    "LimitRanger plugin set: " + "; ".join(applied)
            for item in limits:
                if item.get("type", "Container") != "Container":
                    continue
                for c in _pod_containers(obj):
                    res = c.get("resources") if \
                        isinstance(c.get("resources"), dict) else {}
                    req = res.get("requests") if \
                        isinstance(res.get("requests"), dict) else {}
                    lim = res.get("limits") if \
                        isinstance(res.get("limits"), dict) else {}
                    for rname, floor in (item.get("min") or {}).items():
                        fv = _milli(floor)
                        if rname not in req:
                            violations.append(
                                f"minimum {rname} usage per Container is "
                                f"{floor}.  No request is specified.")
                            continue
                        rv = _milli(req[rname])
                        # None (unparseable) on either side: leave it to
                        # the validator's 422.
                        if fv is not None and rv is not None and rv < fv:
                            violations.append(
                                f"minimum {rname} usage per Container is "
                                f"{floor}, but request is {req[rname]}.")
                    for rname, cap in (item.get("max") or {}).items():
                        cv = _milli(cap)
                        if cv is None:
                            continue
                        lv = _milli(lim[rname]) if rname in lim else None
                        rv = _milli(req[rname]) if rname in req else None
                        if lv is not None and lv > cv:
                            violations.append(
                                f"maximum {rname} usage per Container is "
                                f"{cap}, but limit is {lim[rname]}.")
                        elif rname not in lim and rv is not None and rv > cv:
                            violations.append(
                                f"maximum {rname} usage per Container is "
                                f"{cap}, but request is {req[rname]}.")
        if violations:
            raise AdmissionError(f"{self.name}: " + "; ".join(violations))


# Quota resource names tracked for pods (pkg/quota/evaluator/core/pods.go:
# podUsageHelper — pods count, cpu/memory from requests, the requests.*
# aliases mirror them).
_QUOTA_COMPUTE = {"cpu": "cpu", "requests.cpu": "cpu",
                  "memory": "memory", "requests.memory": "memory"}


class ResourceQuota:
    """plugin/pkg/admission/resourcequota: bound namespace usage.  A write
    that would push any tracked resource past the quota's hard limit
    bounces 403 (admission.go:71-…) — creates charge their full usage,
    updates charge their delta (old self excluded from the recompute); a
    quota tracking a compute resource requires every container to specify
    it (the evaluator's Constraints — this is why LimitRanger runs first).

    Usage is recomputed from the live pod list on every admit rather than
    incrementally CAS-maintained: writes are control-plane-rate, the
    recompute is O(pods-in-namespace), and it self-heals after deletes
    without needing the reference's quota controller resync.  The server
    serializes pod admit+store under one write gate so concurrent creates
    cannot both pass the check before either lands."""

    name = "ResourceQuota"

    def __init__(self, store=None):
        self._store = store

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if kind != "pods" or self._store is None:
            return
        meta = obj.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        # Selector pushed into list(): MemStore filters BEFORE its
        # per-item deepcopy, so a quota'd namespace never pays an
        # O(whole-cluster) copy per pod write under the serializing gate.
        in_ns = (lambda o: (o.get("metadata") or {})
                 .get("namespace", "default") == ns)
        quotas, _ = self._store.list("resourcequotas", in_ns)
        if not quotas:
            return
        new_usage = self._pod_usage(obj)
        self_key = f"{ns}/{meta.get('name', '')}"
        pods, _ = self._store.list("pods", in_ns)
        used = {"pods": 0, "cpu": 0, "memory": 0}
        for p in pods:
            pmeta = p.get("metadata") or {}
            if op == "update" and \
                    f"{ns}/{pmeta.get('name', '')}" == self_key:
                continue  # replaced by new_usage: a PUT that inflates
                # requests is charged its delta, not waved through
            phase = (p.get("status") or {}).get("phase", "")
            if phase in ("Succeeded", "Failed"):
                continue  # terminal pods stop counting (pods.go:52-58)
            u = self._pod_usage(p)
            for k in used:
                used[k] += u[k]
        # Surface CURRENT usage (stored pods only, not the pod being
        # admitted) on the quota objects FIRST — admission runs before the
        # store, so a later 422/409 must not leave a phantom pod in
        # status.used, and a 403 below should still record live usage.
        # Status goes through a fresh read + CAS touching ONLY status
        # (the reference's quota CAS): rewriting the listed copy would
        # silently revert a concurrent admin PUT to spec.hard.  Unchanged
        # usage writes nothing — no event, no WAL append, no watcher wake.
        for q in quotas:
            qname = (q.get("metadata") or {}).get("name", "")
            try:
                cur = self._store.get("resourcequotas", f"{ns}/{qname}")
                if cur is None:
                    continue
                status = {
                    "hard": dict(((cur.get("spec") or {}).get("hard"))
                                 or {}),
                    "used": {
                        "pods": str(used["pods"] // 1000),
                        "requests.cpu": f"{used['cpu']}m",
                        "requests.memory": str(used["memory"] // 1000),
                    }}
                if cur.get("status") == status:
                    continue
                self._store.update(
                    "resourcequotas", {**cur, "status": status},
                    expected_rv=(cur.get("metadata") or {})
                    .get("resourceVersion"))
            except Exception:  # noqa: BLE001 — deleted or CAS-raced by a
                pass           # concurrent PUT: surfacing is best-effort
        for q in quotas:
            hard = ((q.get("spec") or {}).get("hard")) or {}
            for rname, cap in hard.items():
                dim = _QUOTA_COMPUTE.get(rname)
                if dim is None and rname != "pods":
                    continue
                if dim is not None and new_usage[f"unset_{dim}"]:
                    raise AdmissionError(
                        f"{self.name}: must specify {dim} — quota "
                        f"{(q.get('metadata') or {}).get('name', '')} "
                        f"tracks {rname}")
                key = dim or "pods"
                cap_v = _milli(cap)
                if cap_v is not None and \
                        used[key] + new_usage[key] > cap_v:
                    raise AdmissionError(
                        f"{self.name}: exceeded quota "
                        f"{(q.get('metadata') or {}).get('name', '')}: "
                        f"requested {rname}, used {used[key]}m of {cap}")

    @staticmethod
    def _pod_usage(obj: dict) -> dict:
        cpu = mem = 0
        unset_cpu = unset_mem = False
        for c in _pod_containers(obj):
            res = c.get("resources")
            req = res.get("requests") if isinstance(res, dict) else None
            req = req if isinstance(req, dict) else {}
            # Unparseable values count 0 and fall through to the
            # validator's 422 (admission must neither crash nor mask the
            # structural error with a quota 403).
            if "cpu" in req:
                cpu += _milli(req["cpu"]) or 0
            else:
                unset_cpu = True
            if "memory" in req:
                mem += _milli(req["memory"]) or 0
            else:
                unset_mem = True
        # All dimensions in milli-units so they compare directly against
        # _milli(hard-cap) — one pod counts 1000 against a "pods: 10" cap
        # of 10000.
        return {"pods": 1000, "cpu": cpu, "memory": mem,
                "unset_cpu": unset_cpu, "unset_memory": unset_mem}


class AlwaysPullImages:
    """plugin/pkg/admission/alwayspullimages: force every container's
    imagePullPolicy to Always — in a multitenant cluster a cached image
    must not let one tenant run another's private bytes without
    registry-side credential checks."""

    name = "AlwaysPullImages"

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if kind != "pods":
            return
        for c in _pod_containers(obj):
            c["imagePullPolicy"] = "Always"


class SecurityContextDeny:
    """plugin/pkg/admission/securitycontext/scdeny: reject pods that set
    the privilege-adjacent SecurityContext fields (SELinuxOptions,
    RunAsUser, SupplementalGroups, FSGroup) at the pod OR container
    level — the cluster posture where user-controlled UID/SELinux
    assignment is forbidden."""

    name = "SecurityContextDeny"

    _POD_FIELDS = ("seLinuxOptions", "runAsUser", "supplementalGroups",
                   "fsGroup")
    _CONTAINER_FIELDS = ("seLinuxOptions", "runAsUser")

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if kind != "pods":
            return
        spec = obj.get("spec") or {}
        sc = spec.get("securityContext") or {}
        for f in self._POD_FIELDS:
            if sc.get(f) is not None:
                raise AdmissionError(
                    f"{self.name}: pod.spec.securityContext.{f} "
                    f"is forbidden")
        for c in _pod_containers(obj):
            csc = c.get("securityContext") or {}
            for f in self._CONTAINER_FIELDS:
                if csc.get(f) is not None:
                    raise AdmissionError(
                        f"{self.name}: securityContext.{f} is forbidden "
                        f"for container {c.get('name', '')}")


SA_MOUNT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount"


class ServiceAccount:
    """plugin/pkg/admission/serviceaccount/admission.go: every pod runs
    AS a service account —

    * an unset ``spec.serviceAccountName`` defaults to ``default``
      (admission.go DefaultServiceAccountName);
    * a pod naming a MISSING non-default SA bounces 403 (admission.go
      getServiceAccount error path) — it would run with credentials
      that don't exist;
    * the SA's token secret is mounted at the canonical path into every
      container that doesn't already mount one (admission.go
      mountServiceAccountToken).

    Deviation, documented: a missing ``default`` SA skips the mount
    instead of rejecting — the serviceaccounts controller creates it
    asynchronously, and the reference's own perf master runs
    AlwaysAdmit precisely to avoid this bootstrap coupling."""

    name = "ServiceAccount"

    def __init__(self, store=None):
        self._store = store

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if kind != "pods" or op != "create" or self._store is None:
            return
        meta = obj.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        spec = obj.setdefault("spec", {})
        sa_name = spec.get("serviceAccountName") or \
            spec.get("serviceAccount") or "default"
        spec["serviceAccountName"] = sa_name
        spec["serviceAccount"] = sa_name  # 1.x carries both fields
        sa = self._store.get("serviceaccounts", f"{ns}/{sa_name}")
        if sa is None:
            if sa_name != "default":
                raise AdmissionError(
                    f"{self.name}: service account {ns}/{sa_name} "
                    f"does not exist")
            return  # bootstrap window: controller will create it
        refs = sa.get("secrets") or []
        token_name = refs[0].get("name", "") if refs else ""
        if not token_name:
            if sa_name != "default":
                # The reference rejects until the token exists
                # (admission.go mountServiceAccountToken: "no API token
                # found ... retry after the token is automatically
                # created") — admitting now would run the pod without
                # credentials forever, since nothing reconciles mounts
                # post-create.
                raise AdmissionError(
                    f"{self.name}: no API token found for service "
                    f"account {ns}/{sa_name}; retry after the token "
                    f"controller creates it")
            return  # default-SA bootstrap window (documented deviation)
        volumes = spec.setdefault("volumes", [])
        vol_name = None
        for v in volumes:
            if (v.get("secret") or {}).get("secretName") == token_name:
                vol_name = v.get("name")
                break
        if vol_name is None:
            vol_name = f"{token_name}-volume"
            volumes.append({"name": vol_name,
                            "secret": {"secretName": token_name}})
        for c in _pod_containers(obj):
            mounts = c.setdefault("volumeMounts", [])
            if any(m.get("mountPath") == SA_MOUNT_PATH for m in mounts):
                continue
            mounts.append({"name": vol_name, "readOnly": True,
                           "mountPath": SA_MOUNT_PATH})


class NamespaceLifecycle:
    """plugin/pkg/admission/namespace/lifecycle: reject creates into a
    namespace that is being torn down.  Unlike the reference, a namespace
    with no Namespace object is allowed (implicit namespaces are this
    store's default; only an explicit Terminating namespace blocks)."""

    name = "NamespaceLifecycle"

    def __init__(self, store=None):
        self._store = store

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        if op != "create" or self._store is None or \
                kind == "namespaces" or kind not in NAMESPACED_KINDS:
            return
        ns = (obj.get("metadata") or {}).get("namespace") or "default"
        nsobj = self._store.get("namespaces", ns)
        if nsobj is None:
            return
        if (nsobj.get("status") or {}).get("phase") == "Terminating" or \
                (nsobj.get("metadata") or {}).get("deletionTimestamp"):
            raise AdmissionError(
                f"{self.name}: namespace {ns} is terminating")


DEFAULT_ADMISSION = (LimitPodHardAntiAffinityTopology(),)


# --admission-control registry (pkg/admission RegisterPlugin): name ->
# factory(store).  AlwaysDeny/AlwaysAdmit are the reference's testing
# plugins; the perf master runs AlwaysAdmit (master_utils.go:220).
ADMISSION_PLUGINS = {
    "NamespaceLifecycle": NamespaceLifecycle,
    "ServiceAccount": ServiceAccount,
    "LimitPodHardAntiAffinityTopology":
        lambda store: LimitPodHardAntiAffinityTopology(),
    "LimitRanger": LimitRanger,
    "ResourceQuota": ResourceQuota,
    "AlwaysPullImages": lambda store: AlwaysPullImages(),
    "SecurityContextDeny": lambda store: SecurityContextDeny(),
    "AlwaysAdmit": lambda store: None,
    "AlwaysDeny": lambda store: _AlwaysDeny(),
}

# The default chain, in the reference's plugin order: namespace
# lifecycle first, ServiceAccount defaulting/mounting, the
# anti-affinity veto, LimitRanger defaulting, then ResourceQuota
# against the post-default requests.
DEFAULT_ADMISSION_CONTROL = (
    "NamespaceLifecycle", "ServiceAccount",
    "LimitPodHardAntiAffinityTopology", "LimitRanger", "ResourceQuota")


class _AlwaysDeny:
    name = "AlwaysDeny"

    def admit(self, kind: str, obj: dict, op: str = "create") -> None:
        raise AdmissionError("AlwaysDeny: admission is disabled")


def store_admission(store, names=None) -> tuple:
    """Build the admission chain in the order ``names`` lists the
    plugins (the reference applies --admission-control in flag order);
    None = the default chain.  Unknown names raise — a typo'd plugin
    silently skipped would be a silently-open cluster."""
    if names is None:
        names = DEFAULT_ADMISSION_CONTROL
    chain = []
    for name in names:
        name = name.strip()
        if not name:
            continue
        if name not in ADMISSION_PLUGINS:
            raise ValueError(f"unknown admission plugin {name!r}")
        plugin = ADMISSION_PLUGINS[name](store)
        if plugin is not None:  # AlwaysAdmit contributes nothing
            chain.append(plugin)
    return tuple(chain)


def admit_and_validate(kind: str, obj: dict,
                       admission=DEFAULT_ADMISSION,
                       op: str = "create") -> list[str]:
    """The write-path chain (pkg/apiserver: admission -> validation ->
    registry).  Returns validation errors; raises AdmissionError on veto."""
    for plugin in admission:
        plugin.admit(kind, obj, op)
    validator = VALIDATORS.get(kind)
    return validator(obj) if validator else []

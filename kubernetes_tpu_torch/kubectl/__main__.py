"""kubectl analogue: the CLI surface over the apiserver HTTP API.

The reference's kubectl (pkg/kubectl + cmd/kubectl) is a resource builder +
printers over the client machinery; this is that shape for the
scheduler-relevant resources:

    python -m kubernetes_tpu_torch.kubectl --server http://... get pods [-n ns]
    ... get nodes [-o json|wide] [name]
    ... describe pod NAME | describe node NAME
    ... create -f pod.json|pod.yaml      (also list documents)
    ... delete pods NAME [-n ns]
    ... cordon NODE / uncordon NODE      (kubectl cordon semantics:
                                          spec.unschedulable toggles, the
                                          scheduler's ready filter honors it)
    ... get events [-n ns]
    ... explain pod NAME [--scheduler http://...]
                                         (the scheduler's decision flight
                                          recorder: chosen node, or
                                          per-predicate failure counts)

Resource aliases match kubectl's (po/pods, no/nodes, svc/services, ev/events,
pv, pvc, rc, rs).  Printers are the reference's table style: NAME, then
kind-specific columns (printers.go HumanReadablePrinter).
"""

# A copy of ``kubernetes_tpu/kubectl/__main__.py`` with its imports
# pointed at this package; the docstring is the program's --help text,
# so it stays the reference's.

from __future__ import annotations

import argparse
import json
import sys
import time

from kubernetes_tpu_torch.client.http import APIClient, APIError

ALIASES = {
    "po": "pods", "pod": "pods", "pods": "pods",
    "no": "nodes", "node": "nodes", "nodes": "nodes",
    "svc": "services", "service": "services", "services": "services",
    "ev": "events", "event": "events", "events": "events",
    "pv": "persistentvolumes", "persistentvolume": "persistentvolumes",
    "persistentvolumes": "persistentvolumes",
    "pvc": "persistentvolumeclaims",
    "persistentvolumeclaim": "persistentvolumeclaims",
    "persistentvolumeclaims": "persistentvolumeclaims",
    "rc": "replicationcontrollers",
    "replicationcontroller": "replicationcontrollers",
    "replicationcontrollers": "replicationcontrollers",
    "rs": "replicasets", "replicaset": "replicasets",
    "replicasets": "replicasets",
    "deploy": "deployments", "deployment": "deployments",
    "deployments": "deployments",
    "limits": "limitranges", "limitrange": "limitranges",
    "limitranges": "limitranges",
    "quota": "resourcequotas", "resourcequota": "resourcequotas",
    "resourcequotas": "resourcequotas",
    "ns": "namespaces", "namespace": "namespaces",
    "namespaces": "namespaces",
    "ds": "daemonsets", "daemonset": "daemonsets",
    "daemonsets": "daemonsets",
    "job": "jobs", "jobs": "jobs",
    "role": "roles", "roles": "roles",
    "rolebinding": "rolebindings", "rolebindings": "rolebindings",
    "clusterrole": "clusterroles", "clusterroles": "clusterroles",
    "clusterrolebinding": "clusterrolebindings",
    "clusterrolebindings": "clusterrolebindings",
    "hpa": "horizontalpodautoscalers",
    "horizontalpodautoscaler": "horizontalpodautoscalers",
    "horizontalpodautoscalers": "horizontalpodautoscalers",
    "pdb": "poddisruptionbudgets",
    "poddisruptionbudget": "poddisruptionbudgets",
    "poddisruptionbudgets": "poddisruptionbudgets",
    "sj": "scheduledjobs", "scheduledjob": "scheduledjobs",
    "scheduledjobs": "scheduledjobs",
    "petset": "petsets", "petsets": "petsets",
    "secret": "secrets", "secrets": "secrets",
    "cm": "configmaps", "configmap": "configmaps",
    "configmaps": "configmaps",
    "sa": "serviceaccounts", "serviceaccount": "serviceaccounts",
    "serviceaccounts": "serviceaccounts",
}

# Kinds whose storage keys carry a namespace (matches the apiserver).
from kubernetes_tpu_torch.api.types import NAMESPACED_KINDS


def _kind(arg: str) -> str:
    kind = ALIASES.get(arg.lower())
    if kind is None:
        raise SystemExit(f'error: unknown resource type "{arg}"')
    return kind


def _pod_row(o: dict, wide: bool = False) -> list[str]:
    meta = o.get("metadata") or {}
    spec = o.get("spec") or {}
    status = o.get("status") or {}
    phase = status.get("phase") or ("Pending" if not spec.get("nodeName")
                                    else "Scheduled")
    conds = {c.get("type"): c.get("status")
             for c in status.get("conditions") or ()}
    if conds.get("PodScheduled") == "False":
        phase = "Pending(Unschedulable)"
    row = [meta.get("name", ""), phase, spec.get("nodeName") or "<none>"]
    if wide:
        reqs: dict = {}
        for c in spec.get("containers") or ():
            for k, v in ((c.get("resources") or {})
                         .get("requests") or {}).items():
                reqs[k] = v
        row += [",".join(f"{k}={v}" for k, v in sorted(reqs.items()))
                or "<none>",
                ",".join(f"{k}={v}" for k, v in sorted(
                    (meta.get("labels") or {}).items())) or "<none>"]
    return row


def _node_row(o: dict) -> list[str]:
    meta = o.get("metadata") or {}
    spec = o.get("spec") or {}
    status = o.get("status") or {}
    conds = {c.get("type"): c.get("status")
             for c in status.get("conditions") or ()}
    st = "Ready" if conds.get("Ready") == "True" else "NotReady"
    if spec.get("unschedulable"):
        st += ",SchedulingDisabled"
    alloc = status.get("allocatable") or {}
    return [meta.get("name", ""), st,
            str(alloc.get("cpu", "")), str(alloc.get("memory", ""))]


_TABLES = {
    "pods": (["NAME", "STATUS", "NODE"], _pod_row),
    "nodes": (["NAME", "STATUS", "CPU", "MEMORY"], _node_row),
    "events": (["NAME", "TYPE", "REASON", "MESSAGE"],
               lambda o: [(o.get("metadata") or {}).get("name", ""),
                          o.get("type", ""), o.get("reason", ""),
                          o.get("message", "")]),
}


def _print_table(kind: str, items: list[dict], out,
                 wide: bool = False) -> None:
    headers, row_fn = _TABLES.get(
        kind, (["NAME"],
               lambda o: [(o.get("metadata") or {}).get("name", "")]))
    if wide and kind == "pods":
        headers = headers + ["REQUESTS", "LABELS"]
        rows = [row_fn(o, wide=True) for o in items]
    else:
        rows = [row_fn(o) for o in items]
    widths = [max([len(h)] + [len(r[i]) for r in rows])
              for i, h in enumerate(headers)]
    print("   ".join(h.ljust(w) for h, w in zip(headers, widths)), file=out)
    for r in rows:
        print("   ".join(c.ljust(w) for c, w in zip(r, widths)), file=out)


def cmd_get(client: APIClient, opts, out) -> int:
    kind = _kind(opts.resource)
    if opts.name:
        key = f"{opts.namespace}/{opts.name}" \
            if kind in NAMESPACED_KINDS else opts.name
        obj = client.get(kind, key)
        if obj is None:
            print(f'Error: {kind} "{opts.name}" not found', file=sys.stderr)
            return 1
        items = [obj]
    else:
        items, _ = client.list(kind)
        if kind in NAMESPACED_KINDS:
            items = [o for o in items
                     if (o.get("metadata") or {}).get("namespace")
                     == opts.namespace]
    if opts.output == "json":
        print(json.dumps({"items": items}, indent=1), file=out)
    else:
        _print_table(kind, items, out, wide=opts.output == "wide")
    return 0


def cmd_describe(client: APIClient, opts, out) -> int:
    kind = _kind(opts.resource)
    key = f"{opts.namespace}/{opts.name}" \
        if kind in NAMESPACED_KINDS else opts.name
    obj = client.get(kind, key)
    if obj is None:
        print(f'Error: {kind} "{opts.name}" not found', file=sys.stderr)
        return 1
    print(json.dumps(obj, indent=2), file=out)
    if kind == "pods":
        events, _ = client.list("events")
        mine = [e for e in events
                if (e.get("involvedObject") or {}).get("name") == opts.name]
        if mine:
            print("\nEvents:", file=out)
            for e in mine:
                print(f"  {e.get('type', '')}\t{e.get('reason', '')}\t"
                      f"{e.get('message', '')}", file=out)
    return 0


def _load_documents(path: str) -> list[dict]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        docs = [d for d in yaml.safe_load_all(text) if d]
    else:
        loaded = json.loads(text)
        docs = loaded if isinstance(loaded, list) else [loaded]
    out = []
    for d in docs:
        if d.get("kind", "").endswith("List"):
            out.extend(d.get("items") or ())
        else:
            out.append(d)
    return out


_KIND_FIELD_TO_RESOURCE = {
    "pod": "pods", "node": "nodes", "service": "services",
    "persistentvolume": "persistentvolumes",
    "persistentvolumeclaim": "persistentvolumeclaims",
    "replicationcontroller": "replicationcontrollers",
    "replicaset": "replicasets",
    "deployment": "deployments",
    "limitrange": "limitranges",
    "resourcequota": "resourcequotas",
    "namespace": "namespaces",
    "daemonset": "daemonsets",
    "job": "jobs",
    "role": "roles",
    "rolebinding": "rolebindings",
    "clusterrole": "clusterroles",
    "clusterrolebinding": "clusterrolebindings",
    "horizontalpodautoscaler": "horizontalpodautoscalers",
}


def cmd_create(client: APIClient, opts, out) -> int:
    rc = 0
    for doc in _load_documents(opts.filename):
        kind_field = doc.get("kind", "Pod").lower()
        resource = _KIND_FIELD_TO_RESOURCE.get(kind_field)
        if resource is None:
            print(f'error: unsupported kind "{doc.get("kind")}"',
                  file=sys.stderr)
            rc = 1
            continue
        try:
            created = client.create(resource, doc)
            name = (created.get("metadata") or {}).get("name", "")
            print(f"{resource[:-1]}/{name} created", file=out)
        except APIError as err:
            print(f"error creating from {opts.filename}: {err}",
                  file=sys.stderr)
            rc = 1
    return rc


LAST_APPLIED_ANNOTATION = "kubectl.kubernetes.io/last-applied-configuration"


def three_way_merge(last: dict, new: dict, live: dict) -> dict:
    """apply.go's three-way patch (pkg/kubectl/cmd/apply.go:139-209 via
    strategicpatch.CreateThreeWayMergePatch), dict-shaped:

    * a field in the NEW manifest wins;
    * a field the previous manifest set but the new one dropped is
      DELETED from live (the user removed it declaratively);
    * everything else keeps its LIVE value — a controller- or
      scale-written field (e.g. an HPA's replicas) survives an apply
      whose manifest never mentions it.

    Lists replace wholesale (the reference's strategic merge keys some
    lists by name; containers-by-name merging is out of scope here and
    documented as such)."""
    merged = dict(live)
    for k, nv in new.items():
        lv = live.get(k)
        if isinstance(nv, dict) and isinstance(lv, dict):
            lastv = last.get(k)
            merged[k] = _three_way_inner(
                lastv if isinstance(lastv, dict) else {}, nv, lv)
        else:
            merged[k] = nv
    for k in last:
        # Top-level metadata is never declaratively deleted (the live
        # object's identity + server-managed fields live there); NESTED
        # keys named metadata (e.g. spec.template.metadata) delete like
        # any other field — _three_way_inner has no such guard.
        if k not in new and k in merged and k != "metadata":
            del merged[k]
    return merged


def _three_way_inner(last: dict, new: dict, live: dict) -> dict:
    merged = dict(live)
    for k, nv in new.items():
        lv = live.get(k)
        if isinstance(nv, dict) and isinstance(lv, dict):
            lastv = last.get(k)
            merged[k] = _three_way_inner(
                lastv if isinstance(lastv, dict) else {}, nv, lv)
        else:
            merged[k] = nv
    for k in last:
        if k not in new and k in merged:
            del merged[k]
    return merged


def cmd_apply(client: APIClient, opts, out) -> int:
    """kubectl apply (pkg/kubectl/cmd/apply.go, the declarative verb):
    create the object if absent, else THREE-WAY merge — previous applied
    config (the last-applied annotation) vs this manifest vs live state
    — so fields other actors own (an HPA's replica count, controller
    status) survive an apply that doesn't mention them.  The update
    carries the live resourceVersion so a concurrent writer wins the CAS
    and apply reports the conflict."""
    rc = 0
    for doc in _load_documents(opts.filename):
        kind_field = doc.get("kind", "Pod").lower()
        resource = _KIND_FIELD_TO_RESOURCE.get(kind_field)
        if resource is None:
            print(f'error: unsupported kind "{doc.get("kind")}"',
                  file=sys.stderr)
            rc = 1
            continue
        meta = doc.setdefault("metadata", {})
        name = meta.get("name", "")
        if resource in NAMESPACED_KINDS:
            meta.setdefault("namespace", "default")
            key = f"{meta['namespace']}/{name}"
        else:
            key = name
        # The annotation records THIS manifest (without itself) for the
        # next apply's base (apply.go GetOriginalConfiguration).
        applied_json = json.dumps(doc, sort_keys=True,
                                  separators=(",", ":"))
        try:
            current = client.get(resource, key)
        except APIError:
            current = None
        try:
            if current is None:
                meta.setdefault("annotations", {})[
                    LAST_APPLIED_ANNOTATION] = applied_json
                client.create(resource, doc)
                print(f"{resource[:-1]}/{name} created", file=out)
            else:
                last_raw = ((current.get("metadata") or {})
                            .get("annotations") or {}) \
                    .get(LAST_APPLIED_ANNOTATION, "")
                try:
                    last = json.loads(last_raw) if last_raw else {}
                except ValueError:
                    last = {}
                merged = three_way_merge(last, doc, current)
                mmeta = merged.setdefault("metadata", {})
                mmeta.setdefault("annotations", {})[
                    LAST_APPLIED_ANNOTATION] = applied_json
                mmeta["resourceVersion"] = \
                    (current.get("metadata") or {}).get("resourceVersion")
                client.update(resource, merged)
                print(f"{resource[:-1]}/{name} configured", file=out)
        except APIError as err:
            print(f"error applying {resource}/{name}: {err}",
                  file=sys.stderr)
            rc = 1
    return rc


def cmd_delete(client: APIClient, opts, out) -> int:
    kind = _kind(opts.resource)
    key = f"{opts.namespace}/{opts.name}" \
        if kind in NAMESPACED_KINDS else opts.name
    try:
        client.delete(kind, key)
    except APIError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    print(f"{kind[:-1]}/{opts.name} deleted", file=out)
    return 0


_SCALABLE = {"replicationcontrollers", "replicasets", "deployments"}


def cmd_scale(client: APIClient, opts, out) -> int:
    """kubectl scale (pkg/kubectl/cmd/scale.go): set spec.replicas with a
    CAS retry loop (the reference's ScalerFor + retry-on-conflict)."""
    kind = _kind(opts.resource)
    if kind not in _SCALABLE:
        print(f'error: "{kind}" cannot be scaled', file=sys.stderr)
        return 1
    key = f"{opts.namespace}/{opts.name}"
    from kubernetes_tpu_torch.apiserver.memstore import ConflictError
    for _ in range(5):
        obj = client.get(kind, key)
        if obj is None:
            print(f'Error: {kind} "{opts.name}" not found', file=sys.stderr)
            return 1
        obj.setdefault("spec", {})["replicas"] = opts.replicas
        try:
            client.update(kind, obj)
            print(f"{kind[:-1]}/{opts.name} scaled", file=out)
            return 0
        except ConflictError:
            continue  # CAS conflict (409): re-read and retry
        except APIError as err:
            print(f"error: {err}", file=sys.stderr)
            return 1
    print("error: too many conflicts while scaling", file=sys.stderr)
    return 1


def _cas_meta_edit(client: APIClient, kind: str, key: str, field: str,
                   pairs: list[str], overwrite: bool, out,
                   display: str) -> int:
    """Shared label/annotate machinery (pkg/kubectl/cmd/label.go,
    annotate.go): k=v sets, k- removes, CAS retry on conflict, and
    no-overwrite protection unless --overwrite."""
    from kubernetes_tpu_torch.apiserver.memstore import ConflictError
    for _ in range(5):
        obj = client.get(kind, key)
        if obj is None:
            print(f'Error: {kind} "{key}" not found', file=sys.stderr)
            return 1
        bucket = obj.setdefault("metadata", {}).setdefault(field, {})
        for pair in pairs:
            if pair.endswith("-") and "=" not in pair:
                bucket.pop(pair[:-1], None)
                continue
            k, sep, v = pair.partition("=")
            if not sep:
                print(f"error: {display} must be KEY=VALUE or KEY-: "
                      f"{pair!r}", file=sys.stderr)
                return 1
            # validateNoOverwrites (label.go:116-124): ANY existing key
            # errors without --overwrite, same value or not.
            if not overwrite and k in bucket:
                print(f"error: '{k}' already has a value "
                      f"({bucket[k]}), and --overwrite is false",
                      file=sys.stderr)
                return 1
            bucket[k] = v
        try:
            client.update(kind, obj)
            name = (obj.get("metadata") or {}).get("name", "")
            verbed = "labeled" if display == "label" else display + "d"
            print(f"{kind[:-1]}/{name} {verbed}", file=out)
            return 0
        except ConflictError:
            continue
        except APIError as err:
            print(f"error: {err}", file=sys.stderr)
            return 1
    print(f"error: too many conflicts while {display}-updating",
          file=sys.stderr)
    return 1


def cmd_label(client: APIClient, opts, out) -> int:
    """kubectl label (pkg/kubectl/cmd/label.go)."""
    kind = _kind(opts.resource)
    key = f"{opts.namespace}/{opts.name}" \
        if kind in NAMESPACED_KINDS else opts.name
    return _cas_meta_edit(client, kind, key, "labels", opts.pairs,
                          opts.overwrite, out, "label")


def cmd_annotate(client: APIClient, opts, out) -> int:
    """kubectl annotate (pkg/kubectl/cmd/annotate.go)."""
    kind = _kind(opts.resource)
    key = f"{opts.namespace}/{opts.name}" \
        if kind in NAMESPACED_KINDS else opts.name
    return _cas_meta_edit(client, kind, key, "annotations", opts.pairs,
                          opts.overwrite, out, "annotate")


def cmd_expose(client: APIClient, opts, out) -> int:
    """kubectl expose (pkg/kubectl/cmd/expose.go): generate a Service
    selecting the workload's pods.  The selector comes from the
    target's own selector (RC map selector / RS+Deployment
    matchLabels)."""
    kind = _kind(opts.resource)
    if kind not in ("replicationcontrollers", "replicasets",
                    "deployments"):
        print(f'error: cannot expose "{kind}"', file=sys.stderr)
        return 1
    key = f"{opts.namespace}/{opts.name}"
    obj = client.get(kind, key)
    if obj is None:
        print(f'Error: {kind} "{opts.name}" not found', file=sys.stderr)
        return 1
    sel = (obj.get("spec") or {}).get("selector") or {}
    if "matchLabels" in sel or "matchExpressions" in sel:
        if sel.get("matchExpressions"):
            print("error: expose cannot express matchExpressions as a "
                  "service selector (the reference has the same limit)",
                  file=sys.stderr)
            return 1
        sel = sel.get("matchLabels") or {}
    if not sel:
        print(f"error: {kind}/{opts.name} has no selector to expose",
              file=sys.stderr)
        return 1
    svc_name = opts.service_name or opts.name
    svc = {"metadata": {"name": svc_name,
                        "namespace": opts.namespace},
           "spec": {"selector": dict(sel),
                    "ports": [{"port": opts.port,
                               "targetPort": opts.target_port
                               or opts.port}]}}
    try:
        client.create("services", svc)
    except APIError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    print(f"service/{svc_name} exposed", file=out)
    return 0


def cmd_rollout(client: APIClient, opts, out) -> int:
    """kubectl rollout status|history|undo (pkg/kubectl/rollout/)."""
    from kubernetes_tpu_torch.controller.deployment import REVISION_ANN
    kind = _kind(opts.resource)
    if kind != "deployments":
        print("error: rollout supports deployments", file=sys.stderr)
        return 1
    key = f"{opts.namespace}/{opts.name}"

    def owned_rss():
        items, _ = client.list("replicasets")
        dep_local = client.get(kind, key) or {}
        sel = ((dep_local.get("spec") or {}).get("selector") or {})
        match = sel.get("matchLabels") or sel or {}
        return [rs for rs in items
                if (rs.get("metadata") or {}).get("namespace", "default")
                == opts.namespace and match and all(
                    ((rs.get("metadata") or {}).get("labels") or {})
                    .get(k) == v for k, v in match.items())]

    if opts.action == "history":
        revs = []
        for rs in owned_rss():
            ann = ((rs.get("metadata") or {}).get("annotations") or {})
            revs.append((int(ann.get(REVISION_ANN, "0")),
                         (rs.get("metadata") or {}).get("name", "")))
        print("REVISION   REPLICASET", file=out)
        for rev, rsname in sorted(revs):
            print(f"{rev:<10} {rsname}", file=out)
        return 0

    if opts.action == "undo":
        from kubernetes_tpu_torch.apiserver.memstore import ConflictError
        for _ in range(5):
            dep = client.get(kind, key)
            if dep is None:
                print(f'Error: deployment "{opts.name}" not found',
                      file=sys.stderr)
                return 1
            dep.setdefault("spec", {})["rollbackTo"] = {
                "revision": opts.to_revision}
            try:
                client.update(kind, dep)
                print(f"deployment/{opts.name} rolled back", file=out)
                return 0
            except ConflictError:
                continue  # the controller's status CAS raced; retry
            except APIError as err:
                print(f"error: {err}", file=sys.stderr)
                return 1
        print("error: too many conflicts while rolling back",
              file=sys.stderr)
        return 1

    if opts.action == "status":
        import time as _time
        deadline = _time.time() + opts.timeout
        while _time.time() < deadline:
            dep = client.get(kind, key)
            if dep is None:
                print(f'Error: deployment "{opts.name}" not found',
                      file=sys.stderr)
                return 1
            spec = dep.get("spec") or {}
            status = dep.get("status") or {}
            want = int(spec.get("replicas", 1))
            updated = int(status.get("updatedReplicas", 0))
            avail = int(status.get("availableReplicas", 0))
            total = int(status.get("replicas", 0))
            gen = int((dep.get("metadata") or {}).get("generation", 0))
            observed = int(status.get("observedGeneration", 0))
            # The controller must have SEEN this spec (rollout_status.go
            # gates on observedGeneration) — without this, the stale
            # status of the previous revision reads as converged.
            if observed >= gen and updated >= want and avail >= want \
                    and total == want:
                print(f'deployment "{opts.name}" successfully rolled out',
                      file=out)
                return 0
            print(f"Waiting for rollout: {updated} of {want} updated, "
                  f"{avail} available...", file=out)
            _time.sleep(0.5)
        print("error: rollout status timed out", file=sys.stderr)
        return 1
    return 2


def _set_unschedulable(client: APIClient, name: str, value: bool,
                       out) -> int:
    obj = client.get("nodes", name)
    if obj is None:
        print(f'Error: node "{name}" not found', file=sys.stderr)
        return 1
    obj.setdefault("spec", {})["unschedulable"] = value
    client.update("nodes", obj)
    print(f"node/{name} {'cordoned' if value else 'uncordoned'}", file=out)
    return 0


def cmd_drain(client: APIClient, opts, out) -> int:
    """kubectl drain (pkg/kubectl/cmd/drain.go): cordon the node, then
    delete every pod on it.  Pods not managed by an RC/RS/Deployment (no
    controller will re-create them elsewhere) are refused without
    --force; DaemonSet pods are refused without --ignore-daemonsets and
    then LEFT IN PLACE (deleting them is futile — the daemon controller
    ignores cordons and would recreate them within a sync), the
    reference's rule exactly."""
    # One selector semantics, not a divergent copy: _matches handles both
    # RC map selectors and RS LabelSelectors (matchLabels+matchExpressions).
    from kubernetes_tpu_torch.controller.daemonset import DS_LABEL
    from kubernetes_tpu_torch.controller.replication import _matches
    name = opts.name
    rc_code = _set_unschedulable(client, name, True, out)
    if rc_code != 0:
        return rc_code  # nonexistent node must not report a clean drain
    pods, _ = client.list("pods")
    mine = [p for p in pods
            if (p.get("spec") or {}).get("nodeName") == name]
    if not mine:
        print(f"node/{name} drained (no pods)", file=out)
        return 0
    daemon_pods = [p for p in mine
                   if ((p.get("metadata") or {}).get("labels") or {})
                   .get(DS_LABEL)]
    if daemon_pods and not opts.ignore_daemonsets:
        names = ", ".join((p.get("metadata") or {}).get("name", "")
                          for p in daemon_pods)
        print(f"error: DaemonSet-managed pods (use --ignore-daemonsets "
              f"to proceed; they will be left in place): {names}",
              file=out)
        return 1
    mine = [p for p in mine if p not in daemon_pods]
    rcs, _ = client.list("replicationcontrollers")
    rss, _ = client.list("replicasets")

    def managed(pod: dict) -> bool:
        pns = (pod.get("metadata") or {}).get("namespace", "default")
        for owner in rcs + rss:
            sel = (owner.get("spec") or {}).get("selector") or {}
            if (owner.get("metadata") or {}).get(
                    "namespace", "default") == pns and _matches(sel, pod):
                return True
        return False

    unmanaged = [p for p in mine if not managed(p)]
    if unmanaged and not opts.force:
        names = ", ".join((p.get("metadata") or {}).get("name", "")
                          for p in unmanaged)
        print(f"error: pods not managed by ReplicationController/"
              f"ReplicaSet (use --force to override): {names}", file=out)
        return 1
    failures = 0
    deadline = time.time() + max(0.0, getattr(opts, "timeout", 5.0))
    for p in mine:
        meta = p.get("metadata") or {}
        pns = meta.get("namespace", "default")
        try:
            # The eviction subresource honors PodDisruptionBudgets
            # (EvictionREST): a blocked eviction comes back 429 and the
            # pod stays — retried until --timeout, because each granted
            # eviction SPENDS the budget (verify-and-decrement) and the
            # disruption controller must observe the delete before it
            # re-opens ``disruptionAllowed``.  A server without the
            # route (404) gets the plain delete drain used before PDBs
            # existed.
            while True:
                try:
                    client.evict(pns, meta.get("name", ""))
                    break
                except APIError as err:
                    if err.status == 404:
                        if "unknown path" in str(err):
                            # Server without the eviction route (the
                            # native rig): plain delete, and a pod
                            # already gone counts as drained (kubectl
                            # treats NotFound as success).
                            try:
                                client.delete(
                                    "pods", f"{pns}/{meta.get('name')}")
                            except APIError as derr:
                                if derr.status != 404:
                                    raise
                        break  # pod 404: already gone = drained
                    if err.status != 429 or time.time() >= deadline:
                        raise
                    time.sleep(0.2)
            print(f"pod/{meta.get('name')} evicted", file=out)
        except APIError as err:
            failures += 1
            print(f"error evicting pod/{meta.get('name')}: {err}",
                  file=out)
    if failures:
        print(f"error: node/{name} NOT fully drained "
              f"({failures} eviction(s) failed)", file=out)
        return 1
    print(f"node/{name} drained", file=out)
    return 0


def cmd_explain(opts, out) -> int:
    """``explain pod NAME``: query the scheduler daemon's decision flight
    recorder (/debug/scheduler/decisions) for the pod's latest recorded
    decision — chosen node, or per-predicate failure counts and the
    top-scoring candidate nodes for an unschedulable pod."""
    import urllib.error
    import urllib.request
    key = opts.name if "/" in opts.name else \
        f"{opts.namespace}/{opts.name}"
    url = (opts.scheduler.rstrip("/") +
           "/debug/scheduler/decisions?pod=" + key)
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            decision = json.loads(r.read())
    except urllib.error.HTTPError as err:
        if err.code == 404:
            print(f'error: no recorded scheduling decision for pod '
                  f'"{key}" (aged out of the flight recorder, or never '
                  f'seen by this scheduler)', file=sys.stderr)
            return 1
        raise
    except urllib.error.URLError as err:
        print(f"error: cannot reach the scheduler at {opts.scheduler} "
              f"({err.reason}); point --scheduler at the daemon's "
              f"status port", file=sys.stderr)
        return 1
    if opts.output == "json":
        print(json.dumps(decision, indent=2), file=out)
        return 0
    print(f"Pod:\t{decision.get('pod')}", file=out)
    print(f"Result:\t{decision.get('result')}", file=out)
    if decision.get("node"):
        print(f"Node:\t{decision['node']}", file=out)
    if decision.get("nominated_node"):
        print(f"Nominated node:\t{decision['nominated_node']} "
              f"(placed by preemption)", file=out)
    victims = decision.get("preempted_victims") or []
    if victims:
        print(f"Preempted victims:\t{', '.join(victims)}", file=out)
    if decision.get("message"):
        print(f"Message:\t{decision['message']}", file=out)
    preds = decision.get("failed_predicates") or {}
    if preds:
        print("Failed predicates (nodes failing):", file=out)
        for name, count in sorted(preds.items(),
                                  key=lambda kv: -kv[1]):
            print(f"  {name}\t{count}", file=out)
    tops = decision.get("top_scores") or []
    if tops:
        print("Top-scoring nodes:", file=out)
        for t in tops:
            print(f"  {t.get('node')}\t{t.get('score'):g}", file=out)
    if decision.get("trace_id"):
        print(f"Trace:\t{decision['trace_id']} "
              f"(see /debug/traces on the scheduler)", file=out)
    return 0


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(prog="kubectl (kubernetes_tpu_torch)",
                                description=__doc__)
    p.add_argument("--server", "-s", required=True,
                   help="apiserver base URL")
    p.add_argument("--token", default="",
                   help="bearer token for an authenticated apiserver")
    from kubernetes_tpu_torch.client.http import TLSConfig
    TLSConfig.add_flags(p)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("get")
    g.add_argument("resource")
    g.add_argument("name", nargs="?", default="")
    g.add_argument("-n", "--namespace", default="default")
    g.add_argument("-o", "--output", default="",
                   choices=["", "json", "wide"])

    d = sub.add_parser("describe")
    d.add_argument("resource")
    d.add_argument("name")
    d.add_argument("-n", "--namespace", default="default")

    ep = sub.add_parser(
        "explain",
        help="why was this pod (not) scheduled — asks the scheduler's "
             "decision flight recorder")
    ep.add_argument("resource", help='only "pod" is explainable')
    ep.add_argument("name", help="pod name or ns/name")
    ep.add_argument("-n", "--namespace", default="default")
    ep.add_argument("-o", "--output", default="", choices=["", "json"])
    ep.add_argument("--scheduler", default="http://127.0.0.1:10251",
                    help="scheduler daemon status URL (the flight "
                         "recorder lives on the scheduler, not the "
                         "apiserver)")

    c = sub.add_parser("create")
    c.add_argument("-f", "--filename", required=True)

    ap = sub.add_parser("apply")
    ap.add_argument("-f", "--filename", required=True)

    x = sub.add_parser("delete")
    x.add_argument("resource")
    x.add_argument("name")
    x.add_argument("-n", "--namespace", default="default")

    for verb in ("cordon", "uncordon"):
        v = sub.add_parser(verb)
        v.add_argument("name")

    dr = sub.add_parser("drain")
    dr.add_argument("name")
    dr.add_argument("--force", action="store_true",
                    help="also evict pods no controller will re-create")
    dr.add_argument("--ignore-daemonsets", action="store_true",
                    help="proceed past DaemonSet-managed pods (left in "
                         "place; the daemon controller ignores cordons)")
    dr.add_argument("--timeout", type=float, default=5.0,
                    help="how long to keep retrying evictions a "
                         "PodDisruptionBudget blocks (429) before "
                         "reporting the drain failed")

    sc = sub.add_parser("scale")
    sc.add_argument("resource")
    sc.add_argument("name")
    sc.add_argument("--replicas", type=int, required=True)
    sc.add_argument("-n", "--namespace", default="default")

    for verb in ("label", "annotate"):
        lb = sub.add_parser(verb)
        lb.add_argument("resource")
        lb.add_argument("name")
        lb.add_argument("pairs", nargs="+",
                        metavar="KEY=VAL|KEY-",
                        help="set KEY=VAL, remove with KEY-")
        lb.add_argument("--overwrite", action="store_true")
        lb.add_argument("-n", "--namespace", default="default")

    ex = sub.add_parser("expose")
    ex.add_argument("resource")
    ex.add_argument("name")
    ex.add_argument("--port", type=int, required=True)
    ex.add_argument("--target-port", type=int, default=0)
    ex.add_argument("--service-name", default="",
                    help="service name (defaults to the workload's)")
    ex.add_argument("-n", "--namespace", default="default")

    ro = sub.add_parser("rollout")
    ro.add_argument("action", choices=["status", "history", "undo"])
    ro.add_argument("resource")
    ro.add_argument("name")
    ro.add_argument("-n", "--namespace", default="default")
    ro.add_argument("--to-revision", type=int, default=0)
    ro.add_argument("--timeout", type=float, default=60.0)

    opts = p.parse_args(argv)
    client = APIClient(opts.server, qps=0, token=opts.token,
                       tls=TLSConfig.from_opts(opts))
    if opts.cmd == "get":
        return cmd_get(client, opts, out)
    if opts.cmd == "describe":
        return cmd_describe(client, opts, out)
    if opts.cmd == "explain":
        if _kind(opts.resource) != "pods":
            print("error: only pods have recorded scheduling decisions",
                  file=sys.stderr)
            return 1
        return cmd_explain(opts, out)
    if opts.cmd == "create":
        return cmd_create(client, opts, out)
    if opts.cmd == "apply":
        return cmd_apply(client, opts, out)
    if opts.cmd == "delete":
        return cmd_delete(client, opts, out)
    if opts.cmd == "cordon":
        return _set_unschedulable(client, opts.name, True, out)
    if opts.cmd == "uncordon":
        return _set_unschedulable(client, opts.name, False, out)
    if opts.cmd == "drain":
        return cmd_drain(client, opts, out)
    if opts.cmd == "scale":
        return cmd_scale(client, opts, out)
    if opts.cmd == "label":
        return cmd_label(client, opts, out)
    if opts.cmd == "annotate":
        return cmd_annotate(client, opts, out)
    if opts.cmd == "expose":
        return cmd_expose(client, opts, out)
    if opts.cmd == "rollout":
        return cmd_rollout(client, opts, out)
    return 2


if __name__ == "__main__":
    sys.exit(main())

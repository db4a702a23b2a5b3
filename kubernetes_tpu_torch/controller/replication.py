"""The label-selector helpers of the replication controllers.

Counterpart of two functions of
``kubernetes_tpu/controller/replication.py``: the apiserver's eviction
subresource matches PodDisruptionBudgets to pods with ``_matches``.  The
controller loops themselves belong to the controller slice.

ReplicaSets use a LabelSelector (matchLabels + matchExpressions);
ReplicationControllers a plain label map — both handled by _matches.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import types as api


def _is_label_selector(selector: dict) -> bool:
    return "matchLabels" in selector or "matchExpressions" in selector


def _matches(selector: dict, pod: dict) -> bool:
    """RC map selector or RS LabelSelector against a pod's labels.  The
    set-based semantics are api.types.LabelSelector.matches — one
    implementation, not a copy."""
    labels = (pod.get("metadata") or {}).get("labels") or {}
    if _is_label_selector(selector):
        parsed = api._parse_label_selector(selector)
        if parsed is None or (not parsed.match_labels
                              and not parsed.match_expressions):
            return False
        return parsed.matches(labels)
    return bool(selector) and \
        all(labels.get(k) == v for k, v in selector.items())

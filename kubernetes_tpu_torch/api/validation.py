"""Policy validation (plugin/pkg/scheduler/api/validation/validation.go +
the plugin registry's unknown-name rejection, factory/plugins.go:251,266).

``validate_policy`` collects EVERY error before failing (the reference's
utilerrors.NewAggregate behavior) and raises ``PolicyValidationError``.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.policy import (Policy, canonical_predicate_name,
                                       canonical_priority_name)

# Every registered fit predicate name (factory/plugins.go registrations via
# algorithmprovider/defaults/defaults.go:65-163 + legacy aliases).
KNOWN_PREDICATES = frozenset({
    "PodFitsResources", "PodFitsHost", "HostName", "PodFitsHostPorts",
    "PodFitsPorts", "MatchNodeSelector", "NoDiskConflict",
    "NoVolumeZoneConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "GeneralPredicates", "PodToleratesNodeTaints",
    "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
    "MatchInterPodAffinity", "ServiceAffinity", "NewNodeLabelPredicate",
})

KNOWN_PRIORITIES = frozenset({
    "LeastRequestedPriority", "MostRequestedPriority",
    "BalancedResourceAllocation", "SelectorSpreadPriority",
    "ServiceSpreadingPriority", "NodePreferAvoidPodsPriority",
    "NodeAffinityPriority", "TaintTolerationPriority",
    "InterPodAffinityPriority", "ImageLocalityPriority", "EqualPriority",
    "ServiceAntiAffinityPriority", "NodeLabelPriority",
})


class PolicyValidationError(ValueError):
    def __init__(self, errors: list[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def validate_policy(policy: Policy) -> None:
    """Raise PolicyValidationError listing every problem (validation.go:28
    'does not return early so that it can find as many errors as possible')."""
    errors: list[str] = []
    for pred in policy.predicates:
        name = canonical_predicate_name(pred)
        if name not in KNOWN_PREDICATES:
            errors.append(
                f'Invalid predicate name "{pred.name}" specified - no '
                f"corresponding function found")
    for prio in policy.priorities:
        # validation.go:31-34: weight must be positive.
        if prio.weight <= 0:
            errors.append(f"Priority {prio.name} should have a positive "
                          f"weight applied to it")
        name = canonical_priority_name(prio)
        if name not in KNOWN_PRIORITIES:
            errors.append(f"Invalid priority name {prio.name} specified - "
                          f"no corresponding function found")
    for ext in policy.extenders:
        # validation.go:37-41: extender weight must be non-negative.
        if ext.weight < 0:
            errors.append(f"Priority for extender {ext.url_prefix} should "
                          f"have a non negative weight applied to it")
        if not ext.url_prefix:
            errors.append("Extender is missing urlPrefix")
        if not ext.filter_verb and not ext.prioritize_verb:
            errors.append(f"Extender {ext.url_prefix} must configure a "
                          f"filterVerb or prioritizeVerb")
    if not 0 <= policy.hard_pod_affinity_symmetric_weight <= 100:
        # factory.go:305 rejects values outside 0-100.
        errors.append("hardPodAffinitySymmetricWeight must be in [0, 100]")
    if errors:
        raise PolicyValidationError(errors)

"""Typed component configuration — the componentconfig API group slice.

The reference gives every daemon a versioned config struct
(``KubeSchedulerConfiguration``, pkg/apis/componentconfig/types.go:426-457)
with defaults applied by the scheme and a ``--config``-style file path on
the binary; flags override file values.  This module is that struct for
the scheduler daemon: JSON both ways, reference defaults, collect-all
validation (the field-error list style of pkg/api/validation).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from kubernetes_tpu_torch.api import types as api

DEFAULT_PORT = 10251  # options/options.go:49 SchedulerDefaultPort
DEFAULT_FAILURE_DOMAINS = (
    "kubernetes.io/hostname,"
    "failure-domain.beta.kubernetes.io/zone,"
    "failure-domain.beta.kubernetes.io/region")  # pkg/api/types.go:3053-3063


@dataclass
class LeaderElectionConfiguration:
    """componentconfig.LeaderElectionConfiguration (types.go:398-424);
    the scheduler's default is LeaderElect=true in the reference's
    defaulting (options/options.go:46) but opt-in here, matching the
    daemon flag surface."""

    leader_elect: bool = False
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0


@dataclass
class KubeSchedulerConfiguration:
    """componentconfig.KubeSchedulerConfiguration (types.go:426-457)."""

    port: int = DEFAULT_PORT
    algorithm_provider: str = "DefaultProvider"
    policy_config_file: str = ""
    scheduler_name: str = api.DEFAULT_SCHEDULER_NAME
    kube_api_qps: float = 50.0
    kube_api_burst: int = 100
    hard_pod_affinity_symmetric_weight: int = 1
    failure_domains: str = DEFAULT_FAILURE_DOMAINS
    # The reference's scheme default for the scheduler is
    # EnableProfiling=true (v1alpha1 defaults) — a config file that never
    # mentions it must not silently turn /debug off.
    enable_profiling: bool = True
    feature_gates: str = ""          # "Name=true,Other=false"
    leader_election: LeaderElectionConfiguration = field(
        default_factory=LeaderElectionConfiguration)

    # -- codec -----------------------------------------------------------

    _KEYS = {
        "port": "port",
        "algorithmProvider": "algorithm_provider",
        "policyConfigFile": "policy_config_file",
        "schedulerName": "scheduler_name",
        "kubeAPIQPS": "kube_api_qps",
        "kubeAPIBurst": "kube_api_burst",
        "hardPodAffinitySymmetricWeight":
            "hard_pod_affinity_symmetric_weight",
        "failureDomains": "failure_domains",
        "enableProfiling": "enable_profiling",
        "featureGates": "feature_gates",
    }
    _LE_KEYS = {
        "leaderElect": "leader_elect",
        "leaseDuration": "lease_duration",
        "renewDeadline": "renew_deadline",
        "retryPeriod": "retry_period",
    }

    @classmethod
    def from_json(cls, text: str) -> "KubeSchedulerConfiguration":
        raw = json.loads(text)
        if not isinstance(raw, dict):
            raise ValueError("KubeSchedulerConfiguration must be an object")
        kind = raw.get("kind", "KubeSchedulerConfiguration")
        if kind != "KubeSchedulerConfiguration":
            raise ValueError(f"wrong kind {kind!r}")
        cfg = cls()
        unknown = [k for k in raw
                   if k not in cls._KEYS
                   and k not in ("kind", "apiVersion", "leaderElection")]
        if unknown:
            raise ValueError(f"unknown fields: {', '.join(sorted(unknown))}")
        for wire, attr in cls._KEYS.items():
            if wire in raw:
                setattr(cfg, attr, raw[wire])
        le = raw.get("leaderElection") or {}
        unknown_le = [k for k in le if k not in cls._LE_KEYS]
        if unknown_le:
            raise ValueError("unknown leaderElection fields: "
                             + ", ".join(sorted(unknown_le)))
        for wire, attr in cls._LE_KEYS.items():
            if wire in le:
                setattr(cfg.leader_election, attr, le[wire])
        return cfg

    def to_json(self) -> str:
        out: dict = {"kind": "KubeSchedulerConfiguration",
                     "apiVersion": "componentconfig/v1alpha1"}
        for wire, attr in self._KEYS.items():
            out[wire] = getattr(self, attr)
        out["leaderElection"] = {
            wire: getattr(self.leader_election, attr)
            for wire, attr in self._LE_KEYS.items()}
        return json.dumps(out, indent=1)

    def validate(self) -> list[str]:
        """Collect-all field errors (validation.go style).  Type errors
        (a JSON string where a number belongs) are collected too, not
        raised — the contract is one list with every problem."""
        errors: list[str] = []
        num = (int, float)
        typed = [("port", self.port, num),
                 ("kubeAPIQPS", self.kube_api_qps, num),
                 ("kubeAPIBurst", self.kube_api_burst, num),
                 ("hardPodAffinitySymmetricWeight",
                  self.hard_pod_affinity_symmetric_weight, num),
                 ("enableProfiling", self.enable_profiling, bool),
                 ("leaderElection.leaseDuration",
                  self.leader_election.lease_duration, num),
                 ("leaderElection.renewDeadline",
                  self.leader_election.renew_deadline, num)]
        bad_types = set()
        for fieldname, value, kinds in typed:
            # bool is an int subclass: a JSON true for a numeric field
            # should still be flagged.
            if not isinstance(value, kinds) or \
                    (kinds is num and isinstance(value, bool)):
                errors.append(f"{fieldname}: expected a "
                              f"{'number' if kinds is num else 'boolean'},"
                              f" got {value!r}")
                bad_types.add(fieldname)
        if "port" not in bad_types and not 0 <= self.port <= 65535:
            errors.append(f"port: {self.port} not in 0-65535")
        if "hardPodAffinitySymmetricWeight" not in bad_types and \
                not 0 <= self.hard_pod_affinity_symmetric_weight <= 100:
            errors.append("hardPodAffinitySymmetricWeight: "
                          f"{self.hard_pod_affinity_symmetric_weight} "
                          "not in 0-100")
        if "kubeAPIQPS" not in bad_types and self.kube_api_qps < 0:
            errors.append(f"kubeAPIQPS: {self.kube_api_qps} negative")
        if "kubeAPIBurst" not in bad_types and self.kube_api_burst < 0:
            errors.append(f"kubeAPIBurst: {self.kube_api_burst} negative")
        if self.algorithm_provider not in ("DefaultProvider",
                                           "ClusterAutoscalerProvider"):
            errors.append("algorithmProvider: unknown "
                          f"{self.algorithm_provider!r}")
        if self.failure_domains != DEFAULT_FAILURE_DOMAINS:
            # The engine's topology tables pin the default key set
            # (features/affinity.py _DomainTable, ops/interpod.py
            # N_DEFAULT_KEYS); a custom set silently doing nothing would
            # be worse than an explicit refusal.
            errors.append("failureDomains: custom domains are not "
                          "supported by this build (fixed to "
                          f"{DEFAULT_FAILURE_DOMAINS!r})")
        le = self.leader_election
        if "leaderElection.leaseDuration" not in bad_types and \
                "leaderElection.renewDeadline" not in bad_types and \
                le.renew_deadline >= le.lease_duration:
            errors.append("leaderElection: renewDeadline "
                          f"{le.renew_deadline} must be < leaseDuration "
                          f"{le.lease_duration}")
        try:
            from kubernetes_tpu_torch.utils.featuregate import FeatureGate
            FeatureGate.parse(self.feature_gates)
        except ValueError as err:
            errors.append(f"featureGates: {err}")
        return errors

    def asdict(self) -> dict:
        return asdict(self)

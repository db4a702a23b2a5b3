"""Workload constraints: gang scheduling (``gang``: all-or-nothing
admission over the assignment vector), priority preemption
(``preemption``: the victim solve over a per-node victim table) and
topology spread (``topology``: mask and score planes from
topologySpreadConstraints)."""

from kubernetes_tpu_torch.engine.workloads import gang, preemption, topology

__all__ = ["gang", "preemption", "topology"]

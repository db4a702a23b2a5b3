"""Workload constraints: gang scheduling (``gang``: all-or-nothing
admission over the assignment vector) and priority preemption
(``preemption``: the victim solve over a per-node victim table).
Topology spread is a later slice."""

from kubernetes_tpu_torch.engine.workloads import gang, preemption

__all__ = ["gang", "preemption"]

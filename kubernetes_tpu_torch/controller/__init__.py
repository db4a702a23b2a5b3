"""Controllers (pkg/controller analogue): the replication manager
(ReplicationControllers and ReplicaSets), the deployment, daemon set,
job, scheduled job, pet set, disruption budget, horizontal pod
autoscaler, resource quota, service account, namespace, garbage
collector and pod GC controllers, the node lifecycle controller and the
endpoints controller.  ``python -m kubernetes_tpu_torch.controller`` is
the controller-manager binary that runs all fifteen."""

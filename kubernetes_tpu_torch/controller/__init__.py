"""Controllers (pkg/controller analogue): the replication manager
(ReplicationControllers and ReplicaSets), the node lifecycle controller
and the endpoints controller.  The controller-manager binary and the
other controllers come with the next slice."""

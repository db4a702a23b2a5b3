"""Client machinery (pkg/client analogue)."""

from __future__ import annotations


def cas_update(source, kind: str, obj: dict) -> dict:
    """Update with the object's own resourceVersion as a CAS precondition
    on EITHER transport.  The HTTP server applies the body's rv as the
    precondition itself (apiserver PUT -> GuaranteedUpdate semantics); a
    direct MemStore call must pass it explicitly, or a read-modify-write
    silently clobbers concurrent writers (e.g. a node controller
    overwriting a kubelet heartbeat that landed in between)."""
    from kubernetes_tpu_torch.apiserver.memstore import MemStore
    if isinstance(source, MemStore):
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        return source.update(kind, obj, expected_rv=rv)
    return source.update(kind, obj)

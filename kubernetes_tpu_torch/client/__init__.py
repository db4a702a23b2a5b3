"""Client machinery (pkg/client analogue): the HTTP client of the
apiserver surface (``client/http.py``), the transport-agnostic
reflector (``client/reflector.py``) and a CAS update over either
transport."""

from __future__ import annotations

from kubernetes_tpu_torch.client.http import (APIClient, APIError,
                                              HTTPWatcher, TLSConfig)

__all__ = ["APIClient", "APIError", "HTTPWatcher", "TLSConfig",
           "cas_update"]


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

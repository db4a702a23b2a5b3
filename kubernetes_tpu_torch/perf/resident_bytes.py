"""The resident cluster's bytes at a cluster size, from its shapes and
dtypes.

``python -m kubernetes_tpu_torch.perf.resident_bytes [--nodes 5000]
[--pods 30000] [--profile mixed] [--chunk 2048]`` builds the synthetic
rig on the CPU (no card: bytes follow from shapes and dtypes alone),
compiles one chunk, and prints one JSON object: each plane of the
``ResidentCluster`` (the device-resident ``DeviceCluster``) with its
shape, dtype and bytes, their total, and the bytes of one chunk's
``DeviceBatch`` and encoded ``[P, N]`` plane.  It is the count the
JAX package's narrow planes (``NarrowCluster``: int16/uint8 planes in
place of int32) would shrink.
"""

from __future__ import annotations

import argparse
import json
import sys


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=30000)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--profile", default="mixed")
    opts = ap.parse_args(argv)
    from kubernetes_tpu_torch.engine import solver as sv
    from kubernetes_tpu_torch.perf import synth
    sched, pods = synth.make_rig(opts.nodes, opts.pods,
                                 profile=opts.profile, device="cpu")
    _batch, db, dc, _nt = sched._compile(pods[:opts.chunk])
    planes = {name: {"shape": list(t.shape),
                     "dtype": str(t.dtype).replace("torch.", ""),
                     "bytes": _nbytes(t)}
              for name, t in zip(sv.DeviceCluster._fields, dc)}

    def tree_bytes(tree) -> int:
        if hasattr(tree, "_fields"):
            return sum(tree_bytes(v) for v in tree)
        return _nbytes(tree)

    rec = {"nodes": opts.nodes, "profile": opts.profile,
           "resident_planes": planes,
           "resident_bytes": sum(p["bytes"] for p in planes.values()),
           "chunk_pods": opts.chunk,
           "chunk_batch_bytes": tree_bytes(db),
           "chunk_encoded_plane_bytes_f32": opts.chunk * opts.nodes * 4}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

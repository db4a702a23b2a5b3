"""The PyTorch port imports neither ``jax`` nor the JAX package.

``kubernetes_tpu_torch`` starts with ``kubernetes_tpu``, so every check
matches the name ``kubernetes_tpu`` exactly or names starting with
``kubernetes_tpu.``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "kubernetes_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            out.append(node.module)
    return out


def test_forbidden_name_match_is_exact():
    assert _forbidden("kubernetes_tpu") and _forbidden("kubernetes_tpu.api")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping_x")
    assert not _forbidden("kubernetes_tpu_torch.engine.solver")


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"ops/combine.py", "server/extender.py", "utils/debugmux.py",
            "utils/metrics.py", "engine/extender_client.py",
            "api/validation.py"} <= names
    bad = {str(f.relative_to(REPO)): [m for m in _imports(f)
                                      if _forbidden(m)]
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


_DRAIN = r"""
import json, sys
from kubernetes_tpu_torch.perf import synth
eng, pods = synth.make_rig(24, 40, profile="rich", device="cpu")
placed = [n for _, pl in eng.schedule_batch_stream(pods, chunk_size=16)
          for n in pl]
placed += eng.schedule_batch(pods[:8])
placed.append(eng.schedule(pods[8]))
eng.explain_failures(pods[:2])
from kubernetes_tpu_torch.perf.synth import make_nodes
from kubernetes_tpu_torch.api.types import node_to_json
from kubernetes_tpu_torch.server.extender import ExtenderCore
body = json.dumps({"Pod": {"metadata": {"name": "p"}}, "Nodes": {"Items": [
    node_to_json(n) for n in make_nodes(8)]}}).encode()
verdict = json.loads(ExtenderCore(device="cpu").handle("filter", body))
placed += [n["metadata"]["name"] for n in verdict["nodes"]["items"]]
mods = sorted(m for m in sys.modules
              if m in ("jax", "jaxlib", "kubernetes_tpu")
              or m.startswith(("jax.", "jaxlib.", "kubernetes_tpu.")))
print(json.dumps({"placed": sum(p is not None for p in placed),
                  "forbidden": mods}))
"""


def test_a_port_drain_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRAIN], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["placed"] > 0
    assert out["forbidden"] == []


def test_entry_points_default_to_cuda_and_raise_without_it():
    from kubernetes_tpu_torch.engine.solver import ResidentCluster
    from kubernetes_tpu_torch.perf import synth
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResidentCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.make_rig(4, 4)

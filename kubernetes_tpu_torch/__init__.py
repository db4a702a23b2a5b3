"""kubernetes_tpu_torch — the PyTorch/CUDA counterpart of ``kubernetes_tpu``.

The same scheduling decisions as the JAX package, computed with PyTorch
tensors on an NVIDIA GPU; the one Pallas kernel of the JAX package (the
fused select, ``engine/fused.py``), the sequential scan around it
(``engine/scan.py``) and the single-pod selectHost (``ops/combine.py``)
are hand-written CUDA kernels under ``csrc/``.  The scheduler-extender
sidecar runs as ``python -m kubernetes_tpu_torch.server.extender``.  The package keeps the JAX package's module
layout and names so each module has an obvious counterpart, and it
imports neither ``jax`` nor ``kubernetes_tpu``: the host modules it
needs (API types, the NumPy feature compiler, the scheduler cache) are
its own copies.

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"

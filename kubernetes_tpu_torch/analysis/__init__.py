"""kt-lint and kt-xray for this package.

Counterpart of the JAX package's ``analysis/``, held to this package's
tree (``kubernetes_tpu_torch/``) with its own baseline and manifest:

* :mod:`kubernetes_tpu_torch.analysis.core` — the framework: rule
  registry, per-line ``# ktlint: disable=RULE`` suppressions, the
  committed baseline (``analysis/ktlint_baseline.json``), text/JSON
  output;
* :mod:`kubernetes_tpu_torch.analysis.rules_device` — D01..D05 (torch
  import layering, readback routing, purity of the kernel wrappers and
  launched bodies, knob discipline, implicit host syncs);
* :mod:`kubernetes_tpu_torch.analysis.rules_concurrency` — C01..C03
  (static lock-order graph, locktrace, threadreg);
* :mod:`kubernetes_tpu_torch.analysis.knobs_check` — every ``KT_*`` name
  this package reads is declared in its ``utils/knobs.py`` and every
  declared knob is read;
* :mod:`kubernetes_tpu_torch.analysis.xray` — X01..X04 over the compile
  surface: each device program family of ``engine/entrypoints.py`` run on
  ``meta`` tensors into the committed ``analysis/shape_manifest.json``
  (imports torch; not imported here).

Drivers: ``python -m kubernetes_tpu_torch.analysis`` (kt-lint),
``python -m kubernetes_tpu_torch.analysis.knobs_check`` and ``python -m
kubernetes_tpu_torch.analysis.xray``.
"""

from kubernetes_tpu_torch.analysis.core import (Finding, Project,  # noqa: F401
                                                RULES, run_project)
from kubernetes_tpu_torch.analysis import rules_device  # noqa: F401
from kubernetes_tpu_torch.analysis import rules_concurrency  # noqa: F401

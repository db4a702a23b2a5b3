"""kubectl (``python -m kubernetes_tpu_torch.kubectl``): a copy of the JAX
package's client CLI, with ``main(argv, out)`` in ``__main__``."""

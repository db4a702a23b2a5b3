"""The port's fused select (kubernetes_tpu_torch/engine/fused.py) against
the JAX package's select_xla and its Pallas kernel (interpret mode).

Tolerance: exact equality — the outputs are integer choices and tie
counts.  Inputs are made from a seed with numpy and handed to both
packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine import fused as ref_fused
from kubernetes_tpu_torch.engine import fused, kernels

WRAP_COUNTERS = (0, 7, 2 ** 31, 2 ** 32 - 1)

# One compile per row width instead of a trace per call.
_xla = jax.jit(ref_fused.select_xla)
_pallas = jax.jit(lambda m, c: ref_fused.select_pallas(m, c, interpret=True))


def _rows(n: int, rng: np.random.RandomState) -> list[np.ndarray]:
    """Edge-case rows: nothing feasible, one feasible node, many ties,
    every node tied, a +inf maximum, distinct values."""
    neg = -np.inf
    one = np.full(n, neg, np.float32)
    one[rng.randint(n)] = 5.0
    ties = rng.randint(0, 3, n).astype(np.float32)
    ties[rng.rand(n) < 0.4] = neg
    pinf = rng.randint(0, 3, n).astype(np.float32)
    pinf[rng.randint(n)] = np.inf
    return [np.full(n, neg, np.float32), one, ties,
            np.full(n, 2.0, np.float32), pinf,
            rng.randn(n).astype(np.float32)]


def _plain(row: np.ndarray, counter: int) -> tuple[int, int]:
    out = fused.select_plain(torch.from_numpy(row)[None],
                             torch.tensor([counter], dtype=torch.int64))
    return int(out[0, 0]), int(out[0, 1])


@pytest.mark.parametrize("n", [1, 8, 33, 128])
def test_select_plain_matches_xla_and_pallas_interpret(n):
    rng = np.random.RandomState(n)
    for row in _rows(n, rng):
        for counter in WRAP_COUNTERS:
            choice, n_ties = _plain(row, counter)
            cx, ax = _xla(jnp.asarray(row), jnp.uint32(counter))
            cp, ap = _pallas(jnp.asarray(row), jnp.uint32(counter))
            assert choice == int(cx) == int(cp), (row, counter)
            assert (n_ties > 0) == bool(ax) == bool(ap)


def test_select_plain_random_rows_match_xla():
    rng = np.random.RandomState(11)
    for _ in range(40):
        n = int(rng.choice([5, 64, 257]))
        row = np.where(rng.rand(n) > 0.4,
                       rng.randint(0, 4, n), -np.inf).astype(np.float32)
        counter = int(rng.randint(0, 2 ** 32, dtype=np.uint64))
        cx, _ = _xla(jnp.asarray(row), jnp.uint32(counter))
        assert _plain(row, counter)[0] == int(cx)


def test_counter_wraps_like_uint32():
    """The int64 counter's low 32 bits are the reference's uint32: one
    past 2^32-1 selects like counter 0, and the wrap matches the JAX
    select fed the wrapped uint32."""
    row = np.full(33, 1.0, np.float32)
    assert _plain(row, 2 ** 32 - 1)[0] == (2 ** 32 - 1) % 33
    assert _plain(row, 2 ** 32)[0] == 0
    assert _plain(row, 2 ** 32 + 7)[0] == 7
    wrapped = jnp.uint32(2 ** 32 - 1) + jnp.uint32(1)
    cx, _ = ref_fused.select_xla(jnp.asarray(row), wrapped)
    assert int(cx) == _plain(row, 2 ** 32)[0]


def test_tie_count_is_exact():
    row = np.array([3, -np.inf, 3, 1, 3], np.float32)
    assert _plain(row, 0) == (0, 3)
    assert _plain(row, 1) == (2, 3)
    assert _plain(row, 5) == (4, 3)
    assert _plain(np.full(4, -np.inf, np.float32), 9) == (-1, 0)


def test_batched_rows_match_row_by_row():
    rng = np.random.RandomState(3)
    rows = _rows(40, rng)
    masked = np.repeat(np.stack(rows), len(WRAP_COUNTERS), axis=0)
    counters = np.tile(np.asarray(WRAP_COUNTERS, np.int64), len(rows))
    out = fused.select_rows(torch.from_numpy(masked),
                            torch.from_numpy(counters))
    assert out.dtype == torch.int32 and out.shape == (masked.shape[0], 2)
    for r in range(masked.shape[0]):
        assert tuple(out[r].tolist()) == _plain(masked[r], counters[r])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fused.select_rows.launches
    choice, n_ties = fused.select(torch.tensor([1.0, 4.0, 4.0]),
                                  torch.tensor([1], dtype=torch.int64))
    assert (int(choice[0]), int(n_ties[0])) == (2, 2)
    assert fused.select_rows.launches == before


def test_build_targets_hopper_without_fast_math():
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast-math" not in flags and "fast_math" not in flags
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "kubernetes_tpu_torch")

"""The port's single-pod selectHost (kubernetes_tpu_torch/ops/combine.py)
against the JAX package's ``combine.select_hosts``.

Tolerance: exact equality — the outputs are integer choices and the
uint32 round-robin counter.  Inputs are made from a seed with numpy and
handed to both packages.  On the CPU the wrapper computes its plain
version; the kernel itself is checked against it on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import combine as ref_combine
from kubernetes_tpu_torch.ops import combine

# uint32 counters, including the wrap (JAX holds the counter as uint32).
COUNTERS = (0, 3, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1)

_ref = jax.jit(ref_combine.select_hosts)


def _case(p: int, n: int, kind: str, rng: np.random.RandomState
          ) -> tuple[np.ndarray, np.ndarray]:
    """(scores [p, n] f32, feasible [p, n] bool) for one edge case."""
    scores = rng.randint(0, 3, (p, n)).astype(np.float32)
    feasible = rng.rand(p, n) < 0.6
    if kind == "infeasible":
        feasible[:] = False
    elif kind == "mixed_rows":
        # Some rows have no feasible node, so feas_before matters.
        feasible[::2] = False
    elif kind == "nan":
        scores[rng.rand(p, n) < 0.2] = np.nan
    elif kind == "pinf":
        scores[rng.rand(p, n) < 0.2] = np.inf
    elif kind == "ninf":
        scores[:] = -np.inf
    elif kind == "ninf_some":
        scores[rng.rand(p, n) < 0.5] = -np.inf
    elif kind == "nan_infeasible":
        # NaN only where nothing is feasible: masked to -inf, no effect.
        scores[~feasible] = np.nan
    elif kind == "all_tie":
        scores[:] = 1.0
        feasible[:] = True
    elif kind == "distinct":
        scores = rng.randn(p, n).astype(np.float32)
    return scores, feasible


KINDS = ("random", "infeasible", "mixed_rows", "nan", "pinf", "ninf",
         "ninf_some", "nan_infeasible", "all_tie", "distinct")


def _both(scores: np.ndarray, feasible: np.ndarray, last: int):
    jc, jl = _ref(jnp.asarray(scores), jnp.asarray(feasible),
                  jnp.uint32(last))
    tc, tl = combine.select_hosts(torch.from_numpy(scores),
                                  torch.from_numpy(feasible),
                                  torch.tensor([last], dtype=torch.int64))
    return (np.asarray(jc), int(jl)), (tc, tl)


@pytest.mark.parametrize("p", [1, 7])
@pytest.mark.parametrize("n", [1, 5, 300])
@pytest.mark.parametrize("kind", KINDS)
def test_select_hosts_matches_reference(p, n, kind):
    rng = np.random.RandomState(p * 1000 + n)
    scores, feasible = _case(p, n, kind, rng)
    for last in COUNTERS:
        (jc, jl), (tc, tl) = _both(scores, feasible, last)
        assert tc.dtype == torch.int32 and tc.shape == (p,)
        assert tl.dtype == torch.int64 and tl.shape == (1,)
        assert np.array_equal(tc.numpy(), jc), (kind, last)
        assert int(tl[0]) == jl, (kind, last)


def test_edge_cases_pin_the_reference_semantics():
    """A feasible NaN leaves no tie, so the pick is node 0; all -inf
    feasible scores still tie; a row with nothing feasible is -1 and does
    not advance the counter."""
    nan_row = np.array([[1.0, np.nan, 2.0]], np.float32)
    feas = np.array([[False, True, True]])
    (jc, _), (tc, tl) = _both(nan_row, feas, 1)
    assert tc.tolist() == jc.tolist() == [0]
    assert int(tl[0]) == 2
    ninf = np.full((1, 4), -np.inf, np.float32)
    feas = np.array([[False, True, False, True]])
    (jc, _), (tc, _) = _both(ninf, feas, 1)
    assert tc.tolist() == jc.tolist() == [3]
    scores = np.zeros((3, 4), np.float32)
    feas = np.array([[True] * 4, [False] * 4, [True] * 4])
    (jc, jl), (tc, tl) = _both(scores, feas, 2 ** 32 - 1)
    assert tc.tolist() == jc.tolist() == [3, -1, 0]
    assert int(tl[0]) == jl == 1


def test_plain_version_is_what_cpu_tensors_get():
    rng = np.random.RandomState(3)
    scores, feasible = _case(7, 300, "random", rng)
    s, f = torch.from_numpy(scores), torch.from_numpy(feasible)
    last = torch.tensor([9], dtype=torch.int64)
    before = combine.select_hosts.launches
    got = combine.select_hosts(s, f, last)
    want = combine.select_hosts_plain(s, f, last)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert combine.select_hosts.launches == before


def test_counter_above_uint32_is_taken_modulo_2_32():
    scores = np.zeros((2, 5), np.float32)
    feas = np.ones((2, 5), bool)
    s, f = torch.from_numpy(scores), torch.from_numpy(feas)
    choice, new_last = combine.select_hosts(
        s, f, torch.tensor([2 ** 32 + 3], dtype=torch.int64))
    assert choice.tolist() == [3, 4]
    assert new_last.tolist() == [5]


def test_wrapper_rejects_what_it_does_not_take():
    s = torch.zeros((2, 4))
    f = torch.ones((2, 4), dtype=torch.bool)
    last = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="float32"):
        combine.select_hosts(s.double(), f, last)
    with pytest.raises(ValueError, match="float32"):
        combine.select_hosts(s[0], f[0], last)
    with pytest.raises(ValueError, match="bool"):
        combine.select_hosts(s, f.int(), last)
    with pytest.raises(ValueError, match="bool"):
        combine.select_hosts(s, f[:, :3], last)
    with pytest.raises(ValueError, match="contiguous"):
        combine.select_hosts(torch.zeros((4, 2)).t(), f, last)
    with pytest.raises(ValueError, match="int64"):
        combine.select_hosts(s, f, last.int())
    with pytest.raises(ValueError, match=r"\[1\]"):
        combine.select_hosts(s, f, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        combine.select_hosts(torch.zeros((0, 4)),
                             torch.zeros((0, 4), dtype=torch.bool), last)
    with pytest.raises(ValueError, match="share a device"):
        combine.select_hosts(s, f, last.to("meta"))

"""The port's node-sharded mesh (``kubernetes_tpu_torch/parallel/mesh.py``)
against the JAX package's unsharded results, on the CPU.

The one-shot evaluate (pods over the batch axis, nodes over the node
axis), the sequential-greedy solve and the joint solve over k in {1, 2,
3, 4} node shards equal the JAX package's unsharded ``evaluate``,
``_solve_scan`` and ``solve_joint`` bit for bit (feasible masks, scores,
choices and round-robin counters), on ``perf/synth.py`` inputs from a
numpy seed, with N both divisible and not divisible by k.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.engine import solver as r_sv
from kubernetes_tpu_torch.engine import convert
from kubernetes_tpu_torch.engine import solver as t_sv
from kubernetes_tpu_torch.parallel import mesh
from torch_parity import both, host_inputs, ref_rig, same

# (profile, nodes, pods): N = 24 divides by 1..4, N = 23 by none of 2..4.
RIGS = [("mixed", 24, 64), ("rich", 23, 48)]


@pytest.fixture(scope="module", params=RIGS, ids=lambda r: f"{r[0]}-{r[1]}")
def rig(request):
    profile, n, p = request.param
    np.random.seed(0)
    eng, pods, _ = ref_rig(profile, n, p, n_existing=12)
    batch, hb, hc, _ = host_inputs(eng, pods)
    jb, jc, tb, tc = both(hb, hc)
    flags = r_sv.batch_flags(batch)
    ts = t_sv.Solver.for_policy(eng.policy)
    return eng, jb, jc, tb, tc, flags, ts


def test_node_bounds_split_evenly_with_remainders():
    assert mesh.node_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert mesh.node_bounds(8, 1) == [(0, 8)]
    with pytest.raises(ValueError):
        mesh.node_bounds(3, 4)


def test_make_mesh_places_every_shard():
    m = mesh.make_mesh(4, batch=2, device="cpu")
    assert m.shape == {"batch": 2, "nodes": 2}
    assert m.row(1) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        mesh.make_mesh(3, batch=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh(2)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sharded_evaluate_equals_the_reference(rig, k):
    eng, jb, jc, tb, tc, flags, ts = rig
    want_f, want_s = eng.solver.evaluate(jb, jc)
    batch_axis = 2 if k % 2 == 0 else 1
    m = mesh.make_mesh(k, batch=batch_axis, device="cpu")
    got_f, got_s = mesh.evaluate(ts, tb, tc, m)
    assert same(got_f, want_f) and same(got_s, want_s)
    # With the batch's flags, as the daemon's single-pod path passes them.
    want_f, want_s = eng.solver.evaluate(jb, jc, flags)
    got_f, got_s = mesh.evaluate(ts, tb, tc, m, t_sv.BatchFlags(*flags))
    assert same(got_f, want_f) and same(got_s, want_s)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sharded_sequential_solve_equals_the_reference(rig, k):
    eng, jb, jc, tb, tc, flags, ts = rig
    counter = 2 ** 32 - 5      # the uint32 wrap inside the drain
    want_c, want_k, want_fin = eng.solver._solve_scan(
        jb, jc, jnp.uint32(counter), None, flags, None, None, None)
    got_c, got_k, got_fin = mesh.solve_sequential(
        ts, tb, tc, convert.counter_from_numpy(counter, "cpu"),
        mesh.make_mesh(k, device="cpu"), t_sv.BatchFlags(*flags))
    assert same(got_c, want_c)
    assert int(got_k[0]) == int(np.asarray(want_k))
    assert np.array_equal(got_fin["packed"].numpy(),
                          np.asarray(want_fin["packed"]))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sharded_joint_solve_equals_the_reference(rig, k):
    eng, jb, jc, tb, tc, flags, ts = rig
    counter = 7
    want = eng.solver.solve_joint(jb, jc, jnp.uint32(counter), flags=flags)
    got = mesh.solve_joint(ts, tb, tc, torch.tensor([counter]),
                           mesh.make_mesh(k, device="cpu"),
                           flags=t_sv.BatchFlags(*flags))
    assert same(got[0], want[0])
    assert int(got[1][0]) == int(np.asarray(want[1]))


def test_sharded_price_iteration_equals_the_reference(rig):
    eng, jb, jc, tb, tc, _flags, ts = rig
    want_bias, want_key = eng.solver._price_iterate(jb, jc, 24, None)
    biases, key = mesh.price_iterate(ts, tb, tc,
                                     mesh.make_mesh(3, device="cpu"), 24)
    bits = lambda a: np.asarray(a, np.float32).view(np.int32)  # noqa: E731
    assert np.array_equal(bits(torch.cat(biases, 1).numpy()),
                          bits(want_bias))
    assert np.array_equal(bits(key.numpy()), bits(want_key))


@pytest.mark.parametrize("k", [2, 3])
def test_dryrun_multichip_on_the_cpu(k):
    rec = mesh.dryrun_multichip(k, device="cpu", n_nodes=61, n_pods=40,
                                profile="rich", quiet=True)
    assert rec["value_asserts"] == ["evaluate", "solve_sequential",
                                    "solve_joint"]
    assert rec["mesh"]["nodes"] * rec["mesh"]["batch"] == k
    assert rec["placed"] > 0

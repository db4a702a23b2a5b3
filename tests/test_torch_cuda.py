"""Tests of the PyTorch port that need the card: the CUDA select kernel
against its plain version, the scan kernel against its plain version (the
step loop) on every case of ``perf/scan_check.py``, and drains on
``cuda`` against the same drains on ``cpu``.  They skip themselves where
there is no CUDA device; on the card run ``python -m pytest
tests/test_torch_cuda.py -m cuda -q --noconftest``.  This file imports no
JAX, so it also runs where only the port's dependencies are installed.
Tolerance: exact equality (integer outputs; the scan's float state bit
for bit)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.engine import fused, scan
from kubernetes_tpu_torch.perf import scan_check, synth

COUNTERS = (0, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(n: int, rng: np.random.RandomState) -> np.ndarray:
    neg = -np.inf
    one = np.full(n, neg, np.float32)
    one[rng.randint(n)] = 5.0
    ties = rng.randint(0, 3, n).astype(np.float32)
    ties[rng.rand(n) < 0.4] = neg
    pinf = rng.randint(0, 3, n).astype(np.float32)
    pinf[rng.randint(n)] = np.inf
    return np.stack([np.full(n, neg, np.float32), one, ties,
                     np.full(n, 2.0, np.float32), pinf])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 5000, 5003])
def test_cuda_kernel_matches_plain(cuda, n):
    rows = _rows(n, np.random.RandomState(n))
    masked = np.repeat(rows, len(COUNTERS), axis=0)
    counters = np.tile(np.asarray(COUNTERS, np.int64), len(rows))
    m = torch.from_numpy(masked).to(cuda)
    c = torch.from_numpy(counters).to(cuda)
    before = fused.select_rows.launches
    got = fused.select_rows(m, c)
    assert fused.select_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused.select_plain(m, c))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    m = torch.zeros((2, 8), device=cuda)
    c = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fused.select_rows(m.half(), c)
    with pytest.raises(ValueError):
        fused.select_rows(m, c.int())
    with pytest.raises(ValueError):
        fused.select_rows(m.t(), c)
    with pytest.raises(ValueError):
        fused.select_rows(m, c.cpu())


@pytest.mark.cuda
def test_cuda_drain_matches_cpu_drain(cuda):
    out = {}
    for dev in ("cuda", "cpu"):
        eng, pods = synth.make_rig(48, 200, profile="rich", device=dev)
        placed = [n for _, pl in eng.schedule_batch_stream(
            pods, chunk_size=64) for n in pl]
        out[dev] = (placed, int(eng.last_node_index))
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", scan_check.CASE_NAMES)
def test_cuda_scan_kernel_matches_step_loop(cuda, name):
    case = scan_check.case(name, cuda)
    before = scan.scan_chunk.launches
    res = scan_check.run_routes(case)
    torch.cuda.synchronize()
    assert scan.scan_chunk.launches == before + 2  # one per chunk
    assert res["max_abs_err"] == 0.0
    assert (res["placed"] == 0) is case.infeasible


@pytest.mark.cuda
def test_cuda_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p, n = 4, 8
    args = dict(
        request=torch.zeros((p, 4), dtype=torch.int32, device=cuda),
        nonzero=torch.zeros((p, 2), dtype=torch.int32, device=cuda),
        zero_request=torch.zeros(p, dtype=torch.bool, device=cuda),
        alloc=torch.ones((n, 4), dtype=torch.int32, device=cuda),
        packed=torch.zeros((n, 6), dtype=torch.int32, device=cuda),
        counter=torch.zeros(1, dtype=torch.int64, device=cuda))
    enc = torch.zeros((p, n), device=cuda)
    before = scan.scan_chunk.launches
    with pytest.raises(ValueError):
        scan.scan_chunk(enc.double(), **args)
    with pytest.raises(ValueError):
        scan.scan_chunk(enc, **{**args, "packed": args["packed"].cpu()})
    with pytest.raises(ValueError):
        scan.scan_chunk(enc, **{**args, "alloc": args["alloc"].t()})
    assert scan.scan_chunk.launches == before
    choices = scan.scan_chunk(enc, **args)
    torch.cuda.synchronize()
    assert scan.scan_chunk.launches == before + 1
    assert choices.tolist() == [0, 1, 2, 3]  # all tie; counter walks
    assert int(args["counter"][0]) == 4


@pytest.mark.cuda
def test_cuda_mixed_drain_runs_one_scan_launch_per_chunk(cuda):
    out = {}
    for dev in ("cuda", "cpu"):
        eng, pods = synth.make_rig(300, 200, profile="mixed", device=dev)
        fused.select_rows.launches = scan.scan_chunk.launches = 0
        placed = [n for _, pl in eng.schedule_batch_stream(
            pods, chunk_size=64) for n in pl]
        out[dev] = (placed, int(eng.last_node_index))
        if dev == "cuda":
            assert scan.scan_chunk.launches == 4
            assert fused.select_rows.launches == 0
    assert out["cuda"] == out["cpu"]

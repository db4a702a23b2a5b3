"""Host selection for the single-pod path: a CUDA kernel and its plain
PyTorch version.

Counterpart of ``kubernetes_tpu/ops/combine.py:select_hosts``, the
vectorized selectHost (generic_scheduler.go:124-141) of the single-pod
path: among each row's feasible max-score nodes pick the ``counter %
n_ties``-th in node-index order, ``-1`` when the row has no feasible node.
Row ``i``'s counter is ``last + (feasible rows before i)``: the
reference's ``lastNodeIndex`` only advances inside selectHost, which an
unschedulable pod never reaches.

It differs from the scan's select (``engine/fused.py``) in its inputs (a
separate ``feasible`` plane beside the scores) and in its edge cases,
which follow the JAX function exactly:

* ``mx = max(feasible ? score : -inf)`` propagates NaN, so a feasible NaN
  score leaves no tie;
* ties are the feasible nodes equal to ``mx``, with no finiteness test:
  a row whose feasible scores are all ``-inf`` still picks among them;
* with no tie (a NaN maximum) the choice is node 0, the argmax of an
  all-false row.

* :func:`select_hosts` — the wrapper.  On CUDA tensors it works out the
  per-row counters in torch and launches ``kt_select_hosts``
  (``csrc/select.cu``) or raises; on CPU tensors it computes
  :func:`select_hosts_plain`.  It counts its kernel launches in
  ``select_hosts.launches``.
* :func:`select_hosts_plain` — the JAX function's chain in torch ops.

Counters are int64 tensors whose low 32 bits are the reference's uint32
``lastNodeIndex`` (torch has no uint32 ``%`` on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.engine.kernels import library

_MASK32 = 0xFFFFFFFF


def _counters(feasible: torch.Tensor, last: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(any_feasible [P] bool, per-row counter [P] int64, new_last [1]
    int64), all masked to 32 bits."""
    any_feasible = feasible.any(dim=1)
    a = any_feasible.to(torch.int64)
    feas_before = torch.cumsum(a, dim=0) - a
    counter = (last + feas_before) & _MASK32
    new_last = (last + a.sum()) & _MASK32
    return any_feasible, counter, new_last


def select_hosts_plain(scores: torch.Tensor, feasible: torch.Tensor,
                       last: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [P] int32, new_last [1] int64) for ``scores`` [P, N] f32,
    ``feasible`` [P, N] bool and ``last`` [1] int64 — the JAX function's
    chain in torch ops."""
    any_feasible, counter, new_last = _counters(feasible, last)
    masked = torch.where(feasible, scores, float("-inf"))
    mx = masked.amax(dim=1, keepdim=True)
    ties = feasible & (masked == mx)
    n_ties = torch.clamp(ties.sum(dim=1), min=1)
    ix = counter % n_ties
    rank = torch.cumsum(ties.to(torch.int32), dim=1, dtype=torch.int32) - 1
    pick = ties & (rank == ix[:, None])
    choice = pick.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(any_feasible, choice, -1), new_last


def select_hosts(scores: torch.Tensor, feasible: torch.Tensor,
                 last: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [P] int32, new_last [1] int64) per row of ``scores`` [P, N]
    float32 under ``feasible`` [P, N] bool, from the round-robin counter
    ``last`` [1] int64.  CUDA tensors go through the kernel (or raise);
    CPU tensors through :func:`select_hosts_plain`."""
    devices = {scores.device, feasible.device, last.device}
    if len(devices) != 1:
        raise ValueError(f"select_hosts: scores, feasible and last must "
                         f"share a device, got {sorted(map(str, devices))}")
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"select_hosts: scores must be a [P, N] float32 "
                         f"tensor, got {scores.dtype} {tuple(scores.shape)}")
    if feasible.dtype != torch.bool or feasible.shape != scores.shape:
        raise ValueError(f"select_hosts: feasible must be a bool tensor "
                         f"of the scores' shape {tuple(scores.shape)}, got "
                         f"{feasible.dtype} {tuple(feasible.shape)}")
    if not (scores.is_contiguous() and feasible.is_contiguous()):
        raise ValueError("select_hosts: scores and feasible must be "
                         "contiguous")
    if last.dtype != torch.int64 or last.shape != (1,):
        raise ValueError(f"select_hosts: last must be a [1] int64 tensor, "
                         f"got {last.dtype} {tuple(last.shape)}")
    rows, n = scores.shape
    if rows == 0 or n == 0 or n >= 2 ** 31:
        raise ValueError(f"select_hosts: unsupported shape {(rows, n)}")
    if scores.device.type == "cpu":
        return select_hosts_plain(scores, feasible, last)
    if scores.device.type != "cuda":
        raise ValueError(f"select_hosts: unsupported device {scores.device}")
    if scores.device.index != torch.cuda.current_device():
        raise ValueError("select_hosts: tensors must lie on the current "
                         "CUDA device")
    _, counter, new_last = _counters(feasible, last)
    choice = torch.empty(rows, dtype=torch.int32, device=scores.device)
    launch(scores, feasible, counter, choice)
    select_hosts.launches += 1
    return choice, new_last


select_hosts.launches = 0


def launch(scores: torch.Tensor, feasible: torch.Tensor,
           counter: torch.Tensor, choice: torch.Tensor) -> None:
    """One launch of ``kt_select_hosts`` on checked CUDA tensors: scores
    [P, N] f32, feasible [P, N] bool, the per-row counters [P] int64, into
    ``choice`` [P] int32.  Raises if the launch fails.  Counts nothing:
    :func:`select_hosts` is the entry point; this is exposed for timing
    the kernel alone."""
    rows, n = scores.shape
    err = library().kt_select_hosts(
        ctypes.c_void_p(scores.data_ptr()),
        ctypes.c_void_p(feasible.data_ptr()),
        ctypes.c_void_p(counter.data_ptr()),
        ctypes.c_void_p(choice.data_ptr()), ctypes.c_int(rows),
        ctypes.c_int(n),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"select_hosts: kernel launch failed "
                           f"(cudaError {err})")

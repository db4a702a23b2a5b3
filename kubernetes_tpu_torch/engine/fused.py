"""The fused select of the sequential-greedy scan: a CUDA kernel and its
plain PyTorch version.

Counterpart of ``kubernetes_tpu/engine/fused.py``, whose Pallas kernel
(``_pallas_kernel``, launched by ``select_pallas``) computes selectHost
(generic_scheduler.go:124-141) over one score row: among the feasible
max-score nodes pick the ``counter % n_ties``-th in node-index order,
``-1`` when nothing is feasible.  ``masked`` encodes infeasibility as
``-inf``, so one row is the whole per-pod decision input.

* :func:`select_rows` — the wrapper.  On a CUDA tensor it launches the
  hand-written kernel ``csrc/select.cu`` (in the library that
  ``engine/kernels.py`` builds at first use) or raises; on a CPU tensor
  it computes :func:`select_plain`.  It counts its kernel launches in
  ``select_rows.launches``.
* :func:`select_plain` — the same chain in torch ops, built the way the
  Pallas body builds it.

The round-robin counter is an int64 tensor whose low 32 bits are the
reference's uint32 ``lastNodeIndex`` (torch has no uint32 ``%`` on the
CPU); the kernel and the plain version both take the modulo in uint32.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.engine.kernels import library

_MASK32 = 0xFFFFFFFF


def select_plain(masked: torch.Tensor, counter: torch.Tensor
                 ) -> torch.Tensor:
    """[P, 2] int32 (choice, n) for ``masked`` [P, N] f32 and ``counter``
    [P] int64 — the Pallas body's chain in torch ops."""
    mx = masked.amax(dim=1, keepdim=True)
    ties = (masked == mx) & torch.isfinite(mx)
    rank = torch.cumsum(ties.to(torch.int32), dim=1, dtype=torch.int32)
    n_raw = rank[:, -1]
    ix = (counter & _MASK32) % torch.clamp(n_raw, min=1).to(torch.int64)
    pick = ties & (rank == (ix + 1)[:, None])
    col = torch.arange(masked.shape[1], dtype=torch.int32,
                       device=masked.device)
    choice = torch.where(pick, col, -1).amax(dim=1)
    return torch.stack([torch.where(n_raw > 0, choice, -1), n_raw],
                       dim=1).to(torch.int32)


def select_rows(masked: torch.Tensor, counter: torch.Tensor
                ) -> torch.Tensor:
    """[P, 2] int32 (choice, n) per row of ``masked`` [P, N] float32 with
    its ``counter`` [P] int64.  CUDA tensors go through the kernel (or
    raise); CPU tensors through :func:`select_plain`."""
    if masked.device.type == "cpu":
        if counter.device.type != "cpu":
            raise ValueError("select_rows: masked and counter must share "
                             "a device")
        return select_plain(masked, counter)
    if masked.device.type != "cuda":
        raise ValueError(f"select_rows: unsupported device {masked.device}")
    if masked.dtype != torch.float32 or masked.dim() != 2 or \
            not masked.is_contiguous():
        raise ValueError("select_rows: masked must be a contiguous [P, N] "
                         f"float32 tensor, got {masked.dtype} "
                         f"{tuple(masked.shape)}")
    rows, n = masked.shape
    if counter.dtype != torch.int64 or counter.shape != (rows,) or \
            not counter.is_contiguous() or counter.device != masked.device:
        raise ValueError("select_rows: counter must be a contiguous [P] "
                         f"int64 tensor on {masked.device}, got "
                         f"{counter.dtype} {tuple(counter.shape)} on "
                         f"{counter.device}")
    if rows == 0 or n == 0 or n >= 2 ** 31:
        raise ValueError(f"select_rows: unsupported shape {(rows, n)}")
    if masked.device.index != torch.cuda.current_device():
        raise ValueError("select_rows: tensors must lie on the current "
                         "CUDA device")
    out = torch.empty((rows, 2), dtype=torch.int32, device=masked.device)
    err = library().kt_select_rows(
        ctypes.c_void_p(masked.data_ptr()),
        ctypes.c_void_p(counter.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(rows),
        ctypes.c_int(n),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"select_rows: kernel launch failed "
                           f"(cudaError {err})")
    select_rows.launches += 1
    return out


select_rows.launches = 0


def warm(n: int, device: "torch.device | str") -> torch.Tensor:
    """One launch of the select on a zero row of ``n`` nodes: the
    prewarm's ``select_rows@1`` key."""
    return select_rows(torch.zeros((1, n), dtype=torch.float32,
                                   device=device),
                       torch.zeros(1, dtype=torch.int64, device=device))


def select(masked: torch.Tensor, counter: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One scan step's select: ``masked`` [N] f32, ``counter`` [1] int64
    -> (choice [1] int32, n [1] int32), both left on the device."""
    out = select_rows(masked.reshape(1, -1), counter)
    return out[:, 0], out[:, 1]

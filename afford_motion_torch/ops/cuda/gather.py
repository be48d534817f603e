"""Neighbourhood row gather: the CUDA kernel ``csrc/gather.cu`` and its
plain PyTorch version.

Counterpart of the forward of ``afford_motion_tpu/ops/pallas/gather.py``
(``gather_rows``). Forward only: the scatter-add backward kernel comes with
training, so the CUDA path refuses inputs that require grad.
"""
from __future__ import annotations

import torch

from . import build

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, K) int -> (B, M, K, C)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx.long()]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) f32|bf16, (B, M, K) int32 -> (B, M, K, C), bit-exact.
    Launches the kernel for CUDA tensors; CPU tensors take
    :func:`gather_rows_plain`."""
    if x.ndim != 3 or idx.ndim != 3 or x.shape[0] != idx.shape[0]:
        raise ValueError(f"gather_rows: expected (B, N, C) and (B, M, K), got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.device != idx.device:
        raise ValueError("gather_rows: x and idx lie on different devices")
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    build.require_cuda(x, "gather_rows")
    if x.dtype not in _ELEM_BYTES or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: takes float32/bfloat16 rows and int32 "
                         f"indices, got {x.dtype} and {idx.dtype}")
    if x.requires_grad:
        raise RuntimeError("gather_rows: the CUDA path is forward-only; its "
                           "scatter-add backward is not ported yet")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: x and idx must be contiguous")
    B, N, C = x.shape
    _, M, K = idx.shape
    out = torch.empty((B, M, K, C), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.amt_gather_rows(x.data_ptr(), idx.data_ptr(), B, N, C, M, K,
                                   _ELEM_BYTES[x.dtype], out.data_ptr(),
                                   build.stream_of(x))
    build.check(code, "amt_gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0

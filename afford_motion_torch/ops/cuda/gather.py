"""Neighbourhood row gather and its scatter-add backward: the CUDA kernels
``csrc/gather.cu`` and ``csrc/scatter.cu`` with their plain PyTorch versions.

Counterpart of ``afford_motion_tpu/ops/pallas/gather.py``: ``gather_rows``
is differentiable in ``x``, through a ``torch.autograd.Function`` whose
backward is the scatter-add. The scatter sums every destination row's
contributions in ascending flat position ``m * K + k``, from zero, in
float32, on the card and in the plain version alike, so the backward is
deterministic and the two agree bit for bit.
"""
from __future__ import annotations

import torch

from . import build

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, K) int -> (B, M, K, C)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx.long()]


def ordered_segment_sum(rows: torch.Tensor, order: torch.Tensor, seg: torch.Tensor,
                        nseg: int) -> torch.Tensor:
    """``out[b, s] = sum of rows[b, order[b, p]] over the p with seg[b, p] ==
    s``, from zero, in ascending ``p``. rows (B, P', C), order and seg (B, P)
    int64 with ``seg`` non-decreasing along P -> (B, nseg, C) in rows' type.
    Pass r adds every segment's r-th member, so a pass touches a segment at
    most once and the order of each sum is fixed."""
    B, P = seg.shape
    pos = torch.arange(P, device=seg.device).expand(B, -1)
    new_segment = torch.ones_like(seg, dtype=torch.bool)
    new_segment[:, 1:] = seg[:, 1:] != seg[:, :-1]
    segment_start = torch.where(new_segment, pos, torch.zeros_like(pos)).cummax(dim=1).values
    rank = pos - segment_start
    out = torch.zeros((B, nseg, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    for r in range(int(rank.max()) + 1 if P else 0):
        b_i, p_i = (rank == r).nonzero(as_tuple=True)
        s_i = seg[b_i, p_i]
        out[b_i, s_i] = out[b_i, s_i] + rows[b_i, order[b_i, p_i]]
    return out


def scatter_add_rows_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, M, K, C), (B, M, K) int -> (B, n, C): ``out[b, idx[b, m, k]] +=
    g[b, m, k]`` from zero, each destination's contributions added in
    ascending ``m * K + k``: a stable sort groups the positions by
    destination for :func:`ordered_segment_sum`. float32 and bfloat16
    accumulate in float32 (the bfloat16 sum is rounded once at the end);
    other types in their own."""
    B, M, K, C = g.shape
    acc_dtype = torch.float32 if g.dtype in ELEM_BYTES else g.dtype
    dest, order = torch.sort(idx.reshape(B, M * K).long(), dim=1, stable=True)
    rows = g.reshape(B, M * K, C).to(acc_dtype)
    return ordered_segment_sum(rows, order, dest, n).to(g.dtype)


def check_rows(x: torch.Tensor, idx: torch.Tensor, name: str, x_ndim: int) -> None:
    if x.ndim != x_ndim or idx.ndim != 3 or x.shape[0] != idx.shape[0]:
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)} and {tuple(idx.shape)}")
    if x.device != idx.device:
        raise ValueError(f"{name}: the rows and idx lie on different devices")
    if x.device.type == "cpu":
        return
    build.require_cuda(x, name)
    if x.dtype not in ELEM_BYTES or idx.dtype != torch.int32:
        raise ValueError(f"{name}: takes float32/bfloat16 rows and int32 "
                         f"indices, got {x.dtype} and {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: the rows and idx must be contiguous")


def _gather_forward(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    check_rows(x, idx, "gather_rows", 3)
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    B, N, C = x.shape
    _, M, K = idx.shape
    out = torch.empty((B, M, K, C), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.amt_gather_rows(x.data_ptr(), idx.data_ptr(), B, N, C, M, K,
                                   ELEM_BYTES[x.dtype], out.data_ptr(),
                                   build.stream_of(x))
    build.check(code, "amt_gather_rows")
    gather_rows.launches += 1
    return out


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, M, K, C) f32|bf16, (B, M, K) int32 in [0, n) -> (B, n, C): the
    ordered scatter-add (see :func:`scatter_add_rows_plain`). Launches the
    kernel for CUDA tensors; CPU tensors take the plain version."""
    check_rows(g, idx, "scatter_add_rows", 4)
    if g.shape[1:3] != idx.shape[1:]:
        raise ValueError(f"scatter_add_rows: g {tuple(g.shape)} does not match "
                         f"idx {tuple(idx.shape)}")
    if g.device.type == "cpu":
        return scatter_add_rows_plain(g, idx, n)
    B, M, K, C = g.shape
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    # scratch: counts / cursors and slice starts per destination, the
    # positions grouped by destination before and after the sort
    per_dest = torch.empty((2, B, n), dtype=torch.int32, device=g.device)
    per_pos = torch.empty((2, B, M * K), dtype=torch.int32, device=g.device)
    lib = build.library()
    with torch.cuda.device(g.device):
        code = lib.amt_scatter_add_rows(
            g.data_ptr(), idx.data_ptr(), B, n, C, M * K, ELEM_BYTES[g.dtype],
            per_dest[0].data_ptr(), per_dest[1].data_ptr(), per_pos[0].data_ptr(),
            per_pos[1].data_ptr(), out.data_ptr(), build.stream_of(g))
    build.check(code, "amt_scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


class GatherRows(torch.autograd.Function):
    """``out[b, m, k] = x[b, idx[b, m, k]]``; the gradient of ``x`` is the
    ordered scatter-add of the output's gradient, ``idx`` gets none."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        return _gather_forward(x, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_add_rows(g.contiguous(), idx, ctx.n), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) f32|bf16, (B, M, K) int32 -> (B, M, K, C), bit-exact, and
    differentiable in ``x``. Launches the kernels for CUDA tensors (forward
    and backward); CPU tensors take the plain versions."""
    return GatherRows.apply(x, idx)


gather_rows.launches = 0
scatter_add_rows.launches = 0

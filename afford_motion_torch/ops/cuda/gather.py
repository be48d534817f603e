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

from typing import Tuple

import torch

from . import build

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# destinations a cloud the scatter kernels take (1024 ranges of 128)
SCATTER_MAX_N = 131072


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


# the gather kernel's launch configurations (``csrc/gather.cu``): (mode,
# wide, span), mode 0 / 1 / 2 a lane's 16-byte chunks 1, 2 or 4 at a time,
# wide a chunk inside one source row read as aligned 16-byte words (1) or
# word by word (0), span the output rows a warp copies at a time
GATHER_CONFIGS = tuple((mode, wide, span) for mode in (0, 1, 2) for wide in (0, 1)
                       for span in (8, 16, 32, 64, 128))


def gather_config(rows: int, c: int, itemsize: int) -> Tuple[int, int, int]:
    """(mode, wide, span) of the gather kernel for ``rows`` output rows of
    ``c`` words of ``itemsize`` bytes, from ``tools/kernel_ab.py --sweep`` at
    the SceneMap's shapes. bf16: rows of 512 bytes or more, and calls of
    fewer than 2^17 rows, one chunk a lane at a time, read wide, spans of 16
    rows; the others 4 chunks at a time, word by word, spans of 64. f32:
    spans of 16, rows of 1 KB or more 4 chunks at a time read wide, the
    others 2, word by word."""
    if itemsize == 4:
        return (2, 1, 16) if c * itemsize >= 1024 else (1, 0, 16)
    if c * itemsize >= 512 or rows < 1 << 17:
        return 0, 1, 16
    return 2, 0, 64


def launch_gather(x: torch.Tensor, idx: torch.Tensor, mode: int, wide: int,
                  span: int) -> torch.Tensor:
    """One launch of the gather kernel with the given configuration (see
    :func:`gather_config`); checks and counts are the caller's."""
    B, N, C = x.shape
    _, M, K = idx.shape
    out = torch.empty((B, M, K, C), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.amt_gather_rows(x.data_ptr(), idx.data_ptr(), B, N, C, M, K,
                                   ELEM_BYTES[x.dtype], mode, wide, span, out.data_ptr(),
                                   build.stream_of(x))
    build.check(code, "amt_gather_rows")
    return out


def _gather_forward(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    check_rows(x, idx, "gather_rows", 3)
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    out = launch_gather(x, idx, *gather_config(idx.numel(), x.shape[2], x.element_size()))
    gather_rows.launches += 1
    return out


def scatter_config(c: int, banded: bool = False) -> Tuple[int, int, int]:
    """(passes, wide, budget) of the scatter kernels' sums
    (``csrc/ordered_scatter.cuh``), from ``tools/kernel_ab.py --sweep`` at
    the SceneMap's shapes: one warp a destination takes the channels in
    passes of equal width; ``wide``, the channels a lane takes (1 to 4); the
    registers budgeted for 8 blocks an SM (1) or as the compiler allocates
    them (0). The row gather's: passes of at most 128 channels, 4 a lane,
    the compiler's registers. The banded gather's, whose sums also fold tile
    partials: passes of at most 96 channels, the fewest a lane, the
    budget."""
    passes = -(-c // (96 if banded else 128))
    wide = -(-(-(-c // passes)) // 32) if banded else 4
    return passes, wide, int(banded)


def scratch(g: torch.Tensor, n: int) -> torch.Tensor:
    """The int32 scratch of a scatter kernel's call: the counts and offsets
    of the grouping by range and the positions grouped, then listed by
    destination."""
    B, M, K, _ = g.shape
    return torch.empty(build.library().amt_scatter_scratch(B, n, M * K), dtype=torch.int32,
                       device=g.device)


def check_scatter_shape(name: str, g: torch.Tensor, n: int) -> None:
    """The shapes the scatter kernels take (on the card)."""
    positions = g.shape[1] * g.shape[2]
    if positions >= 1 << 24 or n > SCATTER_MAX_N or g.shape[0] > 65535:
        raise ValueError(f"{name}: the kernel takes fewer than 2^24 positions, at most "
                         f"{SCATTER_MAX_N} destinations and 65535 clouds, got {positions}, {n} "
                         f"and {g.shape[0]}")


def launch_scatter(g: torch.Tensor, idx: torch.Tensor, n: int, passes: int, wide: int,
                   budget: int) -> torch.Tensor:
    """One call of the scatter kernels with the given configuration of the
    sums (see :func:`scatter_config`); checks and counts are the caller's."""
    B, M, K, C = g.shape
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    work = scratch(g, n)
    with torch.cuda.device(g.device):
        code = build.library().amt_scatter_add_rows(
            g.data_ptr(), idx.data_ptr(), B, n, C, M * K, ELEM_BYTES[g.dtype], passes, wide,
            budget, work.data_ptr(), out.data_ptr(), build.stream_of(g))
    build.check(code, "amt_scatter_add_rows")
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
    check_scatter_shape("scatter_add_rows", g, n)
    out = launch_scatter(g, idx, n, *scatter_config(g.shape[-1]))
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

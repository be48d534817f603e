"""Banded (windowed) neighbourhood kernels for curve-sorted clouds: the CUDA
kernels ``csrc/banded_{knn,gather,scatter}.cu`` with their plain PyTorch
versions, and the window policy they share.

Counterpart of ``afford_motion_tpu/ops/pallas/banded.py``. With points stored
in Morton or Hilbert order (``ops/curves.py``, the prepare ``sort`` stage)
kNN neighbours are index-local, and the *window* becomes the neighbourhood
definition: every tile of ``TQ`` = 128 query rows looks at ``S`` consecutive
support rows ``[start, start + S)`` only.

- :func:`knn_banded`: packed-key kNN of each tile over its window;
- :func:`gather_banded`: neighbourhood gather in which a row whose index
  lies outside its tile's window comes out zero. Every index produced by
  ``knn_banded`` with the same starts lies in its window, so for those the
  gather is exact;
- its backward :func:`scatter_banded`: the ordered scatter-add that drops
  the out-of-window contributions and sums per tile first, then over tiles.

Bandedness is no global state: it is carried as ``model.use_banded`` ->
``add_hierarchies`` -> ``LevelGeometry.banded`` -> the per-call arguments of
``bgather`` and the hierarchy functions. There is no ``available()`` here:
the route is always there, the kernels for CUDA tensors and the plain
versions for CPU tensors.

``starts`` is int32, rank 1 ``(G,)`` (one start per tile, the static
proportional policy) or rank 2 ``(B, G)`` (per cloud and tile, the adaptive
policy), every entry in ``[0, N - S]``.
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import torch

from . import build
from .gather import ELEM_BYTES, check_rows, ordered_segment_sum
from .knn import IDX_BITS, IDX_MASK

TQ = 128  # query rows per tile (all level sizes are multiples of 128)


# ------------------------------------------------------------ window policy
# The window-width knob W0 (the policy's level-0 value, a multiple of 128,
# default 128) and the adaptive-starts toggle are config values,
# ``model.banded_window`` / ``model.banded_adaptive``, threaded to the
# kernels like ``use_banded``. The AM_BANDED_* environment variables are
# debug overrides and win when set.
def resolve_window(cfg_value: int = 0) -> int:
    """W0 precedence: AM_BANDED_WINDOW (debug override) > config value
    (``model.banded_window``; 0 = unset) > 128."""
    env = int(os.environ.get("AM_BANDED_WINDOW", "0") or 0)
    v = env or int(cfg_value or 0) or 128
    return max(128, (v // 128) * 128)


def resolve_adaptive(cfg_value=None) -> bool:
    """Adaptive per-cloud window starts (FPS density varies per scene, so
    cross-level windows are centred on each query tile's own span of
    ``fps_idx``). Precedence: AM_BANDED_ADAPTIVE (debug override) > config
    value (``model.banded_adaptive``; None = unset) > True."""
    env = os.environ.get("AM_BANDED_ADAPTIVE")
    if env is not None and env != "":
        return env != "0"
    return True if cfg_value is None else bool(cfg_value)


def window_width(n_support: int, w0: int = 0) -> int:
    """W policy: scale with the support size, clamped to [128, W0], a
    multiple of 128. ``w0=0`` resolves to the env/default policy."""
    w0 = resolve_window(w0)
    return max(128, min(w0, (n_support // 16) // 128 * 128))


def window_starts(m: int, n: int, w: int) -> Tuple[List[int], int]:
    """Static per-tile window starts and the window size S for M query rows
    over N support rows. The window centre tracks the proportional position
    (curve order is preserved across FPS levels by sorted ``fps_idx``)."""
    ratio = n / m
    s = min(n, ((int(TQ * ratio) + 2 * w + 127) // 128) * 128)
    starts = []
    for t in range(m // TQ):
        c = int(t * TQ * ratio) - w
        c = max(0, min(n - s, c))
        starts.append((c // 128) * 128)
    return starts, s


@functools.lru_cache(maxsize=None)
def _starts_on_device(starts: Tuple[int, ...], device: str) -> torch.Tensor:
    return torch.tensor(starts, dtype=torch.int32, device=device)


def _starts_tensor(m: int, n: int, w0: int, device) -> torch.Tensor:
    """The proportional starts as a rank-1 (G,) int32 tensor. Every distinct
    list goes to a device once and is kept (a few hundred bytes each): a
    copy from host memory on every call would make the host wait for the
    device each time, in a step whose time is the host's dispatch."""
    starts, _ = window_starts(m, n, window_width(n, w0))
    return _starts_on_device(tuple(starts), str(device))


def _clip_round_starts(center: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """center (B, G) -> window starts: clipped to [0, n - s], 128-aligned."""
    st = torch.clamp(center - s // 2, 0, n - s)
    return (torch.div(st, 128, rounding_mode="floor") * 128).to(torch.int32)


def adaptive_down_starts(fps_idx: torch.Tensor, n_support: int, w0: int = 0) -> torch.Tensor:
    """Window starts for cross-level queries (FPS level -> parent level):
    each query tile's window is centred on the tile's own span of parent
    curve positions (``fps_idx`` is sorted ascending). (B, M) -> (B, G)."""
    _, M = fps_idx.shape
    _, s = window_starts(M, n_support, window_width(n_support, w0))
    lo = fps_idx[:, 0::TQ].to(torch.int32)
    hi = fps_idx[:, TQ - 1::TQ].to(torch.int32)
    return _clip_round_starts(torch.div(lo + hi, 2, rounding_mode="floor"), n_support, s)


def adaptive_up_starts(fps_idx: torch.Tensor, m_fine: int, w0: int = 0) -> torch.Tensor:
    """Window starts for parent-level queries over the coarse level (the
    3-NN up-interpolation): each fine tile's window is centred on where its
    rows land in the coarse curve order (searchsorted into sorted
    ``fps_idx``, left side). (B, n_coarse) -> (B, m_fine // TQ)."""
    B, n_coarse = fps_idx.shape
    _, s = window_starts(m_fine, n_coarse, window_width(n_coarse, w0))
    g = m_fine // TQ
    tile_centers = torch.arange(g, dtype=torch.int32, device=fps_idx.device) * TQ + TQ // 2
    center = torch.searchsorted(fps_idx.to(torch.int32).contiguous(),
                                tile_centers.expand(B, g).contiguous(), right=False)
    return _clip_round_starts(center.to(torch.int32), n_coarse, s)


def knn_supports(m: int, n: int, k: int) -> bool:
    """Shapes the banded kNN takes (not the predicate of ``ops/cuda/knn.py``)."""
    return (
        m % TQ == 0
        and n % 128 == 0
        and 256 <= n <= 8192
        and k < 64
    )


def gather_supports(m: int, n: int, c: int, k: int, itemsize: int, w0: int = 0) -> bool:
    """Shapes the banded gather and scatter take. Valid either when the
    window covers the whole support (S == N: exact for any indices) or when
    the indices came from :func:`knn_banded` with the same window geometry.

    The last term is the JAX package's predicate letter for letter: 12 MiB
    is the on-chip memory budget of its TPU kernel (the cloud, a one-hot
    tile and two output tiles) and says nothing of this card. It is kept
    because it decides which calls take the windowed route (out-of-window
    rows come out zero) and which the row gather, and the port routes as the
    JAX package does."""
    if m % TQ != 0 or n % 128 != 0 or n > 8192 or k >= 64:
        return False
    _, s = window_starts(m, n, window_width(n, w0))
    x_bytes = n * c * itemsize
    onehot_bytes = TQ * k * s * itemsize
    out_bytes = TQ * k * c * itemsize
    return x_bytes + onehot_bytes + 2 * out_bytes <= 12 * 1024 * 1024


def _window(m: int, n: int, w0: int) -> int:
    return window_starts(m, n, window_width(n, w0))[1]


def _per_row_starts(starts: torch.Tensor, batch: int) -> torch.Tensor:
    """(G,) | (B, G) per-tile starts -> (B, G * TQ) int64, one per query row."""
    st = starts.long()
    if st.ndim == 1:
        st = st[None, :].expand(batch, -1)
    return st.repeat_interleave(TQ, dim=1)


def _check_starts(starts: torch.Tensor, batch: int, m: int, like: torch.Tensor, name: str) -> int:
    """Validate a starts operand; returns its stride between clouds (0 for
    rank 1, G for rank 2)."""
    g = m // TQ
    if starts.shape not in ((g,), (batch, g)):
        raise ValueError(f"{name}: starts must be ({g},) or ({batch}, {g}), got "
                         f"{tuple(starts.shape)}")
    if starts.device != like.device:
        raise ValueError(f"{name}: starts lie on another device")
    if like.device.type != "cpu" and (starts.dtype != torch.int32 or not starts.is_contiguous()):
        raise ValueError(f"{name}: starts must be contiguous int32")
    return 0 if starts.ndim == 1 else g


# ---------------------------------------------------------------------- kNN
def knn_banded_plain(query: torch.Tensor, support: torch.Tensor, k: int,
                     starts: torch.Tensor, s: int, tiles_per_chunk: Optional[int] = None):
    """(B, M, 3), (B, N, 3) f32, starts (G,) | (B, G), window size ``s`` ->
    idx (B, M, k) int32 absolute, dist (B, M, k) f32.

    The key's low 13 bits hold the window-local column, so ties and the
    quantized order are those of the window, not of the cloud. Tiles go in
    chunks so the (B, tiles, TQ, S) key tensor stays bounded."""
    B, M, _ = query.shape
    G = M // TQ
    dev = query.device
    st = starts.long()
    st = st[None, :].expand(B, -1) if st.ndim == 1 else st          # (B, G)
    col = torch.arange(s, dtype=torch.int32, device=dev)
    if tiles_per_chunk is None:
        tiles_per_chunk = max(1, (1 << 24) // (B * TQ * s))
    rows = torch.arange(B, device=dev)[:, None, None]
    idx_l, dist_l = [], []
    for lo in range(0, G, tiles_per_chunk):
        st_c = st[:, lo:lo + tiles_per_chunk]                       # (B, g)
        g = st_c.shape[1]
        win = support[rows, st_c[:, :, None] + col.long()]          # (B, g, S, 3)
        q = query[:, lo * TQ:(lo + g) * TQ].reshape(B, g, TQ, 3)
        d = None
        for c in range(3):
            t = q[:, :, :, None, c] - win[:, :, None, :, c]
            t = t * t
            d = t if d is None else d + t                           # (B, g, TQ, S)
        packed = (d.view(torch.int32) & ~IDX_MASK) | col
        keys = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
        idx_l.append(((keys & IDX_MASK) + st_c[:, :, None, None].to(torch.int32))
                     .reshape(B, g * TQ, k))
        dq = (keys & ~IDX_MASK).view(torch.float32)
        # torch's vectorized CPU sqrt is not correctly rounded; through f64 it is
        dist_l.append(torch.sqrt(torch.clamp_min(dq, 0.0).double()).float()
                      .reshape(B, g * TQ, k))
    return torch.cat(idx_l, dim=1), torch.cat(dist_l, dim=1)


def knn_banded(query: torch.Tensor, support: torch.Tensor, k: int,
               starts: Optional[torch.Tensor] = None, w0: int = 0):
    """(B, M, 3), (B, N, 3) f32 -> absolute idx (B, M, k) int32, sqrt dist
    (B, M, k), neighbours restricted to each tile's curve window. ``starts``
    overrides the proportional per-tile starts (the adaptive centring of
    cross-level queries); ``w0`` is the window-width knob (0 = env/default
    policy). Launches the kernel for CUDA tensors; CPU tensors take
    :func:`knn_banded_plain`."""
    for name, t in (("query", query), ("support", support)):
        if t.ndim != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"knn_banded: {name} must be (B, *, 3) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    B, M, _ = query.shape
    N = support.shape[1]
    if support.shape[0] != B or query.device != support.device:
        raise ValueError("knn_banded: query and support differ in batch or device")
    if not knn_supports(M, N, k):
        raise ValueError(f"knn_banded: unsupported shape M={M} N={N} k={k}")
    s = _window(M, N, w0)
    if k > s or s > (1 << IDX_BITS):
        raise ValueError(f"knn_banded: k={k} does not fit the window S={s}")
    if starts is None:
        starts = _starts_tensor(M, N, w0, query.device)
    stride = _check_starts(starts, B, M, query, "knn_banded")
    if query.device.type == "cpu":
        return knn_banded_plain(query, support, k, starts, s)
    build.require_cuda(query, "knn_banded")
    if not (query.is_contiguous() and support.is_contiguous()):
        raise ValueError("knn_banded: query and support must be contiguous")
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    lib = build.library()
    with torch.cuda.device(query.device):
        code = lib.amt_knn_banded(query.data_ptr(), support.data_ptr(), starts.data_ptr(),
                                  stride, B, M, N, s, k, idx.data_ptr(), dist.data_ptr(),
                                  build.stream_of(query))
    build.check(code, "amt_knn_banded")
    knn_banded.launches += 1
    return idx, dist


# ----------------------------------------------------------- gather/scatter
def gather_banded_plain(x: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                        s: int) -> torch.Tensor:
    """(B, N, C), (B, M, K) int, starts (G,) | (B, G) -> (B, M, K, C); a row
    whose index lies outside ``[start, start + s)`` of its tile is zero."""
    B, N, _ = x.shape
    rel = idx.long() - _per_row_starts(starts, B)[:, :, None]
    inside = (rel >= 0) & (rel < s)
    rows = torch.arange(B, device=x.device)[:, None, None]
    out = x[rows, idx.long().clamp(0, N - 1)]
    return torch.where(inside[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))


def scatter_banded_plain(g: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor, n: int,
                         s: int) -> torch.Tensor:
    """(B, M, K, C), (B, M, K) int, starts (G,) | (B, G) -> (B, n, C), the
    backward of :func:`gather_banded_plain`. Per destination row: the
    contributions of one tile (positions ``m * K + k`` with ``m`` in the tile
    and the index in the tile's window) are summed in ascending position from
    zero; the tile partials are then added in ascending tile order from zero.
    Contributions outside their tile's window are dropped. float32 and
    bfloat16 accumulate in float32 (bfloat16 is rounded once at the end)."""
    B, M, K, C = g.shape
    G = M // TQ
    acc_dtype = torch.float32 if g.dtype in ELEM_BYTES else g.dtype
    flat = idx.reshape(B, M * K).long()
    tile = torch.arange(M * K, device=g.device) // (TQ * K)
    rel = flat - _per_row_starts(starts, B).repeat_interleave(K, dim=1)
    inside = (rel >= 0) & (rel < s)
    # one segment per (destination, tile); the dropped positions share one
    # segment behind all others, which lands on a destination row n
    key = torch.where(inside, flat * G + tile, torch.full_like(flat, n * G))
    key, order = torch.sort(key, dim=1, stable=True)
    new_segment = torch.ones_like(key, dtype=torch.bool)
    new_segment[:, 1:] = key[:, 1:] != key[:, :-1]
    seg = new_segment.long().cumsum(dim=1) - 1
    nseg = int(seg.max()) + 1
    partial = ordered_segment_sum(g.reshape(B, M * K, C).to(acc_dtype), order, seg, nseg)
    # the segments of a cloud ascend by destination, then by tile
    seg_dest = torch.full((B, nseg), n, dtype=torch.long, device=g.device)
    seg_dest.scatter_(1, seg, torch.div(key, G, rounding_mode="floor"))
    same = torch.arange(nseg, device=g.device).expand(B, -1)
    return ordered_segment_sum(partial, same, seg_dest, n + 1)[:, :n].to(g.dtype)


def _gather_forward(x: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                    s: int) -> torch.Tensor:
    check_rows(x, idx, "gather_banded", 3)
    B, N, C = x.shape
    _, M, K = idx.shape
    stride = _check_starts(starts, B, M, x, "gather_banded")
    if x.device.type == "cpu":
        return gather_banded_plain(x, idx, starts, s)
    out = launch_gather(x, idx, starts, stride, s, *gather_config(B, M, C, K, s, x.element_size()))
    gather_banded.launches += 1
    return out


def gather_config(b: int, m: int, c: int, k: int, s: int, itemsize: int) -> Tuple[int, bool]:
    """(blocks a tile, window in shared memory) of the gather kernel: the
    window is staged when it fits beside the block's indices; a tile's 128
    rows are split across blocks until the call has a block an SM (at
    least 8 rows a block)."""
    staged = s * c * itemsize + TQ * k * 4 <= build.SMEM_BYTES
    parts, tiles = 1, b * (m // TQ)
    while tiles * parts < build.SMS and parts < 16:
        parts *= 2
    return parts, staged


def launch_gather(x: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor, stride: int, s: int,
                  parts: int, staged: bool) -> torch.Tensor:
    """One launch of the gather kernel with the given configuration (see
    :func:`gather_config`); checks and counts are the caller's."""
    B, N, C = x.shape
    _, M, K = idx.shape
    out = torch.empty((B, M, K, C), dtype=x.dtype, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.amt_gather_banded(x.data_ptr(), idx.data_ptr(), starts.data_ptr(), stride,
                                     B, N, C, M, K, s, ELEM_BYTES[x.dtype], parts, int(staged),
                                     out.data_ptr(), build.stream_of(x))
    build.check(code, "amt_gather_banded")
    return out


def scatter_banded(g: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor, n: int,
                   s: int) -> torch.Tensor:
    """(B, M, K, C) f32|bf16, (B, M, K) int32, starts, window size ``s`` ->
    (B, n, C): the ordered, windowed scatter-add (see
    :func:`scatter_banded_plain`). Launches the kernel for CUDA tensors; CPU
    tensors take the plain version."""
    check_rows(g, idx, "scatter_banded", 4)
    if g.shape[1:3] != idx.shape[1:]:
        raise ValueError(f"scatter_banded: g {tuple(g.shape)} does not match "
                         f"idx {tuple(idx.shape)}")
    B, M, K, C = g.shape
    stride = _check_starts(starts, B, M, g, "scatter_banded")
    if g.device.type == "cpu":
        return scatter_banded_plain(g, idx, starts, n, s)
    out = torch.empty((B, n, C), dtype=g.dtype, device=g.device)
    # scratch: counts / cursors and slice starts per destination, the
    # positions grouped by destination before and after the sort
    per_dest = torch.empty((2, B, n), dtype=torch.int32, device=g.device)
    per_pos = torch.empty((2, B, M * K), dtype=torch.int32, device=g.device)
    lib = build.library()
    with torch.cuda.device(g.device):
        code = lib.amt_scatter_banded(
            g.data_ptr(), idx.data_ptr(), starts.data_ptr(), stride, B, n, C, M, K, s,
            ELEM_BYTES[g.dtype], per_dest[0].data_ptr(), per_dest[1].data_ptr(),
            per_pos[0].data_ptr(), per_pos[1].data_ptr(), out.data_ptr(), build.stream_of(g))
    build.check(code, "amt_scatter_banded")
    scatter_banded.launches += 1
    return out


class GatherBanded(torch.autograd.Function):
    """The windowed gather; the gradient of ``x`` is the windowed ordered
    scatter-add of the output's gradient, ``idx`` and ``starts`` get none."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                s: int) -> torch.Tensor:
        ctx.save_for_backward(idx, starts)
        ctx.n, ctx.s = x.shape[1], s
        return _gather_forward(x, idx, starts, s)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        idx, starts = ctx.saved_tensors
        return scatter_banded(g.contiguous(), idx, starts, ctx.n, ctx.s), None, None, None


def gather_banded(x: torch.Tensor, idx: torch.Tensor, starts: Optional[torch.Tensor] = None,
                  w0: int = 0) -> torch.Tensor:
    """(B, N, C) f32|bf16, (B, M, K) int32 -> (B, M, K, C), differentiable
    in ``x``. Exact for indices produced by :func:`knn_banded` with the same
    ``starts`` and ``w0``.

    Invariant: every index in row block t of cloud b must lie inside that
    tile's window ``[starts[b, t], starts[b, t] + S)`` for the same (M, N,
    w0) geometry; ``starts`` defaults to the proportional policy.
    Out-of-window indices silently give zero rows, so call sites feed only
    indices from ``knn_banded`` with matching shapes, starts and w0, or
    shapes where S == N (full window: exact for any indices). With
    ``AM_BANDED_DEBUG=1`` the containment is asserted on the host (a debug
    check: it waits for the device).

    Launches the kernels for CUDA tensors (forward and backward); CPU
    tensors take the plain versions."""
    B, N, _ = x.shape
    _, M, K = idx.shape
    if M % TQ != 0:
        raise ValueError(f"gather_banded: M={M} is not a multiple of {TQ}")
    s = _window(M, N, w0)
    if starts is None:
        starts = _starts_tensor(M, N, w0, x.device)
    if os.environ.get("AM_BANDED_DEBUG", "") == "1":
        rel = idx.long() - _per_row_starts(starts, B)[:, :, None]
        assert bool(((rel >= 0) & (rel < s)).all()), (
            f"gather_banded: index outside its curve window (M={M}, N={N}, S={s})")
    return GatherBanded.apply(x, idx, starts, s)


knn_banded.launches = 0
gather_banded.launches = 0
scatter_banded.launches = 0

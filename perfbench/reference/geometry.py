"""The clouds' curve order and point hierarchy, worked out plainly: frozen
copies of the plain versions the program's kernels are held to (the
Hilbert order of ``prepare sort``, greedy FPS, the windowed kNN of curve-
sorted clouds and its window policy, the exact kNN of small levels), and
the SceneMap hierarchy of a cloud from them."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

TQ = 128           # query rows a window tile
IDX_BITS = 13      # a kNN key's index bits
IDX_MASK = (1 << IDX_BITS) - 1
STRIDES = (1, 4, 4, 4)
NSAMPLES = (8, 16, 16, 16)


# ----------------------------------------------------------- curve order
def hilbert_codes(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(..., N, 3) f32 -> (..., N) int64 Hilbert codes on a 2^bits grid
    over each cloud's bounding box (Skilling's transpose algorithm), the
    grid worked out in float64 as the program's ``prepare sort`` does."""
    p = points.double()
    lo = p.amin(dim=-2, keepdim=True)
    extent = (p.amax(dim=-2, keepdim=True) - lo) + 1e-9
    X = ((p - lo) / extent * ((1 << bits) - 1)).long().reshape(-1, 3)
    n = 3
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(n):
            mask = (X[:, i] & Q) != 0
            X[:, 0] = torch.where(mask, X[:, 0] ^ P, X[:, 0])
            t = (X[:, 0] ^ X[:, i]) & P
            t = torch.where(mask, torch.zeros_like(t), t)
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= 1
    for i in range(1, n):
        X[:, i] ^= X[:, i - 1]
    t = torch.zeros_like(X[:, 0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((X[:, n - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X ^= t[:, None]
    code = torch.zeros_like(X[:, 0])
    for b in range(bits):
        for i in range(n):
            code |= ((X[:, i] >> b) & 1) << (n * b + (n - 1 - i))
    return code.reshape(points.shape[:-1])


def hilbert_order(points: torch.Tensor) -> torch.Tensor:
    """The stable sort of each cloud's points by their codes: (..., N)."""
    return torch.sort(hilbert_codes(points), dim=-1, stable=True).indices


# ------------------------------------------------------------------- FPS
def fps(points: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, m) int32: index 0 first, then the first index
    of the largest distance to the picked set, d = (dx dx + dy dy) + dz dz."""
    B, N, _ = points.shape
    out = torch.zeros((B, m), dtype=torch.int32, device=points.device)
    min_d = torch.full((B, N), float("inf"), dtype=torch.float32, device=points.device)
    rows = torch.arange(B, device=points.device)
    last = torch.zeros(B, dtype=torch.long, device=points.device)
    for i in range(1, m):
        delta = points - points[rows, last][:, None, :]
        dx, dy, dz = delta.unbind(-1)
        d = (dx * dx + dy * dy) + dz * dz
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1)
        out[:, i] = last.to(torch.int32)
    return out


# --------------------------------------------------- the windowed kNN
def window_width(n_support: int, w0: int) -> int:
    w0 = max(128, (int(w0 or 128) // 128) * 128)
    return max(128, min(w0, (n_support // 16) // 128 * 128))


def window_starts(m: int, n: int, w: int):
    ratio = n / m
    s = min(n, ((int(TQ * ratio) + 2 * w + 127) // 128) * 128)
    starts = []
    for t in range(m // TQ):
        c = int(t * TQ * ratio) - w
        c = max(0, min(n - s, c))
        starts.append((c // 128) * 128)
    return starts, s


def banded_supports(m: int, n: int, k: int) -> bool:
    return m % TQ == 0 and n % 128 == 0 and 256 <= n <= 8192 and k < 64


def down_starts(fps_idx: torch.Tensor, n_support: int, w0: int) -> torch.Tensor:
    """Each query tile's window centred on its span of parent rows."""
    _, M = fps_idx.shape
    _, s = window_starts(M, n_support, window_width(n_support, w0))
    lo = fps_idx[:, 0::TQ].to(torch.int32)
    hi = fps_idx[:, TQ - 1::TQ].to(torch.int32)
    center = torch.div(lo + hi, 2, rounding_mode="floor")
    st = torch.clamp(center - s // 2, 0, n_support - s)
    return (torch.div(st, 128, rounding_mode="floor") * 128).to(torch.int32)


def knn_banded(query: torch.Tensor, support: torch.Tensor, k: int, w0: int,
               starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Neighbours of each 128-query tile among its window of ``s`` support
    rows: the k smallest keys (d^2 with its low 13 bits replaced by the
    window column), absolute indices (B, M, k)."""
    B, M, _ = query.shape
    N = support.shape[1]
    _, s = window_starts(M, N, window_width(N, w0))
    G = M // TQ
    dev = query.device
    if starts is None:
        st0, _ = window_starts(M, N, window_width(N, w0))
        starts = torch.tensor(st0, dtype=torch.int32, device=dev)
    st = starts.long()
    st = st[None, :].expand(B, -1) if st.ndim == 1 else st
    col = torch.arange(s, dtype=torch.int32, device=dev)
    per = max(1, (1 << 24) // (B * TQ * s))
    rows = torch.arange(B, device=dev)[:, None, None]
    out = []
    for lo in range(0, G, per):
        st_c = st[:, lo:lo + per]
        g = st_c.shape[1]
        win = support[rows, st_c[:, :, None] + col.long()]          # (B, g, s, 3)
        q = query[:, lo * TQ:(lo + g) * TQ].reshape(B, g, TQ, 3)
        d = None
        for c in range(3):
            t = q[:, :, :, None, c] - win[:, :, None, :, c]
            t = t * t
            d = t if d is None else d + t
        packed = (d.view(torch.int32) & ~IDX_MASK) | col
        keys = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
        out.append(((keys & IDX_MASK) + st_c[:, :, None, None].to(torch.int32))
                   .reshape(B, g * TQ, k))
    return torch.cat(out, dim=1)


def knn_exact(query: torch.Tensor, support: torch.Tensor, k: int) -> torch.Tensor:
    """Exact kNN by k passes of argmin (ties to the smaller index) over the
    expanded-form squared distances |q|^2 - 2 q.s + |s|^2, clamped at 0."""
    def sq(p):
        x, y, z = p.unbind(-1)
        return (x * x + y * y) + z * z

    cross = torch.matmul(query, support.transpose(1, 2))
    d = torch.clamp_min(sq(query)[:, :, None] - 2.0 * cross + sq(support)[:, None, :], 0.0)
    dd = d.clone()
    idx = []
    for _ in range(min(k, support.shape[1])):
        i = torch.argmin(dd, dim=-1, keepdim=True)
        idx.append(i)
        dd.scatter_(-1, i, float("inf"))
    return torch.cat(idx, dim=-1).to(torch.int32)


def knn(query: torch.Tensor, support: torch.Tensor, k: int, w0: int,
        starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The windowed kNN where the shapes take it, the exact one where the
    program's packed-key kNN would not take them either (the last level, of
    128 points); the packed-key kNN's shapes are not held here."""
    m, n = query.shape[1], support.shape[1]
    if banded_supports(m, n, k):
        return knn_banded(query, support, k, w0, starts)
    if m % TQ == 0 and n % 128 == 0 and 256 <= n <= 8192 and k < n:
        raise NotImplementedError(f"a {m} x {n} kNN: the packed-key kNN's shapes")
    return knn_exact(query, support, k)


# ------------------------------------------------------------ hierarchy
def fps_wire(xyz: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Each level's FPS indices (ascending) from the f32 sorted cloud, as
    ``prepare geometry`` caches them."""
    wire, parent = {}, xyz
    for level, stride in enumerate(STRIDES):
        if stride == 1:
            continue
        idx = torch.sort(fps(parent, parent.shape[1] // stride), dim=-1).values
        wire[level] = idx
        parent = torch.gather(parent, 1, idx.long()[..., None].expand(-1, -1, 3))
    return wire


def hierarchy(xyz: torch.Tensor, wire: Dict[int, torch.Tensor], w0: int) -> List[Dict]:
    """Levels of ``xyz`` (B, N, 3) f32 from the FPS wire: each level's
    points, its own kNN and, below the first, its kNN in the parent level."""
    levels, parent = [], xyz
    for level, k in enumerate(NSAMPLES):
        lvl, down = parent, None
        if level in wire:
            idx = wire[level]
            lvl = torch.gather(parent, 1, idx.long()[..., None].expand(-1, -1, 3))
            st = None
            if banded_supports(lvl.shape[1], parent.shape[1], k):
                st = down_starts(idx, parent.shape[1], w0)
            down = knn(lvl, parent, k, w0, st)
        levels.append({"xyz": lvl, "knn": knn(lvl, lvl, k, w0), "down": down})
        parent = lvl
    return levels

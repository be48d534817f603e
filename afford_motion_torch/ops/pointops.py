"""Point-cloud primitives in a dense ``(B, N, C)`` layout
(counterpart of ``afford_motion_tpu/ops/pointops.py``).

Routing of the batched entry points, as on the TPU:

- ``batched_fps`` -> the FPS kernel (``ops/cuda/fps.py``);
- ``batched_knn`` -> the packed-key kNN kernel (``ops/cuda/knn.py``) for the
  shapes it supports, the exact :func:`knn` otherwise or when
  ``method='exact'``. The TPU sent unsupported shapes to ``approx_min_k``,
  which is approximate there; here they take the exact path.

Each kernel wrapper runs its plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .cuda.fps import fps_cuda, fps_plain
from .cuda.knn import knn_cuda
from .cuda.knn import supports as knn_supports

PAD_DIST = float(np.sqrt(1e10))  # the reference knnquery's heap-init distance


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def pairwise_sqdist(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, m, 3) x (B, n, 3) -> (B, m, n) in the expanded
    form ``|q|^2 - 2 q.s + |s|^2``, clamped at 0."""
    cross = torch.matmul(query, support.transpose(1, 2))
    d = _sq_norm(query)[:, :, None] - 2.0 * cross + _sq_norm(support)[:, None, :]
    return torch.clamp_min(d, 0.0)


def knn(query: torch.Tensor, support: torch.Tensor, k: int, *,
        chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN, (B, m, 3), (B, n, 3) -> idx (B, m, k) int32, dist (B, m, k)
    sqrt-distances.

    k passes of argmin + mask, so ties go to the smaller index. With
    k > n the tail slots keep index 0 at distance sqrt(1e10), the reference
    kernel's heap init (afford_motion_tpu/ops/pointops.py:74-113)."""
    B, m, _ = query.shape
    n = support.shape[1]
    k_eff = min(k, n)
    chunk = min(chunk, m)
    if m % chunk != 0:
        chunk = m
    idx_l, dist_l = [], []
    for lo in range(0, m, chunk):
        d = pairwise_sqdist(query[:, lo:lo + chunk], support)
        dd = d.clone()
        idx_k, dk = [], []
        for _ in range(k_eff):
            i = torch.argmin(dd, dim=-1, keepdim=True)
            idx_k.append(i)
            dk.append(torch.gather(d, -1, i))
            dd.scatter_(-1, i, float("inf"))
        idx = torch.cat(idx_k, dim=-1).to(torch.int32)
        dist = torch.sqrt(torch.cat(dk, dim=-1))
        if k_eff < k:
            pad = (B, idx.shape[1], k - k_eff)
            idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
            dist = torch.cat([dist, dist.new_full(pad, PAD_DIST)], dim=-1)
        idx_l.append(idx)
        dist_l.append(dist)
    return torch.cat(idx_l, dim=1), torch.cat(dist_l, dim=1)


def farthest_point_sampling(points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Greedy FPS of one cloud, (n, 3) -> (num_samples,) int32."""
    return fps_plain(points[None], num_samples)[0]


def interpolation_weights(sqrt_dist: torch.Tensor) -> torch.Tensor:
    """Normalized inverse-distance weights 1/(d + 1e-8)."""
    recip = 1.0 / (sqrt_dist + 1e-8)
    return recip / recip.sum(dim=-1, keepdim=True)


def batched_knn(query: torch.Tensor, support: torch.Tensor, k: int,
                method: Optional[str] = None):
    """(B, m, 3), (B, n, 3) -> idx (B, m, k) int32, dist (B, m, k)."""
    if method != "exact" and knn_supports(query.shape[1], support.shape[1], k):
        return knn_cuda(query.contiguous(), support.contiguous(), k)
    return knn(query, support, k)


def batched_fps(points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, n, 3) f32 -> (B, num_samples) int32."""
    return fps_cuda(points.contiguous(), num_samples)

"""Batched farthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its
plain PyTorch version.

Counterpart of ``afford_motion_tpu/ops/pallas/fps.py`` (``fps_pallas``).
Selection rule of both: pick index 0 first; the min-distance field starts at
+inf; each step folds d = (dx*dx + dy*dy) + dz*dz into it and picks the
first index of its maximum.

The kernel spreads each cloud over a thread block cluster of
:data:`CLUSTER` blocks of :data:`THREADS` threads. Clouds of at most
:data:`RESIDENT_POINTS` points sit in registers and shared memory; larger
ones take the kernel's streamed instance, which reads them from device
memory and keeps the distance field in a scratch buffer.
"""
from __future__ import annotations

import torch

from . import build

RESIDENT_POINTS = 8192  # threads x blocks x register-resident points a thread (csrc/fps.cu)
THREADS, CLUSTER = 256, 4   # a block, blocks a cloud (csrc/fps.cu kThreads, kCluster)


def fps_plain(points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, num_samples) int32, one greedy step per loop
    iteration. ``torch.argmax`` returns the first maximal index."""
    B, N, _ = points.shape
    out = torch.zeros((B, num_samples), dtype=torch.int32, device=points.device)
    min_d = torch.full((B, N), float("inf"), dtype=torch.float32, device=points.device)
    rows = torch.arange(B, device=points.device)
    last = torch.zeros(B, dtype=torch.long, device=points.device)
    for i in range(1, num_samples):
        delta = points - points[rows, last][:, None, :]
        dx, dy, dz = delta.unbind(-1)
        d = (dx * dx + dy * dy) + dz * dz
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1)
        out[:, i] = last.to(torch.int32)
    return out


def fps_cuda(points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, num_samples) int32. Launches the kernel for a
    CUDA tensor; a CPU tensor takes :func:`fps_plain`."""
    if points.ndim != 3 or points.shape[-1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"fps_cuda: expected (B, N, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    B, N, _ = points.shape
    if not 0 < num_samples <= N:
        raise ValueError(f"fps_cuda: num_samples={num_samples} outside (0, {N}]")
    if points.device.type == "cpu":
        return fps_plain(points, num_samples)
    build.require_cuda(points, "fps_cuda")
    if not points.is_contiguous():
        raise ValueError("fps_cuda: points must be contiguous")
    out = torch.empty((B, num_samples), dtype=torch.int32, device=points.device)
    lib = build.library()
    with torch.cuda.device(points.device):
        if N <= RESIDENT_POINTS:
            name = "amt_fps"
            code = lib.amt_fps(points.data_ptr(), B, N, num_samples, out.data_ptr(),
                               build.stream_of(points))
        else:
            name = "amt_fps_streamed"
            field = torch.empty((B, N), dtype=torch.float32, device=points.device)
            code = lib.amt_fps_streamed(points.data_ptr(), B, N, num_samples, field.data_ptr(),
                                        out.data_ptr(), build.stream_of(points))
    build.check(code, name)
    fps_cuda.launches += 1
    return out


fps_cuda.launches = 0

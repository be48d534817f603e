"""Fused exact 1-NN for the SDF physics metric: the CUDA kernel
``csrc/nn1.cu`` and its plain PyTorch version.

Counterpart of ``afford_motion_tpu/ops/pallas/sdf.py`` (``nn1_pallas``): for
every frame and scene point, the squared distance to the nearest body vertex
and that vertex's index. Distances are the exact float32 coordinate-difference
form ``((dx*dx + dy*dy) + dz*dz)`` with every step rounded (no FMA), and an
exact tie goes to the smallest vertex index. Inputs must be NaN-free. Any
O, H and L are taken: the kernel masks its ragged tiles, so the TPU kernel's
``supports`` predicate (queries tile by 128) has no counterpart here.
The kernel visits the vertices in groups of 32 sorted by cell and skips a
group whose box cannot hold a vertex as near as the best found (exactly:
see ``csrc/nn1.cu``); ``tests/test_torch_nn1_design.py`` models that order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

def nn1_plain(points: torch.Tensor, verts_seq: torch.Tensor, chunk: int = 2048):
    """points (O, 3) f32, verts_seq (L, H, 3) f32 -> d2 (L, O) f32,
    idx (L, O) int32. Queries go in chunks so the (chunk, H) distance matrix
    stays bounded; the first index attaining the exact minimum wins."""
    O = points.shape[0]
    L, H, _ = verts_seq.shape
    col = torch.arange(H, dtype=torch.int32, device=points.device)
    big = torch.tensor(2 ** 30, dtype=torch.int32, device=points.device)
    d2 = torch.empty((L, O), dtype=torch.float32, device=points.device)
    idx = torch.empty((L, O), dtype=torch.int32, device=points.device)
    for f in range(L):
        v = verts_seq[f]
        for lo in range(0, O, chunk):
            q = points[lo:lo + chunk]
            d = None
            for a in range(3):
                t = q[:, None, a] - v[None, :, a]
                t = t * t
                d = t if d is None else d + t
            m = d.min(dim=1, keepdim=True).values
            d2[f, lo:lo + chunk] = m[:, 0]
            idx[f, lo:lo + chunk] = torch.where(d == m, col, big).min(dim=1).values
    return d2, idx


def nn1_cuda(points: torch.Tensor, verts_seq: torch.Tensor):
    """points (O, 3) f32, verts_seq (L, H, 3) f32 -> d2 (L, O) f32,
    idx (L, O) int32. Launches the kernels for CUDA tensors; CPU tensors take
    :func:`nn1_plain`."""
    return nn1_launch(points, verts_seq)


def nn1_launch(points: torch.Tensor, verts_seq: torch.Tensor,
               visits: Optional[torch.Tensor] = None):
    """:func:`nn1_cuda`, and with ``visits``, a (1,) int64 CUDA tensor, the
    vertex-query pairs the kernel evaluated added to it (the share of pairs
    it visits, for the record)."""
    if points.ndim != 2 or points.shape[-1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"nn1_cuda: points must be (O, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if verts_seq.ndim != 3 or verts_seq.shape[-1] != 3 or verts_seq.dtype != torch.float32:
        raise ValueError(f"nn1_cuda: verts_seq must be (L, H, 3) float32, got "
                         f"{tuple(verts_seq.shape)} {verts_seq.dtype}")
    if points.device != verts_seq.device:
        raise ValueError("nn1_cuda: points and verts_seq lie on different devices")
    O = points.shape[0]
    L, H, _ = verts_seq.shape
    if O < 1 or L < 1 or H < 1:
        raise ValueError(f"nn1_cuda: empty input O={O} L={L} H={H}")
    if points.device.type == "cpu":
        return nn1_plain(points, verts_seq)
    build.require_cuda(points, "nn1_cuda")
    if not (points.is_contiguous() and verts_seq.is_contiguous()):
        raise ValueError("nn1_cuda: points and verts_seq must be contiguous")
    if L > 65535:
        raise ValueError(f"nn1_cuda: {L} frames; the kernel takes at most 65535")
    if visits is not None and (visits.dtype != torch.int64 or tuple(visits.shape) != (1,)
                               or visits.device != points.device):
        raise ValueError("nn1_cuda: visits must be a (1,) int64 tensor on the points' device")
    lib = build.library()
    scratch = torch.empty(lib.amt_nn1_scratch(L, O, H), dtype=torch.uint8, device=points.device)
    d2 = torch.empty((L, O), dtype=torch.float32, device=points.device)
    idx = torch.empty((L, O), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        code = lib.amt_nn1(points.data_ptr(), verts_seq.data_ptr(), L, O, H, scratch.data_ptr(),
                           d2.data_ptr(), idx.data_ptr(),
                           None if visits is None else visits.data_ptr(),
                           build.stream_of(points))
    build.check(code, "amt_nn1")
    nn1_cuda.launches += 1
    return d2, idx


nn1_cuda.launches = 0

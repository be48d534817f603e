"""Packed-key kNN: the CUDA kernel ``csrc/knn.cu`` and its plain PyTorch
version.

Counterpart of ``afford_motion_tpu/ops/pallas/knn.py`` (``knn_pallas``),
with the same quantized semantics, which are NOT exact top-k: the f32
difference-form d^2 has its low 13 mantissa bits replaced by the support
index, and the k smallest of these unique int32 keys come out ascending.
idx is the key's low bits; dist is the sqrt of the key with them cleared.
"""
from __future__ import annotations

import torch

from . import build

IDX_BITS = 13  # supports N up to 8192
IDX_MASK = (1 << IDX_BITS) - 1


def supports(m: int, n: int, k: int) -> bool:
    """Shapes the packed kNN takes; the same predicate as the TPU kernel's
    ``supports`` with its 128-query tiles (its VMEM bound always holds for
    n <= 8192)."""
    tq = 128
    return (
        m % tq == 0
        and n % 128 == 0
        and 256 <= n <= (1 << IDX_BITS)
        and k <= 64
        and k < n
        and tq * n * 4 * 3 + n * 32 <= 14 * 1024 * 1024
    )


def knn_plain(query: torch.Tensor, support: torch.Tensor, k: int,
              chunk: int = 2048):
    """(B, M, 3), (B, N, 3) f32 -> idx (B, M, k) int32, dist (B, M, k) f32.

    Queries go in chunks so the (B, chunk, N) key matrix stays bounded.
    ``torch.topk`` of the unique keys gives what the TPU kernel's k passes
    of int-min give."""
    B, M, _ = query.shape
    N = support.shape[1]
    col = torch.arange(N, dtype=torch.int32, device=query.device)
    idx_l, dist_l = [], []
    for lo in range(0, M, chunk):
        q = query[:, lo:lo + chunk]
        d = None
        for c in range(3):
            t = q[:, :, None, c] - support[:, None, :, c]
            t = t * t
            d = t if d is None else d + t
        packed = (d.view(torch.int32) & ~IDX_MASK) | col
        keys = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
        idx_l.append(keys & IDX_MASK)
        dq = (keys & ~IDX_MASK).view(torch.float32)
        # torch's vectorized CPU sqrt is not correctly rounded; through f64
        # it is, as sqrtf is in the kernel and jnp.sqrt on the TPU side
        dist_l.append(torch.sqrt(torch.clamp_min(dq, 0.0).double()).float())
    return torch.cat(idx_l, dim=1), torch.cat(dist_l, dim=1)


def knn_cuda(query: torch.Tensor, support: torch.Tensor, k: int):
    """(B, M, 3), (B, N, 3) f32 -> idx (B, M, k) int32, dist (B, M, k) f32
    (sqrt distances, the contract of ``ops.pointops.knn``). Launches the
    kernel for CUDA tensors; CPU tensors take :func:`knn_plain`."""
    for name, t in (("query", query), ("support", support)):
        if t.ndim != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"knn_cuda: {name} must be (B, *, 3) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    B, M, _ = query.shape
    N = support.shape[1]
    if support.shape[0] != B or query.device != support.device:
        raise ValueError("knn_cuda: query and support differ in batch or device")
    if not supports(M, N, k):
        raise ValueError(f"knn_cuda: unsupported shape M={M} N={N} k={k}")
    if query.device.type == "cpu":
        return knn_plain(query, support, k)
    build.require_cuda(query, "knn_cuda")
    if not (query.is_contiguous() and support.is_contiguous()):
        raise ValueError("knn_cuda: query and support must be contiguous")
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    lib = build.library()
    with torch.cuda.device(query.device):
        code = lib.amt_knn_packed(query.data_ptr(), support.data_ptr(), B, M, N, k,
                                  idx.data_ptr(), dist.data_ptr(),
                                  build.stream_of(query))
    build.check(code, "amt_knn_packed")
    knn_cuda.launches += 1
    return idx, dist


knn_cuda.launches = 0

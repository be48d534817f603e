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


CHUNK = 32  # support points a box (csrc/knn.cu kChunk)


def launch_config(b: int, m: int, n: int, k: int):
    """(threads a block, support parts) of the kernel for a call: one query
    a thread; 1024 a block for 4096 queries or more over 2048 points or more
    (512 for k > 16), 512 for 512 queries or more over 2048 points or more,
    else 128; the support split in two until the call has a block for every
    two SMs or a part would fall under 128 points. Chosen from the times of
    every configuration at the path's shapes (``tools/kernel_ab.py --sweep``)."""
    if m >= 4096 and n >= 2048 and k <= 16:
        threads = 1024
    else:
        threads = 512 if m >= 512 and n >= 2048 else 128
    blocks = b * -(-m // threads)
    split = 1
    while (blocks * split < build.SMS // 2 and n % (2 * split * CHUNK) == 0
           and n // (2 * split) >= 128):
        split *= 2
    return threads, split


def curve_order(query: torch.Tensor, support: torch.Tensor):
    """Each cloud's support points and queries sorted by cell of a 16^3 grid
    over the support's bounding box, the cells numbered along a Morton curve
    (``amt_knn_order``): (qorder, qcells, ssorted, sorder, scells), the
    orders and cells int32 in that order, ``ssorted`` the support's points
    in it."""
    B, M, _ = query.shape
    N = support.shape[1]
    dev = query.device
    ssorted = torch.empty_like(support)
    sorder, scells = (torch.empty((B, N), dtype=torch.int32, device=dev) for _ in range(2))
    qorder, qcells = (torch.empty((B, M), dtype=torch.int32, device=dev) for _ in range(2))
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.amt_knn_order(support.data_ptr(), query.data_ptr(), B, N, M,
                                 ssorted.data_ptr(), sorder.data_ptr(), scells.data_ptr(),
                                 qorder.data_ptr(), qcells.data_ptr(), build.stream_of(query))
    build.check(code, "amt_knn_order")
    return qorder, qcells, ssorted, sorder, scells


def launch(query: torch.Tensor, support: torch.Tensor, k: int, threads: int, split: int,
           order=None, visits: torch.Tensor | None = None):
    """One launch of the kernel with the given configuration (see
    :func:`launch_config`) and curve order (see :func:`curve_order`; made
    here when not given); checks and counts are the caller's. ``visits``, a
    one-element int64 tensor on the device, gains the 32-query x 32-point
    chunks the kernel scanned (its share of the M*N pairs, for the record)."""
    B, M, _ = query.shape
    N = support.shape[1]
    qorder, qcells, ssorted, sorder, scells = order or curve_order(query, support)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    dist = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    part_keys = (torch.empty((B, M, split, k), dtype=torch.int32, device=query.device)
                 if split > 1 else None)
    lib = build.library()
    with torch.cuda.device(query.device):
        code = lib.amt_knn_packed(
            query.data_ptr(), qorder.data_ptr(), qcells.data_ptr(), ssorted.data_ptr(),
            sorder.data_ptr(), scells.data_ptr(), B, M, N, k, threads, split,
            None if part_keys is None else part_keys.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), None if visits is None else visits.data_ptr(),
            build.stream_of(query))
    build.check(code, "amt_knn_packed")
    return idx, dist


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
    out = launch(query, support, k, *launch_config(B, M, N, k))
    knn_cuda.launches += 1
    return out


knn_cuda.launches = 0

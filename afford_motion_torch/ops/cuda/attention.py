"""Fused inference attention: the CUDA kernel ``csrc/attention.cu`` and its
plain PyTorch version.

Counterpart of the flash-attention path of
``afford_motion_tpu/models/layers.py`` (``_flash_attention``): masked
scaled-dot-product attention over (B, L, heads * hd) projections, keys with
``pad_mask`` True left out. Logits, softmax and sums are float32 whatever
the input type; for bfloat16 inputs the softmax weights are rounded to
bfloat16 before they weight v (as the TPU kernel's ``p.astype(v.dtype)`` and
the einsum path ``_attention`` do), and the result is rounded to the input
type once. The kernel's sums run in another order than the plain version's,
and its bf16 weights are rounded before their normalisation, against the
running maximum of each 64-key tile, so the two agree to a tolerance, not
bit for bit (:data:`TOLERANCE`): every entry within ``atol * max |v| + rtol
* |plain|``. float32: 1e-5 of the largest ``|v|``. bfloat16: 2^-9 of the
largest ``|v|`` plus 2^-7 of ``|plain|`` (one bf16 ulp of the result). The
bf16 figure is set from readings, between what a right kernel and a faulty
one give: the kernel's order, emulated on the CPU
(``tests/test_torch_attention.py``), needs at most 2^-11.3 of the largest
``|v|`` beyond the ulp term at the denoiser's shape and at head dimensions
8, 40 and 64, and the kernel on an H100 2^-11.2; one attended key left out,
or the last tile of keys skipped, needs 2^-4.8 or more at the denoiser's
shape. Whether the weights are rounded to bf16 moves
the result by less than its own final rounding, so no elementwise tolerance
tells a kernel that skips that rounding from one that does it. A query whose
keys are all masked has no defined result.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

MAX_HEAD_DIM = 64   # the kernel's one instance; every attention in the repo has 64
# (atol as a share of max |v|, rtol) of the kernel against attention_plain
TOLERANCE = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2.0 ** -9, 2.0 ** -7)}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Lq, D), k, v (B, Lk, D), pad_mask (B, Lk) bool (True = leave the
    key out) -> (B, Lq, D) in q's type. All arithmetic in float32; the
    softmax weights are rounded to v's type before the weighted sum."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    qh = q.float().reshape(B, Lq, num_heads, hd).transpose(1, 2)
    kh = k.float().reshape(B, Lk, num_heads, hd).transpose(1, 2)
    vh = v.float().reshape(B, Lk, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, None, :], float("-inf"))
    o = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype).float(), vh)
    return o.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same contract as :func:`attention_plain`. Launches the kernel for CUDA
    tensors; CPU tensors take the plain version."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"attention_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, L, D)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_cuda: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if D % num_heads != 0 or D // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"attention_cuda: width {D} over {num_heads} heads: the head "
                         f"dimension must be whole and at most {MAX_HEAD_DIM}")
    if pad_mask is not None and (pad_mask.dtype != torch.bool
                                 or tuple(pad_mask.shape) != (B, Lk)):
        raise ValueError(f"attention_cuda: pad_mask must be (B, Lk) bool, got "
                         f"{tuple(pad_mask.shape)} {pad_mask.dtype}")
    tensors = [q, k, v] + ([] if pad_mask is None else [pad_mask])
    if any(t.device != q.device for t in tensors):
        raise ValueError("attention_cuda: the inputs lie on different devices")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, pad_mask)
    build.require_cuda(q, "attention_cuda")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_cuda: q, k, v and pad_mask must be contiguous")
    if q.dtype == torch.bfloat16 and ((D // num_heads) % 8 != 0
                                      or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("attention_cuda: bfloat16 needs a head dimension that is a multiple of "
                         "8 and 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    hd = D // num_heads
    lib = build.library()
    with torch.cuda.device(q.device):
        code = lib.amt_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None if pad_mask is None else pad_mask.data_ptr(), B, Lq, Lk,
                                 num_heads, hd, hd ** -0.5, q.element_size(),
                                 out.data_ptr(), build.stream_of(q))
    build.check(code, "amt_attention")
    attention_cuda.launches += 1
    return out


attention_cuda.launches = 0

"""Fused attention: the CUDA kernels ``csrc/attention.cu`` (forward and
backward) and their plain PyTorch versions.

Counterpart of the flash-attention path of
``afford_motion_tpu/models/layers.py`` (``_flash_attention``, the library's
Pallas kernel and its ``custom_vjp``): masked scaled-dot-product attention
over (B, L, heads * hd) projections, keys with ``pad_mask`` True left out.
:func:`attention_cuda` goes through :class:`FlashAttention`, whose backward
is the library's: from the row statistics the forward saves (here the
log-sum-exp of each row's scaled logits, (B, heads, Lq) float32, +inf for a
row with no attended key; JAX saves the running max m and sum l, and
lse = m + log l) it recomputes P in float32 and gives dq, dk and dv
(:func:`attention_backward_plain`, :func:`attention_backward_cuda`).

Forward. Logits, softmax and sums are float32 whatever the input type; for
bfloat16 inputs the softmax weights are rounded to bfloat16 before they
weight v (as the TPU kernel's ``p.astype(v.dtype)`` and the einsum path
``_attention`` do), and the result is rounded to the input type once. The
kernel's sums run in another order than the plain version's, and its bf16
weights are rounded before their normalisation, against the running maximum
of each 64-key tile, so the two agree to a tolerance, not bit for bit
(:data:`TOLERANCE`): every entry within ``atol * max |v| + rtol * |plain|``.
float32: 1e-5 of the largest ``|v|``. bfloat16: 2^-9 of the largest ``|v|``
plus 2^-7 of ``|plain|`` (one bf16 ulp of the result). The bf16 figure is set
from readings, between what a right kernel and a faulty one give: the
kernel's order, emulated on the CPU (``tests/test_torch_attention.py``),
needs at most 2^-11.3 of the largest ``|v|`` beyond the ulp term at the
denoiser's shape and at head dimensions 8, 40 and 64, and the kernel on an
H100 2^-11.2; one attended key left out, or the last tile of keys skipped,
needs 2^-4.8 or more at the denoiser's shape. Whether the weights are
rounded to bf16 moves the result by less than its own final rounding, so no
elementwise tolerance tells a kernel that skips that rounding from one that
does it. The f32 kernel (the regressor's) sums over tiles of 32 keys with
the online softmax in base e; its order, emulated, needs at most 2^-22.5 of
the largest ``|v|`` at the regressor's shape and at head dimensions 8, 40 and
64, and the last tile of keys skipped 4.5e-2 or more. A query whose keys are
all masked gets a zero row from both (the JAX package leaves that case
undefined).

Backward. ``di = sum(o * do)`` over the rounded output; ``dv = P^T do`` with
P rounded to the input type first; ``ds = (do v^T - di) * P * scale``;
``dk = ds^T q`` and ``dq = ds k`` with ds rounded to the input type first;
sums in float32, each gradient rounded once. Masked keys get zero gradients.
Each instance is one launch, whose dK/dV work walks each key tile's query
tiles (bf16 64 rows, f32 32) and writes the dS^T (bf16, rounded) or dS (f32)
tiles, and whose dQ work sums dS K over the key tiles of 64 in order, so the
kernels agree with the plain version to :data:`TOLERANCE_BWD`: every entry of each
gradient within ``atol * max |plain gradient| + rtol * |plain|``
(:func:`backward_excess` gives the atol a pair needs). float32: 1e-5 of the
largest entry. bfloat16: 2^-9 of it plus one bf16 ulp of the result. Both
set from readings, between what a right kernel and a faulty one give: the
kernels' order, emulated on the CPU (``tests/test_torch_attention_bwd.py``,
and for f32 ``tests/test_torch_attention_bwd_f32_design.py``), needs at most
2^-11.4 (bf16) and 2^-19.1 (f32) of the largest entry at the denoiser's
shape and at head dimensions 8, 40 and 64, and the kernels on an H100
2^-10.8 and 2^-18.2; a key tile skipped, di left out, the mask
missing in the backward, or a key tile's dq part left out or added twice
needs 2^-1.5 or more. Whether P is rounded to bf16
before dV moves dv by less than its own final rounding (2^-9.5 of the
largest entry, inside the ulp term), so no elementwise limit tells a kernel
that skips that rounding from one that does it. The share of dv's entries
that differ from the plain version's at all does: the kernels round P as the
plain version does, so only the sums' order moves dv (0.2% of the entries
emulated, 0.09% on an H100), where an unrounded P moves 13% to 43%; bf16
is held to :data:`DV_DIFFER_SHARE`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import build

MAX_HEAD_DIM = 64   # the kernel's one instance; every attention in the repo has 64
# (atol as a share of max |v|, rtol) of the kernel against attention_plain
TOLERANCE = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2.0 ** -9, 2.0 ** -7)}
# (atol as a share of each gradient's max |plain|, rtol) of the backward
# kernels against attention_backward_plain
TOLERANCE_BWD = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2.0 ** -9, 2.0 ** -7)}
# bf16: the largest share of dv's entries that may differ from the plain
# version's at all (see the module docstring)
DV_DIFFER_SHARE = 2.0 ** -5
# the f32 forward's launch configurations besides the default (0), for sweeps
# (tools/kernel_ab.py): queries a block
F32_ROWS = (8, 16, 32)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, heads * hd) -> (B, heads, L, hd) in float32."""
    B, L, D = x.shape
    return x.float().reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def _logits(q: torch.Tensor, k: torch.Tensor, num_heads: int,
            pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled float32 logits (B, heads, Lq, Lk), -inf on masked keys."""
    hd = q.shape[-1] // num_heads
    logits = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2)) * hd ** -0.5
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, None, :], float("-inf"))
    return logits


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Lq, D), k, v (B, Lk, D), pad_mask (B, Lk) bool (True = leave the
    key out) -> (B, Lq, D) in q's type. All arithmetic in float32; the
    softmax weights are rounded to v's type before the weighted sum. An item
    with no attended key gets zero rows, as from the kernel."""
    B, Lq, D = q.shape
    weights = torch.softmax(_logits(q, k, num_heads, pad_mask), dim=-1)
    if pad_mask is not None:
        weights = weights.masked_fill(pad_mask.all(dim=-1)[:, None, None, None], 0.0)
    o = torch.matmul(weights.to(v.dtype).float(), _heads(v, num_heads))
    return o.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                        pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The row statistics the backward reads: log-sum-exp of each row's
    scaled logits over its attended keys, (B, heads, Lq) float32, +inf for a
    row with no attended key (so that its recomputed weights are 0)."""
    lse = torch.logsumexp(_logits(q, k, num_heads, pad_mask), dim=-1)
    return torch.where(lse == float("-inf"), torch.full_like(lse, float("inf")), lse)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, num_heads: int,
                             pad_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`attention_plain` as the JAX library's
    ``_flash_attention_bwd`` computes it: o the forward's (rounded) output,
    do its gradient, lse from :func:`attention_lse_plain` -> (dq, dk, dv) in
    q's type. P = exp(s - lse) in float32; di = sum(o * do);
    dv = P^T do with P rounded to the type; ds = (do v^T - di) P scale;
    dk = ds^T q, dq = ds k with ds rounded to the type; masked keys get 0."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    dt = q.dtype
    scale = (D // num_heads) ** -0.5
    qh, kh, vh, oh, doh = (_heads(x, num_heads) for x in (q, k, v, o, do))
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lse[..., None])
    if pad_mask is not None:
        p = p.masked_fill(pad_mask[:, None, None, :], 0.0)
    di = (oh * doh).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    ds = ((torch.matmul(doh, vh.transpose(-1, -2)) - di) * p * scale).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dq = torch.matmul(ds, kh)

    def back(x, L):
        return x.transpose(1, 2).reshape(B, L, D).to(dt)

    return back(dq, Lq), back(dk, Lk), back(dv, Lk)


def backward_excess(got, want, rtol: float) -> float:
    """The atol (a share of each gradient's max |plain|) that the pair of
    gradient tuples needs beyond ``rtol * |plain|``: the largest over the
    gradients of max(|got - want| - rtol |want|) / max |want|."""
    need = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        if not bool(torch.isfinite(g).all()):
            return math.inf
        excess = float(((g - w).abs() - rtol * w.abs()).max())
        scale = float(w.abs().max())
        if excess > 0.0:
            need = max(need, excess / scale if scale > 0.0 else math.inf)
    return need


def _check_qkv(q, k, v, num_heads, pad_mask, name) -> None:
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (B, L, D)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if D % num_heads != 0 or D // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: width {D} over {num_heads} heads: the head "
                         f"dimension must be whole and at most {MAX_HEAD_DIM}")
    if pad_mask is not None and (pad_mask.dtype != torch.bool
                                 or tuple(pad_mask.shape) != (B, Lk)):
        raise ValueError(f"{name}: pad_mask must be (B, Lk) bool, got "
                         f"{tuple(pad_mask.shape)} {pad_mask.dtype}")


def _check_cuda(tensors, q, num_heads, name) -> None:
    """What the kernels take beyond the shapes: one CUDA device, contiguous
    tensors, and for bfloat16 a head dimension that is a multiple of 8 and
    16-byte aligned rows."""
    build.require_cuda(q, name)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the tensors must be contiguous")
    if q.dtype == torch.bfloat16 and ((q.shape[-1] // num_heads) % 8 != 0 or any(
            t.data_ptr() % 16 for t in tensors if t.dtype == torch.bfloat16)):
        raise ValueError(f"{name}: bfloat16 needs a head dimension that is a multiple of 8 "
                         "and 16-byte aligned tensors")


def attention_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           pad_mask: Optional[torch.Tensor] = None, stats: bool = False, *,
                           config: int = 0):
    """(o, lse): :func:`attention_plain`'s o and, with ``stats``,
    :func:`attention_lse_plain`'s statistics (else None), not differentiable.
    Launches the kernel for CUDA tensors; CPU tensors take the plain
    versions. The kernel's o is the same with and without ``stats``.
    ``config``: 0 for the default launch, or for float32 one of
    :data:`F32_ROWS` (queries a block)."""
    _check_qkv(q, k, v, num_heads, pad_mask, "attention_cuda")
    if q.device.type == "cpu":
        lse = attention_lse_plain(q, k, num_heads, pad_mask) if stats else None
        return attention_plain(q, k, v, num_heads, pad_mask), lse
    tensors = [q, k, v] + ([] if pad_mask is None else [pad_mask])
    _check_cuda(tensors, q, num_heads, "attention_cuda")
    B, Lq, D = q.shape
    hd = D // num_heads
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, Lq), dtype=torch.float32, device=q.device) if stats else None
    lib = build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_mask is None else pad_mask.data_ptr(), B, Lq, k.shape[1], num_heads, hd,
            hd ** -0.5, q.element_size(), out.data_ptr(), None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        code = (lib.amt_attention_config(*args, config, build.stream_of(q)) if config
                else lib.amt_attention(*args, build.stream_of(q)))
    build.check(code, "amt_attention")
    attention_cuda.launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """The fused attention with the library's backward: CPU tensors take
    the plain versions, CUDA tensors the kernels. ``with_grad`` asks the
    forward for the row statistics and keeps what the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, pad_mask, with_grad: bool):
        o, lse = attention_forward_cuda(q, k, v, num_heads, pad_mask, with_grad)
        if with_grad:
            ctx.save_for_backward(q, k, v, o, lse, pad_mask)
            ctx.num_heads = num_heads
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, pad_mask = ctx.saved_tensors
        dq, dk, dv = attention_backward_cuda(q, k, v, o, do.contiguous(), lse, ctx.num_heads,
                                             pad_mask)
        return dq, dk, dv, None, None, None


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same contract as :func:`attention_plain`, differentiable through
    :class:`FlashAttention`. Launches the kernels for CUDA tensors; CPU
    tensors take the plain versions."""
    _check_qkv(q, k, v, num_heads, pad_mask, "attention_cuda")
    tensors = [q, k, v] + ([] if pad_mask is None else [pad_mask])
    if any(t.device != q.device for t in tensors):
        raise ValueError("attention_cuda: the inputs lie on different devices")
    with_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, num_heads, pad_mask, with_grad)


attention_cuda.launches = 0


def attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, num_heads: int,
                            pad_mask: Optional[torch.Tensor] = None):
    """Same contract as :func:`attention_backward_plain`. Launches the
    kernels for CUDA tensors (bf16: one kernel for dq, dk and dv after a
    memset of its counters; float32: one kernel, dK/dV then dQ by ticket,
    after a memset of its counters; one count a call, and one on
    :data:`backward_bf16` or :data:`backward_f32`); CPU tensors take the
    plain version."""
    _check_qkv(q, k, v, num_heads, pad_mask, "attention_backward_cuda")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"attention_backward_cuda: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (B, num_heads, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"attention_backward_cuda: lse must be ({B}, {num_heads}, {Lq}) float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    tensors = [q, k, v, o, do, lse] + ([] if pad_mask is None else [pad_mask])
    if any(t.device != q.device for t in tensors):
        raise ValueError("attention_backward_cuda: the inputs lie on different devices")
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, do, lse, num_heads, pad_mask)
    _check_cuda(tensors, q, num_heads, "attention_backward_cuda")
    lib = build.library()
    # bf16: di, the kernel's counters and the dS^T tiles its dK/dV work hands
    # its dQ work; f32: the counters and the dS tiles
    scratch = torch.empty(lib.amt_attention_bwd_scratch(B, Lq, Lk, num_heads, q.element_size()),
                          dtype=torch.uint8, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hd = D // num_heads
    with torch.cuda.device(q.device):
        code = lib.amt_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), None if pad_mask is None else pad_mask.data_ptr(), B, Lq, Lk,
            num_heads, hd, hd ** -0.5, q.element_size(), scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), build.stream_of(q))
    build.check(code, "amt_attention_bwd")
    attention_backward_cuda.launches += 1
    (backward_f32 if q.dtype == torch.float32 else backward_bf16).launches += 1
    return dq, dk, dv


class LaunchCount:
    """A count of one kernel instance's launches (``launches``, as on the
    wrappers), where one wrapper launches more than one instance."""

    def __init__(self):
        self.launches = 0


attention_backward_cuda.launches = 0
# attention_backward_cuda's launches by instance
backward_bf16 = LaunchCount()
backward_f32 = LaunchCount()

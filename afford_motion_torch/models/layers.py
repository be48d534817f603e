"""Transformer building blocks of the CMDM denoiser
(counterpart of ``afford_motion_tpu/models/layers.py``).

Mixed precision follows the JAX package, with explicit casts and no
autocast: parameters stay float32, a module computes in its ``dtype``
(bfloat16 in the shipped config), and attention logits, softmax and
LayerNorm run in float32. Where flax's defaults differ from torch's, the
port follows flax: LayerNorm epsilon 1e-6, GELU in its tanh form.

Masks follow the torch convention, True = padding. A masked logit becomes
``finfo(float32).min``, not -inf, so a fully masked row gives a uniform
softmax (as in JAX) instead of NaN.

Dropout sits where the JAX layers have it (after the positional encoding,
on the attention weights, after the FFN activation and on both residual
branches). It is active in train mode only and draws its masks from an
explicit ``torch.Generator`` on the module's device, set for a whole model
by :func:`set_dropout_generator`; the masks are torch's, not JAX's.

With ``AM_FLASH_ATTN=1`` in the environment, attention on CUDA tensors goes
through the fused kernels (``ops/cuda/attention.py``) wherever the weights'
dropout is inactive, as the JAX package's flash path does on its device; the
default is the float32-softmax :func:`_attention`. An item whose keys are
all masked gets that function's uniform rows on the fused route too
(``uniform_where_all_masked`` of ``ops/cuda/attention.py``; the kernels give
it zeros). The fused route carries gradients (its backward is the
library's, in kernels too), so a train step with ``model.dropout=0``, which
reaches every Dropout here, differentiates through it. Self- and
cross-attention both take it.

Every attention computes its projections fused, as the JAX package's
``fused_qkv=True`` does: a self-attention (query is key is value) q, k and v
as one projection over the whole ``in_proj_weight``, and a cross-attention,
whose key is always its value, q alone and k, v as one projection over
``in_proj_weight[D:]``. The parameters stay torch's packed
``in_proj_weight`` / ``in_proj_bias``, so the state_dict is the same whatever
the JAX model's flag; the flag names only the JAX tree's layout
(``utils/convert.py``). Both routes read q, k and v as views of the packed
projections: the kernels through ``attention_qkv_cuda`` /
``attention_q_kv_cuda``, whose backward writes one packed gradient.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.attention import MAX_HEAD_DIM, attention_q_kv_cuda, attention_qkv_cuda


def sinusoidal_table(max_len: int, dim: int) -> np.ndarray:
    """Classic transformer sin/cos table, (max_len, dim), float32."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe.astype(np.float32)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode an entry is zeroed with probability
    ``p`` and the rest scaled by ``1 / (1 - p)``; the identity in eval mode
    or with ``p = 0``. The mask comes from ``self.generator``."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: call "
                               "set_dropout_generator(model, generator) first")
        keep = torch.rand(x.shape, device=x.device, generator=self.generator) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator``."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


class Linear(nn.Linear):
    """``nn.Linear`` that casts its input and parameters to ``dtype`` (the
    flax ``Dense(dtype=...)`` rule); parameters are stored in float32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=float32)``: epsilon 1e-6, computed in
    float32, result cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table over the sequence dim of (B, L, D), then
    dropout."""

    def __init__(self, dim: int, max_len: int = 5000, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = Dropout(dropout)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, dim)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x.to(self.dtype) + self.pe[: x.shape[1]].to(self.dtype)[None])


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep lookup + Linear, SiLU, Linear -> (B, 1, d_model)."""

    def __init__(self, d_model: int, time_embed_dim: int, max_len: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, time_embed_dim)),
                             persistent=False)
        self.time_embed = nn.Sequential(
            Linear(time_embed_dim, d_model, dtype=dtype), nn.SiLU(),
            Linear(d_model, d_model, dtype=dtype),
        )

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps.long()][:, None, :])


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
               pad_mask: Optional[torch.Tensor], dropout: nn.Module) -> torch.Tensor:
    """Masked scaled-dot-product attention over (B, L, H*C) projections;
    logits and softmax in float32, dropout on the weights, the weighted sum
    in ``v.dtype``."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // num_heads
    q = q.reshape(B, Lq, num_heads, hd).transpose(1, 2)
    k = k.reshape(B, Lk, num_heads, -1).transpose(1, 2)
    v = v.reshape(B, Lk, num_heads, -1).transpose(1, 2)
    attn = torch.matmul((q * hd ** -0.5).float(), k.float().transpose(-1, -2))
    if pad_mask is not None:
        attn = attn.masked_fill(pad_mask[:, None, None, :], torch.finfo(torch.float32).min)
    attn = dropout(torch.softmax(attn, dim=-1).to(v.dtype))
    o = torch.matmul(attn, v)
    return o.transpose(1, 2).reshape(B, Lq, -1)


def _flash_enabled(t: torch.Tensor) -> bool:
    """The fused-kernel switch: ``AM_FLASH_ATTN=1`` (read at call time) and
    tensors on a CUDA device, as the JAX package's is its variable and its
    device."""
    return os.environ.get("AM_FLASH_ATTN", "0") == "1" and t.is_cuda


class TorchMultiHeadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters (``in_proj_weight`` packs
    q, k, v; ``out_proj``), computed as the fused flax module does: one
    projection for a self-attention (``query``, ``key`` and ``value`` one
    tensor), q plus one k/v projection for a cross-attention (``key`` and
    ``value`` one tensor, the memory). Another ``value`` than ``key`` is
    refused."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model, self.num_heads, self.dtype = d_model, num_heads, dtype
        self.dropout = Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, pad_mask=None):
        if value is not key:
            raise ValueError("TorchMultiHeadAttention: key and value must be one tensor")
        dt, D = self.dtype, self.d_model
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)
        use_flash = (
            _flash_enabled(query)
            and (not self.training or self.dropout.p == 0.0)
            and (D // self.num_heads) % 8 == 0
            and D // self.num_heads <= MAX_HEAD_DIM
        )
        if key is query:
            qkv = F.linear(query.to(dt), w, b)
            if use_flash:
                return self.out_proj(attention_qkv_cuda(qkv, self.num_heads, pad_mask))
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            q = F.linear(query.to(dt), w[:D], b[:D])
            kv = F.linear(key.to(dt), w[D:], b[D:])
            if use_flash:
                return self.out_proj(attention_q_kv_cuda(q, kv, self.num_heads, pad_mask))
            k, v = kv.chunk(2, dim=-1)
        return self.out_proj(_attention(q, k, v, self.num_heads, pad_mask, self.dropout))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with torch's parameter names: self-attn, add,
    norm1, linear1, activation, linear2, add, norm2; dropout on both
    residual branches and after the activation. ``activation``: ``gelu``
    (flax's tanh form, the CMDM's) or ``relu`` (the joints-to-SMPL-X
    regressor's)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 activation: str = "gelu"):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.dtype = dtype
        self.activation = activation
        self.self_attn = TorchMultiHeadAttention(d_model, num_heads, dtype, dropout)
        self.dropout = Dropout(dropout)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor, pad_mask=None) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.norm1(x + self.dropout(self.self_attn(x, x, x, pad_mask)))
        h = self.linear1(x)
        h = F.relu(h) if self.activation == "relu" else F.gelu(h, approximate="tanh")
        h = self.linear2(self.dropout(h))
        return self.norm2(x + self.dropout(h))


class TransformerEncoder(nn.Module):
    """Stack of post-LN encoder layers (``layers.{i}``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, activation: str = "gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward, dtype, dropout,
                                    activation)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, pad_mask=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, pad_mask)
        return x


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer with torch's parameter names: self-attn, add,
    norm1; cross-attn (``multihead_attn``: q from the tokens, k and v from
    the memory), add, norm2; linear1, GELU, linear2, add, norm3; dropout on
    the three residual branches and after the activation."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.self_attn = TorchMultiHeadAttention(d_model, num_heads, dtype, dropout)
        self.multihead_attn = TorchMultiHeadAttention(d_model, num_heads, dtype, dropout)
        self.dropout = Dropout(dropout)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.norm3 = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, tgt_pad_mask=None,
                mem_pad_mask=None) -> torch.Tensor:
        x = x.to(self.dtype)
        memory = memory.to(self.dtype)
        x = self.norm1(x + self.dropout(self.self_attn(x, x, x, tgt_pad_mask)))
        x = self.norm2(x + self.dropout(self.multihead_attn(x, memory, memory, mem_pad_mask)))
        h = self.linear2(self.dropout(F.gelu(self.linear1(x), approximate="tanh")))
        return self.norm3(x + self.dropout(h))

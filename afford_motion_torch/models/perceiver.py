"""Perceiver-IO attention stack of the CDM's published backbone (counterpart
of ``afford_motion_tpu/models/perceiver.py``): pre-LN cross and self
attention with residual MLPs.

Module names are the reference's (krasserm's perceiver-io, vendored in the
reference's ``models/modules.py``): a layer is ``Sequential(Residual(attention),
Residual(MLP))``, so a reference state_dict loads with ``strict=True``:
``{layer}.0.module.{q_norm,kv_norm,attention.{q,k,v,o}_proj}`` (cross),
``{layer}.0.module.{norm,attention...}`` (self) and ``{layer}.1.module.{0,1,3}``
(the MLP's LayerNorm and two Linears).

In the CDM the encoder cross-attends 2 query tokens (text, time) over the
point tokens and the decoder every point over those 2 latents, so no
attention matrix is larger than (points x 2): attention is the einsum
:func:`~.layers._attention` (float32 logits and softmax, dropout on the
weights), never the fused kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout, LayerNorm, Linear, _attention


class MultiHeadAttention(nn.Module):
    """q from ``x_q``, k and v from ``x_kv`` (their widths may differ), the
    masked attention, then the output projection (Perceiver-IO appendix E),
    every projection ``num_q_input_channels`` wide."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = num_q_input_channels
        if ch % num_heads:
            raise ValueError(f"{ch} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.q_proj = Linear(ch, ch, dtype=dtype)
        self.k_proj = Linear(num_kv_input_channels, ch, dtype=dtype)
        self.v_proj = Linear(num_kv_input_channels, ch, dtype=dtype)
        self.o_proj = Linear(ch, ch, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x_q, x_kv, pad_mask=None):
        o = _attention(self.q_proj(x_q), self.k_proj(x_kv), self.v_proj(x_kv),
                       self.num_heads, pad_mask, self.dropout)
        return self.o_proj(o)


class CrossAttention(nn.Module):
    """LayerNorm of the queries and of the keys/values, then attention."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q_norm = LayerNorm(num_q_input_channels, dtype)
        self.kv_norm = LayerNorm(num_kv_input_channels, dtype)
        self.attention = MultiHeadAttention(num_heads, num_q_input_channels,
                                            num_kv_input_channels, dropout=dropout, dtype=dtype)

    def forward(self, x_q, x_kv, pad_mask=None):
        return self.attention(self.q_norm(x_q), self.kv_norm(x_kv), pad_mask)


class SelfAttention(nn.Module):
    """One LayerNorm, then attention of the sequence over itself."""

    def __init__(self, num_heads: int, num_channels: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(num_channels, dtype)
        self.attention = MultiHeadAttention(num_heads, num_channels, num_channels,
                                            dropout=dropout, dtype=dtype)

    def forward(self, x, pad_mask=None):
        h = self.norm(x)
        return self.attention(h, h, pad_mask)


class GELU(nn.Module):
    """flax's ``nn.gelu``: the tanh form."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")


def mlp(num_channels: int, widening_factor: int = 1,
        dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Pre-LN MLP: LayerNorm, Linear(w c), GELU, Linear(c)."""
    return nn.Sequential(LayerNorm(num_channels, dtype),
                         Linear(num_channels, widening_factor * num_channels, dtype=dtype),
                         GELU(),
                         Linear(widening_factor * num_channels, num_channels, dtype=dtype))


class Residual(nn.Module):
    """``x + dropout(module(x, ...))``."""

    def __init__(self, module: nn.Module, dropout: float = 0.0):
        super().__init__()
        self.module = module
        self.dropout = Dropout(dropout)

    def forward(self, x, *args):
        return x + self.dropout(self.module(x, *args))


class CrossAttentionLayer(nn.Sequential):
    """Residual cross-attention, then a residual MLP, in ``dtype``."""

    def __init__(self, num_heads: int, num_q_input_channels: int, num_kv_input_channels: int,
                 widening_factor: int = 1, dropout: float = 0.0, residual_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            Residual(CrossAttention(num_heads, num_q_input_channels, num_kv_input_channels,
                                    dropout, dtype), residual_dropout),
            Residual(mlp(num_q_input_channels, widening_factor, dtype), residual_dropout))
        self.dtype = dtype

    def forward(self, x_q, x_kv, pad_mask=None):
        x = self[0](x_q.to(self.dtype), x_kv, pad_mask)
        return self[1](x)


class SelfAttentionLayer(nn.Sequential):
    """Residual self-attention, then a residual MLP, in ``dtype``."""

    def __init__(self, num_heads: int, num_channels: int, widening_factor: int = 1,
                 dropout: float = 0.0, residual_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            Residual(SelfAttention(num_heads, num_channels, dropout, dtype), residual_dropout),
            Residual(mlp(num_channels, widening_factor, dtype), residual_dropout))
        self.dtype = dtype

    def forward(self, x, pad_mask=None):
        x = self[0](x.to(self.dtype), pad_mask)
        return self[1](x)


class SelfAttentionBlock(nn.Sequential):
    """``num_layers`` self-attention layers (``{i}``)."""

    def __init__(self, num_layers: int, num_heads: int, num_channels: int,
                 widening_factor: int = 1, dropout: float = 0.0, residual_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(*(SelfAttentionLayer(num_heads, num_channels, widening_factor, dropout,
                                              residual_dropout, dtype)
                           for _ in range(num_layers)))

    def forward(self, x, pad_mask=None):
        for layer in self:
            x = layer(x, pad_mask)
        return x

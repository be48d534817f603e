"""The two denoisers, plainly, in float32: the CMDM ``trans_enc`` (the
SceneMap point-transformer encoder over the contact cloud, one transformer
encoder over the time, text, contact and motion tokens) and the CDM with
its Perceiver-IO backbone. Parameter names are the program's, so that one
set of weights loads into both. Dropout draws its masks, in the forward's
order, from the step's generator (``drop``), the rule the program's masks
follow; ``mm`` is the matrix product, which the control rounds."""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_table(max_len: int, dim: int) -> torch.Tensor:
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return torch.from_numpy(pe.astype(np.float32))


class Ctx:
    """What a forward reads besides its inputs: the dropout generator and
    probability, and the matrix product."""

    def __init__(self, generator, p: float, mm: Callable):
        self.generator, self.p, self.mm = generator, p, mm

    def drop(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=self.generator) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def linear(ctx: Ctx, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = ctx.mm(x, m.weight.t())
    return y if m.bias is None else y + m.bias


def layer_norm(m: nn.LayerNorm, x):
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, 1e-6)


def attention(ctx: Ctx, q, k, v, heads: int, pad_mask, p: float):
    """Masked attention over (B, L, H C) projections; a masked logit is
    float32's lowest, the weights' dropout from the step's generator."""
    B, Lq, D = q.shape
    hd = D // heads
    q = q.reshape(B, Lq, heads, hd).transpose(1, 2)
    k = k.reshape(B, k.shape[1], heads, -1).transpose(1, 2)
    v = v.reshape(B, v.shape[1], heads, -1).transpose(1, 2)
    logits = ctx.mm(q * hd ** -0.5, k.transpose(-1, -2))
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, None, None, :], torch.finfo(torch.float32).min)
    w = ctx.drop(torch.softmax(logits, dim=-1), p)
    return ctx.mm(w, v).transpose(1, 2).reshape(B, Lq, -1)


class BatchNorm(nn.BatchNorm1d):
    """Batch statistics over every axis but the last: the mean, and the
    variance max(E[x^2] - E[x]^2, 0), epsilon 1e-5."""

    def forward(self, x):
        xf = x.reshape(-1, x.shape[-1])
        mean = xf.mean(dim=0)
        var = ((xf * xf).mean(dim=0) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.reshape(x.shape)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx.long()]


# ------------------------------------------------------------ CMDM trans_enc
class PointLayer(nn.Module):
    def __init__(self, c: int, share: int = 8):
        super().__init__()
        mid = c // share
        self.c, self.share = c, share
        self.linear_q, self.linear_k, self.linear_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.linear_p = nn.Sequential(nn.Linear(3, 3), BatchNorm(3), nn.ReLU(), nn.Linear(3, c))
        self.linear_w = nn.Sequential(BatchNorm(c), nn.ReLU(), nn.Linear(c, mid), BatchNorm(mid),
                                      nn.ReLU(), nn.Linear(mid, mid))

    def forward(self, ctx, p, x, knn):
        B, N, K = knn.shape
        C, s = self.c, self.share
        x_q = linear(ctx, self.linear_q, x)
        packed = gather(torch.cat([p, linear(ctx, self.linear_k, x),
                                   linear(ctx, self.linear_v, x)], dim=-1), knn)
        rel = packed[..., :3] - p[:, :, None, :]
        x_k, x_v = packed[..., 3:3 + C], packed[..., 3 + C:]
        lp = self.linear_p
        p_r = linear(ctx, lp[3], F.relu(lp[1](linear(ctx, lp[0], rel))))
        lw = self.linear_w
        w = linear(ctx, lw[2], F.relu(lw[0](x_k - x_q[:, :, None, :] + p_r)))
        w = torch.softmax(linear(ctx, lw[5], F.relu(lw[3](w))), dim=2)
        agg = (x_v + p_r).reshape(B, N, K, s, C // s) * w[:, :, :, None, :]
        return agg.sum(dim=2).reshape(B, N, C)


class PointBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear1, self.bn1 = nn.Linear(c, c, bias=False), BatchNorm(c)
        self.transformer2, self.bn2 = PointLayer(c), BatchNorm(c)
        self.linear3, self.bn3 = nn.Linear(c, c, bias=False), BatchNorm(c)

    def forward(self, ctx, p, x, knn):
        h = F.relu(self.bn1(linear(ctx, self.linear1, x)))
        h = F.relu(self.bn2(self.transformer2(ctx, p, h, knn)))
        return F.relu(self.bn3(linear(ctx, self.linear3, h)) + x)


class Down(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.stride = stride
        self.linear = nn.Linear(c_in if stride == 1 else 3 + c_in, c_out, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, ctx, parent_xyz, x, level):
        if self.stride == 1:
            return F.relu(self.bn(linear(ctx, self.linear, x)))
        packed = gather(torch.cat([parent_xyz, x], dim=-1), level["down"])
        rel = packed[..., :3] - level["xyz"][:, :, None, :]
        h = linear(ctx, self.linear, torch.cat([rel, packed[..., 3:]], dim=-1))
        return F.relu(self.bn(h)).amax(dim=2)


class SceneMapEncoder(nn.Module):
    def __init__(self, c_in: int, planes, blocks, strides=(1, 4, 4, 4)):
        super().__init__()
        self.n = len(planes)
        for i, (c, nb, st) in enumerate(zip(planes, blocks, strides), start=1):
            setattr(self, f"enc{i}", nn.ModuleList([Down(c_in, c, st)]
                                                   + [PointBlock(c) for _ in range(1, nb)]))
            c_in = c

    def forward(self, ctx, levels: List[Dict], feats):
        x = torch.cat([levels[0]["xyz"], feats], dim=-1)
        parent = levels[0]["xyz"]
        for i in range(self.n):
            stage = getattr(self, f"enc{i + 1}")
            x = stage[0](ctx, parent, x, levels[i])
            for block in stage[1:]:
                x = block(ctx, levels[i]["xyz"], x, levels[i]["knn"])
            parent = levels[i]["xyz"]
        return x


class TimestepEmbedder(nn.Module):
    def __init__(self, d_model: int, dim: int):
        super().__init__()
        self.register_buffer("pe", sinusoidal_table(1000, dim), persistent=False)
        self.time_embed = nn.Sequential(nn.Linear(dim, d_model), nn.SiLU(),
                                        nn.Linear(d_model, d_model))

    def forward(self, ctx, t):
        h = self.pe[t.long()][:, None, :]
        return linear(ctx, self.time_embed[2], F.silu(linear(ctx, self.time_embed[0], h)))


class SelfAttention(nn.Module):
    """torch's packed ``in_proj``, computed as one projection."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, ctx, x, pad_mask, p):
        qkv = ctx.mm(x, self.in_proj_weight.t()) + self.in_proj_bias
        q, k, v = qkv.chunk(3, dim=-1)
        return linear(ctx, self.out_proj, attention(ctx, q, k, v, self.heads, pad_mask, p))


class EncoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, ff: int):
        super().__init__()
        self.self_attn = SelfAttention(d, heads)
        self.linear1, self.linear2 = nn.Linear(d, ff), nn.Linear(ff, d)
        self.norm1, self.norm2 = nn.LayerNorm(d), nn.LayerNorm(d)

    def forward(self, ctx, x, pad_mask):
        p = ctx.p
        x = layer_norm(self.norm1, x + ctx.drop(self.self_attn(ctx, x, pad_mask, p), p))
        h = F.gelu(linear(ctx, self.linear1, x), approximate="tanh")
        h = linear(ctx, self.linear2, ctx.drop(h, p))
        return layer_norm(self.norm2, x + ctx.drop(h, p))


class Encoder(nn.Module):
    def __init__(self, n: int, d: int, heads: int, ff: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d, heads, ff) for _ in range(n))

    def forward(self, ctx, x, pad_mask):
        for layer in self.layers:
            x = layer(ctx, x, pad_mask)
        return x


class CMDM(nn.Module):
    """``trans_enc``: [time, text, contact groups, motion] through one
    encoder; the motion tokens to the motion's features."""

    def __init__(self, m: Dict, motion_dim: int, contact_dim: int, text_dim: int = 512):
        super().__init__()
        d = int(m["latent_dim"])
        cm = m["contact_model"]
        planes, blocks = list(cm["planes"]), list(cm["blocks"])
        self.timestep_embedder = TimestepEmbedder(d, int(m["time_emb_dim"]))
        self.contact_encoder = SceneMapEncoder(3 + contact_dim, planes, blocks)
        self.contact_adapter = nn.Linear(planes[-1], d)
        self.self_attn_layer = Encoder(sum(m["num_layers"]), d, int(m["num_heads"]),
                                       int(m["dim_feedforward"]))
        self.language_adapter = nn.Linear(text_dim, d)
        self.motion_adapter = nn.Linear(motion_dim, d)
        self.motion_layer = nn.Linear(d, motion_dim)
        self.register_buffer("pe", sinusoidal_table(5000, d), persistent=False)

    def forward(self, ctx, x, t, cond):
        B = x.shape[0]
        dev = x.device
        time_emb = self.timestep_embedder(ctx, t)
        text = cond["text_emb"] * (1.0 - cond["c_text_erase"][..., None].float())
        text = linear(ctx, self.language_adapter, text)
        h = linear(ctx, self.motion_adapter, x)
        c = self.contact_encoder(ctx, cond["levels"], cond["c_pc_contact"])
        c = c * (1.0 - cond["c_pc_erase"][..., None].float())
        c = linear(ctx, self.contact_adapter, c)
        tokens = torch.cat([time_emb, text, c, h], dim=1)
        tokens = ctx.drop(tokens + self.pe[: tokens.shape[1]][None], ctx.p)
        zeros = torch.zeros((B, 1 + text.shape[1] + c.shape[1]), dtype=torch.bool, device=dev)
        tokens = self.self_attn_layer(ctx, tokens, torch.cat([zeros, cond["x_mask"]], dim=1))
        return linear(ctx, self.motion_layer, tokens[:, 1 + text.shape[1] + c.shape[1]:])


# --------------------------------------------------------- CDM Perceiver-IO
class MHA(nn.Module):
    def __init__(self, heads: int, q_ch: int, kv_ch: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(q_ch, q_ch), nn.Linear(kv_ch, q_ch)
        self.v_proj, self.o_proj = nn.Linear(kv_ch, q_ch), nn.Linear(q_ch, q_ch)

    def forward(self, ctx, x_q, x_kv, p):
        o = attention(ctx, linear(ctx, self.q_proj, x_q), linear(ctx, self.k_proj, x_kv),
                      linear(ctx, self.v_proj, x_kv), self.heads, None, p)
        return linear(ctx, self.o_proj, o)


class CrossAttn(nn.Module):
    def __init__(self, heads, q_ch, kv_ch):
        super().__init__()
        self.q_norm, self.kv_norm = nn.LayerNorm(q_ch), nn.LayerNorm(kv_ch)
        self.attention = MHA(heads, q_ch, kv_ch)

    def forward(self, ctx, x_q, x_kv, p):
        return self.attention(ctx, layer_norm(self.q_norm, x_q), layer_norm(self.kv_norm, x_kv), p)


class SelfAttn(nn.Module):
    def __init__(self, heads, ch):
        super().__init__()
        self.norm = nn.LayerNorm(ch)
        self.attention = MHA(heads, ch, ch)

    def forward(self, ctx, x, _unused, p):
        h = layer_norm(self.norm, x)
        return self.attention(ctx, h, h, p)


class Residual(nn.Module):
    def __init__(self, module):
        super().__init__()
        self.module = module


def mlp(ch: int, widening: int) -> nn.Sequential:
    return nn.Sequential(nn.LayerNorm(ch), nn.Linear(ch, widening * ch), nn.GELU(),
                         nn.Linear(widening * ch, ch))


class AttnLayer(nn.Sequential):
    """Residual attention (residual dropout 0), then a residual MLP."""

    def __init__(self, attn: nn.Module, ch: int, widening: int):
        super().__init__(Residual(attn), Residual(mlp(ch, widening)))

    def forward(self, ctx, x, x_kv, p):
        x = x + self[0].module(ctx, x, x_kv, p)
        m = self[1].module
        return x + linear(ctx, m[3], F.gelu(linear(ctx, m[1], layer_norm(m[0], x)),
                                            approximate="tanh"))


class CDM(nn.Module):
    def __init__(self, m: Dict, contact_dim: int, text_dim: int = 512):
        super().__init__()
        a = m["arch_perceiver"]
        q, kv = int(a["encoder_q_input_channels"]), int(a["encoder_kv_input_channels"])
        dq = int(a["decoder_q_input_channels"])
        te = int(m["time_emb_dim"])
        self.p_enc, self.p_dec = float(a["encoder_dropout"]), float(a["decoder_dropout"])
        if float(a["encoder_residual_dropout"]) or float(a["decoder_residual_dropout"]):
            raise NotImplementedError("residual dropout")
        self.timestep_embedder = TimestepEmbedder(te, te)
        cm = nn.Module()
        cm.encoder_adapter = nn.Linear(contact_dim + 3 * bool(a["point_pos_emb"]), kv)
        cm.language_adapter = nn.Linear(text_dim, q)
        cm.time_embedding_adapter = nn.Linear(te, q)
        w = int(a["encoder_widening_factor"])
        cm.encoder_cross_attn = AttnLayer(CrossAttn(int(a["encoder_num_heads"]), q, kv), q, w)
        cm.encoder_self_attn = nn.Sequential(*(
            AttnLayer(SelfAttn(int(a["encoder_num_heads"]), q), q, w)
            for _ in range(int(a["encoder_self_attn_num_layers"]))))
        cm.decoder_adapter = nn.Linear(kv, dq)
        cm.decoder_cross_attn = AttnLayer(CrossAttn(int(a["decoder_num_heads"]), dq, q), dq,
                                          int(a["decoder_widening_factor"]))
        self.contact_model = cm
        self.contact_layer = nn.Linear(dq, contact_dim)
        self.pos = bool(a["point_pos_emb"])

    def forward(self, ctx, x, t, cond):
        cm = self.contact_model
        time_emb = self.timestep_embedder(ctx, t)
        if self.pos:
            x = torch.cat([x, cond["c_pc_xyz"]], dim=-1)
        kv = linear(ctx, cm.encoder_adapter, x)
        q = torch.cat([linear(ctx, cm.language_adapter, cond["text_emb"]),
                       linear(ctx, cm.time_embedding_adapter, time_emb)], dim=1)
        q = cm.encoder_cross_attn(ctx, q, kv, self.p_enc)
        for layer in cm.encoder_self_attn:
            q = layer(ctx, q, None, self.p_enc)
        h = cm.decoder_cross_attn(ctx, linear(ctx, cm.decoder_adapter, kv), q, self.p_dec)
        return linear(ctx, self.contact_layer, h)

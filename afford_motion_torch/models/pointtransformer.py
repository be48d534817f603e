"""PointTransformer encoder and U-Net decoder in dense (B, N, C) layout on a
precomputed hierarchy (counterpart of
``afford_motion_tpu/models/pointtransformer.py``).

Parameter names are the reference torch names (``enc{i}.{j}.linear``,
``transformer2.linear_p.1``, ...), the layout ``export_cmdm_checkpoint``
writes. Every neighbourhood gather goes through :func:`bgather`, i.e. the
row-gather kernel or, on a banded hierarchy, the windowed gather kernel (and,
backward, their scatter-add kernels) for CUDA tensors.
Train or eval is the module's mode (``.train()`` / ``.eval()``), which
stands for the JAX package's ``train=`` argument.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import banded as banded_ops
from ..ops.cuda.gather import gather_rows
from ..ops.hierarchy import LevelGeometry
from ..utils.convert import load_torch_state_dict
from .layers import Linear

SCENEMAP_STRIDES = (1, 4, 4, 4)
SCENEMAP_NSAMPLES = (8, 16, 16, 16)


def bgather(x: torch.Tensor, idx: torch.Tensor, banded: bool = False,
            starts: Optional[torch.Tensor] = None, window: int = 0) -> torch.Tensor:
    """Batched neighbourhood gather: x (B, N, C), idx (B, M, K) -> (B, M, K, C).

    With ``banded=True`` (indices produced by the windowed kNN on
    curve-ordered clouds: callers pass ``geom.banded``) and a shape the
    banded gather supports, the windowed gather kernel; else the row-gather
    kernel. ``starts`` (B, G) are the per-cloud window starts the indices
    were produced with (``LevelGeometry.down_starts`` / ``up_starts``; None =
    proportional policy), ``window`` the W0 width knob they were built with
    (``LevelGeometry.window``; 0 = env/default)."""
    x, idx = x.contiguous(), idx.to(torch.int32).contiguous()
    if banded and banded_ops.gather_supports(idx.shape[1], x.shape[1], x.shape[2], idx.shape[2],
                                             x.element_size(), window):
        return banded_ops.gather_banded(x, idx, starts, window)
    return gather_rows(x, idx)


class PointNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of any (..., C) tensor, in float32 with
    epsilon 1e-5, the result cast to ``dtype``: flax
    ``BatchNorm(momentum=0.9, dtype=float32)``. In train mode the statistics
    run over all other axes, the variance is flax's ``max(E[x^2] - E[x]^2,
    0)`` and it is the biased one both for normalising and for the running
    update ``ra = 0.9 * ra + 0.1 * batch`` (torch's own BatchNorm would store
    the unbiased variance)."""

    FLAX_MOMENTUM = 0.9

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float().reshape(-1, x.shape[-1])
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.reshape(x.shape).to(self.compute_dtype)
        mean = xf.mean(dim=0)
        var = ((xf * xf).mean(dim=0) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            keep = self.FLAX_MOMENTUM
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
            self.num_batches_tracked += 1
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.reshape(x.shape).to(self.compute_dtype)


class PointTransformerLayer(nn.Module):
    """Vector self-attention over kNN neighbourhoods; xyz, k and v share one
    packed gather."""

    def __init__(self, planes: int, share_planes: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.planes, self.share_planes, self.dtype = planes, share_planes, dtype
        mid = planes // share_planes
        self.linear_q = Linear(planes, planes, dtype=dtype)
        self.linear_k = Linear(planes, planes, dtype=dtype)
        self.linear_v = Linear(planes, planes, dtype=dtype)
        self.linear_p = nn.Sequential(
            Linear(3, 3, dtype=dtype), PointNorm(3, dtype), nn.ReLU(),
            Linear(3, planes, dtype=dtype),
        )
        self.linear_w = nn.Sequential(
            PointNorm(planes, dtype), nn.ReLU(), Linear(planes, mid, dtype=dtype),
            PointNorm(mid, dtype), nn.ReLU(), Linear(mid, mid, dtype=dtype),
        )

    def forward(self, p: torch.Tensor, x: torch.Tensor, knn_idx: torch.Tensor,
                banded: bool = False, window: int = 0) -> torch.Tensor:
        """``banded``/``window``: ``knn_idx`` came from the banded windowed
        kNN with this W0 (the level's ``LevelGeometry`` fields)."""
        C, s = self.planes, self.share_planes
        B, N, K = knn_idx.shape
        p = p.to(self.dtype)
        x = x.to(self.dtype)
        x_q = self.linear_q(x)
        packed = bgather(torch.cat([p, self.linear_k(x), self.linear_v(x)], dim=-1),
                         knn_idx, banded, window=window)           # (B, N, K, 3+2C)
        rel = packed[..., :3] - p[:, :, None, :]
        x_k, x_v = packed[..., 3:3 + C], packed[..., 3 + C:]
        p_r = self.linear_p(rel)
        w = self.linear_w(x_k - x_q[:, :, None, :] + p_r)
        w = torch.softmax(w.float(), dim=2).to(self.dtype)
        agg = (x_v + p_r).reshape(B, N, K, s, C // s) * w[:, :, :, None, :]
        return agg.sum(dim=2).reshape(B, N, C)


class TransitionDown(nn.Module):
    """Stride 1: linear + BN + ReLU. Otherwise the kNN group of every FPS
    point in the parent level, linear + BN + ReLU, max over the group."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        in_ch = in_planes if stride == 1 else 3 + in_planes
        self.linear = Linear(in_ch, out_planes, bias=False, dtype=dtype)
        self.bn = PointNorm(out_planes, dtype)

    def forward(self, parent_xyz: torch.Tensor, x: torch.Tensor,
                geom: LevelGeometry) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stride == 1:
            return F.relu(self.bn(self.linear(x)))
        new_xyz = geom.xyz.to(self.dtype)
        packed = bgather(torch.cat([parent_xyz.to(self.dtype), x], dim=-1),
                         geom.down_knn_idx, geom.banded, geom.down_starts, geom.window)
        rel = packed[..., :3] - new_xyz[:, :, None, :]
        h = self.linear(torch.cat([rel, packed[..., 3:]], dim=-1))
        return F.relu(self.bn(h)).amax(dim=2)


class TransitionUp(nn.Module):
    """Head form (``out_planes`` None): ``linear2`` (Linear + ReLU) of the
    mean over the points, joined to every point's features, then ``linear1``
    (Linear(2C -> C) + BN + ReLU). Fusion form: ``linear1`` (Linear + BN +
    ReLU) of the fine level plus the 3-NN interpolation of ``linear2``
    (Linear + BN + ReLU) of the coarse level: the coarse rows gathered
    through the coarse level's ``up_idx`` (the row-gather kernel or, on a
    banded hierarchy, the windowed one with its ``up_starts``) and weighted
    by its ``up_weight``."""

    def __init__(self, in_planes: int, out_planes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.is_head = out_planes is None
        if self.is_head:
            self.linear1 = nn.Sequential(Linear(2 * in_planes, in_planes, dtype=dtype),
                                         PointNorm(in_planes, dtype), nn.ReLU())
            self.linear2 = nn.Sequential(Linear(in_planes, in_planes, dtype=dtype), nn.ReLU())
        else:
            self.linear1 = nn.Sequential(Linear(out_planes, out_planes, dtype=dtype),
                                         PointNorm(out_planes, dtype), nn.ReLU())
            self.linear2 = nn.Sequential(Linear(in_planes, out_planes, dtype=dtype),
                                         PointNorm(out_planes, dtype), nn.ReLU())

    def forward(self, x: torch.Tensor, coarse_x: Optional[torch.Tensor] = None,
                coarse_geom: Optional[LevelGeometry] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.is_head:
            g = self.linear2(x.mean(dim=1, keepdim=True))
            return self.linear1(torch.cat([x, g.expand_as(x)], dim=-1))
        b = self.linear2(coarse_x.to(self.dtype))
        gathered = bgather(b, coarse_geom.up_idx, coarse_geom.banded, coarse_geom.up_starts,
                           coarse_geom.window)                      # (B, N_fine, 3, C)
        b_up = torch.einsum("bnkc,bnk->bnc", gathered, coarse_geom.up_weight.to(self.dtype))
        return self.linear1(x) + b_up


class PointTransformerBlock(nn.Module):
    """Residual bottleneck around the vector-attention layer."""

    def __init__(self, planes: int, share_planes: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear1 = Linear(planes, planes, bias=False, dtype=dtype)
        self.bn1 = PointNorm(planes, dtype)
        self.transformer2 = PointTransformerLayer(planes, share_planes, dtype)
        self.bn2 = PointNorm(planes, dtype)
        self.linear3 = Linear(planes, planes, bias=False, dtype=dtype)
        self.bn3 = PointNorm(planes, dtype)

    def forward(self, p: torch.Tensor, x: torch.Tensor, knn_idx: torch.Tensor,
                banded: bool = False, window: int = 0) -> torch.Tensor:
        x = x.to(self.dtype)
        h = F.relu(self.bn1(self.linear1(x)))
        h = F.relu(self.bn2(self.transformer2(p, h, knn_idx, banded, window)))
        h = self.bn3(self.linear3(h))
        return F.relu(h + x)


class PointTransformerEncoder(nn.Module):
    """Stages ``enc1..encL``, each a TransitionDown followed by
    ``blocks[i] - 1`` PointTransformerBlocks; returns every stage's output."""

    def __init__(self, in_planes: int, planes: Sequence[int], blocks: Sequence[int],
                 strides: Sequence[int], share_planes: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stages = len(planes)
        for i, (plane, nblocks, stride) in enumerate(zip(planes, blocks, strides), start=1):
            stage = nn.ModuleList([TransitionDown(in_planes, plane, stride, dtype)])
            stage.extend(PointTransformerBlock(plane, share_planes, dtype)
                         for _ in range(1, nblocks))
            setattr(self, f"enc{i}", stage)
            in_planes = plane

    def encode(self, levels: List[LevelGeometry], feats: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        x = feats
        parent_xyz = levels[0].xyz
        for i in range(self.num_stages):
            geom = levels[i]
            stage = getattr(self, f"enc{i + 1}")
            x = stage[0](parent_xyz, x, geom)
            for block in stage[1:]:
                x = block(geom.xyz, x, geom.knn_idx, geom.banded, geom.window)
            outs.append(x)
            parent_xyz = geom.xyz
        return outs


def decoder_stages(planes: Sequence[int], share_planes: int = 8,
                   dtype: torch.dtype = torch.float32) -> Dict[str, nn.ModuleList]:
    """The U-Net decoder's stages over an encoder of ``planes``: ``dec{L}``
    (the head, at the coarsest level) down to ``dec1``, each a TransitionUp
    and one PointTransformerBlock; a module adds them under these names."""
    L = len(planes)
    return {f"dec{i}": nn.ModuleList([
        TransitionUp(planes[i - 1], None, dtype) if i == L
        else TransitionUp(planes[i], planes[i - 1], dtype),
        PointTransformerBlock(planes[i - 1], share_planes, dtype)]) for i in range(L, 0, -1)}


def decode(module: nn.Module, levels: List[LevelGeometry], enc_feats: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Run ``module``'s :func:`decoder_stages` over the encoder's per-level
    outputs; every stage's output, coarsest first."""
    outs: List[torch.Tensor] = []
    for i in range(len(enc_feats) - 1, -1, -1):
        up, block = getattr(module, f"dec{i + 1}")
        geom = levels[i]
        x = up(enc_feats[i]) if not outs else up(enc_feats[i], outs[-1], levels[i + 1])
        outs.append(block(geom.xyz, x, geom.knn_idx, geom.banded, geom.window))
    return outs


# the frozen scene feature extractor's 5-level geometry, planes and blocks
SEG_STRIDES = (1, 4, 4, 4, 4)
SEG_NSAMPLES = (8, 16, 16, 16, 16)
SEG_PLANES = (32, 64, 128, 256, 512)
SEG_BLOCKS = (2, 3, 4, 6, 3)


class PointTransformerEnc(PointTransformerEncoder):
    """The 5-level encoder over (xyz, and the ``c - 3`` point features when
    ``c > 3``); returns the coarsest level's points and features."""

    def __init__(self, c: int = 6, planes: Sequence[int] = SEG_PLANES,
                 blocks: Sequence[int] = SEG_BLOCKS, dtype: torch.dtype = torch.float32):
        super().__init__(c, planes, blocks, SEG_STRIDES[:len(planes)], dtype=dtype)
        self.c = c

    def encode_input(self, levels: List[LevelGeometry], feats: torch.Tensor
                     ) -> List[torch.Tensor]:
        xyz = levels[0].xyz
        x0 = xyz if self.c == 3 else torch.cat([xyz, feats.to(xyz.dtype)], dim=-1)
        return self.encode(levels, x0)

    def forward(self, levels: List[LevelGeometry], feats: torch.Tensor):
        return levels[-1].xyz, self.encode_input(levels, feats)[-1]


class PointTransformerSeg(PointTransformerEnc):
    """The 5-level U-Net of the frozen scene feature extractor: ``enc1..enc5``
    and ``dec5..dec1``, per-point ``planes[0]`` features on the finest
    level."""

    def __init__(self, c: int = 6, planes: Sequence[int] = SEG_PLANES,
                 blocks: Sequence[int] = SEG_BLOCKS, dtype: torch.dtype = torch.float32):
        super().__init__(c, planes, blocks, dtype)
        for name, stage in decoder_stages(planes, dtype=dtype).items():
            self.add_module(name, stage)

    def forward(self, levels: List[LevelGeometry], feats: torch.Tensor) -> torch.Tensor:
        return decode(self, levels, self.encode_input(levels, feats))[-1]


SCENE_MODELS = {"PointTransformerSeg": PointTransformerSeg,
                "PointTransformerEnc": PointTransformerEnc}


def load_pretrained_scene(model: nn.Module, path: str) -> None:
    """Load a pretrained scene-model file (a torch state_dict, DDP's
    ``module.`` prefix stripped) into ``model`` with ``strict=True``: the
    file's entries under ``model``'s own stages (the encoder's ``enc*``, a
    U-Net's ``dec*``); the rest, a segmentation head, is left out."""
    stages = {k.split(".", 1)[0] for k in model.state_dict()}
    sd = load_torch_state_dict(path)
    model.load_state_dict({k: v for k, v in sd.items() if k.split(".", 1)[0] in stages},
                          strict=True)


def load_scene_model(name: str, c: int, pretrained_weight: str = "") -> nn.Module:
    """The scene model of ``name`` with ``c`` input channels, with the weights
    of ``pretrained_weight`` where that file exists, else its initial
    ones."""
    if name not in SCENE_MODELS:
        raise NotImplementedError(f"unknown scene model: {name}")
    model = SCENE_MODELS[name](c=c)
    if pretrained_weight and os.path.exists(pretrained_weight):
        load_pretrained_scene(model, pretrained_weight)
    return model

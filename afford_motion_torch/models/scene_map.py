"""Contact-map scene encoder of the CMDM
(counterpart of ``afford_motion_tpu/models/scene_map.py``)."""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.hierarchy import LevelGeometry
from .pointtransformer import SCENEMAP_STRIDES, PointTransformerEncoder


class SceneMapEncoder(PointTransformerEncoder):
    """4-level encoder over (xyz ⊕ contact) -> (B, num_points/64, planes[-1])
    group tokens; the stages are this module's ``enc1..enc4``."""

    def __init__(self, contact_dim: int, planes: Sequence[int] = (32, 64, 128, 256),
                 blocks: Sequence[int] = (2, 2, 2, 2), dtype: torch.dtype = torch.float32):
        super().__init__(3 + contact_dim, planes, blocks, SCENEMAP_STRIDES, dtype=dtype)

    def forward(self, levels: List[LevelGeometry], point_feats: torch.Tensor) -> torch.Tensor:
        x0 = torch.cat([levels[0].xyz, point_feats.to(levels[0].xyz.dtype)], dim=-1)
        return self.encode(levels, x0)[-1]


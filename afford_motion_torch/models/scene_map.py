"""Contact-map scene encoders of the CMDM
(counterpart of ``afford_motion_tpu/models/scene_map.py``)."""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.hierarchy import LevelGeometry
from .pointtransformer import (
    SCENEMAP_STRIDES,
    PointTransformerEncoder,
    decode,
    decoder_stages,
)


class SceneMapEncoder(PointTransformerEncoder):
    """4-level encoder over (xyz ⊕ contact) -> (B, num_points/64, planes[-1])
    group tokens; the stages are this module's ``enc1..enc4``."""

    def __init__(self, contact_dim: int, planes: Sequence[int] = (32, 64, 128, 256),
                 blocks: Sequence[int] = (2, 2, 2, 2), dtype: torch.dtype = torch.float32,
                 norm: str = "batch"):
        super().__init__(3 + contact_dim, planes, blocks, SCENEMAP_STRIDES, dtype=dtype,
                         norm=norm)

    def encode_levels(self, levels: List[LevelGeometry], point_feats: torch.Tensor
                      ) -> List[torch.Tensor]:
        x0 = torch.cat([levels[0].xyz, point_feats.to(levels[0].xyz.dtype)], dim=-1)
        return self.encode(levels, x0)

    def forward(self, levels: List[LevelGeometry], point_feats: torch.Tensor) -> torch.Tensor:
        return self.encode_levels(levels, point_feats)[-1]


class SceneMapEncoderDecoder(SceneMapEncoder):
    """4-level U-Net -> multi-scale features ``[x4, x3, x2, x1]``, coarsest
    first (planes[-1] channels on num_points/64 points down to planes[0] on
    every point); the encoder's stages are ``enc1..enc4``, the decoder's
    ``dec4`` (the head) .. ``dec1``."""

    def __init__(self, contact_dim: int, planes: Sequence[int] = (32, 64, 128, 256),
                 blocks: Sequence[int] = (2, 2, 2, 2), dtype: torch.dtype = torch.float32,
                 norm: str = "batch"):
        super().__init__(contact_dim, planes, blocks, dtype, norm)
        for name, stage in decoder_stages(planes, dtype=dtype, norm=norm).items():
            self.add_module(name, stage)

    def forward(self, levels: List[LevelGeometry], point_feats: torch.Tensor
                ) -> List[torch.Tensor]:
        return decode(self, levels, self.encode_levels(levels, point_feats))

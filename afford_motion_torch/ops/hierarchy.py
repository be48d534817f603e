"""Precomputed multi-resolution point geometry
(counterpart of ``afford_motion_tpu/ops/hierarchy.py``, non-banded).

All of a hierarchy's index fields depend on the coordinates only, so they
are built once per batch (once per sampling chain) and fed to every
PointTransformer layer. FPS keeps the greedy selection order: the CMDM adds
positional encodings to the group tokens, so the order matters; the JAX
package sorts ``fps_idx`` only for banded or cached data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from .pointops import batched_fps, batched_knn, interpolation_weights


@dataclass
class LevelGeometry:
    """One resolution level; every field has a leading batch dim and the
    fields that do not apply to a level are None."""

    xyz: torch.Tensor                     # (B, N_l, 3) f32
    knn_idx: torch.Tensor                 # (B, N_l, k) neighbours within the level
    fps_idx: Optional[torch.Tensor]       # (B, N_l) indices into the parent level
    down_knn_idx: Optional[torch.Tensor]  # (B, N_l, k) neighbours in the parent level
    up_idx: Optional[torch.Tensor]        # (B, N_parent, 3) this-level NNs of parent points
    up_weight: Optional[torch.Tensor]     # (B, N_parent, 3) inverse-distance weights


def _take_points(parent: torch.Tensor, fps_idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(parent, 1, fps_idx.long()[..., None].expand(-1, -1, 3))


def _up(parent: torch.Tensor, xyz: torch.Tensor, knn_method: Optional[str]):
    up_idx, up_dist = batched_knn(parent, xyz, 3, knn_method)
    return up_idx, interpolation_weights(up_dist)


def build_point_hierarchy(
    xyz: torch.Tensor,
    strides: Sequence[int],
    nsamples: Sequence[int],
    *,
    with_up: bool = True,
    knn_method: Optional[str] = None,
) -> List[LevelGeometry]:
    """Hierarchy of a batch of clouds (B, N, 3); ``strides``/``nsamples``
    follow the encoder, e.g. ([1, 4, 4, 4], [8, 16, 16, 16]) for SceneMap.
    ``knn_method='exact'`` bypasses the packed-key kNN."""
    if len(strides) != len(nsamples):
        raise ValueError("strides and nsamples differ in length")
    levels = []
    parent = xyz.float()
    for stride, nsample in zip(strides, nsamples):
        fps_idx = down_knn_idx = up_idx = up_weight = None
        lvl = parent
        if stride != 1:
            fps_idx = batched_fps(parent, parent.shape[1] // stride)
            lvl = _take_points(parent, fps_idx)
            down_knn_idx, _ = batched_knn(lvl, parent, nsample, knn_method)
            if with_up:
                up_idx, up_weight = _up(parent, lvl, knn_method)
        knn_idx, _ = batched_knn(lvl, lvl, nsample, knn_method)
        levels.append(LevelGeometry(lvl, knn_idx, fps_idx, down_knn_idx,
                                    up_idx, up_weight))
        parent = lvl
    return levels


def build_point_hierarchy_from_fps(
    xyz: torch.Tensor,
    arrays: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nsamples: Sequence[int],
    *,
    prefix: str = "geo",
    with_up: bool = True,
    knn_method: Optional[str] = None,
) -> List[LevelGeometry]:
    """Rebuild the hierarchy from cached FPS indices
    (``{prefix}{l}_fps_idx``), computing the kNN fields here. Any cached
    ``knn_idx``/``down_knn_idx``/``up_idx``+``up_weight`` of a level is used
    as it is."""
    def cached(li, field):
        v = arrays.get(f"{prefix}{li}_{field}")
        if v is None:
            return None
        return v.float() if field == "up_weight" else v.to(torch.int32)

    levels = []
    parent = xyz.float()
    for li, (stride, nsample) in enumerate(zip(strides, nsamples)):
        fps_idx = down_knn_idx = up_idx = up_weight = None
        lvl = parent
        if stride != 1:
            fps_idx = arrays[f"{prefix}{li}_fps_idx"].to(torch.int32)
            lvl = _take_points(parent, fps_idx)
            down_knn_idx = cached(li, "down_knn_idx")
            if down_knn_idx is None:
                down_knn_idx, _ = batched_knn(lvl, parent, nsample, knn_method)
            if with_up:
                up_idx, up_weight = cached(li, "up_idx"), cached(li, "up_weight")
                if up_idx is None or up_weight is None:
                    up_idx, up_weight = _up(parent, lvl, knn_method)
        knn_idx = cached(li, "knn_idx")
        if knn_idx is None:
            knn_idx, _ = batched_knn(lvl, lvl, nsample, knn_method)
        levels.append(LevelGeometry(lvl, knn_idx, fps_idx, down_knn_idx,
                                    up_idx, up_weight))
        parent = lvl
    return levels


def geometry_from_arrays(arrays: Dict[str, torch.Tensor], xyz: torch.Tensor,
                         num_levels: int, prefix: str = "geo") -> List[LevelGeometry]:
    """Hierarchy from a full cache of index arrays plus the level-0
    coordinates; each level's xyz is re-gathered through the FPS chain."""
    def get(li, field, dtype):
        v = arrays.get(f"{prefix}{li}_{field}")
        return None if v is None else v.to(dtype)

    levels = []
    parent = xyz.float()
    for li in range(num_levels):
        fps_idx = get(li, "fps_idx", torch.int32)
        lvl = parent if fps_idx is None else _take_points(parent, fps_idx)
        levels.append(LevelGeometry(
            xyz=lvl,
            knn_idx=get(li, "knn_idx", torch.int32),
            fps_idx=fps_idx,
            down_knn_idx=get(li, "down_knn_idx", torch.int32),
            up_idx=get(li, "up_idx", torch.int32),
            up_weight=get(li, "up_weight", torch.float32),
        ))
        parent = lvl
    return levels

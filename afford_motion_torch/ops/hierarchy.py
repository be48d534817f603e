"""Precomputed multi-resolution point geometry
(counterpart of ``afford_motion_tpu/ops/hierarchy.py``).

All of a hierarchy's index fields depend on the coordinates only, so they
are built once per batch (once per sampling chain) and fed to every
PointTransformer layer. By default FPS keeps the greedy selection order: the
CMDM adds positional encodings to the group tokens, so the order matters.
With ``banded`` or ``sort_fps`` each level's ``fps_idx`` is sorted
ascending, a relabeling of the FPS set that keeps a curve-sorted parent's
locality in the child level, which the banded kernels' windows assume.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from .cuda import banded as banded_ops
from .pointops import batched_fps, batched_knn, interpolation_weights


def _knn_auto(query: torch.Tensor, support: torch.Tensor, k: int, banded_on: bool = False,
              method: Optional[str] = None, starts: Optional[torch.Tensor] = None,
              window: int = 0):
    """Windowed (banded) kNN on curve-ordered data when requested and the
    shapes support it, full kNN otherwise. ``starts`` (B, G) overrides the
    per-tile window starts (adaptive centring); ``window`` is the W0 width
    knob (0 = env/default policy)."""
    if banded_on and banded_ops.knn_supports(query.shape[1], support.shape[1], k):
        return banded_ops.knn_banded(query.contiguous(), support.contiguous(), k, starts, window)
    return batched_knn(query, support, k, method)


def _adaptive_starts(fps_idx: Optional[torch.Tensor], m_query: int, n_support: int, k: int,
                     banded_on: bool, kind: str, window: int = 0,
                     adaptive: Optional[bool] = None) -> Optional[torch.Tensor]:
    """Per-cloud window starts for the cross-level banded ops, or None
    whenever the banded kNN would not engage (the gating mirrors
    :func:`_knn_auto`, so a fallback kNN is never paired with windowed
    gathers). A pure function of ``fps_idx``: recomputed identically at
    geometry build, cache load and in-step rebuild."""
    if (
        fps_idx is None
        or not banded_on
        or not banded_ops.resolve_adaptive(adaptive)
        or not banded_ops.knn_supports(m_query, n_support, k)
    ):
        return None
    if kind == "down":
        return banded_ops.adaptive_down_starts(fps_idx, n_support, window)
    return banded_ops.adaptive_up_starts(fps_idx, m_query, window)


@dataclass
class LevelGeometry:
    """One resolution level; every tensor field has a leading batch dim and
    the fields that do not apply to a level are None."""

    xyz: torch.Tensor                     # (B, N_l, 3) f32
    knn_idx: torch.Tensor                 # (B, N_l, k) neighbours within the level
    fps_idx: Optional[torch.Tensor]       # (B, N_l) indices into the parent level
    down_knn_idx: Optional[torch.Tensor]  # (B, N_l, k) neighbours in the parent level
    up_idx: Optional[torch.Tensor]        # (B, N_parent, 3) this-level NNs of parent points
    up_weight: Optional[torch.Tensor]     # (B, N_parent, 3) inverse-distance weights
    # per-cloud adaptive window starts of the banded cross-level ops (None =
    # proportional policy); pure functions of fps_idx, attached wherever the
    # geometry is built so kNN indices and gathers share the same windows
    down_starts: Optional[torch.Tensor] = None  # (B, N_l // TQ)
    up_starts: Optional[torch.Tensor] = None    # (B, N_parent // TQ)
    # the index fields came from the banded windowed kNN, so neighbourhood
    # gathers may take the banded kernels
    banded: bool = False
    # W0 window-width knob the indices were built with (model.banded_window;
    # 0 = env/default policy): gathers must use the same width
    window: int = 0


def _take_points(parent: torch.Tensor, fps_idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(parent, 1, fps_idx.long()[..., None].expand(-1, -1, 3))


def _level(parent: torch.Tensor, fps_idx: Optional[torch.Tensor], nsample: int, with_up: bool,
           banded: bool, knn_method: Optional[str], window: int, adaptive: Optional[bool],
           cached=lambda field: None) -> LevelGeometry:
    """One level from its parent's coordinates and its (sorted or greedy)
    ``fps_idx`` (None at stride 1); ``cached(field)`` supplies index fields
    that need not be computed."""
    down_knn_idx = up_idx = up_weight = down_starts = up_starts = None
    lvl = parent
    if fps_idx is not None:
        lvl = _take_points(parent, fps_idx)
        m, n = lvl.shape[1], parent.shape[1]
        down_starts = _adaptive_starts(fps_idx, m, n, nsample, banded, "down", window, adaptive)
        down_knn_idx = cached("down_knn_idx")
        if down_knn_idx is None:
            down_knn_idx, _ = _knn_auto(lvl, parent, nsample, banded, knn_method, down_starts,
                                        window)
    knn_idx = cached("knn_idx")
    if knn_idx is None:
        knn_idx, _ = _knn_auto(lvl, lvl, nsample, banded, knn_method, window=window)
    if with_up and fps_idx is not None:
        up_starts = _adaptive_starts(fps_idx, parent.shape[1], lvl.shape[1], 3, banded, "up",
                                     window, adaptive)
        up_idx, up_weight = cached("up_idx"), cached("up_weight")
        if up_idx is None or up_weight is None:
            up_idx, up_dist = _knn_auto(parent, lvl, 3, banded, knn_method, up_starts, window)
            up_weight = interpolation_weights(up_dist)
    return LevelGeometry(lvl, knn_idx, fps_idx, down_knn_idx, up_idx, up_weight,
                         down_starts, up_starts, banded, window)


def build_point_hierarchy(
    xyz: torch.Tensor,
    strides: Sequence[int],
    nsamples: Sequence[int],
    *,
    with_up: bool = True,
    banded: bool = False,
    sort_fps: bool = False,
    knn_method: Optional[str] = None,
    window: int = 0,
    adaptive: Optional[bool] = None,
) -> List[LevelGeometry]:
    """Hierarchy of a batch of clouds (B, N, 3); ``strides``/``nsamples``
    follow the encoder, e.g. ([1, 4, 4, 4], [8, 16, 16, 16]) for SceneMap.
    ``knn_method='exact'`` bypasses the packed-key kNN. ``sort_fps`` relabels
    each level into ascending-index order (implied by ``banded``; the offline
    geometry cache sets it so that its indices satisfy the banded wire's
    window assumption). ``window``/``adaptive``: the banded W0 width and
    adaptive-starts knobs (0/None = env + default)."""
    if len(strides) != len(nsamples):
        raise ValueError("strides and nsamples differ in length")
    levels = []
    parent = xyz.float()
    for stride, nsample in zip(strides, nsamples):
        fps_idx = None
        if stride != 1:
            fps_idx = batched_fps(parent, parent.shape[1] // stride)
            if banded or sort_fps:
                fps_idx = torch.sort(fps_idx, dim=-1).values
        levels.append(_level(parent, fps_idx, nsample, with_up, banded, knn_method, window,
                             adaptive))
        parent = levels[-1].xyz
    return levels


def build_point_hierarchy_from_fps(
    xyz: torch.Tensor,
    arrays: Dict[str, torch.Tensor],
    strides: Sequence[int],
    nsamples: Sequence[int],
    *,
    prefix: str = "geo",
    with_up: bool = True,
    banded: bool = False,
    knn_method: Optional[str] = None,
    window: int = 0,
    adaptive: Optional[bool] = None,
) -> List[LevelGeometry]:
    """Rebuild the hierarchy from cached FPS indices
    (``{prefix}{l}_fps_idx``), computing the kNN fields here. Any cached
    ``knn_idx``/``down_knn_idx``/``up_idx``+``up_weight`` of a level is used
    as it is."""
    levels = []
    parent = xyz.float()
    for li, (stride, nsample) in enumerate(zip(strides, nsamples)):
        def cached(field, li=li):
            v = arrays.get(f"{prefix}{li}_{field}")
            if v is None:
                return None
            return v.float() if field == "up_weight" else v.to(torch.int32)

        fps_idx = None if stride == 1 else arrays[f"{prefix}{li}_fps_idx"].to(torch.int32)
        levels.append(_level(parent, fps_idx, nsample, with_up, banded, knn_method, window,
                             adaptive, cached))
        parent = levels[-1].xyz
    return levels


# Every index and weight field depends only on pairwise distances, so it is
# invariant to the rigid augmentations the datasets apply. The geometry can
# be computed once per sample offline (the prepare ``geometry`` stage) and fed
# through the batch; only the xyz fields are re-gathered from the augmented
# cloud.
_GEO_FIELDS = ("knn_idx", "fps_idx", "down_knn_idx", "up_idx", "up_weight")


def geometry_to_arrays(levels: List[LevelGeometry], prefix: str = "geo") -> Dict[str, torch.Tensor]:
    """Flatten a hierarchy's index and weight fields into a {name: tensor}
    dict for npz storage or batch transport."""
    out = {}
    for li, lvl in enumerate(levels):
        for field in _GEO_FIELDS:
            v = getattr(lvl, field)
            if v is not None:
                out[f"{prefix}{li}_{field}"] = v
    return out


def geometry_from_arrays(arrays: Dict[str, torch.Tensor], xyz: torch.Tensor, num_levels: int,
                         prefix: str = "geo", banded: bool = False, window: int = 0,
                         adaptive: Optional[bool] = None) -> List[LevelGeometry]:
    """Hierarchy from a full cache of index arrays plus the level-0
    coordinates; each level's xyz is re-gathered through the FPS chain.
    ``banded=True`` marks the cached indices as produced by the banded
    windowed kNN, so neighbourhood gathers may take the banded kernels; the
    adaptive starts they were built with are re-attached (they are functions
    of ``fps_idx``). Offline caches from the full kNN keep the default."""
    def get(li, field, dtype):
        v = arrays.get(f"{prefix}{li}_{field}")
        return None if v is None else v.to(dtype)

    levels = []
    parent = xyz.float()
    for li in range(num_levels):
        fps_idx = get(li, "fps_idx", torch.int32)
        lvl = parent if fps_idx is None else _take_points(parent, fps_idx)
        down_knn_idx = get(li, "down_knn_idx", torch.int32)
        up_idx = get(li, "up_idx", torch.int32)
        down_starts = up_starts = None
        if fps_idx is not None and down_knn_idx is not None:
            down_starts = _adaptive_starts(fps_idx, lvl.shape[1], parent.shape[1],
                                           int(down_knn_idx.shape[-1]), banded, "down", window,
                                           adaptive)
        if fps_idx is not None and up_idx is not None:
            up_starts = _adaptive_starts(fps_idx, parent.shape[1], lvl.shape[1], 3, banded, "up",
                                         window, adaptive)
        levels.append(LevelGeometry(
            xyz=lvl,
            knn_idx=get(li, "knn_idx", torch.int32),
            fps_idx=fps_idx,
            down_knn_idx=down_knn_idx,
            up_idx=up_idx,
            up_weight=get(li, "up_weight", torch.float32),
            down_starts=down_starts, up_starts=up_starts, banded=banded, window=window,
        ))
        parent = lvl
    return levels

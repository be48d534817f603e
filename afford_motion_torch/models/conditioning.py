"""Condition preparation (counterpart of
``afford_motion_tpu/models/conditioning.py``): strings become embeddings on
the host; the point hierarchies and the expensive encodings (a CMDM's
contact encoder, a CDM's frozen scene model) run on the device, once per
batch or sampling chain."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.hierarchy import (
    build_point_hierarchy,
    build_point_hierarchy_from_fps,
    geometry_from_arrays,
)
from ..utils.trace import span
from .cdm import CDM
from .cmdm import CMDM
from .pointtransformer import SCENEMAP_NSAMPLES, SCENEMAP_STRIDES, SEG_NSAMPLES, SEG_STRIDES
from .text import TextEncoder

ARRAY_COND_KEYS = (
    "c_pc_xyz", "c_pc_feat", "c_pc_contact",
    "c_text_mask", "c_text_erase", "c_pc_mask", "c_pc_erase",
    "x_mask",
)
_FLAG_KEYS = ("c_text_mask", "c_text_erase", "c_pc_mask", "c_pc_erase")


def encode_text(text_encoder: TextEncoder, captions) -> Dict[str, np.ndarray]:
    """Captions -> ``text_emb`` (B, Lt, D), plus ``text_token_mask`` (True =
    padding) from a per-token encoder; (B, 1, D) from a pooled one."""
    with span("text: encode"):
        if getattr(text_encoder, "per_token", False):
            emb, pad = text_encoder.encode_tokens(captions)
            return {"text_emb": emb, "text_token_mask": pad}
        return {"text_emb": text_encoder.encode(captions)[:, None, :]}


def host_prepare_cond(batch: Dict[str, Any], text_encoder: TextEncoder,
                      drop: Tuple[str, ...] = ()) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Strings -> embeddings, info_* metadata dropped. Returns (x, cond) as
    numpy, cached geometry (``geo_*``) included except the fields whose name
    ends in one of ``drop`` (geometry the model never reads)."""
    cond = encode_text(text_encoder, batch["c_text"])
    for key in ARRAY_COND_KEYS:
        if key in batch and isinstance(batch[key], np.ndarray):
            v = batch[key]
            cond[key] = v.reshape(v.shape[0], 1) if key in _FLAG_KEYS else v
    for key, v in batch.items():
        if key.startswith("geo_") and isinstance(v, np.ndarray) and not key.endswith(tuple(drop)):
            cond[key] = v
    return batch["x"], cond


def cond_to_device(cond: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy condition arrays -> tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in cond.items()}


def hierarchy_specs(model: Union[CMDM, CDM]
                    ) -> List[Tuple[str, str, Sequence[int], Sequence[int], bool]]:
    """The point hierarchies ``model`` reads, each as (cond key, cache
    prefix, strides, nsamples, with the 3-NN up-interpolation): a CMDM's
    SceneMap hierarchy ``levels_sm``; a CDM's scene-model hierarchy
    ``levels_seg`` and PointTrans hierarchy ``levels_pt``, both for a U-Net,
    so with the up-interpolation."""
    if isinstance(model, CMDM):
        return [("levels_sm", "geo_sm", SCENEMAP_STRIDES, SCENEMAP_NSAMPLES,
                 bool(model.needs_up_interpolation))]
    if isinstance(model, CDM):
        return ([("levels_seg", "geo_seg", SEG_STRIDES, SEG_NSAMPLES, True)]
                * model.needs_seg_hierarchy
                + [("levels_pt", "geo_sm", SCENEMAP_STRIDES, SCENEMAP_NSAMPLES, True)]
                * model.needs_pt_hierarchy)
    raise NotImplementedError(f"{type(model).__name__} is not ported")


@torch.no_grad()
def add_hierarchies(model: Union[CMDM, CDM], cond: Dict[str, Any]) -> Dict[str, Any]:
    """Attach the point hierarchies the model reads (:func:`hierarchy_specs`),
    each from a full geometry cache, from cached FPS indices, or built from
    ``c_pc_xyz``. Indices and level coordinates carry no gradient.
    Bandedness and its window knobs ride on the model (``use_banded``, set by
    the TrainLoop for curve-sorted packed data or by the config;
    ``banded_window``, ``banded_adaptive``)."""
    specs = hierarchy_specs(model)
    xyz = cond.get("c_pc_xyz")
    if xyz is None:
        return cond
    cond = dict(cond)
    knn_method = "exact" if model.knn_exact else None
    knobs = dict(banded=bool(model.use_banded), window=int(model.banded_window or 0),
                 adaptive=model.banded_adaptive)
    for key, prefix, strides, nsamples, with_up in specs:
        if f"{prefix}0_knn_idx" in cond:
            # a full cache rides with use_banded only where its indices came
            # from the banded kNN; offline caches from the full kNN keep it off
            cond[key] = geometry_from_arrays(cond, xyz, len(strides), prefix=prefix, **knobs)
        elif f"{prefix}1_fps_idx" in cond:
            cond[key] = build_point_hierarchy_from_fps(
                xyz, cond, strides, nsamples, prefix=prefix, with_up=with_up,
                knn_method=knn_method, **knobs)
        else:
            cond[key] = build_point_hierarchy(xyz, strides, nsamples, with_up=with_up,
                                              knn_method=knn_method, **knobs)
    return cond


def encode_conditions(model: Union[CMDM, CDM], cond: Dict[str, Any]) -> Optional[torch.Tensor]:
    """The expensive condition encoding, hoisted out of the denoising loop:
    a CMDM's contact encoding, a CDM's frozen scene features (None where
    its configuration reads no scene model)."""
    if isinstance(model, CMDM):
        return model.encode_contact(cond)
    if isinstance(model, CDM):
        return model.encode_scene(cond)
    raise NotImplementedError(f"encode_conditions: {type(model).__name__} is not ported")

"""HUMANISE target-object masks for the ``dist_to_target`` metric
(counterpart of ``afford_motion_tpu/prepare/target_object_mask.py``;
reference: prepare/generate_target_object_mask.py): for each HUMANISE item,
which of its sampled contact points lie on the annotated object, from
ScanNet's per-vertex segments (``<id>_vh_clean_2.0.010000.segs.json``) and
their grouping into objects (``<id>.aggregation.json``). It reads the
contacts' ``mask`` (the points' rows in the scene), so it runs after
``contact_data`` and before ``sort``, which reorders the masks with their
clouds."""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils.io import get_logger

logger = get_logger()


def load_scannet_object_vertex_mask(scene_dir: str, scene_id: str, object_id: int) -> np.ndarray:
    """(N_scene_verts,) bool: the vertices of ``object_id``."""
    segs_file = os.path.join(scene_dir, scene_id, f"{scene_id}_vh_clean_2.0.010000.segs.json")
    agg_file = os.path.join(scene_dir, scene_id, f"{scene_id}.aggregation.json")
    with open(segs_file) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"])
    with open(agg_file) as f:
        groups = json.load(f)["segGroups"]
    target_segs = set()
    for g in groups:
        if int(g["objectId"]) == int(object_id):
            target_segs.update(g["segments"])
    return np.isin(seg_indices, list(target_segs))


def generate_target_object_masks(data_dir: str = "./data") -> None:
    """``HUMANISE/contact_motion/target_mask/{i:05d}.npy`` for every item; an
    item whose scene has no segment files is logged and gets none, as in the
    JAX package."""
    import pandas as pd

    base = os.path.join(data_dir, "HUMANISE")
    anno = pd.read_csv(os.path.join(base, "annotations.csv"))
    contact_anno = pd.read_csv(os.path.join(base, "contact_motion", "anno.csv"))
    out_dir = os.path.join(base, "contact_motion", "target_mask")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(contact_anno)):
        scene_id = contact_anno.loc[i]["scene_id"]
        object_id = anno.loc[i]["object_id"]
        try:
            vert_mask = load_scannet_object_vertex_mask(os.path.join(base, "scenes"), scene_id,
                                                        object_id)
        except FileNotFoundError as e:
            logger.warning(f"target mask skipped for {i}: {e}")
            continue
        sampled = np.load(os.path.join(base, "contact_motion", "contacts", f"{i:05d}.npz"))["mask"]
        np.save(os.path.join(out_dir, f"{i:05d}.npy"), vert_mask[sampled])

"""Representation-dimension table and small host-side geometry helpers
(reference: utils/misc.py:4-22, datasets/transforms.py uses of
trimesh.transform_points).
"""
from __future__ import annotations

import numpy as np


# Central repr-dimension table (reference: utils/misc.py:4-22). Fills
# cfg.model.input_feats at startup (reference: train.py:60, test.py:158).
_REPR_DIMS = {
    "smplx_no_hands": 69,
    "pos": 22 * 3,           # 66
    "pos_rot": 22 * 3 + 21 * 3,  # 129
    "contact_one_joints": 1,
    "contact_all_joints": 22,
    "contact_cont_joints": 6,
    "contact_pelvis": 1,
    "h3d": 263,
}


def compute_repr_dimension(data_repr: str) -> int:
    if data_repr not in _REPR_DIMS:
        raise ValueError(f"unknown data representation: {data_repr}")
    return _REPR_DIMS[data_repr]


# Keep the reference's (misspelled) name as an alias so configs/scripts that
# reference it port 1:1 (reference: utils/misc.py:4).
compute_repr_dimesion = compute_repr_dimension


def natsorted(items):
    """Natural-order sort (replaces the natsort package used by the
    reference for checkpoint/file ordering, e.g. test.py:47-49)."""
    import re

    def key(s):
        return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def transform_points(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points.

    Replaces trimesh.transform_points (not installed); pure numpy.
    """
    points = np.asarray(points)
    matrix = np.asarray(matrix)
    return points @ matrix[:3, :3].T + matrix[:3, 3]

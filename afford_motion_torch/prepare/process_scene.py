"""Scene PLY -> (N, 6) xyz and rgb in [-1, 1] ``.npy`` (counterpart of
``afford_motion_tpu/prepare/process_scene.py``; reference:
prepare/process_scene.py:8-61). Colours are scaled by 1 / 127.5 - 1 as the
reference does (the datasets map them back with (c + 1) / 2). Where
OpenScene's distilled features lie beside a scene, their alignment with its
vertices is asserted. Numpy only; a scene that fails raises."""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ..utils.io import get_logger
from ..utils.misc import natsorted

logger = get_logger()

PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
             "int": "<i4", "uint": "<u4"}


def read_ply_xyzrgb(path: str) -> np.ndarray:
    """(N, 6) float32 xyz and rgb of a PLY's vertices, ascii or binary
    little-endian (the vertex element first, as ScanNet and PROX write it)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", errors="replace").splitlines()
    body = data[head_end:]
    fmt, n_v, props, section = "ascii", 0, [], None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            section = parts[1]
            if section == "vertex":
                n_v = int(parts[2])
        elif parts[0] == "property" and section == "vertex" and parts[1] != "list":
            props.append((parts[2], parts[1]))
    out = np.zeros((n_v, 6), dtype=np.float32)
    if fmt.startswith("binary_little"):
        rec = np.frombuffer(body, dtype=np.dtype([(n, PLY_TYPES[t]) for n, t in props]),
                            count=n_v)
        for k, name in enumerate(("x", "y", "z", "red", "green", "blue")):
            out[:, k] = rec[name]
        return out
    lines = body.decode().splitlines()
    names = [n for n, _ in props]
    for i in range(n_v):
        row = dict(zip(names, lines[i].split()))
        out[i] = [row["x"], row["y"], row["z"], row["red"], row["green"], row["blue"]]
    return out


def process_scene(scene_path: str, out_filename: str, feat_dir: Optional[str] = None) -> None:
    pts = read_ply_xyzrgb(scene_path)
    verts = pts[:, 0:3]
    color = pts[:, 3:6] / 127.5 - 1.0
    if feat_dir:
        scene = os.path.basename(scene_path)
        feat_path = os.path.join(feat_dir, scene.replace(".ply", "_openscene_feat_distill.npy"))
        if os.path.exists(feat_path):
            feat = np.load(feat_path)
            assert verts.shape[0] == feat.shape[0], "OpenScene feature misalignment"
    np.save(out_filename, np.concatenate([verts, color], axis=1).astype(np.float32))


def process_all(data_dir: str = "./data") -> None:
    """Every scene of HUMANISE (ScanNet's ``scenes/<id>/<id>_vh_clean_2.ply``),
    PROX and HumanML3D under ``data_dir`` to ``<set>/points/<scene>.npy``
    (reference: process_scene.py:20-61)."""
    jobs = [
        ("HUMANISE", os.path.join(data_dir, "HUMANISE/scenes/*_00/*_00_vh_clean_2.ply"), -2),
        ("PROX", os.path.join(data_dir, "PROX/scenes/*.ply"), -1),
        ("HumanML3D", os.path.join(data_dir, "HumanML3D/scenes/*.ply"), -1),
    ]
    for dataset, pattern, name_part in jobs:
        out_dir = os.path.join(data_dir, dataset, "points")
        os.makedirs(out_dir, exist_ok=True)
        for scene_path in natsorted(glob.glob(pattern)):
            scene_name = scene_path.split("/")[name_part].split(".")[0]
            process_scene(scene_path, os.path.join(out_dir, scene_name + ".npy"),
                          feat_dir=os.path.join(data_dir, dataset, "feat"))
        logger.info(f"{dataset} scenes processed")

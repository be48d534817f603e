"""Raw releases -> SMPL-X parameter pickles (counterpart of
``afford_motion_tpu/prepare/raw_datasets.py``; reference: prepare/datasets/*):
AMASS SMPL-X for HumanML3D, the HUMANISE ``align_data_release`` tree, the
PROX fittings. Each extractor writes ``<out_root>/motions/*.pkl``, a
(param_seq, betas) tuple a sequence; HUMANISE also writes
``<out_root>/annotations.csv``, the only ``annotations.csv`` the pipeline
has (``contact_data`` reads it). PROX's per-frame pelvis comes from the
port's joints-only SMPL-X LBS on the device; the rest is numpy and scipy.
"""
from __future__ import annotations

import csv
import glob
import json
import os
import pickle
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..utils.io import get_logger
from ..utils.misc import natsorted

logger = get_logger()


def aa_to_matrix(aa: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(aa).as_matrix()


def matrix_to_aa(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R).as_rotvec()


def apply_rigid_to_params(T: np.ndarray, trans: np.ndarray, orient: np.ndarray,
                          pelvis: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """SMPL-X (transl, global orient) re-expressed after the rigid transform
    ``T``, about the pelvis (the smplkit ``matrix_to_parameter`` of the
    reference's HUMANISE.py:114 and PROX.py:110); ``pelvis`` is the current
    world pelvis a frame."""
    R, t = T[:3, :3], T[:3, 3]
    offset = pelvis - trans                         # the rest pelvis offset, a frame
    new_trans = (trans + offset) @ R.T + t - offset
    new_orient = matrix_to_aa(R[None] @ aa_to_matrix(orient))
    return new_trans.astype(np.float32), new_orient.astype(np.float32)


class HumanML3DExtractor:
    """AMASS SMPL-X sequences cut and resampled to 20 fps by HumanML3D's
    index (reference: prepare/datasets/HumanML3D/HumanML3D.py:11-97). The
    frame rate comes from the SMPL-H release beside ``data_dir`` (its path
    with ``smplx_neutral`` read as ``smplh``); a sequence without that file,
    or whose file has no ``mocap_framerate``, is logged and left out."""

    FPS = 20
    LEAD_TRIM = {
        "Eyes_Japan_Dataset": 3, "MPI_HDM05": 3, "TotalCapture": 1,
        "MPI_Limits": 1, "Transitions_mocap": 0.5,
    }

    def __init__(self, data_dir: str, index_csv: str, out_dir: str = "./data/HumanML3D/motions"):
        import pandas as pd

        self.data_dir = data_dir
        self.smplh_dir = data_dir.replace("smplx_neutral", "smplh")
        self.index = pd.read_csv(index_csv)
        self.out_dir = out_dir

    def process(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        for i in range(len(self.index)):
            row = self.index.loc[i]
            source_path = row["source_path"]
            if "humanact12" in source_path:
                continue
            rel = "/".join(source_path.split("/")[2:])
            src = os.path.join(self.data_dir, rel)
            src = src.replace("poses.npy", "stageii.npz").replace(" ", "_")
            if not os.path.exists(src):
                logger.warning(f"missing {src}")
                continue
            bdata = np.load(src, allow_pickle=True)
            try:
                fps = float(np.load(os.path.join(self.smplh_dir, rel).replace(".npy", ".npz"),
                                    allow_pickle=True)["mocap_framerate"])
            except (FileNotFoundError, KeyError):
                logger.warning(f"no framerate for {src}")
                continue
            step = int(fps / self.FPS)
            frames = np.arange(0, bdata["trans"].shape[0], step)
            data = np.concatenate([
                bdata["trans"][frames],
                bdata["root_orient"][frames],
                bdata["pose_body"][frames],
                bdata["pose_hand"][frames],
            ], axis=-1).astype(np.float32)
            for key, secs in self.LEAD_TRIM.items():
                if key in source_path:
                    data = data[int(secs * self.FPS):]
            data = data[int(row["start_frame"]): int(row["end_frame"])]
            betas = np.asarray(bdata["betas"][:10], dtype=np.float32)
            out = os.path.join(self.out_dir, str(row["new_name"]).replace(".npy", ".pkl"))
            with open(out, "wb") as fp:
                pickle.dump((data, betas), fp)


class HUMANISEExtractor:
    """HUMANISE's aligned motions: each pure motion re-anchored at its sampled
    placement in the scene (reference:
    prepare/datasets/HUMANISE/HUMANISE.py:16-124)."""

    ANCHOR = {"sit": -1, "stand up": 0, "walk": -1, "lie": -1}

    def __init__(self, data_dir: str, out_root: str = "./data/HUMANISE"):
        self.data_dir = data_dir
        self.out_root = out_root

    def process(self) -> None:
        save_dir = os.path.join(self.out_root, "motions")
        os.makedirs(save_dir, exist_ok=True)
        aligns = natsorted(
            glob.glob(os.path.join(self.data_dir, "align_data_release", "*", "*", "anno.pkl")))
        anno_list, motion_cache = [], {}
        for align in aligns:
            with open(align, "rb") as f:
                anno_list.extend(pickle.load(f))
        rows = []
        for idx, anno in enumerate(anno_list):
            motion_id, action = anno["motion"], anno["action"]
            if motion_id not in motion_cache:
                with open(os.path.join(self.data_dir, "pure_motion", action, motion_id,
                                       "motion.pkl"), "rb") as fp:
                    motion_cache[motion_id] = pickle.load(fp)
            (gender, origin_trans, origin_orient, betas, pose_body, pose_hand,
             pose_jaw, pose_eye, joints_traj) = motion_cache[motion_id]
            pelvis = joints_traj[:, 0, :]
            anchor = self.ANCHOR[action]

            # T = translate(sampled) @ rotz(sampled) @ translate(-anchor pelvis xy)
            T1 = np.eye(4, dtype=np.float32)
            T1[0:2, -1] = -pelvis[anchor, 0:2]
            ang = float(anno["rotation"])
            c, s = np.cos(ang), np.sin(ang)
            T2 = np.eye(4, dtype=np.float32)
            T2[:2, :2] = [[c, -s], [s, c]]
            T3 = np.eye(4, dtype=np.float32)
            T3[0:3, -1] = anno["translation"]
            T = T3 @ T2 @ T1
            new_trans, new_orient = apply_rigid_to_params(T, origin_trans, origin_orient, pelvis)

            param_seq = np.concatenate([new_trans, new_orient, pose_body, pose_hand], axis=-1)
            with open(os.path.join(save_dir, f"{idx:06d}.pkl"), "wb") as fp:
                pickle.dump((param_seq, betas[:10]), fp)
            st = anno["scene_translation"]
            rows.append([
                f"{idx:06d}", anno["scene"], f"{st[0]:.8f}", f"{st[1]:.8f}", f"{st[2]:.8f}",
                anno["object_id"], anno["object_semantic_label"], action, anno["utterance"],
            ])
        with open(os.path.join(self.out_root, "annotations.csv"), "w", newline="") as fp:
            w = csv.writer(fp)
            w.writerow(["motion_id", "scene_id", "scene_trans_x", "scene_trans_y",
                        "scene_trans_z", "object_id", "object_semantic_label", "action", "text"])
            w.writerows(rows)


class PROXExtractor:
    """PROX fittings re-expressed in the recentred world frame (reference:
    prepare/datasets/PROX/PROX.py:14-131). ``out_root`` holds
    ``cam2world/<scene>.json`` and ``scenes/<scene>.ply``; the scene centres
    are read from ``normalize_to_center.json`` there, or computed from the
    scenes and written to it. Each sequence's per-frame pelvis comes from
    the neutral body model (``SMPLXModel.load_default``, standing in for the
    male and female ones) on ``device``, all frames in one call."""

    FEMALE_SUBJECTS = {162, 3452, 159, 3403}

    def __init__(self, data_dir: str, out_root: str = "./data/PROX",
                 device: Union[str, torch.device] = "cuda"):
        self.data_dir = data_dir
        self.out_root = out_root
        self.device = device

    def _cam_and_center(self) -> Tuple[Dict, Dict]:
        cam_trans = {}
        for f in glob.glob(os.path.join(self.out_root, "cam2world", "*.json")):
            if "_" in os.path.basename(f):
                continue
            with open(f) as fp:
                cam_trans[os.path.basename(f).split(".")[0]] = np.array(json.load(fp),
                                                                        dtype=np.float32)
        center_path = os.path.join(self.out_root, "normalize_to_center.json")
        if os.path.exists(center_path):
            with open(center_path) as fp:
                centers = {k: np.array(v, dtype=np.float32) for k, v in json.load(fp).items()}
        else:
            from .process_scene import read_ply_xyzrgb

            centers = {}
            for s in cam_trans:
                pts = read_ply_xyzrgb(os.path.join(self.out_root, "scenes", f"{s}.ply"))[:, :3]
                m = np.eye(4, dtype=np.float32)
                m[0:3, -1] = [-pts[:, 0].mean(), -pts[:, 1].mean(), -np.percentile(pts[:, 2], 2)]
                centers[s] = m
            with open(center_path, "w") as fp:
                json.dump({k: v.tolist() for k, v in centers.items()}, fp)
        return cam_trans, centers

    def pelvis(self, model, transl: np.ndarray, orient: np.ndarray,
               body_pose: np.ndarray) -> np.ndarray:
        """(F, 3) pelvis positions of F frames' (transl, global orient, body
        pose) with the model's rest shape, on the model's device."""
        from ..eval.smplx_lbs import smplx_joints

        dev = model.v_template.device
        joints = smplx_joints(model, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                       for a in (transl, orient, body_pose)))
        return joints[:, 0, :].cpu().numpy()

    def process(self) -> None:
        from ..eval.smplx_lbs import SMPLXModel

        model = SMPLXModel.load_default().to(self.device)
        cam_trans, centers = self._cam_and_center()
        save_dir = os.path.join(self.out_root, "motions")
        os.makedirs(save_dir, exist_ok=True)

        sequences = [s for s in os.listdir(self.data_dir)
                     if os.path.isdir(os.path.join(self.data_dir, s))]
        for sequence in sequences:
            scene_id = sequence.split("_")[0]
            frames = []
            for pkl in natsorted(glob.glob(os.path.join(self.data_dir, sequence, "results", "*",
                                                        "000.pkl"))):
                with open(pkl, "rb") as fp:
                    frames.append(pickle.load(fp))
            if not frames:
                continue
            fields = {k: np.concatenate([np.asarray(p[k], dtype=np.float32) for p in frames])
                      for k in ("transl", "global_orient", "body_pose")}
            pelvis = self.pelvis(model, fields["transl"], fields["global_orient"],
                                 fields["body_pose"])
            T = centers[scene_id] @ cam_trans[scene_id]
            pose_params = []
            for f, p in enumerate(frames):
                transl = np.asarray(p["transl"], dtype=np.float32)
                orient = np.asarray(p["global_orient"], dtype=np.float32)
                body_pose = np.asarray(p["body_pose"], dtype=np.float32)
                new_trans, new_orient = apply_rigid_to_params(T, transl, orient,
                                                              pelvis[f: f + 1])
                hands = np.zeros((1, 90), dtype=np.float32)  # PCA hands left at rest
                pose_params.append(np.concatenate([new_trans, new_orient, body_pose, hands],
                                                  axis=1))
            pose_params = np.concatenate(pose_params, axis=0)
            betas = np.concatenate([np.asarray(p["betas"], dtype=np.float32) for p in frames],
                                   axis=0).mean(axis=0)
            with open(os.path.join(save_dir, f"{sequence}.pkl"), "wb") as fp:
                pickle.dump((pose_params, betas), fp)


def create_extractor(dataset: str, data_dir: str, out_dir: str = "./data",
                     device: Union[str, torch.device] = "cuda"):
    """The extractor of ``dataset`` reading the raw release at ``data_dir``
    and writing under ``<out_dir>/<dataset>`` (reference: prepare/process.py's
    dispatch). HumanML3D reads its release's ``index.csv`` of AMASS sources,
    cuts and new names as ``humanml3d_index.csv`` beside this module (not in
    the repository); without it this raises ``FileNotFoundError`` naming
    the file."""
    out_root = os.path.join(out_dir, dataset)
    if dataset == "HumanML3D":
        index_csv = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "humanml3d_index.csv")
        if not os.path.exists(index_csv):
            raise FileNotFoundError(f"HumanML3D's index of AMASS sources is not at {index_csv}; "
                                    "copy index.csv of the HumanML3D release there")
        return HumanML3DExtractor(data_dir, index_csv, os.path.join(out_root, "motions"))
    if dataset == "HUMANISE":
        return HUMANISEExtractor(data_dir, out_root)
    if dataset == "PROX":
        return PROXExtractor(data_dir, out_root, device)
    raise NotImplementedError(dataset)

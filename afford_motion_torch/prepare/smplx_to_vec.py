"""SMPL-X parameter sequences -> 22-joint position vectors, with the mirrored
twin for HumanML3D (counterpart of ``afford_motion_tpu/prepare/smplx_to_vec.py``;
reference: prepare/smplx_to_vec.py:18-96). The joints come from the port's
joints-only LBS (``eval/smplx_lbs.smplx_joints``) on the body model's device:
hand poses move only the hands' joints (descendants of the wrists), so the
22 body joints are those of the hands at rest."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..eval.smplx_lbs import SMPLXModel, smplx_joints

JOINTS = 22
RIGHT_CHAIN = [2, 5, 8, 11, 14, 17, 19, 21]
LEFT_CHAIN = [1, 4, 7, 10, 13, 16, 18, 20]


def convert_smplx_to_pos(smplx: Tuple[np.ndarray, np.ndarray], model: SMPLXModel,
                         same_betas: bool = False) -> np.ndarray:
    """(pose_seq (L, >= 69), betas (n_betas,)) -> (L, 66) float32 joint
    positions, computed on ``model``'s device."""
    pose_seq, betas = smplx
    L = pose_seq.shape[0]
    dev = model.v_template.device
    betas = np.zeros_like(betas) if same_betas else betas
    pose = torch.from_numpy(np.ascontiguousarray(pose_seq[:, :69], np.float32)).to(dev)
    betas_b = torch.from_numpy(np.asarray(betas, np.float32)).to(dev).expand(L, -1)
    joints = smplx_joints(model, pose[:, :3], pose[:, 3:6], pose[:, 6:69], betas=betas_b)
    return joints[:, :JOINTS, :].reshape(L, JOINTS * 3).cpu().numpy().astype(np.float32)


def mirror_pos(joints: np.ndarray) -> np.ndarray:
    """x-flip and the left / right chains swapped (reference:
    smplx_to_vec.py:22-33)."""
    m = joints.copy().reshape(-1, JOINTS, 3)
    m[:, :, 0] *= -1
    tmp = m[:, RIGHT_CHAIN, :].copy()
    m[:, RIGHT_CHAIN, :] = m[:, LEFT_CHAIN, :]
    m[:, LEFT_CHAIN, :] = tmp
    return m.reshape(-1, JOINTS * 3).astype(np.float32)


def smplx_to_vec(smplx: Tuple[np.ndarray, np.ndarray], dataset: str, save_path: str,
                 model: Optional[SMPLXModel] = None) -> None:
    """One sequence's joints to ``save_path``; HumanML3D (zero betas) also
    gets its mirrored twin as ``M<name>.npy`` (reference:
    smplx_to_vec.py:69-96)."""
    model = model or SMPLXModel.load_default()
    vec = convert_smplx_to_pos(smplx, model, same_betas=dataset == "HumanML3D")
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    np.save(save_path, vec)
    if dataset == "HumanML3D":
        dirname, basename = os.path.dirname(save_path), os.path.basename(save_path)
        np.save(os.path.join(dirname, "M" + basename), mirror_pos(vec))

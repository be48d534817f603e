"""Dataset base class, shared protocol helpers, and the factory
(reference: datasets/base.py:7-17 plus the logic duplicated across every
dataset class in datasets/motionx.py and datasets/humanml3d.py —
split-id loading, anno.csv scanning, contact extraction, σ-kernel,
mean/std caching, motion padding — factored out once here)."""
from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native as nio
from ..utils.io import get_logger
from ..utils.registry import DATASET
from .loader import DataLoader, collate_fn_general
from .transforms import make_default_transform

logger = get_logger()


def full_name(dataset: str, scene_id: str, folder: bool = False) -> str:
    """Scene mesh naming scheme (reference: motionx.py:18-22)."""
    if dataset == "HUMANISE":
        return f"{scene_id}/{scene_id}_vh_clean_2" if folder else f"{scene_id}_vh_clean_2"
    return f"{scene_id}"


def translation_to_transform(translation: np.ndarray) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    t[0:3, -1] = translation
    return t


def extract_contact(dist: np.ndarray, contact_type: str, joints: Sequence[int]) -> np.ndarray:
    """Select contact channels per representation
    (reference: motionx.py:551-563)."""
    if contact_type == "contact_one_joints":
        return dist.max(axis=-1, keepdims=True)
    if contact_type == "contact_all_joints":
        return dist
    if contact_type == "contact_cont_joints":
        return dist[:, list(joints)]
    if contact_type == "contact_pelvis":
        return dist[:, [0]]
    raise ValueError(f"unknown contact type: {contact_type}")


def gaussian_contact(dist: np.ndarray, sigma: float) -> np.ndarray:
    """distance -> contact via the Gaussian kernel exp(-d²/2σ²)
    (reference: motionx.py:642, humanml3d.py:541)."""
    return np.exp(-0.5 * dist ** 2 / sigma ** 2)


def contact_to_dist(contact: np.ndarray, sigma: float) -> np.ndarray:
    """Inverse kernel: contact -> distance sqrt(-2σ²·log c)
    (reference: utils/evaluate.py:60)."""
    return np.sqrt(np.maximum(-2.0 * sigma ** 2 * np.log(np.clip(contact, 1e-20, 1.0)), 0.0))


def pad_motion(motion: np.ndarray, max_horizon: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad to max_horizon; mask True = padding."""
    l, d = motion.shape
    padded = np.concatenate(
        [motion, np.zeros((max_horizon - l, d), dtype=np.float32)], axis=0
    ).astype(np.float32)
    mask = np.concatenate(
        [np.zeros((l,), dtype=bool), np.ones((max_horizon - l,), dtype=bool)]
    )
    return padded, mask


def load_split_ids(data_dir: str, sets: Sequence[str], phase: str, sets_config: Any) -> Dict[str, set]:
    """Per-set split index sets from {set}/{phase}.txt
    (reference: motionx.py:68-81)."""
    split_ids: Dict[str, set] = defaultdict(set)
    for s in sets:
        txt = os.path.join(data_dir, s, f"{phase}.txt")
        if s == "HumanML3D" and not sets_config.HumanML3D.get("use_mirror", True):
            txt = os.path.join(data_dir, s, f"{phase}_without_mirror.txt")
        with open(txt) as f:
            split_ids[s] = {int(line.strip()) for line in f if line.strip()}
    return split_ids


def read_anno(data_dir: str, set_name: str, anno_rel: str = "contact_motion/anno.csv"):
    """Parse anno.csv rows -> (scene_id, scene_trans, desc_list) per index
    (reference: motionx.py:90-105)."""
    import pandas as pd

    anno = pd.read_csv(os.path.join(data_dir, set_name, anno_rel))
    rows = []
    for i in range(len(anno)):
        scene_id = anno.loc[i]["scene_id"]
        scene_id = "" if not isinstance(scene_id, str) else scene_id
        scene_trans = np.array(
            [anno.loc[i][f"scene_trans_{a}"] for a in "xyz"], dtype=np.float32
        )
        desc = anno.loc[i]["utterance"]
        desc = [] if not isinstance(desc, str) or desc == "" else desc.split("$$")
        rows.append((scene_id, scene_trans, desc))
    return rows


def compute_or_load_stats(path: str, compute_fn) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std cache protocol (reference: motionx.py:121-142)."""
    try:
        npz = nio.load(path)
        logger.info(f"Load mean and std from {path}")
        return npz["mean"], npz["std"]
    except Exception:
        values = compute_fn()
        mean = values.mean(axis=0, keepdims=True)
        std = values.std(axis=0, keepdims=True)
        try:
            np.savez(path, mean=mean, std=std)
            logger.info(f"Save mean and std to {path}")
        except OSError:
            pass
        return mean, std


# Conditioning arrays safe to ship at half precision: point coordinates /
# contact conditioning / cached interpolation weights. Never the diffusion
# target "x" (loss precision) nor any info_* metadata the evaluators read.
_HALF_WIRE_PREFIXES = ("c_pc_", "geo_")


def _half_wire(data: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in data.items():
        if (
            isinstance(v, np.ndarray)
            and v.dtype == np.float32
            and k.startswith(_HALF_WIRE_PREFIXES)
        ):
            data[k] = v.astype(np.float16)
    return data


class BaseDataset:
    """Common surface: transforms, normalize/denormalize, get_dataloader."""

    mean: np.ndarray
    std: np.ndarray

    def _setup_transform(self, cfg: Any, phase: str) -> None:
        tlist = cfg.train_transforms if phase in ("train", "all") else cfg.test_transforms
        base = make_default_transform(tlist, cfg.get("transform_cfg", {}))
        # half_wire: ship float conditioning at f16 — halves the host copy
        # + host->device bytes for data that the model immediately casts to
        # bf16 anyway. Train-phase only; eval keeps full-precision inputs.
        train = phase in ("train", "all")
        if bool(cfg.get("half_wire", False)) and train:
            self.transform = lambda d, _b=base: _half_wire(_b(d))
        else:
            self.transform = base
        # half_wire_x: additionally ship the (normalized) diffusion target
        # at f16; the train step upcasts to f32 before q_sample/loss. The
        # ~5e-4 quantization is far below the diffusion noise floor. Applied
        # by __getitem__ via _finalize (AFTER any post-transform normalize).
        self._x16 = bool(cfg.get("half_wire_x", False)) and bool(
            cfg.get("half_wire", False)
        ) and train

    def _finalize(self, data: Dict[str, Any]) -> Dict[str, Any]:
        if self._x16:
            v = data.get("x")
            if isinstance(v, np.ndarray) and v.dtype == np.float32:
                data["x"] = v.astype(np.float16)
        return data

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def denormalize(self, x: np.ndarray, clip: bool = False) -> np.ndarray:
        x = x * self.std + self.mean
        if clip:
            if getattr(self, "use_raw_dist", False):
                x = x.clip(0.0, None)
            else:
                x = x.clip(1e-20, 1.0)
        return x

    def get_dataloader(self, **kwargs) -> DataLoader:
        kwargs.setdefault("collate_fn", collate_fn_general)
        return DataLoader(self, **kwargs)

    def __len__(self) -> int:
        return len(self.indices) if self.indices is not None else len(self.all_data)


def create_dataset(cfg: Any, phase: str, **kwargs) -> BaseDataset:
    """Factory by cfg.name (reference: datasets/base.py:7-17)."""
    return DATASET.get(cfg.name)(cfg, phase, **kwargs)

"""MotionX dataset family over {HumanML3D, HUMANISE, PROX} (counterpart of
``afford_motion_tpu/data/motionx.py``).

Wire-compatible with the reference data directory layout:
``{set}/contact_motion/{anno.csv, motions/*.npy, contacts/*.npz,
target_mask/*.npy}``, ``{set}/{phase}.txt`` splits, per-corpus mean/std
caches, and the two-stage handoff files ``pred_contact/*.npy``.

Ported so far: the shared base, ``ContactMapDataset`` (the stage-1 contact
set of ``ts2m_contact`` and ``novel_contact``) and ``ContactMotionDataset``
(the stage-2 motion set of the scene protocol), on ``.npy`` / ``.npz``
trees, test and train phases. The six other classes of the family and the
packed MotionX store are refused by name until their slices are ported.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict, List

import numpy as np

from .. import native as nio
from ..utils.io import get_logger
from ..utils.registry import DATASET
from .base import (
    BaseDataset,
    compute_or_load_stats,
    extract_contact,
    full_name,
    gaussian_contact,
    load_split_ids,
    pad_motion,
    read_anno,
    translation_to_transform,
)

logger = get_logger()


class _MotionXBase(BaseDataset):
    """Shared anno-scan + split logic for all MotionX-style datasets."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.cfg = cfg
        self.phase = phase
        self.gpu = kwargs.get("gpu", 0)
        self.data_dir = cfg.data_dir
        self.sets = list(cfg.sets)
        self.sets_config = cfg.sets_config
        self.shuffle_seed = cfg.shuffle_seed
        self.num_points = cfg.num_points
        self._read_cfg(cfg)
        self._setup_transform(cfg, phase)
        self._load_datasets()
        self._prepare_statistics()

    # subclasses override ------------------------------------------------
    def _read_cfg(self, cfg: Any) -> None:
        raise NotImplementedError

    def _prepare_statistics(self) -> None:
        raise NotImplementedError

    # shared helpers ------------------------------------------------------
    def _scan_sets(self, filter_horizon: bool = False) -> None:
        split_ids = load_split_ids(self.data_dir, self.sets, self.phase, self.sets_config)
        self.all_data: List = []
        for s in self.sets:
            rows = read_anno(self.data_dir, s)
            count = 0
            for i, (scene_id, scene_trans, desc) in enumerate(rows):
                if i not in split_ids[s]:
                    continue
                if filter_horizon:
                    motion = nio.load(self._motion_path(s, i))
                    if not (self.min_horizon <= motion.shape[0] <= self.max_horizon):
                        continue
                self.all_data.append((s, i, scene_id, scene_trans, desc))
                count += 1
            if self.gpu == 0:
                logger.info(f"Load {count} cases in {s} dataset")
        self._shuffle_indices()

    def _shuffle_indices(self) -> None:
        self.indices = list(range(len(self.all_data)))
        if self.phase in ("train", "all"):
            random.shuffle(self.indices)
        elif self.phase == "test":
            # seeded so the eval order the metrics depend on is reproducible
            random.Random(self.shuffle_seed).shuffle(self.indices)

    def _resolve(self, idx: int) -> int:
        return idx if self.indices is None else self.indices[idx]

    def _motion_path(self, s: str, i: int) -> str:
        return os.path.join(self.data_dir, s, "contact_motion", "motions", f"{i:05d}.npy")

    def _contact_path(self, s: str, i: int) -> str:
        sub = "contacts"
        if s == "HumanML3D" and self.sets_config.HumanML3D.get("use_fur", False):
            sub = "contacts_fur"
        return os.path.join(self.data_dir, s, "contact_motion", sub, f"{i:05d}.npz")

    def _scene_mesh_path(self, s: str, scene_id: str) -> str:
        return os.path.join(self.data_dir, s, "scenes", f"{full_name(s, scene_id, True)}.ply")

    def _pick_text(self, desc: List[str], rng=None) -> str:
        return (rng or random).choice(desc) if desc else ""

    def _color_feat(self, points: np.ndarray, scale: str = "sym") -> np.ndarray:
        """rgb features; 'sym' maps [-1,1]->[0,1], 'byte' maps /255."""
        feat = points[:, 3:3]
        if self.use_color:
            color = (points[:, 3:6] + 1) / 2.0 if scale == "sym" else points[:, 3:6] / 255.0
            feat = np.concatenate([feat, color], axis=-1)
        return feat

    def _load_geometry(self, data: Dict, s: str, i: int) -> None:
        """Attach precomputed rigid-invariant FPS/kNN geometry where the
        offline cache exists; it replaces the hierarchy build on the device."""
        if not self.cfg.get("use_geometry_cache", True):
            return
        # see humanml3d._load_geometry: fps-only wire / trans_enc up-skip
        fps_only = str(self.cfg.get("geometry_wire", "full")) == "fps"
        skip_up = str(self.cfg.get("geometry_arch", "")) == "trans_enc"
        for kind in ("sm", "seg"):
            f = os.path.join(
                self.data_dir, s, "contact_motion", f"geometry_{kind}", f"{i:05d}.npz"
            )
            if os.path.exists(f):
                npz = nio.load(f)
                for k in npz.files:
                    if fps_only and "_fps_idx" not in k:
                        continue
                    if skip_up and kind == "sm" and ("_up_idx" in k or "_up_weight" in k):
                        continue
                    data[k] = npz[k]

    # ---------------------------------------------------------------- packed
    def _open_packed(self, contact_type: str, contact_joints) -> None:
        """Where the JAX package would open a set's packed memmap store
        (train phases, the half_wire wire format, the geometry cache on,
        never the contacts_fur variant), the port refuses: reading the
        packed MotionX store is not ported yet, and going on from the
        ``.npz`` files would train on another wire format unasked."""
        if self.phase not in ("train", "all"):
            return
        if not (self.cfg.get("use_packed", True) and self.cfg.get("half_wire", False)):
            return
        if not self.cfg.get("use_geometry_cache", True):
            return
        for s in self.sets:
            if s == "HumanML3D" and self.sets_config.HumanML3D.get("use_fur", False):
                continue
            meta = os.path.join(self.data_dir, s, "contact_motion", "packed", "meta.json")
            if os.path.exists(meta):
                raise NotImplementedError(
                    f"the packed MotionX store ({os.path.dirname(meta)}) is not ported yet; "
                    "set task.dataset.use_packed=false to read the .npz files")

    def _obj_mask(self, data: Dict, s: str, i: int) -> None:
        if self.phase == "test":
            if s == "HUMANISE":
                data["info_obj_mask"] = nio.load(
                    os.path.join(self.data_dir, s, "contact_motion", "target_mask", f"{i:05d}.npy")
                )
            else:
                data["info_obj_mask"] = None


@DATASET.register()
class ContactMapDataset(_MotionXBase):
    """Stage-1 contact maps over the scene sets: ``x`` is the normalized
    sigma-kernel contact (or the raw distances with ``use_raw_dist``) of the
    ``data_repr`` channels; ``c_pc_feat`` the colours (and OpenScene
    features)."""

    def _read_cfg(self, cfg: Any) -> None:
        self.contact_type = cfg.data_repr
        self.contact_joints = list(cfg.data_repr_joints)
        self.use_raw_dist = cfg.use_raw_dist
        self.sigma = cfg.sigma
        self.use_color = cfg.use_color
        self.use_openscene = cfg.get("use_openscene", False)
        self.point_feat_dim = cfg.get("point_feat_dim", 32)

    def _load_datasets(self) -> None:
        self._scan_sets(filter_horizon=False)
        if not self.use_openscene:
            self._open_packed(self.contact_type, self.contact_joints)

    def _stats_path(self) -> str:
        sets = "_".join(self.sets)
        tail = (f"Mean_Std_Dist_{sets}_{self.contact_type}.npz" if self.use_raw_dist
                else f"Mean_Std_Cont_{sets}_{self.contact_type}_{self.sigma}.npz")
        path = os.path.join(self.data_dir, tail)
        if "HumanML3D" in self.sets and self.sets_config.HumanML3D.get("use_fur", False):
            path = path.replace(".npz", "_fur.npz")
        return path

    def _prepare_statistics(self) -> None:
        def compute():
            chunks = []
            for s, i, *_ in self.all_data:
                dist = nio.load(self._contact_path(s, i))["dist"].astype(np.float32)
                c = extract_contact(dist, self.contact_type, self.contact_joints)
                if not self.use_raw_dist:
                    c = gaussian_contact(c, self.sigma)
                chunks.append(c)
            return np.concatenate(chunks, axis=0)

        self.mean, self.std = compute_or_load_stats(self._stats_path(), compute)

    def __len__(self) -> int:
        return len(self.all_data)

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc = self.all_data[self._resolve(idx)]
        npz = nio.load(self._contact_path(s, i))
        points = npz["points"].astype(np.float32)
        feat = self._color_feat(points)
        if self.use_openscene:
            feat = np.concatenate([feat, self._openscene_feat(npz, s, i, scene_id)], axis=-1)
        contact = extract_contact(npz["dist"].astype(np.float32), self.contact_type,
                                  self.contact_joints)
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)

        data = {
            "x": contact,
            "c_pc_xyz": points[:, 0:3],
            "c_pc_feat": feat,
            "c_text": self._pick_text(desc),
            "info_set": s,
            "info_index": i,
            "info_scene_trans": translation_to_transform(scene_trans),
            "info_scene_mesh": self._scene_mesh_path(s, scene_id),
        }
        self._obj_mask(data, s, i)
        self._load_geometry(data, s, i)
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data

    def _openscene_feat(self, npz, s: str, i: int, scene_id: str) -> np.ndarray:
        """Distilled OpenScene features: the item's affordance file where
        ``point_feat_dim`` is 1, else the scene's features at the item's
        point mask."""
        aff = os.path.join(self.data_dir, s, "contact_motion", "affordance", f"{i:05d}.npy")
        if self.point_feat_dim == 1 and os.path.exists(aff):
            return nio.load(aff).astype(np.float32)
        feat_file = os.path.join(
            self.data_dir, s, "feat", f"{full_name(s, scene_id)}_openscene_feat_distill.npy")
        return nio.load(feat_file)[npz["mask"]]


@DATASET.register()
class ContactMotionDataset(_MotionXBase):
    """Stage-2 motion dataset conditioned on contact maps. The test phase
    reads the stage-1 handoff files
    ``{contact_folder}/{set}/pred_contact/{i:05d}.npy`` (shape (k, n, j), raw
    distances); training mixes pre-generated contacts at mix_train_ratio."""

    def _read_cfg(self, cfg: Any) -> None:
        self.motion_type = cfg.data_repr
        self.contact_type = cfg.contact_type
        self.contact_joints = list(cfg.contact_joints)
        self.use_raw_dist = cfg.use_raw_dist
        self.sigma = cfg.sigma
        self.max_horizon = cfg.max_horizon
        self.min_horizon = cfg.min_horizon
        self.mix_train_ratio = cfg.get("mix_train_ratio", 0.0)
        self.use_color = cfg.get("use_color", False)

    def __init__(self, cfg: Any, phase: str, **kwargs):
        if phase == "test":
            self.contact_folder = kwargs.get("contact_folder", "")
            assert self.contact_folder != "", (
                "specify the pre-generated contact folder for testing"
            )
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self._scan_sets(filter_horizon=True)
        self._open_packed(self.contact_type, self.contact_joints)

    def _prepare_statistics(self) -> None:
        path = os.path.join(
            self.data_dir, f"Mean_Std_CM_{'_'.join(self.sets)}_{self.motion_type}.npz"
        )

        def compute():
            chunks = []
            for s, i, *_ in self.all_data:
                m = nio.load(self._motion_path(s, i))
                chunks.append(m.reshape(m.shape[0], -1))
            return np.concatenate(chunks, axis=0)

        self.mean, self.std = compute_or_load_stats(path, compute)

    def __len__(self) -> int:
        return len(self.all_data)

    def _load_contact(self, s: str, i: int, contact: np.ndarray) -> np.ndarray:
        """``contact``: pre-extracted (P, C) per-joint distances."""
        if self.phase == "test":
            contact = nio.load(
                os.path.join(self.contact_folder, s, "pred_contact", f"{i:05d}.npy")
            )  # (k, n, j) raw distances from stage 1
        elif self.phase in ("train", "all") and np.random.random() < self.mix_train_ratio:
            f = os.path.join(self.data_dir, s, "pred_contact", f"{i:05d}.npy")
            if os.path.exists(f):
                contact = nio.load(f).squeeze(0)
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)
        return contact.astype(np.float32)

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc = self.all_data[self._resolve(idx)]
        npz = nio.load(self._contact_path(s, i))
        points3 = npz["points"].astype(np.float32)[:, 0:3]
        contact = extract_contact(
            npz["dist"].astype(np.float32), self.contact_type, self.contact_joints
        )
        motion = nio.load(self._motion_path(s, i))
        motion = motion.reshape(motion.shape[0], -1)
        padded, mask = pad_motion(np.asarray(motion), self.max_horizon)

        data = {
            "x": padded,
            "x_mask": mask,
            "c_pc_xyz": points3,
            "c_pc_contact": self._load_contact(s, i, contact),
            "c_text": self._pick_text(desc),
            "info_set": s,
            "info_index": i,
            "info_scene_trans": translation_to_transform(scene_trans),
            "info_scene_mesh": self._scene_mesh_path(s, scene_id),
        }
        self._obj_mask(data, s, i)
        self._load_geometry(data, s, i)
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return self._finalize(data)

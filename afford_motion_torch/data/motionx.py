"""MotionX dataset family over {HumanML3D, HUMANISE, PROX} (counterpart of
``afford_motion_tpu/data/motionx.py``).

Wire-compatible with the reference data directory layout:
``{set}/contact_motion/{anno.csv, motions/*.npy, contacts/*.npz,
target_mask/*.npy}``, ``{set}/{phase}.txt`` splits, per-corpus mean/std
caches, and the two-stage handoff files ``pred_contact/*.npy``.

All ten registered classes: ``MotionXDataset``, ``ContactMapDataset`` (the
stage-1 contact set of ``ts2m_contact`` and ``novel_contact``) and
``ContactMotionDataset`` (the stage-2 motion set of the scene protocol), on
``.npy`` / ``.npz`` trees and, for the two contact sets' train phases, on the
per-set packed memmap stores of ``prepare pack`` (``data/packed.py``); the
four example sets of ``sample.py`` (prompt files ``desc#set#index[#frames]``)
and the three sets of the novel-scene ``custom/`` layout (test phase only).
"""
from __future__ import annotations

import glob
import os
import random
from typing import Any, Dict, List

import numpy as np

from .. import native as nio
from ..utils.io import get_logger
from ..utils.misc import compute_repr_dimension, natsorted
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
        """Per-set packed memmap stores (``prepare pack``) for the training
        fast path: train phases only, the ``half_wire`` wire format only, the
        geometry cache on, and never for the ``contacts_fur`` variant (the
        store is packed from the default contacts). A set without a store
        compatible with ``contact_type`` / ``contact_joints`` reads its
        ``.npz`` files."""
        self._packed: Dict[str, Any] = {}
        if self.phase not in ("train", "all"):
            return
        if not (self.cfg.get("use_packed", True) and self.cfg.get("half_wire", False)):
            return
        if not self.cfg.get("use_geometry_cache", True):
            return
        from .packed import PackedStore

        for s in self.sets:
            if s == "HumanML3D" and self.sets_config.HumanML3D.get("use_fur", False):
                continue
            st = PackedStore.try_open(
                os.path.join(self.data_dir, s, "contact_motion", "packed"),
                expect={"contact_type": contact_type, "contact_joints": list(contact_joints)})
            if st is not None:
                self._packed[s] = st

    def _packed_row(self, s: str, i: int):
        """(the item's packed row or None, the set's store or None)."""
        st = getattr(self, "_packed", {}).get(s)
        return (st.row(f"{i:05d}") if st is not None else None), st

    def _attach_geometry(self, data: Dict, s: str, i: int, row, store) -> None:
        """The geometry cache's fields: from the packed row where there is
        one, else from the set's ``geometry_*`` files."""
        if row is None:
            self._load_geometry(data, s, i)
            return
        store.attach_geometry(data, row, str(self.cfg.get("geometry_arch", "")) == "trans_enc",
                              str(self.cfg.get("geometry_wire", "full")) == "fps")

    def _obj_mask(self, data: Dict, s: str, i: int) -> None:
        if self.phase == "test":
            if s == "HUMANISE":
                data["info_obj_mask"] = nio.load(
                    os.path.join(self.data_dir, s, "contact_motion", "target_mask", f"{i:05d}.npy")
                )
            else:
                data["info_obj_mask"] = None


@DATASET.register()
class MotionXDataset(_MotionXBase):
    """Text-to-motion over the scene sets: ``x`` the normalized
    ``data_repr`` motion, padded to ``max_horizon``; ``c_pc_feat`` the
    colours. No shipped config names it."""

    def _read_cfg(self, cfg: Any) -> None:
        self.motion_type = cfg.data_repr
        self.use_color = cfg.use_color
        self.min_horizon = cfg.min_horizon
        self.max_horizon = cfg.max_horizon

    def _load_datasets(self) -> None:
        self._scan_sets(filter_horizon=True)

    def _prepare_statistics(self) -> None:
        path = os.path.join(
            self.data_dir, f"Mean_Std_MotionX_{'_'.join(self.sets)}_{self.motion_type}.npz")
        dim = compute_repr_dimension(self.motion_type)

        def compute():
            return np.concatenate([nio.load(self._motion_path(s, i)).reshape(-1, dim)
                                   for s, i, *_ in self.all_data], axis=0)

        self.mean, self.std = compute_or_load_stats(path, compute)

    def __len__(self) -> int:
        return len(self.all_data)

    def _motion_item(self, s, i, scene_id, scene_trans, desc, motion) -> Dict:
        points = nio.load(self._contact_path(s, i))["points"].astype(np.float32)
        padded, mask = pad_motion(motion.reshape(motion.shape[0], -1), self.max_horizon)
        return {
            "x": padded,
            "x_mask": mask,
            "c_text": self._pick_text(desc),
            "c_pc_xyz": points[:, 0:3],
            "c_pc_feat": self._color_feat(points),
            "info_set": s,
            "info_index": i,
            "info_scene_trans": translation_to_transform(scene_trans),
            "info_scene_mesh": self._scene_mesh_path(s, scene_id),
        }

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc = self.all_data[self._resolve(idx)]
        data = self._motion_item(s, i, scene_id, scene_trans, desc,
                                 nio.load(self._motion_path(s, i)))
        self._obj_mask(data, s, i)
        self._load_geometry(data, s, i)
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data


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
        row, store = self._packed_row(s, i)
        if row is not None:
            # the packed row: f16 points and colours (the half wire), and the
            # f32 distances, so that the diffusion target is the live path's
            points3 = row["xyz16"]
            contact = row["dist32"]
            feat = np.zeros((points3.shape[0], 0), dtype=np.float32)
            if self.use_color:
                feat = (row["rgb16"].astype(np.float32) + 1) / 2.0
        else:
            npz = nio.load(self._contact_path(s, i))
            points = npz["points"].astype(np.float32)
            points3 = points[:, 0:3]
            feat = self._color_feat(points)
            if self.use_openscene:
                feat = np.concatenate([feat, self._openscene_feat(npz, s, i, scene_id)], axis=-1)
            contact = extract_contact(npz["dist"].astype(np.float32), self.contact_type,
                                      self.contact_joints)
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)

        data = {
            "x": contact,
            "c_pc_xyz": points3,
            "c_pc_feat": feat,
            "c_text": self._pick_text(desc),
            "info_set": s,
            "info_index": i,
            "info_scene_trans": translation_to_transform(scene_trans),
            "info_scene_mesh": self._scene_mesh_path(s, scene_id),
        }
        self._obj_mask(data, s, i)
        self._attach_geometry(data, s, i, row, store)
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
        row, store = self._packed_row(s, i)
        if row is not None and "motion32" in row:
            # the packed row: f16 points and distances, the raw f32 motion
            points3 = row["xyz16"]
            contact = row["dist16"].astype(np.float32)
            motion = row["motion32"][: int(row["motion_len"])]
        else:
            row = None
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
        self._attach_geometry(data, s, i, row, store)
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return self._finalize(data)


# --------------------------------------------------------------- examples
def _example_lines(path: str) -> List[List[str]]:
    """The '#'-separated fields of each line of a prompt file."""
    with open(path) as f:
        return [line.strip("\n").split("#") for line in f]


@DATASET.register()
class MotionXExampleDataset(MotionXDataset):
    """``sample.py``'s set for ``MotionXDataset``: lines
    ``desc#set#index#nframes``. With a caption and a frame count the motion
    is ``nframes`` zero frames under that caption; with either empty, the
    item's own motion and captions."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self.all_data = []
        for desc, s, index, nframes in _example_lines(self.data_path):
            index = int(index)
            scene_id, scene_trans, anno_desc = read_anno(self.data_dir, s)[index]
            motion = nio.load(self._motion_path(s, index))
            if desc == "" or nframes == "":
                descs = anno_desc
            else:
                descs = [desc]
                motion = np.zeros((int(nframes), *motion.shape[1:]), dtype=np.float32)
            self.all_data.append((s, index, scene_id, scene_trans, descs, motion))
        self.indices = None

    def __getitem__(self, idx: int) -> Dict:
        data = self._motion_item(*self.all_data[idx])
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data


@DATASET.register()
class ContactMapExampleDataset(ContactMapDataset):
    """``sample.py``'s stage-1 set: lines ``desc#set#index[#...]``, the
    item's scene under the given caption."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self.all_data = []
        for parts in _example_lines(self.data_path):
            desc, s, index = parts[0], parts[1], int(parts[2])
            scene_id, scene_trans, _ = read_anno(self.data_dir, s)[index]
            self.all_data.append((s, index, scene_id, scene_trans, [desc]))
        self.indices = None


@DATASET.register()
class ContactMotionExampleOriginDataset(ContactMotionDataset):
    """Stage-2 examples on the items' ground-truth contacts: lines
    ``desc#set#index#nframes``, of which only the set and the index are
    read (the item's captions and motion)."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        kwargs.setdefault("contact_folder", "unused")
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self.all_data = []
        for _, s, index, _ in _example_lines(self.data_path):
            index = int(index)
            scene_id, scene_trans, desc = read_anno(self.data_dir, s)[index]
            self.all_data.append((s, index, scene_id, scene_trans, desc))
        self.indices = None

    def _load_contact(self, s, i, contact):
        """``contact``: the pre-extracted (P, C) ground-truth distances; no
        ``pred_contact`` file replaces them."""
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)
        return contact.astype(np.float32)


@DATASET.register()
class ContactMotionExampleDataset(ContactMotionDataset):
    """``sample.py``'s stage-2 set: lines ``desc#set#index#nframes`` in the
    order of the stage-1 visualizer's cases, whose
    ``{contact_folder}/*-*/contact.npy`` (points then distances, natsorted)
    give the cloud and the contact; the motion is ``nframes`` zero frames."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        self._example_contact_folder = kwargs.get("contact_folder", "")
        kwargs["contact_folder"] = kwargs.get("contact_folder") or "unused"
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        pred_contacts = []
        if self._example_contact_folder:
            files = natsorted(
                glob.glob(os.path.join(self._example_contact_folder, "*-*", "contact.npy")))
            pred_contacts = [nio.load(f).astype(np.float32) for f in files]
            if not pred_contacts:
                raise FileNotFoundError(
                    f"no predicted contacts in {self._example_contact_folder}")
            if self.gpu == 0:
                logger.info(f"Load {len(pred_contacts)} predicted contacts")

        self.all_data = []
        for i, (desc, s, index, nframes) in enumerate(_example_lines(self.data_path)):
            index, nframes = int(index), int(nframes)
            scene_id, scene_trans, _ = read_anno(self.data_dir, s)[index]
            xyz, dist = pred_contacts[i][:, 0:3], pred_contacts[i][:, 3:]
            motion_shape = nio.load(self._motion_path(s, index)).shape[1:]
            motion = np.zeros((nframes, *motion_shape), dtype=np.float32)
            self.all_data.append((s, index, scene_id, scene_trans, [desc], xyz, dist, motion))
        self.indices = None

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc, xyz, dist, motion = self.all_data[idx]
        contact = dist if self.use_raw_dist else gaussian_contact(dist, self.sigma)
        padded, mask = pad_motion(motion.reshape(motion.shape[0], -1), self.max_horizon)
        data = {
            "x": padded,
            "x_mask": mask,
            "c_pc_xyz": xyz,
            "c_pc_contact": contact.astype(np.float32),
            "c_text": self._pick_text(desc),
            "info_set": s,
            "info_index": i,
            "info_scene_trans": translation_to_transform(scene_trans),
            "info_scene_mesh": self._scene_mesh_path(s, scene_id),
        }
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data


# ----------------------------------------------------------------- custom
class _CustomMixin:
    """The novel-scene ``custom`` layout: ``custom/anno.csv`` (scene id and
    translation, the utterance, its tagged tokens under ``others`` and a
    frame count under ``frame``) and ``custom/points/{i:04d}.npz`` clouds
    with 0..255 colours. Test phase only; the order is shuffled by
    ``shuffle_seed``."""

    def _scan_custom(self) -> List:
        import pandas as pd

        anno = pd.read_csv(os.path.join(self.data_dir, "custom", "anno.csv"))
        rows = []
        for i in range(len(anno)):
            scene_id = anno.loc[i]["scene_id"]
            scene_id = "" if not isinstance(scene_id, str) else scene_id
            scene_trans = np.array([anno.loc[i][f"scene_trans_{a}"] for a in "xyz"],
                                   dtype=np.float32)
            rows.append((scene_id, scene_trans, anno.loc[i]["utterance"],
                         anno.loc[i].get("others", ""), int(anno.loc[i].get("frame", 0))))
        return rows

    def _custom_points(self, i: int) -> np.ndarray:
        return nio.load(os.path.join(self.data_dir, "custom", "points", f"{i:04d}.npz")
                        )["points"].astype(np.float32)

    def _custom_data(self, make_row) -> None:
        if self.phase != "test":
            raise ValueError("the custom datasets have a test phase only")
        self.all_data = [make_row(i, *row) for i, row in enumerate(self._scan_custom())]
        self.indices = list(range(len(self.all_data)))
        random.Random(self.shuffle_seed).shuffle(self.indices)

    def _custom_fields(self, s: str, i: int, scene_id: str, scene_trans) -> Dict:
        return {"info_set": s, "info_index": i,
                "info_scene_trans": translation_to_transform(-scene_trans),
                "info_scene_mesh": os.path.join(self.data_dir, s, "scenes", f"{scene_id}.ply")}


@DATASET.register()
class MotionXCustomDataset(_CustomMixin, MotionXDataset):
    """Text-to-motion on a custom scene: ``frame`` zero frames to
    generate."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        self.motion_dim = compute_repr_dimension(cfg.data_repr)
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self._custom_data(lambda i, sid, st, desc, tok, nf: (
            "custom", i, sid, st, desc, self._custom_points(i), tok, nf))

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc, points, tokens, nframes = (
            self.all_data[self._resolve(idx)])
        data = {
            "x": np.zeros((self.max_horizon, self.motion_dim), dtype=np.float32),
            "x_mask": np.arange(self.max_horizon) >= nframes,
            "c_text": desc,
            "c_pc_xyz": points[:, 0:3],
            "c_pc_feat": self._color_feat(points, scale="byte"),
            "info_tokens": tokens,
            **self._custom_fields(s, i, scene_id, scene_trans),
        }
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data


@DATASET.register()
class ContactMapCustomDataset(_CustomMixin, ContactMapDataset):
    """Stage-1 contact maps on a custom scene."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        self.contact_dim = compute_repr_dimension(cfg.data_repr)
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self._custom_data(lambda i, sid, st, desc, _tok, _nf: (
            "custom", i, sid, st, [desc] if isinstance(desc, str) else []))

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc = self.all_data[self._resolve(idx)]
        points = self._custom_points(i)
        data = {
            "x": np.zeros((points.shape[0], self.contact_dim), dtype=np.float32),
            "c_pc_xyz": points[:, 0:3],
            "c_pc_feat": self._color_feat(points, scale="byte"),
            "c_text": desc[0] if desc else "",
            **self._custom_fields(s, i, scene_id, scene_trans),
        }
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data


@DATASET.register()
class ContactMotionCustomDataset(_CustomMixin, ContactMotionDataset):
    """Stage-2 motion on a custom scene, conditioned on the stage-1 handoff
    ``{contact_folder}/custom/pred_contact/{i:05d}.npy``."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        self.motion_dim = compute_repr_dimension(cfg.data_repr)
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self._custom_data(lambda i, sid, st, desc, tok, nf: (
            "custom", i, sid, st, desc, self._custom_points(i)[:, 0:3], tok, nf))

    def __getitem__(self, idx: int) -> Dict:
        s, i, scene_id, scene_trans, desc, xyz, tokens, nframes = (
            self.all_data[self._resolve(idx)])
        contact = nio.load(os.path.join(self.contact_folder, s, "pred_contact", f"{i:05d}.npy"))
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)
        data = {
            "x": np.zeros((self.max_horizon, self.motion_dim), dtype=np.float32),
            "x_mask": np.arange(self.max_horizon) >= nframes,
            "c_pc_xyz": xyz,
            "c_pc_contact": contact.astype(np.float32),
            "c_text": desc,
            "info_tokens": tokens,
            **self._custom_fields(s, i, scene_id, scene_trans),
        }
        data = self.transform(data)
        data["x"] = self.normalize(data["x"]).astype(np.float32)
        return data

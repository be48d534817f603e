"""HumanML3D dataset family (reference: datasets/humanml3d.py:16-801).

Wire-compatible with the reference layout:
``H3D/{train,test,all}.txt`` (string ids), ``H3D/new_joint_vecs/*.npy``
(263-d vectors), ``H3D/texts/*.txt`` ('caption#tokens#f_tag#to_tag' lines),
``H3D/Mean.npy``/``Std.npy``, ``H3D/contacts/*.npz``, and the two-stage
handoff ``{contact_folder}/H3D/pred_contact/{id}-{caption_idx}.npy``.
"""
from __future__ import annotations

import glob
import os
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.io import get_logger
from ..utils.misc import compute_repr_dimension
from ..utils.registry import DATASET
from .base import (
    BaseDataset,
    compute_or_load_stats,
    extract_contact,
    gaussian_contact,
    pad_motion,
)

logger = get_logger()

_SEGMENT_PREFIXES = "ABCDEFGHIJKLMNOPQRSTUVW"


def parse_text_file(path: str) -> List[Dict]:
    """Parse a H3D caption file: 'caption#tok/POS tok/POS ...#f_tag#to_tag'
    per line (reference: humanml3d.py:73-87)."""
    entries = []
    with open(path) as f:
        for i, line in enumerate(f):
            parts = line.strip().split("#")
            if len(parts) < 4:
                continue
            f_tag = float(parts[2]) if parts[2] not in ("", "nan") else 0.0
            to_tag = float(parts[3]) if parts[3] not in ("", "nan") else 0.0
            f_tag = 0.0 if np.isnan(f_tag) else f_tag
            to_tag = 0.0 if np.isnan(to_tag) else to_tag
            entries.append({
                "caption": parts[0],
                "tokens": parts[1].split(" "),
                "caption_idx": i,
                "f_tag": f_tag,
                "to_tag": to_tag,
            })
    return entries


def load_h3d_corpus(
    data_dir: str,
    split_file: str,
    min_horizon: int,
    ratio: float = 1.0,
) -> Tuple[Dict, List[str], np.ndarray]:
    """Build the {name: {motion, length, text}} dict with f_tag/to_tag
    sub-segments split into fresh entries (reference: humanml3d.py:48-122).
    Corrupt samples are skipped, matching the reference's broad except."""
    id_list = []
    with open(os.path.join(data_dir, "H3D", split_file)) as f:
        for line in f:
            if random.random() > ratio:
                continue
            if line.strip():
                id_list.append(line.strip())
    logger.info(f"Load {len(id_list)} cases in H3D")

    data_dict: Dict[str, Dict] = {}
    names: List[str] = []
    lengths: List[int] = []
    for name in id_list:
        try:
            motion = np.load(os.path.join(data_dir, "H3D", "new_joint_vecs", name + ".npy"))
            if np.isnan(motion).any() or len(motion) < min_horizon or len(motion) >= 200:
                continue
            full_texts = []
            for entry in parse_text_file(os.path.join(data_dir, "H3D", "texts", name + ".txt")):
                if entry["f_tag"] == 0.0 and entry["to_tag"] == 0.0:
                    full_texts.append(entry)
                else:
                    seg = motion[int(entry["f_tag"] * 20): int(entry["to_tag"] * 20)]
                    if len(seg) < min_horizon or len(seg) >= 200:
                        continue
                    new_name = random.choice(_SEGMENT_PREFIXES) + "_" + name
                    while new_name in data_dict:
                        new_name = random.choice(_SEGMENT_PREFIXES) + "_" + name
                    data_dict[new_name] = {"motion": seg, "length": len(seg), "text": [entry]}
                    names.append(new_name)
                    lengths.append(len(seg))
            if full_texts:
                data_dict[name] = {"motion": motion, "length": len(motion), "text": full_texts}
                names.append(name)
                lengths.append(len(motion))
        except Exception:
            continue

    order = np.argsort(lengths, kind="stable")
    names = [names[i] for i in order]
    lengths = [lengths[i] for i in order]
    return data_dict, names, np.asarray(lengths)


class _H3DBase(BaseDataset):
    """Shared H3D loading / shuffling / crop logic."""

    unit_length = 4

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.cfg = cfg
        self.phase = phase
        self.gpu = kwargs.get("gpu", 0)
        self.data_dir = cfg.data_dir
        self.shuffle_seed = cfg.shuffle_seed
        self.min_horizon = cfg.min_horizon
        self.max_horizon = cfg.max_horizon
        self._read_cfg(cfg)
        self._setup_transform(cfg, phase)
        self._load_datasets()
        self._prepare_statistics()

    def _read_cfg(self, cfg: Any) -> None:
        raise NotImplementedError

    def _load_corpus(self, ratio: float = 1.0) -> None:
        self.data_dict, self.name_list, self.length_arr = load_h3d_corpus(
            self.data_dir, f"{self.phase}.txt", self.min_horizon, ratio
        )
        self.indices = list(range(len(self.name_list)))
        if self.phase in ("train", "all"):
            random.shuffle(self.indices)
        elif self.phase == "test":
            # seed offset matches the reference's (shuffle_seed - 2023)
            random.Random(self.shuffle_seed - 2023).shuffle(self.indices)

    def _load_geometry(self, data: Dict, base_name: str) -> None:
        """Precomputed rigid-invariant FPS/kNN geometry (prepare.py
        geometry stage), H3D path scheme."""
        if not self.cfg.get("use_geometry_cache", True):
            return
        # geometry_wire='fps': ship only the tiny FPS indices, kNN/up are
        # recomputed on device (ops/hierarchy.build_point_hierarchy_from_fps)
        fps_only = str(self.cfg.get("geometry_wire", "full")) == "fps"
        # encoder-only SceneMap (trans_enc) never reads the 3-NN
        # up-interpolation arrays: skip those members
        skip_up = str(self.cfg.get("geometry_arch", "")) == "trans_enc"
        for kind in ("sm", "seg"):
            f = os.path.join(self.data_dir, "H3D", f"geometry_{kind}", f"{base_name}.npz")
            if os.path.exists(f):
                npz = np.load(f)
                for k in npz.files:
                    if fps_only and "_fps_idx" not in k:
                        continue
                    if skip_up and kind == "sm" and ("_up_idx" in k or "_up_weight" in k):
                        continue
                    data[k] = npz[k]

    # ---------------------------------------------------------------- packed
    def _open_packed(self, contact_type: str, contact_joints) -> None:
        """Open the packed memmap store (the prepare ``pack`` stage) for the
        training fast path. Train-only, and only under the half_wire wire
        format (the packed f16 fields are that format); silently absent
        otherwise."""
        self._packed = None
        if self.phase not in ("train", "all"):
            return
        if not (self.cfg.get("use_packed", True) and self.cfg.get("half_wire", False)):
            return
        if not self.cfg.get("use_geometry_cache", True):
            return
        from .packed import PackedStore

        self._packed = PackedStore.try_open(
            os.path.join(self.data_dir, "H3D", "packed"),
            expect={"contact_type": contact_type,
                    "contact_joints": list(contact_joints)},
        )

    def _packed_row(self, base: str):
        packed = getattr(self, "_packed", None)
        return packed.row(base) if packed is not None else None

    def _packed_geometry(self, data: Dict, row: Dict) -> None:
        self._packed.attach_geometry(
            data, row,
            str(self.cfg.get("geometry_arch", "")) == "trans_enc",
            str(self.cfg.get("geometry_wire", "full")) == "fps",
        )

    def _pick_caption(self, text_list: List[Dict], rng=None) -> Dict:
        if self.phase == "test":
            return text_list[0]  # fixed description for reproducible eval
        return (rng or random).choice(text_list)

    def _crop_motion(self, motion: np.ndarray, m_length: int) -> Tuple[np.ndarray, int]:
        """Crop to a 4-frame multiple with random start
        (reference: humanml3d.py:180-182)."""
        m_length = (m_length // self.unit_length) * self.unit_length
        start = random.randint(0, len(motion) - m_length)
        return motion[start: start + m_length], m_length

    def __len__(self) -> int:
        return len(self.indices)


@DATASET.register()
class HumanML3DDataset(_H3DBase):
    """Plain HumanML3D text-to-motion (reference: humanml3d.py:16-200)."""

    def _read_cfg(self, cfg: Any) -> None:
        self.motion_type = cfg.data_repr
        self.motion_dim = compute_repr_dimension(self.motion_type)
        self.ratio = cfg.get("ratio", 1.0)

    def _load_datasets(self) -> None:
        self._load_corpus(self.ratio)

    def _prepare_statistics(self) -> None:
        self.mean = np.load(os.path.join(self.data_dir, "H3D", "Mean.npy"))
        self.std = np.load(os.path.join(self.data_dir, "H3D", "Std.npy"))

    def __getitem__(self, idx: int) -> Dict:
        name = self.name_list[self.indices[idx]]
        item = self.data_dict[name]
        text = self._pick_caption(item["text"])
        motion, m_length = self._crop_motion(item["motion"], item["length"])
        motion = self.normalize(motion)
        padded, mask = pad_motion(motion.astype(np.float32), self.max_horizon)
        data = {
            "x": padded,
            "x_mask": mask,
            "c_text": text["caption"],
            "info_tokens": text["tokens"],
            "info_index": name.split("_")[-1],
            "info_caption_index": text["caption_idx"],
        }
        return self.transform(data)


@DATASET.register()
class HumanML3DExampleDataset(HumanML3DDataset):
    """Example-driven sampling set (reference: humanml3d.py:202-309).
    Lines: 'id#desc#length'."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self.name_list, self.desc_list, self.len_list = [], [], []
        with open(self.data_path) as f:
            for line in f:
                idx, desc, length = line.strip().split("#")
                self.name_list.append(idx)
                self.desc_list.append(desc)
                self.len_list.append(int(length) if length != "" else 0)

        self.data_dict = {}
        for name in self.name_list:
            try:
                motion = np.load(
                    os.path.join(self.data_dir, "H3D", "new_joint_vecs", name + ".npy")
                )
                if np.isnan(motion).any() or len(motion) < self.min_horizon or len(motion) >= 200:
                    self.data_dict[name] = None
                    continue
                items = []
                for entry in parse_text_file(
                    os.path.join(self.data_dir, "H3D", "texts", name + ".txt")
                ):
                    if entry["f_tag"] == 0.0 and entry["to_tag"] == 0.0:
                        items.append({"motion": motion, "length": len(motion), "text": entry})
                    else:
                        seg = motion[int(entry["f_tag"] * 20): int(entry["to_tag"] * 20)]
                        if self.min_horizon <= len(seg) < 200:
                            items.append({"motion": seg, "length": len(seg), "text": entry})
                self.data_dict[name] = random.choice(items) if items else None
            except Exception:
                self.data_dict[name] = None
        self.indices = list(range(len(self.name_list)))

    def __len__(self) -> int:
        return len(self.name_list)

    def __getitem__(self, idx: int) -> Dict:
        name = self.name_list[idx]
        desc, length = self.desc_list[idx], self.len_list[idx]
        if length != 0 and desc != "":
            motion, m_length = np.zeros((length, self.motion_dim), dtype=np.float32), length
            text = {"caption": desc, "tokens": ""}
        else:
            item = self.data_dict[name]
            assert item is not None, f"data is None, index: {idx}"
            motion, m_length, text = item["motion"], item["length"], item["text"]
        motion, m_length = self._crop_motion(motion, m_length)
        motion = self.normalize(motion)
        padded, mask = pad_motion(motion.astype(np.float32), self.max_horizon)
        data = {
            "x": padded,
            "x_mask": mask,
            "c_text": text["caption"],
            "info_tokens": text["tokens"],
            "info_index": name.split("_")[-1],
        }
        return self.transform(data)


@DATASET.register()
class ContactHumanML3DDataset(_H3DBase):
    """Stage-1 contacts over the H3D corpus (reference: humanml3d.py:311-557)."""

    def _read_cfg(self, cfg: Any) -> None:
        self.contact_type = cfg.data_repr
        self.contact_joints = list(cfg.data_repr_joints)
        self.use_raw_dist = cfg.use_raw_dist
        self.sigma = cfg.sigma

    def _load_datasets(self) -> None:
        self._load_corpus()
        self._open_packed(self.contact_type, self.contact_joints)

    def _prepare_statistics(self) -> None:
        kind = "Dist" if self.use_raw_dist else "Cont"
        suffix = (
            f"{self.contact_type}.npz" if self.use_raw_dist
            else f"{self.contact_type}_{self.sigma}.npz"
        )
        path = os.path.join(self.data_dir, f"Mean_Std_{kind}_OriH3D_{suffix}")

        def compute():
            with open(os.path.join(self.data_dir, "H3D", "all.txt")) as f:
                ids = [line.strip() for line in f if line.strip()]
            chunks = []
            for name in ids:
                cont_file = os.path.join(self.data_dir, "H3D", "contacts", name + ".npz")
                if not os.path.exists(cont_file):
                    continue
                c = extract_contact(
                    np.load(cont_file)["dist"].astype(np.float32),
                    self.contact_type, self.contact_joints,
                )
                if not self.use_raw_dist:
                    c = gaussian_contact(c, self.sigma)
                chunks.append(c)
            return np.concatenate(chunks, axis=0)

        self.mean, self.std = compute_or_load_stats(path, compute)

    def __getitem__(self, idx: int) -> Dict:
        name = self.name_list[self.indices[idx]]
        item = self.data_dict[name]
        text = self._pick_caption(item["text"])
        base = name.split("_")[-1]
        row = self._packed_row(base)
        if row is not None:
            # packed fast path: xyz already at wire dtype; dist32 is the
            # bit-identical full-precision diffusion target input
            points3 = row["xyz16"]
            contact = row["dist32"]
        else:
            npz = np.load(os.path.join(self.data_dir, "H3D", "contacts", base + ".npz"))
            points3 = npz["points"].astype(np.float32)[:, 0:3]
            contact = extract_contact(
                npz["dist"].astype(np.float32), self.contact_type, self.contact_joints
            )
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)
        contact = self.normalize(contact).astype(np.float32)
        data = {
            "x": contact,
            "c_pc_xyz": points3,
            "c_text": text["caption"],
            "info_index": base,
            "info_caption_index": text["caption_idx"],
        }
        if row is not None:
            self._packed_geometry(data, row)
        else:
            self._load_geometry(data, base)
        return self.transform(data)


@DATASET.register()
class ContactHumanML3DExampleDataset(ContactHumanML3DDataset):
    """Example-file-driven stage-1 sampling over H3D contacts. The
    reference's text_to_motion_contact_gen.yaml names this class but never
    shipped it (its sample mode was broken); lines: 'id#desc[#...]'."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        self.name_list, self.desc_list = [], []
        with open(self.data_path) as f:
            for line in f:
                parts = line.strip().split("#")
                self.name_list.append(parts[0])
                self.desc_list.append(parts[1] if len(parts) > 1 else "")
        self.data_dict = {
            name: {"text": [{"caption": desc, "tokens": [], "caption_idx": 0}]}
            for name, desc in zip(self.name_list, self.desc_list)
        }
        self.indices = list(range(len(self.name_list)))


@DATASET.register()
class ContactMotionHumanML3DDataset(_H3DBase):
    """Stage-2 motion-from-contact over H3D (reference: humanml3d.py:559-801).

    Test reads ``{contact_folder}/H3D/pred_contact/{id}-{caption_idx}.npy``;
    train mixes pre-generated contacts from
    ``H3D/pred_contact/{id}-*.npy`` at mix_train_ratio."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        if phase == "test":
            self.contact_folder = kwargs.get("contact_folder", "")
            assert self.contact_folder != "", (
                "specify the pre-generated contact folder for testing"
            )
        super().__init__(cfg, phase, **kwargs)

    def _read_cfg(self, cfg: Any) -> None:
        self.motion_type = cfg.data_repr
        self.motion_dim = compute_repr_dimension(self.motion_type)
        self.contact_type = cfg.contact_type
        self.contact_joints = list(cfg.contact_joints)
        self.use_raw_dist = cfg.use_raw_dist
        self.sigma = cfg.sigma
        self.mix_train_ratio = cfg.get("mix_train_ratio", 0.0)

    def _load_datasets(self) -> None:
        self._load_corpus()
        self._open_packed(self.contact_type, self.contact_joints)
        if self.phase in ("train", "all") and self.mix_train_ratio > 0:
            self.pred_contact_dict = defaultdict(list)
            for f in glob.glob(os.path.join(self.data_dir, "H3D", "pred_contact", "*-*.npy")):
                self.pred_contact_dict[os.path.basename(f).split("-")[0]].append(f)

    def _prepare_statistics(self) -> None:
        self.mean = np.load(os.path.join(self.data_dir, "H3D", "Mean.npy"))
        self.std = np.load(os.path.join(self.data_dir, "H3D", "Std.npy"))

    def __getitem__(self, idx: int) -> Dict:
        name = self.name_list[self.indices[idx]]
        item = self.data_dict[name]
        text = self._pick_caption(item["text"])
        base = name.split("_")[-1]

        row = self._packed_row(base)
        if row is not None:
            # packed fast path: f16 wire dtypes straight off the memmap;
            # the sigma kernel below runs in f32 (cheap) like the live path
            points = row["xyz16"]
            contact = row["dist16"].astype(np.float32)
        else:
            npz = np.load(os.path.join(self.data_dir, "H3D", "contacts", base + ".npz"))
            points = npz["points"].astype(np.float32)
            contact = extract_contact(
                npz["dist"].astype(np.float32), self.contact_type, self.contact_joints
            )
        if self.phase == "test":
            contact = np.load(
                os.path.join(
                    self.contact_folder, "H3D", "pred_contact",
                    f"{base}-{text['caption_idx']}.npy",
                )
            )
        elif self.phase in ("train", "all") and np.random.random() < self.mix_train_ratio:
            cands = getattr(self, "pred_contact_dict", {}).get(base, [])
            if cands:
                contact = np.load(np.random.choice(cands)).squeeze(0)
        if not self.use_raw_dist:
            contact = gaussian_contact(contact, self.sigma)

        motion, m_length = self._crop_motion(item["motion"], item["length"])
        motion = self.normalize(motion)
        padded, mask = pad_motion(motion.astype(np.float32), self.max_horizon)
        data = {
            "x": padded,
            "x_mask": mask,
            "c_pc_xyz": points[:, 0:3],
            "c_pc_contact": contact.astype(np.float32),
            "c_text": text["caption"],
            "info_tokens": text["tokens"],
            "info_index": base,
            "info_caption_index": text["caption_idx"],
        }
        if row is not None:
            self._packed_geometry(data, row)
        else:
            self._load_geometry(data, base)
        return self._finalize(self.transform(data))


@DATASET.register()
class ContactMotionHumanML3DExampleDataset(ContactMotionHumanML3DDataset):
    """Example-file-driven stage-2 sampling over H3D, consuming stage-1
    visualizer output ``{contact_folder}/*-*/contact.npy`` (xyz ⊕ dist).
    Named by the reference's text_to_motion_contact_motion_gen.yaml sample
    section but never shipped there; lines: 'id#desc#length'."""

    def __init__(self, cfg: Any, phase: str, **kwargs):
        self.data_path = kwargs.get("data_path", "")
        self._example_contact_folder = kwargs.get("contact_folder", "")
        kwargs["contact_folder"] = kwargs.get("contact_folder") or "unused"
        super().__init__(cfg, phase, **kwargs)

    def _load_datasets(self) -> None:
        from ..utils.misc import natsorted

        files = natsorted(
            glob.glob(os.path.join(self._example_contact_folder, "*-*", "contact.npy"))
        )
        assert files, f"no predicted contacts in {self._example_contact_folder}"
        self.examples = []
        with open(self.data_path) as f:
            for i, line in enumerate(f):
                parts = line.strip().split("#")
                name, desc = parts[0], parts[1] if len(parts) > 1 else ""
                length = int(parts[2]) if len(parts) > 2 and parts[2] else 60
                contact = np.load(files[i % len(files)]).astype(np.float32)
                self.examples.append((name, desc, length, contact))
        self.indices = list(range(len(self.examples)))

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict:
        name, desc, length, scene_contact = self.examples[idx]
        xyz, dist = scene_contact[:, 0:3], scene_contact[:, 3:]
        contact = dist if self.use_raw_dist else gaussian_contact(dist, self.sigma)
        length = (length // self.unit_length) * self.unit_length
        motion = np.zeros((self.max_horizon, self.motion_dim), dtype=np.float32)
        data = {
            "x": motion,
            "x_mask": np.arange(self.max_horizon) >= length,
            "c_pc_xyz": xyz,
            "c_pc_contact": contact.astype(np.float32),
            "c_text": desc,
            "info_tokens": [],
            "info_index": name,
            "info_caption_index": 0,
        }
        return self.transform(data)

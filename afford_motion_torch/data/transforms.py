"""CPU-side numpy data transforms (reference: datasets/transforms.py:18-215).

Same registry names so the task YAMLs' ``train_transforms`` lists work
unchanged. ``NumpyToTensor`` is a no-op here: batches stay numpy until the
device put (host→device transfer happens once, post-collate, in the loader)."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..utils.misc import transform_points


class Compose:
    def __init__(self, transforms: List[Any]):
        self.transforms = transforms

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        for t in self.transforms:
            data = t(data, *args, **kwargs)
        return data


class NumpyToTensor:
    """Kept for config compatibility; arrays remain numpy."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        return data


class _RandomFlag:
    """Shared base: sets a (1,) bool flag with probability p."""

    key = ""
    prob_key = "random_mask_prob"

    def __init__(self, **kwargs):
        self.prob = kwargs.get(self.prob_key, 0.0)

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        data[self.key] = np.full((1,), np.random.rand() < self.prob, dtype=bool)
        return data


class RandomSetLangNull:
    """CFG: replace the caption with '' with probability p
    (reference: transforms.py:31-43)."""

    def __init__(self, **kwargs):
        self.prob = kwargs.get("random_mask_prob", 0.0)

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        if np.random.rand() < self.prob:
            data["c_text"] = ""
        return data


class RandomMaskLang(_RandomFlag):
    key, prob_key = "c_text_mask", "random_mask_prob"


class RandomEraseLang(_RandomFlag):
    key, prob_key = "c_text_erase", "random_mask_prob"


class RandomMaskContact(_RandomFlag):
    key, prob_key = "c_pc_mask", "random_mask_prob_pc"


class RandomEraseContact(_RandomFlag):
    key, prob_key = "c_pc_erase", "random_mask_prob_pc"


class RandomSetContactNull:
    """CFG: zero out the contact point cloud with probability p
    (reference: transforms.py:79-88)."""

    def __init__(self, **kwargs):
        self.prob = kwargs.get("random_mask_prob_pc", 0.0)

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        if np.random.rand() < self.prob:
            data["c_pc_xyz"] = data["c_pc_xyz"] * 0
            data["c_pc_contact"] = data["c_pc_contact"] * 0
        return data


class RandomRotation:
    """Accumulate a random rotation about the gravity axis into
    info_aug_trans (reference: transforms.py:109-135)."""

    def __init__(self, **kwargs):
        self.gravity_dim = kwargs.get("gravity_dim", 2)

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        angle = np.random.uniform(-1.0, 1.0) * np.pi
        c, s = np.cos(angle), np.sin(angle)
        rot = np.eye(4, dtype=np.float32)
        if self.gravity_dim == 2:
            rot[:2, :2] = [[c, -s], [s, c]]
        elif self.gravity_dim == 1:
            rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
        else:
            rot[1, 1], rot[1, 2], rot[2, 1], rot[2, 2] = c, -s, s, c
        data["info_aug_trans"] = (
            rot @ data["info_aug_trans"] if "info_aug_trans" in data else rot
        )
        return data


class NormalizeToCenter:
    """Center xy at the bbox middle, z at the 5th height percentile
    (reference: transforms.py:137-155)."""

    def __init__(self, **kwargs):
        self.gravity_dim = kwargs.get("gravity_dim", 2)

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        xyz = data["c_pc_xyz"]
        xy_center = (xyz[:, 0:2].max(axis=0) + xyz[:, 0:2].min(axis=0)) * 0.5
        z_height = np.percentile(xyz[:, 2], 5)
        trans = np.eye(4, dtype=np.float32)
        trans[0:3, -1] -= np.array([xy_center[0], xy_center[1], z_height], dtype=np.float32)
        data["info_aug_trans"] = (
            trans @ data["info_aug_trans"] if "info_aug_trans" in data else trans
        )
        return data


class ApplyTransformCDM:
    """Apply the accumulated 4x4 to the point cloud
    (reference: transforms.py:157-170)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        data["c_pc_xyz"] = transform_points(
            data["c_pc_xyz"], data["info_aug_trans"]
        ).astype(np.float32)
        data["info_scene_trans"] = data["info_aug_trans"] @ data["info_scene_trans"]
        return data


class ApplyTransformCMDM:
    """Apply the accumulated 4x4 to points AND the (L, J*3) motion
    (reference: transforms.py:172-184)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data: Dict, *args, **kwargs) -> Dict:
        data["c_pc_xyz"] = transform_points(
            data["c_pc_xyz"], data["info_aug_trans"]
        ).astype(np.float32)
        n, c = data["x"].shape
        motion = transform_points(data["x"].reshape(-1, 3), data["info_aug_trans"])
        data["x"] = motion.reshape(n, c).astype(np.float32)
        data["info_scene_trans"] = data["info_aug_trans"] @ data["info_scene_trans"]
        return data


TRANSFORMS = {
    "NumpyToTensor": NumpyToTensor,
    "RandomSetLangNull": RandomSetLangNull,
    "RandomMaskLang": RandomMaskLang,
    "RandomEraseLang": RandomEraseLang,
    "RandomSetContactNull": RandomSetContactNull,
    "RandomMaskContact": RandomMaskContact,
    "RandomEraseContact": RandomEraseContact,
    "NormalizeToCenter": NormalizeToCenter,
    "RandomRotation": RandomRotation,
    "ApplyTransformCDM": ApplyTransformCDM,
    "ApplyTransformCMDM": ApplyTransformCMDM,
}


def make_default_transform(transforms_list: List[str], transform_cfg: Any) -> Compose:
    cfg = dict(transform_cfg) if transform_cfg else {}
    return Compose([TRANSFORMS[name](**cfg) for name in transforms_list])

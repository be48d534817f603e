"""Train / test splits (counterpart of ``afford_motion_tpu/prepare/split.py``;
reference: prepare/split.py:8-81), from each set's
``contact_motion/anno.csv``:

- HUMANISE: ScanNet scenes below 600 train, the rest test;
- PROX: a fixed list of 8 training scenes;
- HumanML3D: a seeded 0.8 split that keeps each mirror pair together (item
  i and item i + n / 2 are a motion and its mirrored twin).
"""
from __future__ import annotations

import os
import random
from typing import List

from ..utils.misc import natsorted

PROX_TRAIN_SCENES = [
    "BasementSittingBooth", "MPH11", "MPH112", "MPH8",
    "N0Sofa", "N3Library", "N3Office", "Werkraum",
]


def _write_ids(path: str, ids: List[int]) -> None:
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i:06d}\n")


def split_humanise(data_dir: str = "./data") -> None:
    import pandas as pd

    anno = pd.read_csv(os.path.join(data_dir, "HUMANISE/contact_motion/anno.csv"))
    train, test = [], []
    for i in range(len(anno)):
        scene_id = anno.loc[i]["scene_id"]
        (train if int(scene_id[5:9]) < 600 else test).append(i)
    base = os.path.join(data_dir, "HUMANISE")
    _write_ids(os.path.join(base, "train.txt"), train)
    _write_ids(os.path.join(base, "test.txt"), test)
    _write_ids(os.path.join(base, "all.txt"), list(range(len(anno))))


def split_prox(data_dir: str = "./data") -> None:
    import pandas as pd

    anno = pd.read_csv(os.path.join(data_dir, "PROX/contact_motion/anno.csv"))
    train, test = [], []
    for i in range(len(anno)):
        (train if anno.loc[i]["scene_id"] in PROX_TRAIN_SCENES else test).append(i)
    base = os.path.join(data_dir, "PROX")
    _write_ids(os.path.join(base, "train.txt"), train)
    _write_ids(os.path.join(base, "test.txt"), test)
    _write_ids(os.path.join(base, "all.txt"), list(range(len(anno))))


def split_humanml3d(data_dir: str = "./data", train_ratio: float = 0.8, seed: int = 0) -> None:
    import pandas as pd

    anno = pd.read_csv(os.path.join(data_dir, "HumanML3D/contact_motion/anno.csv"))
    n_unique = len(anno) // 2
    ids = list(range(n_unique))
    base = os.path.join(data_dir, "HumanML3D")
    with open(os.path.join(base, "all.txt"), "w") as f:
        for i in ids:
            f.write(f"{i:06d}\n{i + n_unique:06d}\n")
    rng = random.Random(seed)
    rng.shuffle(ids)
    cut = int(len(ids) * train_ratio)
    for name, subset in (("train.txt", natsorted(ids[:cut])), ("test.txt", natsorted(ids[cut:]))):
        with open(os.path.join(base, name), "w") as f:
            for i in subset:
                f.write(f"{i:06d}\n{i + n_unique:06d}\n")


SPLITS = {"HUMANISE": split_humanise, "PROX": split_prox, "HumanML3D": split_humanml3d}


def split_all(data_dir: str = "./data") -> None:
    """Every set's splits, HUMANISE, PROX, HumanML3D in turn; a set without
    its ``anno.csv`` raises ``FileNotFoundError`` naming it."""
    for split in SPLITS.values():
        split(data_dir)

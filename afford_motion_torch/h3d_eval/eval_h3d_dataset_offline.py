"""Offline HumanML3D eval datasets (counterpart of the root
``h3d_eval/eval_h3d_dataset_offline.py``; reference:
h3d_eval/eval_h3d_dataset_offline.py:14-166).

Reads the pkl dumps of ``Text2MotionInSceneHumanML3DEvaluator`` and
re-normalizes the (denormalized) motions with the T2M evaluator's mean/std,
the MDM protocol's quirk the reference documents (utils/evaluate.py:109-117).
The ground truth comes from ``H3D/new_joint_vecs`` with the same statistics.
"""
from __future__ import annotations

import glob
import os
import pickle
import random
from typing import Optional

import numpy as np

from ..data.humanml3d import load_h3d_corpus
from ..eval.eval_humanml import tokenize
from ..utils.misc import natsorted

MAX_MOTION_LEN = 196


class H3DEvalDataset:
    """Generated samples (reference: eval_h3d_dataset_offline.py:14-127): the
    first ``num_samples_limit`` files in a seeded shuffle of their natural
    order."""

    def __init__(self, eval_data_folder: str, mean: np.ndarray, std: np.ndarray,
                 w_vectorizer, num_samples_limit: Optional[int] = 1000):
        self.mean, self.std = mean, std
        self.w_vectorizer = w_vectorizer
        files = natsorted(glob.glob(os.path.join(eval_data_folder, "*.pkl")))
        random.Random(0).shuffle(files)
        if num_samples_limit:
            files = files[:num_samples_limit]
        self.items = []
        for f in files:
            with open(f, "rb") as fp:
                self.items.append(pickle.load(fp))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        data = self.items[idx]
        motion = np.asarray(data["motion"], dtype=np.float32)
        if motion.ndim == 3:  # k-sample dump; single-sample protocol uses [0]
            motion = motion[0]
        # re-normalize with the T2M eval stats (reference: :115)
        motion = (motion - self.mean) / self.std
        word_embs, pos_ohs, sent_len = tokenize(data["tokens"], self.w_vectorizer)
        m_len = int(data["m_len"])
        if motion.shape[0] < MAX_MOTION_LEN:
            motion = np.concatenate(
                [motion, np.zeros((MAX_MOTION_LEN - motion.shape[0], motion.shape[1]),
                                  dtype=np.float32)], axis=0)
        return {
            "word_embs": word_embs, "pos_ohot": pos_ohs, "caption": data["text"],
            "sent_len": np.int32(sent_len), "motion": motion[:MAX_MOTION_LEN],
            "m_len": np.int32(m_len), "tokens": "",
        }


class MMH3DEvalDataset:
    """Multi-modality k-sample dumps (reference: :129-157). Motions stay in
    the model's normalized space (MDM protocol)."""

    def __init__(self, mm_eval_data_folder: str, w_vectorizer, mm_num_samples: int = 100):
        files = natsorted(glob.glob(os.path.join(mm_eval_data_folder, "*.pkl")))
        random.Random(0).shuffle(files)
        self.items = []
        for f in files:
            with open(f, "rb") as fp:
                data = pickle.load(fp)
            motion = np.asarray(data["motion"], dtype=np.float32)
            if motion.ndim != 3:
                continue
            self.items.append({"k_motions": motion, "m_len": int(data["m_len"])})
            if len(self.items) >= mm_num_samples:
                break

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        it = self.items[idx]
        return {"k_samples": it["k_motions"],
                "x_mask": np.arange(it["k_motions"].shape[1]) >= it["m_len"]}


class H3DGTEvalDataset:
    """Ground-truth corpus from ``H3D/new_joint_vecs`` with the eval stats.
    Seeds the global ``random`` stream with 0: the corpus's split draws and
    each item's caption draw come from it, in loader order."""

    def __init__(self, data_dir: str, mean: np.ndarray, std: np.ndarray,
                 w_vectorizer, split: str = "test", min_horizon: int = 24):
        self.mean, self.std = mean, std
        self.w_vectorizer = w_vectorizer
        random.seed(0)
        self.data_dict, self.names, _ = load_h3d_corpus(data_dir, f"{split}.txt", min_horizon)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        item = self.data_dict[self.names[idx]]
        text = random.choice(item["text"])
        motion = (item["motion"] - self.mean) / self.std
        m_len = item["length"]
        if motion.shape[0] < MAX_MOTION_LEN:
            motion = np.concatenate(
                [motion, np.zeros((MAX_MOTION_LEN - motion.shape[0], motion.shape[1]))], axis=0
            )
        word_embs, pos_ohs, sent_len = tokenize(text["tokens"], self.w_vectorizer)
        return {
            "word_embs": word_embs, "pos_ohot": pos_ohs, "caption": text["caption"],
            "sent_len": np.int32(sent_len),
            "motion": motion[:MAX_MOTION_LEN].astype(np.float32),
            "m_len": np.int32(m_len), "tokens": "",
        }

"""The HumanML3D metric protocol (counterpart of
``afford_motion_tpu/eval/eval_humanml.py``; reference:
utils/eval/eval_humanml.py:1-183 + utils/eval/get_data.py).

Matching Score / R-Precision@3 / FID / Diversity / MultiModality of
generated motions against the ground-truth corpus through the frozen
text-motion matching evaluator. The loader's batches are the R-precision
pools; each pool is uploaded to the evaluator's device once
(:class:`DeviceResidentPool`) and extracted in chunks of a fixed number of
pools, so two runs see the same batches and give the same bytes.

FID reads the ground-truth motion embeddings of the matching pass: the
motion half of a co-embedding is the same computation on the same chunk as
a motion embedding, so there is no second pass over the ground truth.

Caption draws (``EvalGTDataset.__getitem__``) come from the global
``random`` stream in loader order, as in the JAX package, so the loaders
run without a prefetch thread. Diversity and MultiModality draw from one
``np.random.RandomState(seed)``, in the JAX package's order.

On the card, turn TF32 off for cuBLAS and cuDNN before calling these
(``eval/t2m_models.py``).
"""
from __future__ import annotations

import os
import random
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.loader import DataLoader
from .evaluator_wrapper import EvaluatorWrapper
from .metrics import (
    calculate_activation_statistics,
    calculate_diversity,
    calculate_frechet_distance,
    calculate_multimodality,
    calculate_top_k,
    euclidean_distance_matrix,
)
from .word_vectorizer import create_word_vectorizer

MAX_TEXT_LEN = 20
EXTRACT_POOLS = 8


def tokenize(tokens, w_vectorizer, max_text_len: int = MAX_TEXT_LEN):
    """'word/POS' token list -> (word_embs, pos_onehots, sent_len)
    (reference: get_data.py:104-126)."""
    if isinstance(tokens, str):
        tokens = tokens.split(" ")
    tokens = [t for t in tokens if t]
    if len(tokens) < max_text_len:
        tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
        sent_len = len(tokens)
        tokens = tokens + ["unk/OTHER"] * (max_text_len + 2 - sent_len)
    else:
        tokens = ["sos/OTHER"] + tokens[:max_text_len] + ["eos/OTHER"]
        sent_len = len(tokens)
    embs, ohs = zip(*(w_vectorizer[t] for t in tokens))
    return (
        np.stack(embs).astype(np.float32),
        np.stack(ohs).astype(np.float32),
        sent_len,
    )


class EvalGTDataset:
    """Ground-truth eval corpus (reference: get_data.py:17-131): motions and
    captions of ``HumanML3D/contact_motion``, normalized by the eval-time
    mean/std of ``{eval_meta_dir}/meta/mean_std.npz``."""

    def __init__(self, data_dir: str, eval_meta_dir: str, split: str = "test",
                 min_motion_len: int = 24, max_motion_len: int = 196):
        import pandas as pd

        self.max_motion_len = max_motion_len
        ms = np.load(os.path.join(eval_meta_dir, "meta", "mean_std.npz"))
        self.mean, self.std = ms["mean"], ms["std"]
        self.w_vectorizer = create_word_vectorizer(os.path.join(eval_meta_dir, "glove"))

        with open(os.path.join(eval_meta_dir, "meta", f"{split}.txt")) as f:
            id_list = {int(line.strip()) for line in f if line.strip()}

        anno = pd.read_csv(os.path.join(data_dir, "HumanML3D", "contact_motion", "anno.csv"))
        self.all_data = []
        for i in range(len(anno)):
            if i not in id_list:
                continue
            desc = anno.loc[i]["utterance"]
            desc = [] if not isinstance(desc, str) or desc == "" else desc.split("$$")
            token = anno.loc[i].get("others", "")
            token = [] if not isinstance(token, str) or token == "" else token.split("$$")
            token = [t.split(" ") for t in token]
            if len(desc) != len(token):
                token = [[] for _ in desc]
            motion = np.load(
                os.path.join(data_dir, "HumanML3D", "contact_motion", "motions", f"{i:05d}.npy")
            )
            motion = motion.reshape(motion.shape[0], -1)
            if not (min_motion_len <= motion.shape[0] <= max_motion_len):
                continue
            self.all_data.append((i, motion, len(motion), list(zip(desc, token))))

        self.indices = list(range(len(self.all_data)))
        if split == "test":
            random.Random(0).shuffle(self.indices)
        else:
            random.shuffle(self.indices)

    def normalize(self, x):
        return (x - self.mean) / self.std

    def __len__(self):
        return len(self.all_data)

    def __getitem__(self, idx):
        i, motion, m_len, text_list = self.all_data[self.indices[idx]]
        desc, tokens = random.choice(text_list)
        word_embs, pos_ohs, sent_len = tokenize(tokens, self.w_vectorizer)
        motion = self.normalize(motion)
        if m_len < self.max_motion_len:
            motion = np.concatenate(
                [motion, np.zeros((self.max_motion_len - m_len, motion.shape[1]))], axis=0
            )
        return {
            "word_embs": word_embs, "pos_ohot": pos_ohs, "caption": desc,
            "sent_len": np.int32(sent_len), "motion": motion.astype(np.float32),
            "m_len": np.int32(m_len), "tokens": "_".join(tokens) if tokens else "",
        }


class EvalGenDataset:
    """Generated-sample wrapper (reference: get_data.py:134-174)."""

    def __init__(self, sample_list: List[Dict], w_vectorizer):
        self.samples = sample_list
        self.w_vectorizer = w_vectorizer

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        data = self.samples[idx]
        motion, x_mask = data["sample"], data["x_mask"]
        tokens = data.get("info_tokens", "")
        word_embs, pos_ohs, sent_len = tokenize(tokens, self.w_vectorizer)
        return {
            "word_embs": word_embs, "pos_ohot": pos_ohs, "caption": data["c_text"],
            "sent_len": np.int32(sent_len), "motion": np.asarray(motion, dtype=np.float32),
            "m_len": np.int32((~np.asarray(x_mask)).sum()),
            "tokens": "_".join(tokens) if isinstance(tokens, list) else str(tokens),
        }


def _batches(dataset, batch_size: int, drop_last: bool = True) -> DataLoader:
    """The protocol's pools: batches in dataset order, the last partial one
    dropped, built in this thread (the caption draws are in loader order)."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=drop_last,
                      prefetch=0)


_CAT_KEYS = ("word_embs", "pos_ohot", "sent_len", "motion", "m_len")
_DEVICE_KEYS = ("word_embs", "pos_ohot", "motion")  # all but a few bytes of a pool


class DeviceResidentPool:
    """A loader's pools held on the evaluator's device: ``word_embs``,
    ``pos_ohot`` and ``motion`` uploaded once as f32 tensors, each
    extraction chunk a slice of them. Lengths stay on the host, where the
    length order is computed."""

    def __init__(self, batches, device: torch.device):
        batches = list(batches)
        if not batches:
            raise ValueError("no pool: fewer items than the batch size")
        self.sizes = [len(np.asarray(b["m_len"])) for b in batches]
        self.host = {
            k: np.concatenate([np.asarray(b[k]) for b in batches], axis=0)
            for k in ("sent_len", "m_len")
        }
        self.dev = {
            k: torch.as_tensor(np.concatenate([np.asarray(b[k], dtype=np.float32)
                                               for b in batches], axis=0)).to(device)
            for k in _DEVICE_KEYS
        }
        self.bounds = np.concatenate([[0], np.cumsum(self.sizes)]).astype(int)

    @property
    def nbytes(self) -> int:
        """Bytes of the pool on the device."""
        return sum(t.numel() * t.element_size() for t in self.dev.values())

    def chunks(self, extract_pools: int, keys: Sequence[str] = _CAT_KEYS):
        """Yield ``(cat, sizes)`` per extraction chunk: full groups of
        ``extract_pools`` pools, then the tail's pools one by one."""
        n = len(self.sizes)
        groups = [
            list(range(a, a + extract_pools))
            for a in range(0, n - n % extract_pools, extract_pools)
        ] + [[i] for i in range(n - n % extract_pools, n)]
        for g in groups:
            a, b = int(self.bounds[g[0]]), int(self.bounds[g[-1] + 1])
            cat = {k: (self.dev[k] if k in self.dev else self.host[k])[a:b] for k in keys}
            yield cat, [self.sizes[i] for i in g]


def evaluate_matching_score(wrapper: EvaluatorWrapper, pools: Dict[str, DeviceResidentPool],
                            extract_pools: int = EXTRACT_POOLS):
    """Matching score, R-precision@1..3 and the motion embeddings of each
    named pool set (reference: eval_humanml.py:8-50). A chunk of
    ``extract_pools`` pools is one call of the evaluator; the embeddings stay
    on the device until the pool set's last chunk; the statistics are per
    pool, in the JAX package's order."""
    match_score, r_precision, activations = OrderedDict(), OrderedDict(), OrderedDict()
    for name, pool in pools.items():
        texts, motions, chunk_sizes = [], [], []
        for cat, sizes in pool.chunks(extract_pools):
            te, me = wrapper.get_co_embeddings(
                cat["word_embs"], cat["pos_ohot"], cat["sent_len"],
                cat["motion"], cat["m_len"], unsort=True, device_out=True,
            )
            texts.append(te)
            motions.append(me)
            chunk_sizes.append(sizes)
        text_all = torch.cat(texts).cpu().numpy()
        motion_all = torch.cat(motions).cpu().numpy()
        score_sum, top_k_count, size, o = 0.0, np.zeros(3), 0, 0
        for sizes in chunk_sizes:
            for n in sizes:
                te, me = text_all[o: o + n], motion_all[o: o + n]
                dist = euclidean_distance_matrix(te, me)
                score_sum += dist.trace()
                top_k_count += calculate_top_k(np.argsort(dist, axis=1), 3).sum(axis=0)
                size += n
                o += n
        match_score[name] = score_sum / max(size, 1)
        r_precision[name] = top_k_count / max(size, 1)
        activations[name] = motion_all
    return match_score, r_precision, activations


def evaluate_fid(gt_activations: np.ndarray, activations: Dict[str, np.ndarray]):
    """FID of every named embedding set against the ground truth's
    (reference: eval_humanml.py:53-74)."""
    gt_mu, gt_cov = calculate_activation_statistics(gt_activations)
    return OrderedDict(
        (name, calculate_frechet_distance(gt_mu, gt_cov, *calculate_activation_statistics(emb)))
        for name, emb in activations.items()
    )


def evaluate_diversity(activations: Dict[str, np.ndarray], diversity_times: int,
                       rng: np.random.RandomState):
    return OrderedDict(
        (name, calculate_diversity(emb, min(diversity_times, emb.shape[0] - 1), rng))
        for name, emb in activations.items()
    )


def evaluate_multimodality_metric(wrapper: EvaluatorWrapper, k_samples_list, mm_num_times: int,
                                  rng: np.random.RandomState,
                                  extract_groups: int = EXTRACT_POOLS) -> float:
    """MultiModality over k-sample groups (reference: eval_humanml.py:53-74).
    A chunk of ``extract_groups`` groups is one evaluator call where their
    motions share a shape; a run of another shape is a call of its own, so
    groups of different (k, frames) give a result. Where k differs between
    groups, each group's first k of the smallest k enter the statistic."""
    if not k_samples_list:
        return 0.0
    groups = [(np.asarray(ks["k_samples"], dtype=np.float32), int((~ks["x_mask"]).sum()))
              for ks in k_samples_list]
    embs = []
    for a in range(0, len(groups), extract_groups):
        chunk = groups[a: a + extract_groups]
        runs = [[chunk[0]]]
        for g in chunk[1:]:
            if g[0].shape == runs[-1][-1][0].shape:
                runs[-1].append(g)
            else:
                runs.append([g])
        for run in runs:
            cat = np.concatenate([g[0] for g in run], axis=0)
            lens = np.concatenate([np.full((len(g[0]),), g[1], dtype=np.int32) for g in run])
            emb = wrapper.get_motion_embeddings(cat, lens, unsort=True)
            o = 0
            for g in run:
                embs.append(emb[o: o + len(g[0])])
                o += len(g[0])
    k = min(len(e) for e in embs)
    embs = np.stack([e[:k] for e in embs])
    if embs.shape[1] <= mm_num_times:
        mm_num_times = max(embs.shape[1] - 1, 1)
    return calculate_multimodality(embs, mm_num_times, rng)


def eval_humanml(
    sample_list: List[Dict],
    k_samples_list: List[Dict],
    dataloader,
    *,
    data_dir: Optional[str] = None,
    eval_meta_dir: str = "./data/eval",
    ckpt_path: str = "./data/eval/text_motion_match/text_mot_match_scenediff2_ckpt/finest.tar",
    batch_size: int = 16,
    diversity_times: int = 32,
    mm_num_times: int = 10,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Dict[str, List]]:
    """The in-process protocol with the 'ours' evaluator (66-d joint
    positions; reference: eval_humanml.py:164-183). Needs the evaluator
    checkpoint and the eval meta (mean/std, split; GloVe, else hash
    vectors) on disk: a missing file raises ``FileNotFoundError``."""
    wrapper = EvaluatorWrapper(ckpt_path, variant="ours", device=device)
    data_dir = data_dir or getattr(dataloader.dataset, "data_dir", "./data")

    gt = EvalGTDataset(data_dir, eval_meta_dir)
    gen = EvalGenDataset(sample_list, gt.w_vectorizer)
    pools = OrderedDict()
    pools["ground truth"] = DeviceResidentPool(_batches(gt, batch_size), wrapper.device)
    pools["vald"] = DeviceResidentPool(_batches(gen, batch_size), wrapper.device)

    rng = np.random.RandomState(seed)
    match_score, r_precision, activations = evaluate_matching_score(wrapper, pools)
    fid = evaluate_fid(activations["ground truth"], activations)
    diversity = evaluate_diversity(activations, diversity_times, rng)
    mm = evaluate_multimodality_metric(wrapper, k_samples_list, mm_num_times, rng)

    all_metrics = OrderedDict()
    all_metrics["Matching Score"] = {k: [v] for k, v in match_score.items()}
    all_metrics["R_precision"] = {k: [v] for k, v in r_precision.items()}
    all_metrics["FID"] = {k: [v] for k, v in fid.items()}
    all_metrics["Diversity"] = {k: [v] for k, v in diversity.items()}
    all_metrics["MultiModality"] = {"vald": [mm]}
    return all_metrics

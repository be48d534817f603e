"""The batches of a training run, worked out plainly from the corpus
generator's items and the run's seed: the dataset's item order, the order
in which the device store's index stream visits the items, the host's
draws of every megabatch, and the assembly of a step's batch on the card
(the f16 wires of the motion, the cloud, the contact and the caption)."""
from __future__ import annotations

import hashlib
import json
import random
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.harness import corpus

UNIT_LENGTH = 4
MAX_LENGTH = 200  # motions of this many frames or more are left out


@lru_cache(maxsize=512)
def _item(params_key: Tuple, i: int) -> Dict:
    return corpus.make_item(dict(params_key), i)


def item(params: Dict, i: int) -> Dict:
    return _item(_key(params), i)


def _key(params: Dict) -> Tuple:
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in params.items()))


def item_order(params: Dict, seed: int, min_horizon: int) -> Tuple[List[int], List[int]]:
    """(the items sorted by length, stably, as the dataset lists them; the
    shuffled positions it draws from): the train list read in file order,
    one draw of the run's ``random`` a line, then one shuffle."""
    rnd = random.Random(seed)
    kept, lengths = [], []
    for i in range(int(params["items"])):
        rnd.random()
        n = corpus.item_length(params, i)
        if min_horizon <= n < MAX_LENGTH:
            kept.append(i)
            lengths.append(n)
    order = np.argsort(lengths, kind="stable")
    names = [kept[j] for j in order]
    positions = list(range(len(names)))
    rnd.shuffle(positions)
    return names, positions


def megabatch_ids(n_items: int, G: int, B: int, gi: int, seed: int) -> np.ndarray:
    """Positions of megabatch ``gi``: each pass over the corpus is one
    seeded permutation cut into chunks of G B (the loader's shuffle seed
    is the run's seed)."""
    chunk = G * B
    per_pass = max(1, n_items // chunk)
    ep, c = divmod(gi, per_pass)
    order = np.random.default_rng((seed * 977 + seed * 9176 + ep) & 0x7FFFFFFF).permutation(
        n_items)
    return order[c * chunk:(c + 1) * chunk]


def draw_motion_batch(params: Dict, names: List[int], positions: List[int], ids: np.ndarray,
                      gi: int, seed: int, flags: List[Tuple[str, float]]) -> Dict:
    """Stage 2's host draws for megabatch ``gi``: per item the caption and
    the crop start from the megabatch's ``random.Random``, then from its
    ``RandomState`` the contact-mix draw and one draw a CFG flag."""
    py = random.Random((seed * 1000003 + gi) & 0xFFFFFFFF)
    npr = np.random.RandomState((seed * 69069 + gi * 40503 + 12345) & 0x7FFFFFFF)
    out = {"item": [], "caption": [], "start": [], "length": [],
           **{k: [] for k, _ in flags}}
    for idx in ids:
        i = names[positions[int(idx)]]
        it = item(params, i)
        out["item"].append(i)
        out["caption"].append(py.choice(it["captions"]))
        L = it["motion"].shape[0]
        m_len = (L // UNIT_LENGTH) * UNIT_LENGTH
        out["start"].append(py.randint(0, L - m_len))
        out["length"].append(m_len)
        npr.random()  # the contact mix: no item of the corpus has a mixed contact
        for key, p in flags:
            out[key].append(bool(npr.rand() < p))
    return out


def draw_contact_batch(params: Dict, names: List[int], positions: List[int], ids: np.ndarray,
                       gi: int, seed: int) -> Dict:
    """Stage 1's host draws: the caption of each item."""
    py = random.Random((seed * 1000003 + gi) & 0xFFFFFFFF)
    out = {"item": [], "caption": []}
    for idx in ids:
        i = names[positions[int(idx)]]
        out["item"].append(i)
        out["caption"].append(py.choice(item(params, i)["captions"]))
    return out


def sorted_clouds(params: Dict, items: List[int], joints: List[int], device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The items' clouds in curve order on ``device``: xyz (B, N, 3) f32 and
    the distances of the contact joints (B, N, J) f32."""
    from .geometry import hilbert_order

    its = [item(params, i) for i in items]
    xyz = torch.from_numpy(np.stack([it["points"][:, :3] for it in its])).to(device)
    dist = torch.from_numpy(np.stack([it["dist"][:, joints] for it in its])).to(device)
    order = hilbert_order(xyz)[..., None]
    return (torch.take_along_dim(xyz, order, dim=1),
            torch.take_along_dim(dist, order, dim=1))


def text_batch(params: Dict, captions: List[str], device) -> torch.Tensor:
    """(B, 1, 512) f32 of the f16 caption wire."""
    emb = np.stack([corpus.text_embedding(params, c) for c in captions])[:, None, :]
    return torch.from_numpy(emb.astype(np.float16)).to(device).float()


def motion_batch(params: Dict, draws: Dict, rows: slice, horizon: int, device):
    """(x (B, H, D) f32 of the f16 motion wire, mask (B, H) True = padding)
    of the cropped, normalized (mean 0, std 1) motions."""
    xs, masks = [], []
    for i, s, n in zip(draws["item"][rows], draws["start"][rows], draws["length"][rows]):
        m = item(params, i)["motion"].astype(np.float16)
        x = np.zeros((horizon, m.shape[1]), np.float16)
        x[:n] = m[s:s + n]
        xs.append(x)
        masks.append(np.arange(horizon) >= n)
    return (torch.from_numpy(np.stack(xs)).to(device).float(),
            torch.from_numpy(np.stack(masks)).to(device))


def contact_stats(params: Dict, joints: List[int], sigma: float,
                  cache: Optional[Path] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1's normalization: mean and std (1, J) over every item's
    kernel exp(-d^2 / (2 sigma^2)), the items' own row order (the sums round
    otherwise than over the program's curve-sorted rows, by far less than
    any limit). Kept in ``cache`` (the reference's own file, keyed by the
    corpus and the kernel) once worked out."""
    key = hashlib.sha256(json.dumps([_key(params), joints, sigma]).encode()).hexdigest()[:16]
    path = None if cache is None else Path(cache) / f"reference-stats-{key}.npz"
    if path is not None and path.exists():
        with np.load(path) as f:
            return f["mean"], f["std"]
    chunks = [np.exp(-0.5 * corpus.make_item(params, i)["dist"][:, joints].astype(np.float32)
                     ** 2 / sigma ** 2) for i in range(int(params["items"]))]
    values = np.concatenate(chunks, axis=0)
    mean, std = values.mean(axis=0, keepdims=True), values.std(axis=0, keepdims=True)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, mean=mean, std=std)
    return mean, std

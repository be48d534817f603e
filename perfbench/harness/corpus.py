"""The benchmark's training corpus: a HumanML3D-layout tree generated from a
fixed corpus seed, and its prepared copy.

Every item is a pure function of (corpus seed, item index): a motion of
``frames`` lengths and ``motion_dim`` features, ``captions`` captions of a
few motion words, and a room-like contact cloud (a floor and boxes of
furniture, the pattern of the synthetic rooms the port's tests use) with
each point's distance to the 22 joints of a body standing in the room. The
plain reference regenerates the items it needs from the same function;
the program reads the files.

The tree is written once per checkout under the benchmark's cache folder,
keyed by the corpus parameters and this file's text, and taken through the
program's own ``prepare`` stages named by the traffic file (``sort``,
``geometry``, ``pack``). Captions are embedded by a table the generator
writes beside the tree (``text_embeddings.npz``: unit-norm vectors, one a
caption, drawn from the caption's text and the corpus seed): the program's
text encoder reads it as it reads a precomputed CLIP table.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np

N_JOINTS = 22
TEXT_DIM = 512

WORDS = ("a person walks forward and sits down on the chair", "someone picks up a box from the table",
         "the man turns left then walks to the sofa", "a woman lies down on the bed slowly",
         "he steps back and leans against the wall", "the person jogs in a circle",
         "she stands up from the stool and stretches", "walks toward the desk and opens a drawer",
         "a person kneels on the floor and ties a shoe", "turns around and sits on the armchair")

# a standing body's joints relative to the pelvis (metres; x right, y forward, z up):
# pelvis, hips, spine, knees, spine, ankles, spine, feet, neck, collars, head,
# shoulders, elbows, wrists
_SKELETON = np.array([
    [0.0, 0.0, 0.0], [0.1, 0.0, -0.08], [-0.1, 0.0, -0.08], [0.0, 0.0, 0.12],
    [0.11, 0.02, -0.48], [-0.11, 0.02, -0.48], [0.0, 0.0, 0.25], [0.12, 0.0, -0.88],
    [-0.12, 0.0, -0.88], [0.0, 0.0, 0.3], [0.12, 0.1, -0.93], [-0.12, 0.1, -0.93],
    [0.0, 0.0, 0.52], [0.08, 0.0, 0.45], [-0.08, 0.0, 0.45], [0.0, 0.02, 0.65],
    [0.18, 0.0, 0.46], [-0.18, 0.0, 0.46], [0.22, 0.0, 0.2], [-0.22, 0.0, 0.2],
    [0.24, 0.02, -0.04], [-0.24, 0.02, -0.04]], dtype=np.float32)


def item_name(i: int) -> str:
    return f"{i:06d}"


def item_length(params: Dict, i: int) -> int:
    """The frames of item ``i``'s motion: the first draw of its generator."""
    lo, hi = params["frames"]
    return int(np.random.default_rng([int(params["seed"]), int(i)]).integers(lo, hi + 1))


def make_item(params: Dict, i: int) -> Dict:
    """Item ``i``: ``motion`` (L, motion_dim) f32, ``captions`` (list of
    str), ``points`` (N, 6) f32 (xyz, colour in [0, 1]) and ``dist`` (N, 22)
    f32, the distance of every point to every joint."""
    rng = np.random.default_rng([int(params["seed"]), int(i)])
    lo, hi = params["frames"]
    length = int(rng.integers(lo, hi + 1))
    motion = rng.standard_normal((length, int(params["motion_dim"]))).astype(np.float32)
    captions = []
    for _ in range(int(params["captions"])):
        words = WORDS[int(rng.integers(len(WORDS)))].split()
        n = int(rng.integers(3, len(words) + 1))
        captions.append(" ".join(words[:n]) + f" {int(rng.integers(1000))}")
    n_points, size = int(params["points"]), float(params["room_size"])
    xyz = np.empty((n_points, 3), np.float32)
    floor = n_points // 2
    xyz[:floor, :2] = rng.uniform(-size / 2, size / 2, size=(floor, 2))
    xyz[:floor, 2] = rng.normal(scale=0.005, size=floor)
    rest = n_points - floor
    centers = rng.uniform(-size / 3, size / 3, size=(8, 2))
    which = rng.integers(0, 8, size=rest)
    xyz[floor:, :2] = centers[which] + rng.uniform(-0.4, 0.4, size=(rest, 2))
    xyz[floor:, 2] = rng.uniform(0.0, 1.2, size=rest)
    rgb = rng.uniform(0.0, 1.0, size=(n_points, 3)).astype(np.float32)
    pelvis = np.array([*rng.uniform(-size / 3, size / 3, size=2), 0.93], np.float32)
    joints = pelvis + _SKELETON + rng.normal(scale=0.02, size=_SKELETON.shape).astype(np.float32)
    dist = np.sqrt(((xyz[:, None, :] - joints[None]) ** 2).sum(-1)).astype(np.float32)
    return {"motion": motion, "captions": captions,
            "points": np.concatenate([xyz, rgb], axis=1), "dist": dist}


def text_embedding(params: Dict, caption: str) -> np.ndarray:
    """The table's embedding of ``caption``: a unit-norm gaussian drawn from
    the caption's crc32 and the corpus seed."""
    rng = np.random.default_rng([int(params["seed"]), zlib.crc32(caption.encode())])
    v = rng.standard_normal(TEXT_DIM).astype(np.float32)
    return v / np.linalg.norm(v)


def corpus_key(params: Dict, stages: List[str]) -> str:
    """The cache key: the corpus parameters, the prepare stages and this
    file's text."""
    text = Path(__file__).read_text()
    blob = json.dumps({"params": params, "stages": stages}, sort_keys=True) + text
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_tree(params: Dict, root: Path) -> None:
    """The HumanML3D layout (``H3D/new_joint_vecs``, ``texts``, ``contacts``,
    ``Mean.npy``, ``Std.npy``, ``train.txt``, ``test.txt``, ``all.txt``) and
    the caption table, under ``root``."""
    h3d = root / "H3D"
    for sub in ("new_joint_vecs", "texts", "contacts"):
        (h3d / sub).mkdir(parents=True, exist_ok=True)
    names, table = [], {}
    for i in range(int(params["items"])):
        item = make_item(params, i)
        name = item_name(i)
        names.append(name)
        np.save(h3d / "new_joint_vecs" / f"{name}.npy", item["motion"])
        lines = []
        for cap in item["captions"]:
            tokens = " ".join(f"{w}/X" for w in cap.split())
            lines.append(f"{cap}#{tokens}#0.0#0.0")
            table[cap] = text_embedding(params, cap)
        (h3d / "texts" / f"{name}.txt").write_text("\n".join(lines) + "\n")
        np.savez(h3d / "contacts" / f"{name}.npz", points=item["points"], dist=item["dist"])
    dim = int(params["motion_dim"])
    np.save(h3d / "Mean.npy", np.zeros(dim, np.float32))
    np.save(h3d / "Std.npy", np.ones(dim, np.float32))
    (h3d / "train.txt").write_text("\n".join(names) + "\n")
    (h3d / "all.txt").write_text("\n".join(names) + "\n")
    (h3d / "test.txt").write_text("")
    texts = sorted(table)
    np.savez(root / "text_embeddings.npz", texts=np.array(texts),
             embeddings=np.stack([table[t] for t in texts]))


def ensure(params: Dict, stages: List[str], cache: Path, device: str) -> Path:
    """The prepared corpus's directory, made once: the tree written to a
    temporary folder beside it, taken through the program's ``prepare``
    ``stages`` on ``device``, then renamed into place."""
    final = cache / f"corpus-{corpus_key(params, stages)}"
    if (final / "READY").exists():
        return final
    work = cache / f"{final.name}.partial"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_tree(params, work)
    from afford_motion_torch import prepare

    for stage in stages:
        argv = [stage, "--dataset", "H3D", "--out_dir", str(work)]
        if stage == "geometry":
            argv += ["--device", device]
        prepare.main(argv)
    (work / "READY").write_text("")
    shutil.rmtree(final, ignore_errors=True)
    os.replace(work, final)
    return final

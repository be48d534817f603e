"""Synthetic data-directory generator.

Creates a miniature data tree with EXACTLY the reference's on-disk layout
so end-to-end train/test/bench runs work without
the real AMASS/HUMANISE/PROX data: anno.csv + contact_motion/{motions,
contacts}/ + split txts for the MotionX sets, and H3D/{new_joint_vecs,
texts, Mean.npy, Std.npy, contacts, train/test/all.txt}.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def make_synthetic_motionx_set(
    root: str,
    set_name: str,
    n_items: int = 8,
    num_points: int = 256,
    n_joints: int = 22,
    horizon_range=(24, 60),
    seed: int = 0,
    test_items: Optional[int] = None,
) -> None:
    """``test_items``: how many of the last items form the test split (the
    last quarter when None)."""
    rng = np.random.default_rng(seed)
    base = Path(root) / set_name
    (base / "contact_motion" / "motions").mkdir(parents=True, exist_ok=True)
    (base / "contact_motion" / "contacts").mkdir(parents=True, exist_ok=True)
    (base / "contact_motion" / "contacts_fur").mkdir(parents=True, exist_ok=True)
    (base / "contact_motion" / "target_mask").mkdir(parents=True, exist_ok=True)
    (base / "scenes").mkdir(parents=True, exist_ok=True)

    rows = ["scene_id,scene_trans_x,scene_trans_y,scene_trans_z,utterance"]
    for i in range(n_items):
        L = int(rng.integers(*horizon_range))
        motion = rng.normal(size=(L, n_joints, 3)).astype(np.float32)
        np.save(base / "contact_motion" / "motions" / f"{i:05d}.npy", motion)

        points = rng.normal(size=(num_points, 6)).astype(np.float32)
        points[:, 3:6] = np.clip(points[:, 3:6], -1, 1)
        dist = np.abs(rng.normal(size=(num_points, n_joints))).astype(np.float32)
        mask = np.zeros(num_points, dtype=bool)
        np.savez(base / "contact_motion" / "contacts" / f"{i:05d}.npz",
                 points=points, dist=dist, mask=mask)
        np.savez(base / "contact_motion" / "contacts_fur" / f"{i:05d}.npz",
                 points=points, dist=dist, mask=mask)
        np.save(base / "contact_motion" / "target_mask" / f"{i:05d}.npy",
                rng.random(num_points) < 0.1)
        rows.append(f"scene{i},0.0,0.0,0.0,walk to the chair$$sit down")

    (base / "contact_motion" / "anno.csv").write_text("\n".join(rows) + "\n")
    ids = list(range(n_items))
    split = n_items * 3 // 4 if test_items is None else n_items - test_items
    (base / "train.txt").write_text("\n".join(str(i) for i in ids[:split]) + "\n")
    (base / "test.txt").write_text("\n".join(str(i) for i in ids[split:]) + "\n")
    (base / "all.txt").write_text("\n".join(str(i) for i in ids) + "\n")
    (base / "train_without_mirror.txt").write_text(
        "\n".join(str(i) for i in ids[:split]) + "\n"
    )
    (base / "test_without_mirror.txt").write_text(
        "\n".join(str(i) for i in ids[split:]) + "\n"
    )


def make_synthetic_h3d(
    root: str,
    n_items: int = 8,
    num_points: int = 256,
    n_joints: int = 22,
    dim: int = 263,
    horizon_range=(28, 80),
    seed: int = 1,
) -> None:
    rng = np.random.default_rng(seed)
    base = Path(root) / "H3D"
    (base / "new_joint_vecs").mkdir(parents=True, exist_ok=True)
    (base / "texts").mkdir(parents=True, exist_ok=True)
    (base / "contacts").mkdir(parents=True, exist_ok=True)

    names = [f"{i:06d}" for i in range(n_items)]
    for i, name in enumerate(names):
        L = int(rng.integers(*horizon_range))
        np.save(base / "new_joint_vecs" / f"{name}.npy",
                rng.normal(size=(L, dim)).astype(np.float32))
        (base / "texts" / f"{name}.txt").write_text(
            "a person walks forward#a/DET person/NOUN walk/VERB forward/ADV#0.0#0.0\n"
            "someone strolls ahead#someone/NOUN stroll/VERB ahead/ADV#0.0#0.0\n"
        )
        points = rng.normal(size=(num_points, 6)).astype(np.float32)
        dist = np.abs(rng.normal(size=(num_points, n_joints))).astype(np.float32)
        np.savez(base / "contacts" / f"{name}.npz", points=points, dist=dist)

    np.save(base / "Mean.npy", np.zeros(dim, dtype=np.float32))
    np.save(base / "Std.npy", np.ones(dim, dtype=np.float32))
    split = n_items * 3 // 4
    (base / "train.txt").write_text("\n".join(names[:split]) + "\n")
    (base / "test.txt").write_text("\n".join(names[split:]) + "\n")
    (base / "all.txt").write_text("\n".join(names) + "\n")


def make_synthetic_h3d_protocol(
    root: str,
    n_train: int = 64,
    n_test: int = 4384,
    num_points: int = 8192,
    n_joints: int = 22,
    dim: int = 263,
    horizon_range=(40, 199),
    seed: int = 11,
    contacts: bool = True,
) -> None:
    """Protocol-scale synthetic H3D tree for eval-rehearsal runs.

    Same on-disk layout as :func:`make_synthetic_h3d` but with independent
    train/test split sizes so the test split can match the reference's real
    HumanML3D eval corpus (4,384 test sequences feed both the generation
    loop and the offline protocol's GT pools —
    reference h3d_eval/eval_h3d_dataset_offline.py:129-160) while the train
    split stays small (only used to mint a checkpoint). Scene point clouds
    are written at the production 8,192-point resolution for every item so
    the test-time conditioning I/O cost is shape-honest; ``contacts=False``
    writes only the motions, texts and splits, all the offline protocol
    reads (the clouds of 4,448 items are ~4 GB).
    """
    rng = np.random.default_rng(seed)
    base = Path(root) / "H3D"
    (base / "new_joint_vecs").mkdir(parents=True, exist_ok=True)
    (base / "texts").mkdir(parents=True, exist_ok=True)
    if contacts:
        (base / "contacts").mkdir(parents=True, exist_ok=True)

    n_items = n_train + n_test
    names = [f"{i:06d}" for i in range(n_items)]
    for name in names:
        L = int(rng.integers(*horizon_range))
        np.save(base / "new_joint_vecs" / f"{name}.npy",
                rng.normal(size=(L, dim)).astype(np.float32))
        (base / "texts" / f"{name}.txt").write_text(
            "a person walks forward#a/DET person/NOUN walk/VERB forward/ADV#0.0#0.0\n"
            "someone strolls ahead#someone/NOUN stroll/VERB ahead/ADV#0.0#0.0\n"
        )
        if contacts:
            points = rng.normal(size=(num_points, 6)).astype(np.float32)
            dist = np.abs(rng.normal(size=(num_points, n_joints))).astype(np.float32)
            np.savez(base / "contacts" / f"{name}.npz", points=points, dist=dist)

    np.save(base / "Mean.npy", np.zeros(dim, dtype=np.float32))
    np.save(base / "Std.npy", np.ones(dim, dtype=np.float32))
    (base / "train.txt").write_text("\n".join(names[:n_train]) + "\n")
    (base / "test.txt").write_text("\n".join(names[n_train:]) + "\n")
    (base / "all.txt").write_text("\n".join(names) + "\n")


# 'word/POS' tokens of the synthetic captions: the words of the H3D texts
# above and of the HumanML3D contact_motion set below, with some of each VIP
# list (``eval/word_vectorizer.py``)
SYNTHETIC_TOKENS = (
    "a/DET", "the/DET", "person/NOUN", "someone/NOUN", "man/NOUN", "woman/NOUN",
    "walk/VERB", "stroll/VERB", "run/VERB", "sit/VERB", "stand/VERB", "turn/VERB",
    "jump/VERB", "kick/VERB", "wave/VERB", "pick/VERB", "forward/ADV", "ahead/ADV",
    "slowly/ADV", "quickly/ADV", "left/ADV", "right/ADV", "back/ADV", "up/ADP",
    "down/ADP", "to/ADP", "on/ADP", "with/ADP", "chair/NOUN", "floor/NOUN", "ball/NOUN",
    "window/NOUN", "hand/NOUN", "arm/NOUN", "leg/NOUN", "two/NUM", "three/NUM",
    "his/PRON", "her/PRON", "then/ADV", "and/CCONJ", "circle/NOUN",
)


def synthetic_caption(rng, n_tokens: int):
    """(caption, 'word/POS' tokens) of ``n_tokens`` drawn from
    :data:`SYNTHETIC_TOKENS`."""
    tokens = [SYNTHETIC_TOKENS[i] for i in rng.integers(0, len(SYNTHETIC_TOKENS), n_tokens)]
    return " ".join(t.split("/")[0] for t in tokens), tokens


def make_synthetic_glove(glove_dir: str, dim: int = 300, seed: int = 0) -> None:
    """A GloVe triple in the T2M files' format (``our_vab_data.npy``, the
    vectors; ``our_vab_words.pkl``, the word list; ``our_vab_idx.pkl``, word
    -> row) over the synthetic captions' words and ``sos``, ``eos``, ``unk``,
    with seeded vectors."""
    import pickle

    words = ["sos", "eos", "unk"] + sorted({t.split("/")[0] for t in SYNTHETIC_TOKENS}
                                           | {"walks", "strolls"})
    rng = np.random.default_rng(seed)
    os.makedirs(glove_dir, exist_ok=True)
    np.save(os.path.join(glove_dir, "our_vab_data.npy"),
            rng.normal(size=(len(words), dim)).astype(np.float32))
    with open(os.path.join(glove_dir, "our_vab_words.pkl"), "wb") as f:
        pickle.dump(words, f)
    with open(os.path.join(glove_dir, "our_vab_idx.pkl"), "wb") as f:
        pickle.dump({w: i for i, w in enumerate(words)}, f)


def make_synthetic_eval_meta(eval_meta_dir: str, test_ids: Sequence[int] = (),
                             seed: int = 0) -> None:
    """What the HumanML3D metrics read beside the evaluator checkpoint, in
    the real formats: ``meta/mean_std.npz`` (66-d, the in-process 'ours'
    evaluator's), ``meta/t2m_mean_std.npz`` (263-d, the offline 'mdm'
    protocol's), ``meta/test.txt`` (the in-process ground truth's ids of
    ``HumanML3D/contact_motion``) and the GloVe triple under ``glove/``."""
    rng = np.random.default_rng(seed)
    meta = Path(eval_meta_dir) / "meta"
    meta.mkdir(parents=True, exist_ok=True)
    for name, dim in (("mean_std", 66), ("t2m_mean_std", 263)):
        np.savez(meta / f"{name}.npz", mean=(rng.normal(size=dim) * 0.1).astype(np.float32),
                 std=rng.uniform(0.5, 1.5, size=dim).astype(np.float32))
    (meta / "test.txt").write_text("".join(f"{i}\n" for i in test_ids))
    make_synthetic_glove(str(Path(eval_meta_dir) / "glove"), seed=seed + 1)


def make_synthetic_h3d_contact_motion(root: str, n_items: int = 64, n_joints: int = 22,
                                      horizon_range=(40, 197), seed: int = 5) -> None:
    """The in-process HumanML3D ground truth's layout,
    ``HumanML3D/contact_motion/{anno.csv, motions/{i:05d}.npy}``: (L, 22, 3)
    joint positions, two captions an item with their tokens (``utterance``
    and ``others``, '$$'-separated)."""
    rng = np.random.default_rng(seed)
    base = Path(root) / "HumanML3D" / "contact_motion"
    (base / "motions").mkdir(parents=True, exist_ok=True)
    rows = ["scene_id,scene_trans_x,scene_trans_y,scene_trans_z,utterance,others"]
    for i in range(n_items):
        L = int(rng.integers(*horizon_range))
        np.save(base / "motions" / f"{i:05d}.npy",
                rng.normal(size=(L, n_joints, 3)).astype(np.float32))
        caps = [synthetic_caption(rng, int(rng.integers(3, 12))) for _ in range(2)]
        rows.append(f"scene{i},0.0,0.0,0.0,{'$$'.join(c for c, _ in caps)},"
                    f"{'$$'.join(' '.join(t) for _, t in caps)}")
    (base / "anno.csv").write_text("\n".join(rows) + "\n")


def make_synthetic_t2m_ckpt(path: str, dim_pose: int = 263, dim_move: int = 512,
                            dim_word: int = 300, dim_pos: int = 15,
                            hid_text: int = 512, hid_motion: int = 1024,
                            coemb: int = 512, strip: bool = True, seed: int = 0) -> None:
    """Random-weight torch ``finest.tar`` with the real T2M evaluator layout
    (reference: evaluator_wrapper.py:200-216 keys movement/text/motion
    encoder) so the checkpoint's load is exercised end-to-end without the
    gated file. The weights are torch's initial draws from ``seed``: at that
    scale the embeddings depend on the input (the JAX package's copy shrinks
    them by 0.2, and its embeddings hardly do)."""
    import torch
    import torch.nn as nn

    torch.manual_seed(seed)

    class Movement(nn.Module):
        def __init__(self):
            super().__init__()
            self.main = nn.Sequential(
                nn.Conv1d(dim_pose - 4 if strip else dim_pose, dim_move, 4, 2, 1),
                nn.Dropout(0.2), nn.LeakyReLU(0.2),
                nn.Conv1d(dim_move, dim_move, 4, 2, 1),
                nn.Dropout(0.2), nn.LeakyReLU(0.2),
            )
            self.out_net = nn.Linear(dim_move, dim_move)

    class Text(nn.Module):
        def __init__(self):
            super().__init__()
            self.pos_emb = nn.Linear(dim_pos, dim_word)
            self.input_emb = nn.Linear(dim_word, hid_text)
            self.gru = nn.GRU(hid_text, hid_text, batch_first=True, bidirectional=True)
            self.output_net = nn.Sequential(
                nn.Linear(hid_text * 2, hid_text), nn.LayerNorm(hid_text),
                nn.LeakyReLU(0.2), nn.Linear(hid_text, coemb))
            self.hidden = nn.Parameter(torch.randn(2, 1, hid_text))

    class Motion(nn.Module):
        def __init__(self):
            super().__init__()
            self.input_emb = nn.Linear(dim_move, hid_motion)
            self.gru = nn.GRU(hid_motion, hid_motion, batch_first=True, bidirectional=True)
            self.output_net = nn.Sequential(
                nn.Linear(hid_motion * 2, hid_motion), nn.LayerNorm(hid_motion),
                nn.LeakyReLU(0.2), nn.Linear(hid_motion, coemb))
            self.hidden = nn.Parameter(torch.randn(2, 1, hid_motion))

    move, text, motion = Movement(), Text(), Motion()
    torch.save({
        "movement_encoder": move.state_dict(),
        "text_encoder": text.state_dict(),
        "motion_encoder": motion.state_dict(),
        "epoch": 1,
    }, path)


def make_synthetic_custom(
    root: str,
    n_items: int = 4,
    num_points: int = 256,
    seed: int = 7,
) -> None:
    """The novel-set 'custom' layout (custom/anno.csv with others/frame
    columns + custom/points/*.npz) driving the *CustomDataset classes."""
    rng = np.random.default_rng(seed)
    base = Path(root) / "custom"
    (base / "points").mkdir(parents=True, exist_ok=True)
    (base / "scenes").mkdir(parents=True, exist_ok=True)
    rows = ["scene_id,scene_trans_x,scene_trans_y,scene_trans_z,utterance,others,frame"]
    for i in range(n_items):
        points = rng.normal(size=(num_points, 6)).astype(np.float32)
        points[:, 3:6] = rng.integers(0, 255, size=(num_points, 3))
        np.savez(base / "points" / f"{i:04d}.npz", points=points)
        rows.append(
            f"scene{i},0.0,0.0,0.0,walk to the window,"
            f"walk/VERB to/ADP the/DET window/NOUN,48"
        )
    (base / "anno.csv").write_text("\n".join(rows) + "\n")


def make_synthetic_data_dir(
    root: str,
    sets: Sequence[str] = ("HumanML3D", "HUMANISE", "PROX"),
    n_items: int = 8,
    num_points: int = 256,
) -> str:
    """Full miniature data tree covering every dataset class."""
    os.makedirs(root, exist_ok=True)
    for k, s in enumerate(sets):
        make_synthetic_motionx_set(root, s, n_items, num_points, seed=k)
    make_synthetic_h3d(root, n_items, num_points)
    make_synthetic_custom(root, max(2, n_items // 2), num_points)
    return root


# ------------------------------------------------------------- raw releases
HUMANISE_ACTIONS = ("sit", "stand up", "walk", "lie")


def write_scene_ply(path, xyz: np.ndarray, rgb: np.ndarray, faces: Optional[np.ndarray] = None,
                    ascii: bool = False) -> None:
    """A scene mesh as ScanNet writes its ``_vh_clean_2.ply``: vertices of
    float x, y, z and uchar red, green, blue, alpha, then triangles; binary
    little-endian, or ascii (6 decimals) without faces."""
    n = len(xyz)
    faces = np.zeros((0, 3), np.int32) if faces is None or ascii else faces
    head = ["ply", f"format {'ascii' if ascii else 'binary_little_endian'} 1.0",
            f"element vertex {n}", "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green", "property uchar blue",
            "property uchar alpha", f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        if ascii:
            f.write("".join(f"{x:.6f} {y:.6f} {z:.6f} {r} {g} {b} 255\n"
                            for (x, y, z), (r, g, b) in zip(xyz, rgb)).encode("ascii"))
            return
        vert = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                                  ("green", "u1"), ("blue", "u1"), ("alpha", "u1")])
        for k, name in enumerate("xyz"):
            vert[name] = xyz[:, k]
        for k, name in enumerate(("red", "green", "blue")):
            vert[name] = rgb[:, k]
        vert["alpha"] = 255
        f.write(vert.tobytes())
        face = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", (3,))])
        face["n"], face["v"] = 3, faces
        f.write(face.tobytes())


def _room(rng, n_points: int, size: float = 6.0):
    """A room's points: a floor and a few boxes of furniture; xyz (N, 3)
    float32 and rgb (N, 3) uint8."""
    xyz = np.empty((n_points, 3), np.float32)
    floor = n_points // 2
    xyz[:floor, :2] = rng.uniform(-size / 2, size / 2, size=(floor, 2))
    xyz[:floor, 2] = rng.normal(scale=0.005, size=floor)
    rest = n_points - floor
    centers = rng.uniform(-size / 3, size / 3, size=(8, 2))
    which = rng.integers(0, 8, size=rest)
    xyz[floor:, :2] = centers[which] + rng.uniform(-0.4, 0.4, size=(rest, 2))
    xyz[floor:, 2] = rng.uniform(0.0, 1.2, size=rest)
    rgb = rng.integers(0, 256, size=(n_points, 3)).astype(np.uint8)
    return xyz, rgb


def make_synthetic_raw_humanise(raw_dir: str, data_dir: str, n_scenes: int = 2,
                                scene_points: int = 2048, n_motions: int = 6,
                                horizon_range=(20, 61), seed: int = 0,
                                empty_caption: Optional[int] = None) -> List[str]:
    """The raw HUMANISE release at its layout under ``raw_dir``: pure motions
    ``pure_motion/<action>/<id>/motion.pkl`` (the 9-tuple gender, transl,
    global orient, betas (16,), body pose (L, 63), hand pose (L, 90), jaw,
    eyes, joints (L, 22, 3) whose joint 0 is the pelvis) and the aligned
    annotations ``align_data_release/<action>/<batch>/anno.pkl`` (a list of
    dicts: motion, action, rotation, translation, scene, scene_translation,
    object_id, object_semantic_label, utterance); ScanNet's scenes under
    ``<data_dir>/HUMANISE/scenes/<id>/``: ``<id>_vh_clean_2.ply`` of
    ``scene_points`` points, the segments ``<id>_vh_clean_2.0.010000.segs.json``
    and their objects ``<id>.aggregation.json``. The scene numbers spread
    over 0..700, so that both splits are non-empty; ``empty_caption`` is an
    annotation whose utterance is empty. Returns the scene ids."""
    import json
    import pickle

    rng = np.random.default_rng(seed)
    raw, data = Path(raw_dir), Path(data_dir)
    numbers = [round(k * 700 / max(n_scenes - 1, 1)) for k in range(n_scenes)]
    scenes = [f"scene{n:04d}_00" for n in numbers]
    n_objects = {}
    for sid in scenes:
        sdir = data / "HUMANISE" / "scenes" / sid
        xyz, rgb = _room(rng, scene_points)
        faces = rng.integers(0, scene_points, size=(scene_points // 2, 3)).astype(np.int32)
        write_scene_ply(sdir / f"{sid}_vh_clean_2.ply", xyz, rgb, faces)
        # segments: 0.5 m cells of the floor plan; objects: groups of cells
        cell = np.floor((xyz[:, :2] + 3.0) / 0.5).astype(np.int64)
        seg = cell[:, 0] * 16 + cell[:, 1]
        segs = np.unique(seg)
        groups = np.array_split(rng.permutation(segs), 6)
        n_objects[sid] = len(groups)
        (sdir / f"{sid}_vh_clean_2.0.010000.segs.json").write_text(json.dumps(
            {"sceneId": sid, "segIndices": seg.tolist()}))
        (sdir / f"{sid}.aggregation.json").write_text(json.dumps({"sceneId": sid, "segGroups": [
            {"id": k, "objectId": k, "label": f"object{k}", "segments": g.tolist()}
            for k, g in enumerate(groups)]}))
    annos = {}
    for i in range(n_motions):
        action = HUMANISE_ACTIONS[i % len(HUMANISE_ACTIONS)]
        motion_id = f"{i:05d}"
        L = int(rng.integers(*horizon_range))
        heading = rng.uniform(0, 2 * np.pi)
        step = np.array([np.cos(heading), np.sin(heading), 0.0]) * (0.01 if action == "walk"
                                                                   else 0.002)
        trans = (np.arange(L)[:, None] * step + rng.normal(scale=0.003, size=(L, 3))
                 + [0.0, 0.0, 0.9]).astype(np.float32)
        pelvis_offset = rng.normal(scale=0.02, size=3).astype(np.float32)
        joints = (trans[:, None, :] + pelvis_offset
                  + rng.normal(scale=0.3, size=(1, 22, 3)).astype(np.float32))
        joints[:, 0, :] = trans + pelvis_offset
        motion = ("neutral", trans, rng.normal(scale=0.3, size=(L, 3)).astype(np.float32),
                  rng.normal(scale=0.5, size=16).astype(np.float32),
                  rng.normal(scale=0.3, size=(L, 63)).astype(np.float32),
                  rng.normal(scale=0.2, size=(L, 90)).astype(np.float32),
                  np.zeros((L, 3), np.float32), np.zeros((L, 6), np.float32),
                  joints.astype(np.float32))
        mdir = raw / "pure_motion" / action / motion_id
        mdir.mkdir(parents=True, exist_ok=True)
        with open(mdir / "motion.pkl", "wb") as f:
            pickle.dump(motion, f)
        sid = scenes[i % n_scenes]
        annos.setdefault(action, []).append({
            "motion": motion_id, "action": action,
            "rotation": float(rng.uniform(-np.pi, np.pi)),
            "translation": rng.uniform(-1.5, 1.5, size=3).astype(np.float32) * [1, 1, 0],
            "scene": sid, "scene_translation": rng.normal(scale=0.2, size=3).astype(np.float32),
            "object_id": int(rng.integers(0, n_objects[sid])),
            "object_semantic_label": "chair" if action == "sit" else "floor",
            "utterance": "" if i == empty_caption else f"{action} to the object number {i}",
        })
    for action, rows in annos.items():
        adir = raw / "align_data_release" / action / "batch0"
        adir.mkdir(parents=True, exist_ok=True)
        with open(adir / "anno.pkl", "wb") as f:
            pickle.dump(rows, f)
    return scenes


PROX_SCENES = ("MPH11", "N3Office", "MPH16")


def make_synthetic_raw_prox(raw_dir: str, data_dir: str, n_frames=(12, 9),
                            scene_points: int = 2048, seed: int = 0) -> List[str]:
    """The PROX fittings at their layout: ``<raw_dir>/<scene>_<subject>_<n>/
    results/s<k>/000.pkl`` (one frame each: transl, global_orient, body_pose
    (1, 63), betas (1, 10)), one sequence of ``n_frames[i]`` frames a scene;
    ``<data_dir>/PROX/cam2world/<scene>.json`` (and a ``_``-named file the
    extractor skips) and the scenes ``<data_dir>/PROX/scenes/<scene>.ply``,
    the last one ascii. Returns the sequences."""
    import json
    import pickle

    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    raw, prox = Path(raw_dir), Path(data_dir) / "PROX"
    (prox / "cam2world").mkdir(parents=True, exist_ok=True)
    sequences = []
    for k, (scene, frames) in enumerate(zip(PROX_SCENES, n_frames)):
        xyz, rgb = _room(rng, scene_points)
        write_scene_ply(prox / "scenes" / f"{scene}.ply", xyz, rgb,
                        ascii=k == len(n_frames) - 1)
        cam = np.eye(4)
        cam[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.5, size=3)).as_matrix()
        cam[:3, 3] = rng.uniform(-2, 2, size=3)
        (prox / "cam2world" / f"{scene}.json").write_text(json.dumps(cam.tolist()))
        seq = f"{scene}_{159 + k}_{k:02d}"
        for f in range(frames):
            fdir = raw / seq / "results" / f"s{f:03d}"
            fdir.mkdir(parents=True, exist_ok=True)
            with open(fdir / "000.pkl", "wb") as fp:
                pickle.dump({
                    "transl": rng.normal(scale=0.5, size=(1, 3)).astype(np.float32),
                    "global_orient": rng.normal(scale=0.5, size=(1, 3)).astype(np.float32),
                    "body_pose": rng.normal(scale=0.3, size=(1, 63)).astype(np.float32),
                    "betas": rng.normal(scale=0.5, size=(1, 10)).astype(np.float32),
                }, fp)
        sequences.append(seq)
    (prox / "cam2world" / f"{PROX_SCENES[0]}_second.json").write_text(
        json.dumps(np.eye(4).tolist()))
    return sequences


def make_synthetic_raw_amass(root: str, seed: int = 0) -> tuple:
    """AMASS SMPL-X sequences (``<root>/amass/smplx_neutral/<dataset>/<subject>/
    <name>_stageii.npz``: trans, root_orient, pose_body (T, 63), pose_hand
    (T, 90), betas (16,)), their SMPL-H frame rates
    (``<root>/amass/smplh/.../<name>_poses.npz`` with ``mocap_framerate``) and
    HumanML3D's index CSV (source_path, start_frame, end_frame, new_name).
    The index also names a humanact12 sequence, one without its SMPL-X file,
    one without its SMPL-H file and one whose SMPL-H file has no frame rate,
    each of which the extractor leaves out. Returns (the SMPL-X directory,
    the index CSV's path)."""
    rng = np.random.default_rng(seed)
    base = Path(root) / "amass"
    smplx, smplh = base / "smplx_neutral", base / "smplh"
    rows = ["source_path,start_frame,end_frame,new_name"]
    specs = [("KIT/3/walk_01", 100, True, True), ("MPI_HDM05/bk/sit 02", 120, True, True),
             ("CMU/07/run_03", 60, True, True), ("KIT/4/missing_04", 60, False, True),
             ("KIT/4/nofps_05", 60, True, False), ("KIT/4/nokey_06", 60, True, "nokey")]
    for n, (rel, fps, has_x, has_h) in enumerate(specs):
        T = int(rng.integers(240, 400))
        if has_x:
            path = smplx / f"{rel}_stageii.npz".replace(" ", "_")
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(path, trans=rng.normal(size=(T, 3)), root_orient=rng.normal(size=(T, 3)),
                     pose_body=rng.normal(size=(T, 63)), pose_hand=rng.normal(size=(T, 90)),
                     betas=rng.normal(size=16))
        if has_h:
            path = smplh / f"{rel}_poses.npz"
            path.parent.mkdir(parents=True, exist_ok=True)
            if has_h == "nokey":
                np.savez(path, trans=np.zeros((1, 3)))
            else:
                np.savez(path, mocap_framerate=np.array(float(fps)))
        rows.append(f"./pose_data/{rel}_poses.npy,{2 + n},{30 + 4 * n},{n:06d}.npy")
    rows.append("./pose_data/humanact12/humanact12/P01G01R01F0001T0064A0101.npy,0,20,"
                "000099.npy")
    index = base / "index.csv"
    index.write_text("\n".join(rows) + "\n")
    return str(smplx), str(index)

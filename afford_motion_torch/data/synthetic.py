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

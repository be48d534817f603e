"""GloVe word vectorizer + POS one-hots (counterpart of
``afford_motion_tpu/eval/word_vectorizer.py``; numpy only)
(reference: utils/eval/word_vectorizer.py:1-80). Loads the T2M GloVe files
('our_vab_{data.npy,words.pkl,idx.pkl}'); tokens are 'word/POS' with VIP
word categories overriding the POS tag."""
from __future__ import annotations

import pickle
from os.path import join as pjoin

import numpy as np

POS_enumerator = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

Loc_list = ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
            "forward", "back", "backward", "up", "down", "straight", "curve")
Body_list = ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
             "waist", "eye", "knee", "shoulder", "thigh")
Obj_List = ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
            "handrail", "baseball", "basketball")
Act_list = ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
            "throw", "hop", "dance", "jump", "turn", "stumble", "dance",
            "stop", "sit", "lift", "lower", "raise", "wash", "stand", "kneel",
            "stroll", "rub", "bend", "balance", "flap", "jog", "shuffle",
            "lean", "rotate", "spin", "spread", "climb")
Desc_list = ("slowly", "carefully", "fast", "careful", "slow", "quickly",
             "happy", "angry", "sad", "happily", "angrily", "sadly")

VIP_dict = {
    "Loc_VIP": Loc_list,
    "Body_VIP": Body_list,
    "Obj_VIP": Obj_List,
    "Act_VIP": Act_list,
    "Desc_VIP": Desc_list,
}


class WordVectorizer:
    def __init__(self, meta_root: str, prefix: str):
        vectors = np.load(pjoin(meta_root, f"{prefix}_data.npy"))
        with open(pjoin(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(pjoin(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            word2idx = pickle.load(f)
        self.word2vec = {w: vectors[word2idx[w]] for w in words}
        self.dim = vectors.shape[1]

    def _get_pos_ohot(self, pos: str) -> np.ndarray:
        vec = np.zeros(len(POS_enumerator), dtype=np.float32)
        vec[POS_enumerator.get(pos, POS_enumerator["OTHER"])] = 1
        return vec

    def __len__(self) -> int:
        return len(self.word2vec)

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            vip_pos = None
            for key, values in VIP_dict.items():
                if word in values:
                    vip_pos = key
                    break
            pos_vec = self._get_pos_ohot(vip_pos if vip_pos is not None else pos)
        else:
            word_vec = self.word2vec.get("unk", np.zeros(self.dim, dtype=np.float32))
            pos_vec = self._get_pos_ohot("OTHER")
        return word_vec, pos_vec


class HashWordVectorizer(WordVectorizer):
    """Deterministic fallback when the GloVe files are unavailable
    (zero-egress deployments, unit tests): unit-norm vectors seeded by the
    word hash, same POS/VIP semantics."""

    def __init__(self, dim: int = 300):
        self.word2vec = {}
        self.dim = dim

    def __getitem__(self, item: str):
        import hashlib

        word, pos = item.split("/")
        if word not in self.word2vec:
            if word == "unk":
                vec = np.zeros(self.dim, dtype=np.float32)
            else:
                seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:8], "little")
                vec = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
                vec /= np.linalg.norm(vec) + 1e-8
            self.word2vec[word] = vec
        vip_pos = None
        for key, values in VIP_dict.items():
            if word in values:
                vip_pos = key
                break
        return self.word2vec[word], self._get_pos_ohot(vip_pos if vip_pos is not None else pos)


def create_word_vectorizer(meta_root: str, prefix: str = "our_vab"):
    """The GloVe triple under ``meta_root``, or the hash vectors, with a
    warning, where it is missing. A triple that is there but does not read
    raises: its metrics would not be the protocol's."""
    try:
        return WordVectorizer(meta_root, prefix)
    except FileNotFoundError:
        import logging
        logging.getLogger("afford_motion_torch").warning(
            "GloVe files not found under %s; using hash word vectors", meta_root
        )
        return HashWordVectorizer()

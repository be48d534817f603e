"""The text towers' tokenizers, read from a Hugging Face model directory:
the slow ``BertTokenizer`` (WordPiece) and ``CLIPTokenizer`` (byte-level
BPE) that the JAX package runs through ``transformers``, written out here
step for step so that the ids are the same.

``CLIPTokenizer`` is followed on the route it takes without ``ftfy``: a
basic tokenizer that cleans and lower-cases, then the pre-split pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` (case-insensitive), here a scanner over
``unicodedata.category``: the standard ``re`` module has no ``\\p{L}``, and
``[^\\W\\d_]`` is another class.
"""
from __future__ import annotations

import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BERT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                 "cls_token": "[CLS]", "mask_token": "[MASK]"}
CLIP_SPECIALS = {"unk_token": "<|endoftext|>", "bos_token": "<|startoftext|>",
                 "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
CLIP_CONTEXT = 77  # CLIP's positions; the JAX encoder zero-pads every caption to it
WORDPIECE_MAX_CHARS = 100
# the most merges CLIPTokenizer reads from merges.txt (after its first line)
CLIP_MAX_MERGES = 49152 - 256 - 2
_CLIP_LITERALS = ("<|startoftext|>", "<|endoftext|>")
_CLIP_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _read_json(path: Path) -> dict:
    if not path.is_file():
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _required(model_dir: Path, name: str) -> Path:
    path = model_dir / name
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: the tokenizer needs it")
    return path


def special_tokens(model_dir: Path, defaults: Dict[str, str]) -> Dict[str, str]:
    """The special tokens of ``defaults``' roles as ``tokenizer_config.json``
    names them, else ``special_tokens_map.json``, else the defaults. A token
    may be a string or ``{"content": ...}``."""
    config = _read_json(model_dir / "tokenizer_config.json")
    mapping = _read_json(model_dir / "special_tokens_map.json")
    out = {}
    for role, default in defaults.items():
        tok = config.get(role, mapping.get(role, default))
        out[role] = tok["content"] if isinstance(tok, dict) else str(tok)
    return out


# ---------------------------------------------------------------- characters
def is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def is_punctuation(ch: str) -> bool:
    """ASCII 33-47, 58-64, 91-96 and 123-126, and every ``P*`` category."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def split_specials(text: str, specials: Sequence[str]) -> List[str]:
    """``text`` cut around every occurrence of a special token (leftmost,
    then longest), specials kept as pieces of their own, empty pieces
    dropped."""
    if not specials:
        return [text] if text else []
    pattern = "(" + "|".join(re.escape(s) for s in sorted(set(specials), key=len,
                                                            reverse=True)) + ")"
    return [p for p in re.split(pattern, text) if p]


def basic_tokenize(text: str, *, lower: bool, strip_accents: Optional[bool],
                   split_punctuation: bool, cjk: bool = True) -> List[str]:
    """``transformers``' ``BasicTokenizer.tokenize``: drop NUL, U+FFFD and
    control characters and turn whitespace into spaces, put spaces around
    CJK ideographs, NFC, split on whitespace, lower-case and strip accents
    (NFD, marks dropped) as configured, split off punctuation."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or is_control(ch):
            continue
        chars.append(" " if is_whitespace(ch) else ch)
    text = "".join(chars)
    if cjk:
        text = "".join(f" {ch} " if is_cjk(ord(ch)) else ch for ch in text)
    out: List[str] = []
    for token in unicodedata.normalize("NFC", text).split():
        if lower:
            token = token.lower()
            if strip_accents is not False:
                token = _strip_accents(token)
        elif strip_accents:
            token = _strip_accents(token)
        out.extend(_split_punctuation(token) if split_punctuation else [token])
    return " ".join(out).split()


def _strip_accents(token: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", token)
                   if unicodedata.category(ch) != "Mn")


def _split_punctuation(token: str) -> List[str]:
    pieces: List[str] = []
    new_word = True
    for ch in token:
        if is_punctuation(ch):
            pieces.append(ch)
            new_word = True
        else:
            if new_word:
                pieces.append("")
            new_word = False
            pieces[-1] += ch
    return pieces


# ---------------------------------------------------------------------- BERT
class BertTokenizer:
    """The slow ``BertTokenizer`` of a directory's ``vocab.txt`` and
    ``tokenizer_config.json`` (``do_lower_case``, ``strip_accents``,
    ``tokenize_chinese_chars``): special tokens cut out first, the rest
    lower-cased a character at a time (``PreTrainedTokenizer.tokenize``),
    the basic tokenizer, then greedy longest-match WordPiece with ``##``
    continuations (``[UNK]`` for a word it cannot cover or longer than 100
    characters)."""

    def __init__(self, model_dir):
        model_dir = Path(model_dir)
        with open(_required(model_dir, "vocab.txt"), encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        config = _read_json(model_dir / "tokenizer_config.json")
        if not config.get("do_basic_tokenize", True) or config.get("never_split"):
            raise ValueError(f"{model_dir}: do_basic_tokenize=false and never_split are not "
                             "supported")
        self.lower = bool(config.get("do_lower_case", True))
        self.strip_accents = config.get("strip_accents")
        self.cjk = bool(config.get("tokenize_chinese_chars", True))
        self.specials = special_tokens(model_dir, BERT_SPECIALS)
        self.unk_id = self.vocab.get(self.specials["unk_token"])
        if self.unk_id is None:
            raise ValueError(f"{model_dir}: unk_token {self.specials['unk_token']!r} is not "
                             "in vocab.txt")
        self.cls_id, self.sep_id, self.pad_id = (
            self.token_id(self.specials[k]) for k in ("cls_token", "sep_token", "pad_token"))

    def token_id(self, token: str) -> int:
        return self.vocab.get(token, self.unk_id)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        specials = list(self.specials.values())
        for piece in split_specials(text, specials):
            if piece in specials:
                out.append(piece)
                continue
            if self.lower:
                piece = "".join(ch.lower() for ch in piece)
            for word in basic_tokenize(piece, lower=self.lower,
                                       strip_accents=self.strip_accents,
                                       split_punctuation=True, cjk=self.cjk):
                out.extend(self.wordpiece(word))
        return out

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > WORDPIECE_MAX_CHARS:
            return [self.specials["unk_token"]]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            else:
                return [self.specials["unk_token"]]
            pieces.append(sub)
            start = end
        return pieces

    def __call__(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention mask), int64 (B, max_length): ``[CLS]`` ids
        ``[SEP]`` with the ids cut to ``max_length - 2``, ``[PAD]`` after;
        the mask is 1 on the real tokens."""
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(texts), max_length), dtype=np.int64)
        for i, text in enumerate(texts):
            row = [self.cls_id, *(self.token_id(t) for t in self.tokenize(text))
                   ][:max_length - 1] + [self.sep_id]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask


# ---------------------------------------------------------------------- CLIP
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace, else '' (the pattern's
    ``[^\\s\\p{L}\\p{N}]``)."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else ""


def _matches_folded(text: str, i: int, literal: str) -> bool:
    """``literal`` at ``text[i:]`` under simple case folding, one character
    for one (``ſ`` matches ``s``)."""
    seg = text[i:i + len(literal)]
    return len(seg) == len(literal) and all(c.casefold() == l for c, l in zip(seg, literal))


def clip_presplit(text: str) -> List[str]:
    """``re.findall`` of CLIP's pre-split pattern: at each position the
    first alternative that matches, in the pattern's order."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = None
        if text[i] == "<":  # the literals' first character folds to itself only
            lit = next((s for s in _CLIP_LITERALS if _matches_folded(text, i, s)), None)
        elif text[i] == "'":
            c = next((c for c in _CLIP_CONTRACTIONS if _matches_folded(text, i + 1, c)), None)
            lit = None if c is None else "'" + c
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class ClipTokenizer:
    """The slow ``CLIPTokenizer`` of a directory's ``vocab.json``,
    ``merges.txt`` and special tokens, as it runs without ``ftfy``: special
    tokens cut out first, the basic tokenizer (lower-case, no accent strip,
    no punctuation split), the pre-split scanner, the byte map, BPE by merge
    rank with ``</w>`` on a word's last symbol, then the ids of
    ``vocab.json`` (the unknown token's for a symbol not in it)."""

    def __init__(self, model_dir):
        model_dir = Path(model_dir)
        with open(_required(model_dir, "vocab.json"), encoding="utf-8") as f:
            self.vocab: Dict[str, int] = json.load(f)
        with open(_required(model_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:CLIP_MAX_MERGES + 1]
        self.ranks = {tuple(line.split()): r for r, line in enumerate(lines)}
        self.byte_map = bytes_to_unicode()
        self.specials = special_tokens(model_dir, CLIP_SPECIALS)
        missing = [t for t in (self.specials["unk_token"], self.specials["bos_token"],
                               self.specials["eos_token"]) if t not in self.vocab]
        if missing:
            raise ValueError(f"{model_dir}: special tokens {missing} are not in vocab.json")
        self.unk_id = self.vocab[self.specials["unk_token"]]
        self.bos_id, self.eos_id, self.pad_id = (
            self.token_id(self.specials[k]) for k in ("bos_token", "eos_token", "pad_token"))
        self._bpe_cache = {s: s for s in _CLIP_LITERALS}

    def token_id(self, token: str) -> int:
        return self.vocab.get(token, self.unk_id)

    def bpe(self, token: str) -> List[str]:
        hit = self._bpe_cache.get(token)
        if hit is not None:
            return hit.split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == best[0] and word[i + 1] == best[1]:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._bpe_cache[token] = " ".join(word)
        return list(word)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        specials = list(self.specials.values())
        for piece in split_specials(text, specials):
            if piece in specials:
                out.append(piece)
                continue
            clean = " ".join(basic_tokenize(piece, lower=True, strip_accents=False,
                                            split_punctuation=False))
            for token in clip_presplit(clean):
                out.extend(self.bpe("".join(self.byte_map[b] for b in token.encode("utf-8"))))
        return out

    def __call__(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, attention mask), int64 (B, 77), as the JAX encoder builds
        them: BOS ids EOS cut to ``m = min(max_length + 2, 77)`` tokens with
        BOS and EOS kept, the pad token up to ``m``, then zeros (mask 0) up
        to 77."""
        m = min(max_length + 2, CLIP_CONTEXT)
        ids = np.zeros((len(texts), CLIP_CONTEXT), dtype=np.int64)
        mask = np.zeros((len(texts), CLIP_CONTEXT), dtype=np.int64)
        ids[:, :m] = self.pad_id
        for i, text in enumerate(texts):
            row = [self.bos_id, *(self.token_id(t) for t in self.tokenize(text))
                   ][:m - 1] + [self.eos_id]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask

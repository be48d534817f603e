"""Frozen text encoders, host side (counterpart of
``afford_motion_tpu/models/text.py``, whose package import loads jax).

Captions become float32 embeddings before the model sees them. Providers:
the precomputed ``.npz`` table, the deterministic hash encoder, and the
local CLIP and BERT towers (``models/text_towers.py`` with the tokenizers
of ``models/tokenizers.py``), read from a Hugging Face model directory
without ``transformers`` and run on the caller's device (the card unless the
caller names the CPU), f32 with TF32 off.

The JAX encoders run one caption a call. The towers here encode a call's
uncached captions together, in chunks of ``ENCODE_CHUNK`` padded with
``""``: every launch has the same shapes, so a caption's embedding is bit
for bit the same whatever else shares its call (a resumed run re-encodes
with an empty cache and must match the straight run).
"""
from __future__ import annotations

import contextlib
import hashlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.io import get_logger
from .text_towers import BertTextModel, ClipTextModel
from .tokenizers import BertTokenizer, ClipTokenizer

logger = get_logger()


def get_lang_feat_dim_type(version: str) -> Tuple[int, str]:
    """Model version -> (feature dim, family)."""
    if version in ("ViT-B/32", "ViT-B/16"):
        return 512, "clip"
    if version in ("ViT-L/14", "ViT-L/14@336px"):
        return 768, "clip"
    if "bert" in version.lower():
        return 768, "bert"
    raise NotImplementedError(f"unknown text model version: {version}")


class TextEncoder:
    """Caption -> embedding provider with a memo cache."""

    # per-token providers (BERT for the CMDM) emit (B, L, dim) features
    per_token: bool = False

    def __init__(self, dim: int):
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def _encode_one(self, text: str) -> np.ndarray:
        raise NotImplementedError

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """(B,) strings -> (B, dim) float32."""
        out = np.empty((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            e = self._cache.get(t)
            if e is None:
                e = self._encode_one(t).astype(np.float32)
                self._cache[t] = e
            out[i] = e
        return out

    def encode_tokens(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(B,) strings -> ((B, 1, dim), (B, 1) all-valid pad mask)."""
        emb = self.encode(texts)[:, None, :]
        return emb, np.zeros((len(texts), 1), dtype=bool)


class HashTextEncoder(TextEncoder):
    """Unit-norm gaussian seeded by the caption's sha256; '' -> zeros (the
    classifier-free-guidance null text)."""

    def _encode_one(self, text: str) -> np.ndarray:
        if text == "":
            return np.zeros(self.dim, dtype=np.float32)
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
        return v / (np.linalg.norm(v) + 1e-8)


class TableTextEncoder(TextEncoder):
    """Embeddings from an ``.npz`` with ``texts`` and ``embeddings`` (N, dim).
    An unknown caption raises with ``strict=True`` (training: a stale table
    must not silently train on hash embeddings), else falls back to the
    hash encoder with a one-time warning."""

    def __init__(self, path: str, strict: bool = False):
        data = np.load(path, allow_pickle=False)
        texts = [str(t) for t in data["texts"]]
        emb = np.asarray(data["embeddings"], dtype=np.float32)
        super().__init__(emb.shape[1])
        self._cache = dict(zip(texts, emb))
        self._fallback = HashTextEncoder(self.dim)
        self.strict = bool(strict)
        self._warned = False

    def _encode_one(self, text: str) -> np.ndarray:
        if self.strict:
            raise KeyError(
                f"caption not in embedding table: {text!r}; re-export the table or "
                "set text_encoder.allow_fallback=true to train on hash embeddings "
                "for unknown captions"
            )
        if not self._warned:
            logger.warning(f"caption not in embedding table, falling back to hash "
                           f"encoder: {text!r}")
            self._warned = True
        return self._fallback._encode_one(text)




ENCODE_CHUNK = 32  # captions a tower launch: the flagship's batch


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for cuBLAS and cuDNN inside the block, the caller's flags
    back after it."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = flags


class _TowerEncoder(TextEncoder):
    """A frozen tower on ``device`` behind a memo cache: new captions are
    tokenized and run in fixed chunks of ``ENCODE_CHUNK``."""

    def __init__(self, model: torch.nn.Module, tokenizer, dim: int, max_length: int,
                 device: Union[str, torch.device]):
        super().__init__(dim)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = int(max_length)

    def _run(self, texts: List[str], fn: Callable) -> Tuple[np.ndarray, np.ndarray]:
        """``fn(ids, mask)`` over ``texts`` chunk by chunk: (its outputs
        (n, ...) f32, the attention masks (n, L))."""
        outs, masks = [], []
        for s in range(0, len(texts), ENCODE_CHUNK):
            chunk = texts[s:s + ENCODE_CHUNK]
            n = len(chunk)
            ids, mask = self.tokenizer(chunk + [""] * (ENCODE_CHUNK - n), self.max_length)
            with torch.no_grad(), f32_matmuls():
                out = fn(torch.from_numpy(ids).to(self.device),
                         torch.from_numpy(mask).to(self.device))
            outs.append(out[:n].to(torch.float32).cpu().numpy())
            masks.append(mask[:n])
        return np.concatenate(outs), np.concatenate(masks)

    def _pooled(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """(B,) strings -> (B, dim) float32; the uncached ones run together."""
        new = list(dict.fromkeys(t for t in texts if t not in self._cache))
        if new:
            self._cache.update(zip(new, self._run(new, self._pooled)[0]))
        out = np.empty((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            out[i] = self._cache[t]
        return out


class ClipTextEncoder(_TowerEncoder):
    """CLIP's projected text embedding (``CLIPTextModelWithProjection``'s
    ``text_embeds``) from a model directory: the JAX encoder's
    ``min(max_length + 2, 77)`` tokens, then zeros to 77."""

    def __init__(self, weights_dir: str, max_length: int = 32,
                 device: Union[str, torch.device] = "cuda"):
        model = ClipTextModel.from_pretrained(weights_dir)
        super().__init__(model, ClipTokenizer(weights_dir), model.dim, max_length, device)

    def _pooled(self, ids, mask):
        return self.model(ids, mask)


class BertTextEncoder(_TowerEncoder):
    """BERT from a model directory, as the reference's ``encode_text_bert``:
    ``pooled=True`` gives ``pooler_output`` (the CDM's sentence feature);
    ``pooled=False`` (``per_token``) gives ``last_hidden_state`` over
    ``max_length`` tokens and the inverted attention mask (True = padding,
    the CMDM's text tokens)."""

    def __init__(self, weights_dir: str, max_length: int = 32, pooled: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        model = BertTextModel.from_pretrained(weights_dir, require_pooler=pooled)
        super().__init__(model, BertTokenizer(weights_dir), model.width, max_length, device)
        self.per_token = not pooled
        # token-feature memo: caption -> (tokens (L, dim), pad (L,) bool)
        self._tok_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def _pooled(self, ids, mask):
        pooled = self.model(ids, mask)[1]
        if pooled is None:
            raise ValueError("this BERT directory holds no pooler: pooled features unavailable")
        return pooled

    def encode_tokens(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        if not self.per_token:
            return super().encode_tokens(texts)
        new = list(dict.fromkeys(t for t in texts if t not in self._tok_cache))
        if new:
            emb, mask = self._run(new, lambda ids, m: self.model(ids, m)[0])
            self._tok_cache.update(zip(new, zip(emb, mask == 0)))
        emb = np.empty((len(texts), self.max_length, self.dim), dtype=np.float32)
        pad = np.empty((len(texts), self.max_length), dtype=bool)
        for i, t in enumerate(texts):
            emb[i], pad[i] = self._tok_cache[t]
        return emb, pad


def create_text_encoder(version: str, *, table_path: Optional[str] = None,
                        weights_dir: Optional[str] = None, max_length: int = 32,
                        strict_table: bool = False, per_token: bool = False,
                        device: Union[str, torch.device] = "cuda") -> TextEncoder:
    """The JAX package's provider choice. BERT family: its weights, else a
    pooled table (not for ``per_token``), else an error with
    ``strict_table`` (the training default), else hash with a warning. CLIP
    family: the table, else its weights, else hash with a warning. A
    weights directory that exists but cannot be loaded raises, naming the
    missing or bad file (JAX falls through to hash for CLIP). The towers run
    on ``device``; ``max_length`` is ``model.text_model.max_length``."""
    dim, family = get_lang_feat_dim_type(version)
    weights = bool(weights_dir) and Path(weights_dir).exists()
    table = bool(table_path) and Path(table_path).exists()
    if family == "bert":
        if weights:
            return BertTextEncoder(weights_dir, max_length=max_length, pooled=not per_token,
                                   device=device)
        if table and not per_token:
            return TableTextEncoder(table_path, strict=strict_table)
        if strict_table:
            raise FileNotFoundError(
                f"text_model.version={version!r} needs local BERT weights "
                f"(text_encoder.weights_dir={weights_dir!r} not found"
                + ("" if per_token else f"; table_path={table_path!r} not found")
                + "); set text_encoder.allow_fallback=true to use hash embeddings (tests only)")
        logger.warning(f"no BERT weights at {weights_dir!r}; using HASH text embeddings — "
                       "test/bench use only")
        return HashTextEncoder(dim)
    if table:
        return TableTextEncoder(table_path, strict=strict_table)
    if weights:
        return ClipTextEncoder(weights_dir, max_length=max_length, device=device)
    logger.warning(f"no embedding table at {table_path!r} and no local CLIP weights at "
                   f"{weights_dir!r}; using HASH text embeddings — test/bench use only")
    return HashTextEncoder(dim)

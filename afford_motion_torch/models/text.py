"""Frozen text encoders, host side (counterpart of
``afford_motion_tpu/models/text.py``, whose package import loads jax).

Captions become float32 embeddings on the host before sampling. Ported
providers: the precomputed ``.npz`` table and the deterministic hash
encoder. Running local CLIP or BERT weights is not ported yet; a config that
points at existing weights is refused instead of silently hashed.
"""
from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.io import get_logger

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


def create_text_encoder(version: str, *, table_path: Optional[str] = None,
                        weights_dir: Optional[str] = None,
                        per_token: bool = False,
                        strict_table: bool = False) -> TextEncoder:
    """The JAX package's provider choice minus the local-weights encoders:
    existing CLIP/BERT weights are refused, not hashed. A pooled table does
    not serve per-token BERT features. ``strict_table`` (the training
    default): a table's unknown captions raise, and a BERT model without
    weights is an error; no provider at all still hashes, with a warning."""
    dim, family = get_lang_feat_dim_type(version)
    if weights_dir and Path(weights_dir).exists():
        raise NotImplementedError(
            f"running local {family} weights ({weights_dir}) is not ported yet; "
            "export an embedding table or point text_encoder.weights_dir elsewhere"
        )
    if table_path and Path(table_path).exists() and not (family == "bert" and per_token):
        return TableTextEncoder(table_path, strict=strict_table)
    if strict_table and family == "bert":
        raise FileNotFoundError(
            f"text_model.version={version!r} needs local BERT weights, which the "
            "port cannot run yet; set text_encoder.allow_fallback=true to use "
            "hash embeddings (tests only)"
        )
    logger.warning(f"no embedding table at {table_path!r}; using HASH text "
                   "embeddings — test/bench use only")
    return HashTextEncoder(dim)

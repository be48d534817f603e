"""The frozen text towers the JAX package runs through ``transformers``:
``BertModel`` and ``CLIPTextModelWithProjection``, as ``nn.Module``s whose
parameter names are those of the Hugging Face checkpoints, so that a
model directory loads with ``strict`` names. Eager attention with an f32
softmax, as ``transformers``' eager path computes it; no port kernel lies
on this path (the JAX package ran these towers as PyTorch on the CPU,
outside any Pallas kernel).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.hf_weights import read_config, read_state_dict

_MASKED = torch.finfo(torch.float32).min


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_CLIP_ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, D) -> (B, n, T, D / n)."""
    return x.reshape(x.shape[0], x.shape[1], n, -1).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, n, T, d) -> (B, T, n d)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1)


def load_strict(model: nn.Module, state: Dict[str, torch.Tensor], where: Path) -> None:
    """``state`` into ``model``: every parameter present and no other key,
    each of its parameter's shape; raises naming the file and the keys."""
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    wrong = sorted(k for k in set(want) & set(state) if tuple(state[k].shape) != tuple(want[k].shape))
    if missing or extra or wrong:
        raise ValueError(f"{where}: the weights do not fit the config: missing {missing[:8]}, "
                         f"unexpected {extra[:8]}, wrong shape {wrong[:8]}")
    model.load_state_dict({k: v.to(torch.float32) for k, v in state.items()}, strict=True)


# ---------------------------------------------------------------------- BERT
class BertSelfAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(f(x), self.heads) for f in (self.query, self.key, self.value))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]) + mask_add
        return _merge(torch.matmul(F.softmax(scores, dim=-1, dtype=torch.float32), v))


class BertDenseNorm(nn.Module):
    """``dense`` then ``LayerNorm`` of the residual sum (BERT's post-LN)."""

    def __init__(self, d_in: int, width: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.self = BertSelfAttention(width, heads)
        self.output = BertDenseNorm(width, width, eps)


class BertIntermediate(nn.Module):
    def __init__(self, width: int, ffn: int):
        super().__init__()
        self.dense = nn.Linear(width, ffn)


class BertLayer(nn.Module):
    def __init__(self, width: int, heads: int, ffn: int, eps: float):
        super().__init__()
        self.attention = BertAttention(width, heads, eps)
        self.intermediate = BertIntermediate(width, ffn)
        self.output = BertDenseNorm(ffn, width, eps)

    def forward(self, x: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
        x = self.attention.output(self.attention.self(x, mask_add), x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class BertEncoder(nn.Module):
    def __init__(self, layers: int, *args):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(*args) for _ in range(layers))


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int, types: int, eps: float):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, width)
        self.position_embeddings = nn.Embedding(positions, width)
        self.token_type_embeddings = nn.Embedding(types, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (self.word_embeddings(ids) + self.token_type_embeddings(torch.zeros_like(ids))
             + self.position_embeddings(pos)[None])
        return self.LayerNorm(x)


class BertPooler(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.dense = nn.Linear(width, width)


class BertTextModel(nn.Module):
    """``transformers.BertModel`` in f32 eval: word, position and token-type
    (0) embeddings, post-LN layers with exact-erf GELU, the additive pad
    mask ``(1 - mask) * finfo(float32).min``, and the pooler ``tanh(dense(h
    [CLS]))`` where ``pooler`` is true."""

    def __init__(self, config: dict, pooler: bool = True):
        super().__init__()
        if config.get("hidden_act", "gelu") != "gelu":
            raise ValueError(f"BERT hidden_act {config.get('hidden_act')!r} is not supported "
                             "(only 'gelu')")
        if config.get("position_embedding_type", "absolute") != "absolute":
            raise ValueError("BERT position_embedding_type "
                             f"{config.get('position_embedding_type')!r} is not supported")
        width, eps = int(config["hidden_size"]), float(config.get("layer_norm_eps", 1e-12))
        self.embeddings = BertEmbeddings(int(config["vocab_size"]), width,
                                         int(config.get("max_position_embeddings", 512)),
                                         int(config.get("type_vocab_size", 2)), eps)
        self.encoder = BertEncoder(int(config["num_hidden_layers"]), width,
                                   int(config["num_attention_heads"]),
                                   int(config["intermediate_size"]), eps)
        self.pooler = BertPooler(width) if pooler else None
        self.width = width

    def forward(self, ids: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(last hidden state (B, T, D), pooled (B, D) or None)."""
        mask_add = ((1.0 - mask.to(torch.float32)) * _MASKED)[:, None, None, :]
        x = self.embeddings(ids)
        for layer in self.encoder.layer:
            x = layer(x, mask_add)
        pooled = None if self.pooler is None else torch.tanh(self.pooler.dense(x[:, 0]))
        return x, pooled

    @classmethod
    def from_pretrained(cls, model_dir, require_pooler: bool = True) -> "BertTextModel":
        """A BERT directory's ``config.json`` and weights: keys with or
        without a ``bert.`` prefix, legacy ``LayerNorm.gamma``/``beta``
        renamed, the ``cls.*`` heads and ``position_ids``/``token_type_ids``
        buffers dropped, strict on the rest. The pooler is built where the
        file holds ``pooler.*``; ``require_pooler`` raises where it does not
        (``transformers`` would draw a random pooler)."""
        model_dir = Path(model_dir)
        config = read_config(model_dir)
        if config.get("model_type") != "bert":
            raise ValueError(f"{model_dir}/config.json: model_type "
                             f"{config.get('model_type')!r}, not 'bert'")
        state = {}
        for key, value in read_state_dict(model_dir).items():
            if key.startswith("cls.") or key.endswith(("position_ids", "token_type_ids")):
                continue
            key = key[len("bert."):] if key.startswith("bert.") else key
            if key.endswith("LayerNorm.gamma"):
                key = key[:-len("gamma")] + "weight"
            elif key.endswith("LayerNorm.beta"):
                key = key[:-len("beta")] + "bias"
            state[key] = value
        pooler = any(k.startswith("pooler.") for k in state)
        if require_pooler and not pooler:
            raise ValueError(f"{model_dir}: the weights hold no pooler.*, which the pooled "
                             "BERT features need")
        model = cls(config, pooler=pooler)
        load_strict(model, state, model_dir)
        return model


# ---------------------------------------------------------------------- CLIP
class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (width // heads) ** -0.5
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(f(x), self.heads) for f in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.scale + mask_add
        return self.out_proj(_merge(torch.matmul(
            F.softmax(scores, dim=-1, dtype=torch.float32), v)))


class ClipMLP(nn.Module):
    def __init__(self, width: int, ffn: int, act):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(width, ffn)
        self.fc2 = nn.Linear(ffn, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ClipLayer(nn.Module):
    def __init__(self, width: int, heads: int, ffn: int, eps: float, act):
        super().__init__()
        self.self_attn = ClipAttention(width, heads)
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.mlp = ClipMLP(width, ffn, act)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)

    def forward(self, x: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask_add)
        return x + self.mlp(self.layer_norm2(x))


class ClipEncoder(nn.Module):
    def __init__(self, layers: int, *args):
        super().__init__()
        self.layers = nn.ModuleList(ClipLayer(*args) for _ in range(layers))


class ClipEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.position_embedding = nn.Embedding(positions, width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class ClipTransformer(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        act = config.get("hidden_act", "quick_gelu")
        if act not in _CLIP_ACTS:
            raise ValueError(f"CLIP hidden_act {act!r} is not supported "
                             f"(one of {sorted(_CLIP_ACTS)})")
        width, eps = int(config["hidden_size"]), float(config.get("layer_norm_eps", 1e-5))
        self.embeddings = ClipEmbeddings(int(config["vocab_size"]), width,
                                         int(config.get("max_position_embeddings", 77)))
        self.encoder = ClipEncoder(int(config["num_hidden_layers"]), width,
                                   int(config["num_attention_heads"]),
                                   int(config["intermediate_size"]), eps, _CLIP_ACTS[act])
        self.final_layer_norm = nn.LayerNorm(width, eps=eps)


class ClipTextModel(nn.Module):
    """``transformers.CLIPTextModelWithProjection`` in f32 eval: token and
    position embeddings, pre-LN layers under the causal mask plus the
    padding mask (each ``finfo(float32).min`` where it masks, added),
    ``final_layer_norm``, the pooled row (the argmax of the ids where the
    config's ``eos_token_id`` is 2, else the first ``eos_token_id``), then
    the bias-free ``text_projection``."""

    def __init__(self, config: dict, projection_dim: int):
        super().__init__()
        self.text_model = ClipTransformer(config)
        self.text_projection = nn.Linear(int(config["hidden_size"]), projection_dim, bias=False)
        self.eos_token_id = int(config.get("eos_token_id", 49407))
        self.dim = projection_dim

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        T = ids.shape[1]
        tm = self.text_model
        causal = torch.full((T, T), _MASKED, device=ids.device).triu(1)
        pad = (1.0 - mask.to(torch.float32))[:, None, None, :] * _MASKED
        mask_add = pad + causal
        x = tm.embeddings(ids)
        for layer in tm.encoder.layers:
            x = layer(x, mask_add)
        x = tm.final_layer_norm(x)
        if self.eos_token_id == 2:
            at = ids.to(torch.int32).argmax(dim=-1)
        else:
            at = (ids == self.eos_token_id).to(torch.int32).argmax(dim=-1)
        return self.text_projection(x[torch.arange(x.shape[0], device=x.device), at])

    @classmethod
    def from_pretrained(cls, model_dir) -> "ClipTextModel":
        """A text-only directory (``model_type: clip_text_model``) or a
        whole ``CLIPModel``'s (``clip``: ``text_config`` nested, the
        ``vision_model.*``, ``visual_projection`` and ``logit_scale`` keys
        dropped)."""
        model_dir = Path(model_dir)
        config = read_config(model_dir)
        kind = config.get("model_type")
        if kind == "clip":
            text = config.get("text_config") or {}
            projection = int(config.get("projection_dim", text.get("projection_dim", 512)))
            config = text
        elif kind == "clip_text_model":
            projection = int(config.get("projection_dim", 512))
        else:
            raise ValueError(f"{model_dir}/config.json: model_type {kind!r}, not 'clip' or "
                             "'clip_text_model'")
        state = {k: v for k, v in read_state_dict(model_dir).items()
                 if not k.startswith(("vision_model.", "visual_projection.", "logit_scale"))
                 and not k.endswith("position_ids")}
        model = cls(config, projection)
        load_strict(model, state, model_dir)
        return model

"""CMDM, the stage-2 contact-to-motion diffusion denoiser, archs
``trans_enc`` and ``trans_dec`` (counterpart of
``afford_motion_tpu/models/cmdm.py``).

``trans_enc`` joins the SceneMap encoder's 128 group tokens to the time,
text and motion tokens and runs one encoder stack. ``trans_dec`` encodes the
contact cloud with the SceneMap U-Net into four scales, coarsest first, and
runs ``len(num_layers)`` self-attention stages with a decoder layer between
each two, whose cross-attention reads one scale through its kv mapping
(Linear + float32 LayerNorm). ``encode_contact`` (the 8192-point encoder, for
``trans_dec`` also its decoder) is split from ``denoise`` so a sampling chain
encodes its constant condition once; the kv mappings run inside ``denoise``
at every step, as in the JAX package. The classifier-free-guidance flags
``c_text_mask``, ``c_text_erase``, ``c_pc_mask`` and ``c_pc_erase`` act as in
the JAX package, on every memory of ``trans_dec``. Parameter names are the
reference state_dict's (including its ``kv_mappling_layers``), so a
converted checkpoint loads with ``strict=True``. Train or eval is the
module's mode: ``.train()`` turns on the batch statistics of the contact
encoder's BatchNorms and the dropout of the transformer (see
``layers.set_dropout_generator``). ``norm="layer"`` (``model.norm`` of the
config) builds the contact encoder with float32 LayerNorms in place of its
BatchNorms, as the JAX package does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ..utils.misc import compute_repr_dimension
from .layers import (
    LayerNorm,
    Linear,
    PositionalEncoding,
    TimestepEmbedder,
    TransformerDecoderLayer,
    TransformerEncoder,
)
from .scene_map import SceneMapEncoder, SceneMapEncoderDecoder
from .text import get_lang_feat_dim_type


class CMDM(nn.Module):
    def __init__(
        self,
        motion_dim: int,
        latent_dim: int = 512,
        time_emb_dim: int = 512,
        text_feat_dim: int = 512,
        contact_dim: int = 6,
        planes: Sequence[int] = (32, 64, 128, 256),
        blocks: Sequence[int] = (2, 2, 2, 2),
        arch: str = "trans_enc",
        mask_motion: bool = True,
        num_layers: Sequence[int] = (1, 1, 1, 1, 1),
        num_heads: int = 8,
        dim_feedforward: int = 1024,
        dtype: torch.dtype = torch.float32,
        knn_exact: bool = False,
        dropout: float = 0.0,
        use_banded: bool = False,
        banded_window: int = 0,
        banded_adaptive: Optional[bool] = None,
        norm: str = "batch",
    ):
        super().__init__()
        if arch not in ("trans_enc", "trans_dec"):
            raise NotImplementedError(f"CMDM arch {arch!r}")
        self.arch = arch
        self.mask_motion = mask_motion
        self.dtype = dtype
        # bit-exact kNN for the hierarchy instead of the packed-key kernel
        self.knn_exact = knn_exact
        # banded windowed-neighbourhood kernels for the hierarchy and the
        # encoder's gathers (curve-sorted clouds only): set by the TrainLoop
        # for a curve-sorted packed store, or by the config for a test run;
        # the W0 width (0 = env/default) and the adaptive starts ride along
        self.use_banded = use_banded
        self.banded_window = banded_window
        self.banded_adaptive = banded_adaptive
        self.timestep_embedder = TimestepEmbedder(latent_dim, time_emb_dim, 1000, dtype)
        if arch == "trans_enc":
            self.contact_encoder = SceneMapEncoder(contact_dim, planes, blocks, dtype, norm)
            self.contact_adapter = Linear(planes[-1], latent_dim, dtype=dtype)
            self.self_attn_layer = TransformerEncoder(sum(num_layers), latent_dim, num_heads,
                                                      dim_feedforward, dtype, dropout)
        else:
            self.contact_encoder = SceneMapEncoderDecoder(contact_dim, planes, blocks, dtype,
                                                          norm)
            self.self_attn_layers = nn.ModuleList(
                TransformerEncoder(n, latent_dim, num_heads, dim_feedforward, dtype, dropout)
                for n in num_layers)
            # one per scale, coarsest first: planes[-1], planes[-2], ...
            self.kv_mappling_layers = nn.ModuleList(
                nn.Sequential(Linear(planes[-1 - i], latent_dim, dtype=dtype),
                              LayerNorm(latent_dim, dtype))
                for i in range(len(num_layers) - 1))
            self.cross_attn_layers = nn.ModuleList(
                TransformerDecoderLayer(latent_dim, num_heads, dim_feedforward, dtype, dropout)
                for _ in range(len(num_layers) - 1))
        self.language_adapter = Linear(text_feat_dim, latent_dim, dtype=dtype)
        self.motion_adapter = Linear(motion_dim, latent_dim, dtype=dtype)
        self.positional_encoder = PositionalEncoding(latent_dim, 5000, dtype, dropout)
        # the prediction head stays float32: the x0 math is full precision
        self.motion_layer = Linear(latent_dim, motion_dim, dtype=torch.float32)

    @property
    def needs_up_interpolation(self) -> bool:
        """Only ``trans_dec``'s U-Net reads the hierarchy's 3-NN
        up-interpolation; ``trans_enc`` pools encoder-only group tokens."""
        return self.arch == "trans_dec"

    def encode_contact(self, cond: Dict[str, Any]) -> Union[torch.Tensor, List[torch.Tensor]]:
        """(xyz ⊕ contact) -> ``trans_enc``: (B, G, planes[-1]) group tokens;
        ``trans_dec``: the U-Net's four scales, coarsest first."""
        return self.contact_encoder(cond["levels_sm"], cond["c_pc_contact"])

    @staticmethod
    def _memory_mask(cond: Dict[str, Any], B: int, n: int, dev) -> torch.Tensor:
        mask = torch.zeros((B, n), dtype=torch.bool, device=dev)
        if "c_pc_mask" in cond:
            mask = mask | cond["c_pc_mask"].bool().expand_as(mask)
        return mask

    @staticmethod
    def _erase(c: torch.Tensor, cond: Dict[str, Any]) -> torch.Tensor:
        if "c_pc_erase" in cond:
            c = c * (1.0 - cond["c_pc_erase"][..., None].to(c.dtype))
        return c

    def denoise(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, Any],
                cont_emb: Union[torch.Tensor, List[torch.Tensor]]) -> torch.Tensor:
        B = x.shape[0]
        dev = x.device
        time_emb = self.timestep_embedder(timesteps)               # (B, 1, D)

        text_emb = cond["text_emb"].to(self.dtype)                 # (B, Lt, Dt)
        Lt = text_emb.shape[1]
        if "text_token_mask" in cond:
            text_mask = cond["text_token_mask"].bool()
        else:
            text_mask = torch.zeros((B, Lt), dtype=torch.bool, device=dev)
        if "c_text_mask" in cond:
            text_mask = text_mask | cond["c_text_mask"].bool()
        if "c_text_erase" in cond:
            text_emb = text_emb * (1.0 - cond["c_text_erase"][..., None].to(text_emb.dtype))
        text_emb = self.language_adapter(text_emb)

        h = self.motion_adapter(x)                                  # (B, L, D)
        time_mask = torch.zeros((B, 1), dtype=torch.bool, device=dev)

        if self.arch == "trans_enc":
            cont_mask = self._memory_mask(cond, B, cont_emb.shape[1], dev)
            c = self.contact_adapter(self._erase(cont_emb, cond))   # (B, G, D)
            tokens = self.positional_encoder(torch.cat([time_emb, text_emb, c, h], dim=1))
            pad_mask = None
            if self.mask_motion:
                pad_mask = torch.cat([time_mask, text_mask, cont_mask, cond["x_mask"].bool()],
                                     dim=1)
            tokens = self.self_attn_layer(tokens, pad_mask)
            h = tokens[:, 1 + Lt + c.shape[1]:, :]
            return self.motion_layer(h.float())

        tokens = self.positional_encoder(torch.cat([time_emb, text_emb, h], dim=1))
        pad_mask = None
        if self.mask_motion:
            pad_mask = torch.cat([time_mask, text_mask, cond["x_mask"].bool()], dim=1)
        for i, self_attn in enumerate(self.self_attn_layers):
            tokens = self_attn(tokens, pad_mask)
            if i < len(self.cross_attn_layers):
                mem = cont_emb[i]                                   # coarsest first
                mem_mask = self._memory_mask(cond, B, mem.shape[1], dev)
                mem = self.kv_mappling_layers[i](self._erase(mem, cond))
                tokens = self.cross_attn_layers[i](tokens, mem, pad_mask, mem_mask)
        h = tokens[:, 1 + Lt:, :]
        return self.motion_layer(h.float())

    def forward(self, x, timesteps, cond):
        return self.denoise(x, timesteps, cond, self.encode_contact(cond))


def build_cmdm(model_cfg: Any) -> CMDM:
    """A CMDM from the model YAML block (``configs/model/cmdm.yaml``)."""
    text_feat_dim, _ = get_lang_feat_dim_type(model_cfg.text_model.version)
    cm = model_cfg.contact_model
    if bool(model_cfg.get("fused_qkv", False)):
        raise NotImplementedError("fused_qkv is not ported yet")
    return CMDM(
        motion_dim=int(model_cfg.input_feats),
        latent_dim=int(model_cfg.latent_dim),
        time_emb_dim=int(model_cfg.time_emb_dim),
        text_feat_dim=text_feat_dim,
        contact_dim=compute_repr_dimension(str(cm.contact_type)),
        planes=tuple(cm.planes),
        blocks=tuple(cm.blocks),
        arch=str(model_cfg.arch),
        mask_motion=bool(model_cfg.mask_motion),
        num_layers=tuple(model_cfg.num_layers),
        num_heads=int(model_cfg.num_heads),
        dim_feedforward=int(model_cfg.dim_feedforward),
        dtype=getattr(torch, str(model_cfg.get("dtype", "float32"))),
        knn_exact=bool(model_cfg.get("knn_exact", False)),
        dropout=float(model_cfg.get("dropout", 0.0)),
        use_banded=bool(model_cfg.get("use_banded", False)),
        banded_window=int(model_cfg.get("banded_window", 0) or 0),
        banded_adaptive=model_cfg.get("banded_adaptive", None),
        norm=str(model_cfg.get("norm", "batch")),
    )

"""CDM, the stage-1 contact diffusion denoiser (counterpart of
``afford_motion_tpu/models/cdm.py``): it predicts the clean contact map x0
over a scene's point cloud from a text embedding and a timestep embedding.

Ported backbones: ``Perceiver`` (the published configuration, every
``scripts/*_contact/train_ddp.sh``) and ``MLP`` (the config's default
``arch``), both without a scene model (``use_scene_model=False``): the point
tokens are the noisy contact map and, with ``point_pos_emb``, the point
coordinates. ``PointTrans``, ``PointTransV2``, the frozen
``PointTransformerSeg`` scene features (``use_scene_model=True``) and the
OpenScene features are refused by name: they need the scene model and its
point hierarchy, which the port has not got yet.

Parameter names are the reference state_dict's, so a converted checkpoint
loads with ``strict=True``. Mixed precision as in the JAX package: float32
parameters, the backbone in ``dtype``, LayerNorms and the attention's
softmax in float32, the ``contact_layer`` head in float32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from .layers import LayerNorm, Linear, TimestepEmbedder
from .perceiver import GELU, CrossAttentionLayer, SelfAttentionBlock
from .text import get_lang_feat_dim_type


class PointSceneMLP(nn.Module):
    """Point MLP, then the scene's mean feature beside each point's, then a
    second MLP (``mlp_pre``, ``mlp_post``)."""

    def __init__(self, in_dim: int, out_dim: int, widening_factor: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp_pre = nn.Sequential(
            LayerNorm(in_dim, dtype), Linear(in_dim, widening_factor * in_dim, bias, dtype),
            GELU(), Linear(widening_factor * in_dim, out_dim, bias, dtype))
        self.mlp_post = nn.Sequential(
            LayerNorm(2 * out_dim, dtype), Linear(2 * out_dim, 2 * out_dim, bias, dtype),
            GELU(), Linear(2 * out_dim, out_dim, bias, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp_pre(x)
        h = torch.cat([h, h.mean(dim=1, keepdim=True).expand_as(h)], dim=-1)
        return self.mlp_post(h)


class ContactMLP(nn.Module):
    """Point-MLP backbone: each point's tokens with the text and time
    embeddings broadcast beside them, through ``point_mlp``."""

    def __init__(self, in_dim: int, point_mlp_dims: Sequence[int] = (512, 512),
                 point_mlp_widening_factor: int = 1, point_mlp_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [in_dim, *point_mlp_dims]
        self.point_mlp = nn.Sequential(*(
            PointSceneMLP(a, b, point_mlp_widening_factor, point_mlp_bias, dtype)
            for a, b in zip(dims[:-1], dims[1:])))
        self.out_dim = dims[-1]

    def forward(self, x, text_emb, time_emb, cond):
        B, N = x.shape[:2]
        parts = [x, text_emb.expand(B, N, -1), time_emb.expand(B, N, -1)]
        return self.point_mlp(torch.cat([p.to(self.dtype) for p in parts], dim=-1))


class ContactPerceiver(nn.Module):
    """Perceiver-IO backbone: the point tokens are keys and values for a
    2-token [text, time] query; after the latent self-attention each point
    cross-attends back to the 2 latents."""

    def __init__(self, in_dim: int, text_feat_dim: int, time_emb_dim: int,
                 point_pos_emb: bool = True,
                 encoder_q_input_channels: int = 512, encoder_kv_input_channels: int = 256,
                 encoder_num_heads: int = 8, encoder_widening_factor: int = 1,
                 encoder_dropout: float = 0.1, encoder_residual_dropout: float = 0.0,
                 encoder_self_attn_num_layers: int = 2,
                 decoder_q_input_channels: int = 256, decoder_kv_input_channels: int = 512,
                 decoder_num_heads: int = 8, decoder_widening_factor: int = 1,
                 decoder_dropout: float = 0.1, decoder_residual_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if decoder_kv_input_channels != encoder_q_input_channels:
            raise ValueError("decoder_kv_input_channels must equal encoder_q_input_channels")
        self.point_pos_emb = point_pos_emb
        enc_q, enc_kv = encoder_q_input_channels, encoder_kv_input_channels
        self.encoder_adapter = Linear(in_dim + 3 * point_pos_emb, enc_kv, dtype=dtype)
        self.language_adapter = Linear(text_feat_dim, enc_q, dtype=dtype)
        self.time_embedding_adapter = Linear(time_emb_dim, enc_q, dtype=dtype)
        self.encoder_cross_attn = CrossAttentionLayer(
            encoder_num_heads, enc_q, enc_kv, encoder_widening_factor, encoder_dropout,
            encoder_residual_dropout, dtype)
        self.encoder_self_attn = SelfAttentionBlock(
            encoder_self_attn_num_layers, encoder_num_heads, enc_q, encoder_widening_factor,
            encoder_dropout, encoder_residual_dropout, dtype)
        self.decoder_adapter = Linear(enc_kv, decoder_q_input_channels, dtype=dtype)
        self.decoder_cross_attn = CrossAttentionLayer(
            decoder_num_heads, decoder_q_input_channels, decoder_kv_input_channels,
            decoder_widening_factor, decoder_dropout, decoder_residual_dropout, dtype)
        self.out_dim = decoder_q_input_channels

    def forward(self, x, text_emb, time_emb, cond):
        if self.point_pos_emb:
            x = torch.cat([x, cond["c_pc_xyz"].to(x.dtype)], dim=-1)
        enc_kv = self.encoder_adapter(x)                                   # (B, N, kv)
        enc_q = torch.cat([self.language_adapter(text_emb),
                           self.time_embedding_adapter(time_emb)], dim=1)  # (B, 2, q)
        enc_q = self.encoder_self_attn(self.encoder_cross_attn(enc_q, enc_kv))
        return self.decoder_cross_attn(self.decoder_adapter(enc_kv), enc_q)


class CDM(nn.Module):
    """Stage-1 denoiser. ``arch_cfg``: the keyword arguments of the backbone
    (``arch_mlp`` or ``arch_perceiver`` of ``configs/model/cdm.yaml``, without
    ``last_dim``)."""

    def __init__(self, contact_dim: int, time_emb_dim: int = 128, text_feat_dim: int = 512,
                 use_scene_model: bool = False, use_openscene: bool = False,
                 arch: str = "Perceiver", arch_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_scene_model or use_openscene:
            raise NotImplementedError("CDM scene features (use_scene_model, use_openscene) "
                                      "are not ported yet")
        self.dtype = dtype
        self.timestep_embedder = TimestepEmbedder(time_emb_dim, time_emb_dim, 1000, dtype)
        if arch == "MLP":
            backbone = ContactMLP(contact_dim + text_feat_dim + time_emb_dim,
                                  **(arch_cfg or {}), dtype=dtype)
        elif arch == "Perceiver":
            backbone = ContactPerceiver(contact_dim, text_feat_dim, time_emb_dim,
                                        **(arch_cfg or {}), dtype=dtype)
        else:
            raise NotImplementedError(f"CDM arch {arch!r} is not ported yet")
        self.contact_model = backbone
        # the prediction head stays float32: the x0 math is full precision
        self.contact_layer = Linear(backbone.out_dim, contact_dim, dtype=torch.float32)

    def encode_scene(self, cond: Dict[str, Any]) -> None:
        """The per-chain scene encoding; the ported configurations read no
        scene model, so there is none."""
        return None

    def denoise(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, Any],
                scene_feat: None = None) -> torch.Tensor:
        time_emb = self.timestep_embedder(timesteps)                  # (B, 1, De)
        text_emb = cond["text_emb"].to(self.dtype)                    # (B, 1, Dt)
        h = self.contact_model(x.to(self.dtype), text_emb, time_emb, cond)
        return self.contact_layer(h.float())

    def forward(self, x, timesteps, cond):
        return self.denoise(x, timesteps, cond, self.encode_scene(cond))


def _flag(value: Any) -> bool:
    """A config flag; an interpolation the task leaves unresolved (the
    H3D task defines no ``task.dataset.use_openscene``) is unset."""
    return bool(value) and not (isinstance(value, str) and value.startswith("${"))


def build_cdm(model_cfg: Any) -> CDM:
    """A CDM from the model YAML block (``configs/model/cdm.yaml``)."""
    text_feat_dim, _ = get_lang_feat_dim_type(model_cfg.text_model.version)
    sm = model_cfg.scene_model
    arch = str(model_cfg.arch)
    ac = {"MLP": model_cfg.get("arch_mlp"),
          "Perceiver": model_cfg.get("arch_perceiver")}.get(arch) or {}
    arch_cfg = {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in ac.items()
                if k not in ("last_dim", "num_points")}
    return CDM(
        contact_dim=int(model_cfg.input_feats),
        time_emb_dim=int(model_cfg.time_emb_dim),
        text_feat_dim=text_feat_dim,
        use_scene_model=_flag(sm.use_scene_model),
        use_openscene=_flag(sm.get("use_openscene", False)),
        arch=arch,
        arch_cfg=arch_cfg,
        dtype=getattr(torch, str(model_cfg.get("dtype", "float32"))),
    )

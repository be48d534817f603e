"""CDM, the stage-1 contact diffusion denoiser (counterpart of
``afford_motion_tpu/models/cdm.py``): it predicts the clean contact map x0
over a scene's point cloud from a text embedding, a timestep embedding and,
with a scene model, per-point scene features.

Backbones: ``MLP`` (the config's default ``arch``), ``Perceiver`` (the
published configuration of every ``scripts/*_contact/train_ddp.sh``),
``PointTrans`` and ``PointTransV2`` (a 4-level point-transformer U-Net on
the SceneMap hierarchy ``levels_pt``, the [text, time] context injected at
the bottleneck; V2 adds a 512-wide self-attention layer there and injects
at levels 3 and 2 too). Point features: with ``use_scene_model`` the frozen
``PointTransformerSeg`` on the 5-level hierarchy ``levels_seg`` gives 32 a
point (``encode_scene``: once per batch or sampling chain, float32, in eval
mode whatever the CDM's mode, without gradient); with ``use_openscene`` the
dataset's OpenScene features, scored against the text embedding where
``point_feat_dim`` is 1.

Parameter names are the reference state_dict's (the scene model under
``scene_model.``), so a converted checkpoint loads with ``strict=True``.
Mixed precision as in the JAX package: float32 parameters, the backbone in
``dtype``, LayerNorms, BatchNorms and the attention's softmax in float32,
the scene model and the ``contact_layer`` head in float32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from .layers import LayerNorm, Linear, TimestepEmbedder, TransformerEncoder
from .perceiver import GELU, CrossAttentionLayer, SelfAttentionBlock
from .pointtransformer import (
    SCENEMAP_STRIDES,
    SEG_BLOCKS,
    SEG_PLANES,
    PointTransformerEncoder,
    PointTransformerSeg,
    decode,
    decoder_stages,
    point_norm,
)
from .text import get_lang_feat_dim_type

# the planes of the PointTrans backbones' four levels
CDM_PT_PLANES = (64, 128, 256, 512)


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
    """Point-MLP backbone: each point's tokens (and point features) with the
    text and time embeddings broadcast beside them, through ``point_mlp``."""

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

    def forward(self, x, point_feat, text_emb, time_emb, cond):
        B, N = x.shape[:2]
        parts = [x, *([] if point_feat is None else [point_feat]),
                 text_emb.expand(B, N, -1), time_emb.expand(B, N, -1)]
        return self.point_mlp(torch.cat([p.to(self.dtype) for p in parts], dim=-1))


class ContactPerceiver(nn.Module):
    """Perceiver-IO backbone: the point tokens (the contact map, the point
    features, the coordinates) are keys and values for a 2-token [text,
    time] query; after the latent self-attention each point
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

    def forward(self, x, point_feat, text_emb, time_emb, cond):
        if point_feat is not None:
            x = torch.cat([x, point_feat.to(x.dtype)], dim=-1)
        if self.point_pos_emb:
            x = torch.cat([x, cond["c_pc_xyz"].to(x.dtype)], dim=-1)
        enc_kv = self.encoder_adapter(x)                                   # (B, N, kv)
        enc_q = torch.cat([self.language_adapter(text_emb),
                           self.time_embedding_adapter(time_emb)], dim=1)  # (B, 2, q)
        enc_q = self.encoder_self_attn(self.encoder_cross_attn(enc_q, enc_kv))
        return self.decoder_cross_attn(self.decoder_adapter(enc_kv), enc_q)


class _CtxMLP(nn.Sequential):
    """Context injection: Linear, the ``norm`` (BatchNorm or LayerNorm), ReLU,
    Linear (``.0/.1/.3``)."""

    def __init__(self, in_dim: int, planes: int, dtype: torch.dtype = torch.float32,
                 norm: str = "batch"):
        super().__init__(Linear(in_dim, planes, dtype=dtype), point_norm(norm, planes, dtype),
                         nn.ReLU(), Linear(planes, planes, dtype=dtype))


class ContactPointTrans(PointTransformerEncoder):
    """4-level point-transformer U-Net on ``cond["levels_pt"]`` over (xyz,
    the contact map, the point features): the encoder's ``enc1..enc4``, the
    decoder's ``dec4`` (the head) .. ``dec1``. The [text, time] context is
    joined to the bottleneck's features by ``ctx``; ``v2`` runs a 1-layer,
    8-head ReLU encoder (``self_attn_layers``, dropout 0.1) over the
    bottleneck first and injects with ``ctx4``, ``ctx3`` and ``ctx2`` at
    levels 4, 3 and 2."""

    def __init__(self, in_dim: int, ctx_dim: int, blocks: Sequence[int] = (2, 2, 2, 2),
                 planes: Sequence[int] = CDM_PT_PLANES, v2: bool = False,
                 dtype: torch.dtype = torch.float32, norm: str = "batch"):
        super().__init__(3 + in_dim, planes, blocks, SCENEMAP_STRIDES, dtype=dtype, norm=norm)
        for name, stage in decoder_stages(planes, dtype=dtype, norm=norm).items():
            self.add_module(name, stage)
        self.dtype, self.v2 = dtype, v2
        if v2:
            self.self_attn_layers = TransformerEncoder(1, planes[3], 8, 1024, dtype, dropout=0.1,
                                                       activation="relu")
            for level in (4, 3, 2):
                self.add_module(f"ctx{level}", _CtxMLP(planes[level - 1] + ctx_dim,
                                                       planes[level - 1], dtype, norm))
        else:
            self.ctx = _CtxMLP(planes[3] + ctx_dim, planes[3], dtype, norm)
        self.out_dim = planes[0]

    def forward(self, x, point_feat, text_emb, time_emb, cond):
        levels = cond["levels_pt"]
        if point_feat is not None:
            x = torch.cat([x, point_feat.to(x.dtype)], dim=-1)
        context = torch.cat([text_emb, time_emb], dim=-1).to(self.dtype)   # (B, 1, Dt + De)
        feats = self.encode(levels, torch.cat([levels[0].xyz.to(x.dtype), x], dim=-1))

        def inject(mlp, feat):
            return mlp(torch.cat([feat, context.expand(*feat.shape[:2], -1)], dim=-1))

        if self.v2:
            feats[3] = inject(self.ctx4, self.self_attn_layers(feats[3]))
            feats[2] = inject(self.ctx3, feats[2])
            feats[1] = inject(self.ctx2, feats[1])
        else:
            feats[3] = inject(self.ctx, feats[3])
        return decode(self, levels, feats)[-1]                             # (B, N, planes[0])


class CDM(nn.Module):
    """Stage-1 denoiser. ``arch_cfg``: the keyword arguments of the backbone
    (``arch_mlp``, ``arch_perceiver`` or ``arch_pointtrans`` of
    ``configs/model/cdm.yaml``, without ``last_dim`` and ``num_points``).
    ``use_scene_model``: per-point features from the frozen
    ``PointTransformerSeg`` over ``scene_in_dim`` channels (xyz, and the
    colours where it is 6) of ``scene_planes`` / ``scene_blocks``, or with
    ``use_openscene`` the dataset's ``point_feat_dim`` OpenScene features.
    ``knn_exact``, ``use_banded``, ``banded_window`` and ``banded_adaptive``
    choose how the point hierarchies are built (``conditioning.
    add_hierarchies``). ``norm`` (``"batch"`` or ``"layer"``) is the
    normalisation of the scene model and of the PointTrans backbones."""

    def __init__(self, contact_dim: int, time_emb_dim: int = 128, text_feat_dim: int = 512,
                 point_feat_dim: int = 0, use_scene_model: bool = False,
                 use_openscene: bool = False, scene_in_dim: int = 6,
                 arch: str = "Perceiver", arch_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32,
                 scene_planes: Sequence[int] = SEG_PLANES,
                 scene_blocks: Sequence[int] = SEG_BLOCKS, knn_exact: bool = False,
                 use_banded: bool = False, banded_window: int = 0,
                 banded_adaptive: Optional[bool] = None, norm: str = "batch"):
        super().__init__()
        self.dtype, self.arch = dtype, arch
        self.use_scene_model, self.use_openscene = use_scene_model, use_openscene
        self.point_feat_dim = point_feat_dim
        self.knn_exact, self.use_banded = knn_exact, use_banded
        self.banded_window, self.banded_adaptive = banded_window, banded_adaptive
        self.timestep_embedder = TimestepEmbedder(time_emb_dim, time_emb_dim, 1000, dtype)
        if self.needs_seg_hierarchy:
            # frozen, float32 and in eval mode always (see train())
            self.scene_model = PointTransformerSeg(scene_in_dim, scene_planes, scene_blocks,
                                                   norm=norm)
            self.scene_model.requires_grad_(False)
            feat_dim = scene_planes[0]
        else:
            self.scene_model = None
            feat_dim = point_feat_dim if use_scene_model else 0
        in_dim = contact_dim + feat_dim
        ac = dict(arch_cfg or {})
        if arch == "MLP":
            backbone = ContactMLP(in_dim + text_feat_dim + time_emb_dim, **ac, dtype=dtype)
        elif arch == "Perceiver":
            backbone = ContactPerceiver(in_dim, text_feat_dim, time_emb_dim, **ac, dtype=dtype)
        elif arch in ("PointTrans", "PointTransV2"):
            backbone = ContactPointTrans(in_dim, text_feat_dim + time_emb_dim, **ac,
                                         v2=arch == "PointTransV2", dtype=dtype, norm=norm)
        else:
            raise NotImplementedError(f"CDM arch {arch!r}")
        self.contact_model = backbone
        # the prediction head stays float32: the x0 math is full precision
        self.contact_layer = Linear(backbone.out_dim, contact_dim, dtype=torch.float32)

    @property
    def needs_seg_hierarchy(self) -> bool:
        return self.use_scene_model and not self.use_openscene

    @property
    def needs_pt_hierarchy(self) -> bool:
        return self.arch in ("PointTrans", "PointTransV2")

    def train(self, mode: bool = True) -> "CDM":
        """The CDM's mode; the frozen scene model stays in eval mode, so that
        its BatchNorms keep their running statistics."""
        super().train(mode)
        if self.scene_model is not None:
            self.scene_model.eval()
        return self

    @torch.no_grad()
    def encode_scene(self, cond: Dict[str, Any]) -> Optional[torch.Tensor]:
        """The frozen per-point scene features (B, N, 32) in float32, once
        per batch or sampling chain; None where the configuration reads no
        scene model."""
        if not self.needs_seg_hierarchy:
            return None
        return self.scene_model(cond["levels_seg"], cond["c_pc_feat"])

    def _point_features(self, cond: Dict[str, Any], text_emb: torch.Tensor,
                        scene_feat: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The per-point conditioning features: the scene model's, or the
        dataset's OpenScene features (with ``point_feat_dim`` 1 scored
        against the text embedding unless they are one channel already)."""
        if scene_feat is not None:
            return scene_feat
        if not self.use_scene_model or self.point_feat_dim == 0:
            return None
        if "c_pc_feat" not in cond:
            raise KeyError("c_pc_feat: a CDM with use_openscene reads the dataset's OpenScene "
                           "point features, which this batch does not carry")
        pc_feat = cond["c_pc_feat"]
        if self.point_feat_dim == 1 and pc_feat.shape[-1] != 1:
            return torch.einsum("bnd,bmd->bnm", pc_feat.float(), text_emb.float())
        return pc_feat

    def denoise(self, x: torch.Tensor, timesteps: torch.Tensor, cond: Dict[str, Any],
                scene_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        time_emb = self.timestep_embedder(timesteps)                  # (B, 1, De)
        text_emb = cond["text_emb"].to(self.dtype)                    # (B, 1, Dt)
        point_feat = self._point_features(cond, text_emb, scene_feat)
        h = self.contact_model(x.to(self.dtype), point_feat, text_emb, time_emb, cond)
        return self.contact_layer(h.float())

    def forward(self, x, timesteps, cond):
        return self.denoise(x, timesteps, cond, self.encode_scene(cond))


def _unresolved(value: Any) -> bool:
    """A config value the task leaves an unresolved interpolation (the H3D
    task defines no ``task.dataset.use_color`` / ``use_openscene``)."""
    return isinstance(value, str) and value.startswith("${")


def build_cdm(model_cfg: Any) -> CDM:
    """A CDM from the model YAML block (``configs/model/cdm.yaml``). A scene
    model on a task that leaves ``use_openscene`` unresolved is refused: the
    JAX package reads that string as true and fails on the ``c_pc_feat``
    that such a task's items lack."""
    text_feat_dim, _ = get_lang_feat_dim_type(model_cfg.text_model.version)
    sm = model_cfg.scene_model
    use_scene_model = bool(sm.use_scene_model)
    openscene = sm.get("use_openscene", False)
    if use_scene_model and _unresolved(openscene):
        raise ValueError(
            f"model.scene_model.use_openscene is {openscene!r} on this task: read as true, the "
            "CDM takes the OpenScene features cond['c_pc_feat'], which this task's items do "
            "not carry; set model.scene_model.use_scene_model=False, as the published "
            "HumanML3D scripts do")
    arch = str(model_cfg.arch)
    ac = {"MLP": model_cfg.get("arch_mlp"), "Perceiver": model_cfg.get("arch_perceiver"),
          "PointTrans": model_cfg.get("arch_pointtrans"),
          "PointTransV2": model_cfg.get("arch_pointtrans")}.get(arch) or {}
    arch_cfg = {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in ac.items()
                if k not in ("last_dim", "num_points")}
    return CDM(
        contact_dim=int(model_cfg.input_feats),
        time_emb_dim=int(model_cfg.time_emb_dim),
        text_feat_dim=text_feat_dim,
        point_feat_dim=int(sm.point_feat_dim) if use_scene_model else 0,
        use_scene_model=use_scene_model,
        use_openscene=bool(openscene),
        scene_in_dim=3 + 3 * bool(sm.get("use_color", True)),
        arch=arch,
        arch_cfg=arch_cfg,
        dtype=getattr(torch, str(model_cfg.get("dtype", "float32"))),
        knn_exact=bool(model_cfg.get("knn_exact", False)),
        use_banded=bool(model_cfg.get("use_banded", False)),
        banded_window=int(model_cfg.get("banded_window", 0) or 0),
        banded_adaptive=model_cfg.get("banded_adaptive", None),
        norm=str(model_cfg.get("norm", "batch")),
    )

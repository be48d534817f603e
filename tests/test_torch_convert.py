"""Checkpoint-converter structural tests: synthesize torch state dicts with
the reference's key names and shapes, convert, and assert the result aligns
leaf-for-leaf with freshly initialized flax variables."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from afford_motion_tpu.utils.torch_convert import (
    assert_tree_compatible,
    convert_cdm_checkpoint,
    convert_cmdm_checkpoint,
    convert_pointtransformer_seg,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

rng = np.random.default_rng(0)


def _lin(sd, name, out_dim, in_dim, bias=True):
    # kaiming-ish scale so the deep synthetic nets stay finite
    sd[f"{name}.weight"] = (
        rng.normal(size=(out_dim, in_dim)) / np.sqrt(in_dim)
    ).astype(np.float32)
    if bias:
        sd[f"{name}.bias"] = (rng.normal(size=(out_dim,)) * 0.01).astype(np.float32)


def _bn(sd, name, dim):
    sd[f"{name}.weight"] = np.ones(dim, np.float32)
    sd[f"{name}.bias"] = np.zeros(dim, np.float32)
    sd[f"{name}.running_mean"] = np.zeros(dim, np.float32)
    sd[f"{name}.running_var"] = np.ones(dim, np.float32)


def _ln(sd, name, dim):
    sd[f"{name}.weight"] = np.ones(dim, np.float32)
    sd[f"{name}.bias"] = np.zeros(dim, np.float32)


def _pt_layer_sd(sd, p, planes, share=8):
    _lin(sd, f"{p}.linear_q", planes, planes)
    _lin(sd, f"{p}.linear_k", planes, planes)
    _lin(sd, f"{p}.linear_v", planes, planes)
    _lin(sd, f"{p}.linear_p.0", 3, 3)
    _bn(sd, f"{p}.linear_p.1", 3)
    _lin(sd, f"{p}.linear_p.3", planes, 3)
    _bn(sd, f"{p}.linear_w.0", planes)
    _lin(sd, f"{p}.linear_w.2", planes // share, planes)
    _bn(sd, f"{p}.linear_w.3", planes // share)
    _lin(sd, f"{p}.linear_w.5", planes // share, planes // share)


def _pt_block_sd(sd, p, planes):
    _lin(sd, f"{p}.linear1", planes, planes, bias=False)
    _bn(sd, f"{p}.bn1", planes)
    _pt_layer_sd(sd, f"{p}.transformer2", planes)
    _bn(sd, f"{p}.bn2", planes)
    _lin(sd, f"{p}.linear3", planes, planes, bias=False)
    _bn(sd, f"{p}.bn3", planes)


def make_pt_sd(blocks, planes, strides, c, prefix="", with_decoder=True):
    """Synthesize the reference PointTransformer state dict
    (reference: pointtransformer.py:126-164 module layout)."""
    sd = {}
    in_planes = c
    for k, (nb, p, s) in enumerate(zip(blocks, planes, strides), start=1):
        td = f"{prefix}enc{k}.0"
        if s != 1:
            _lin(sd, f"{td}.linear", p, 3 + in_planes, bias=False)
        else:
            _lin(sd, f"{td}.linear", p, in_planes, bias=False)
        _bn(sd, f"{td}.bn", p)
        for j in range(1, nb):
            _pt_block_sd(sd, f"{prefix}enc{k}.{j}", p)
        in_planes = p
    if with_decoder:
        L = len(planes)
        for k in range(L, 0, -1):
            tu = f"{prefix}dec{k}.0"
            pk = planes[k - 1]
            if k == L:  # head
                _lin(sd, f"{tu}.linear1.0", pk, 2 * pk)
                _bn(sd, f"{tu}.linear1.1", pk)
                _lin(sd, f"{tu}.linear2.0", pk, pk)
            else:
                coarse = planes[k]
                _lin(sd, f"{tu}.linear1.0", pk, pk)
                _bn(sd, f"{tu}.linear1.1", pk)
                _lin(sd, f"{tu}.linear2.0", pk, coarse)
                _bn(sd, f"{tu}.linear2.1", pk)
            _pt_block_sd(sd, f"{prefix}dec{k}.1", pk)
    return sd


def test_pointtransformer_seg_conversion():
    from afford_motion_tpu.models.pointtransformer import (
        SEG_BLOCKS, SEG_NSAMPLES, SEG_PLANES, SEG_STRIDES, PointTransformerSeg,
    )
    from afford_motion_tpu.ops import build_point_hierarchy

    sd = make_pt_sd(SEG_BLOCKS, SEG_PLANES, SEG_STRIDES, c=6)
    converted = convert_pointtransformer_seg(sd, SEG_BLOCKS)

    xyz = jnp.asarray(rng.normal(size=(1, 1024, 3)).astype(np.float32))
    levels = build_point_hierarchy(xyz, SEG_STRIDES, SEG_NSAMPLES)
    feats = jnp.ones((1, 1024, 3))
    model = PointTransformerSeg(c=6)
    variables = model.init(jax.random.PRNGKey(0), levels, feats)

    assert_tree_compatible(converted["params"], variables["params"])
    assert_tree_compatible(converted["batch_stats"], variables["batch_stats"])

    # converted weights must actually run
    out = model.apply(
        {"params": converted["params"], "batch_stats": converted["batch_stats"]},
        levels, feats,
    )
    assert out.shape == (1, 1024, 32)
    assert np.isfinite(np.asarray(out)).all()


def test_cmdm_conversion():
    from afford_motion_tpu.models.cmdm import CMDM
    from afford_motion_tpu.models.scene_map import SCENEMAP_NSAMPLES, SCENEMAP_STRIDES
    from afford_motion_tpu.ops import build_point_hierarchy

    planes, blocks, latent, nl = (32, 64, 128, 256), (2, 2, 2, 2), 512, (1, 1, 1, 1, 1)
    sd = make_pt_sd(blocks, planes, (1, 4, 4, 4), c=9, prefix="contact_encoder.",
                    with_decoder=False)
    _lin(sd, "timestep_embedder.time_embed.0", latent, 512)
    _lin(sd, "timestep_embedder.time_embed.2", latent, latent)
    _lin(sd, "contact_adapter", latent, planes[-1])
    _lin(sd, "language_adapter", latent, 512)
    _lin(sd, "motion_adapter", latent, 263)
    _lin(sd, "motion_layer", 263, latent)
    for i in range(sum(nl)):
        p = f"self_attn_layer.layers.{i}"
        sd[f"{p}.self_attn.in_proj_weight"] = rng.normal(size=(3 * latent, latent)).astype(np.float32)
        sd[f"{p}.self_attn.in_proj_bias"] = rng.normal(size=(3 * latent,)).astype(np.float32)
        _lin(sd, f"{p}.self_attn.out_proj", latent, latent)
        _ln(sd, f"{p}.norm1", latent)
        _lin(sd, f"{p}.linear1", 1024, latent)
        _lin(sd, f"{p}.linear2", latent, 1024)
        _ln(sd, f"{p}.norm2", latent)

    converted = convert_cmdm_checkpoint(sd, num_layers=nl, blocks=blocks)

    model = CMDM(motion_dim=263, latent_dim=latent, time_emb_dim=512,
                 text_feat_dim=512, contact_dim=6, planes=planes, blocks=blocks,
                 arch="trans_enc", num_layers=nl, num_heads=8, dim_feedforward=1024)
    xyz = jnp.asarray(rng.normal(size=(1, 256, 3)).astype(np.float32))
    cond = {
        "text_emb": jnp.zeros((1, 1, 512)),
        "c_pc_xyz": xyz,
        "c_pc_contact": jnp.zeros((1, 256, 6)),
        "levels_sm": build_point_hierarchy(xyz, SCENEMAP_STRIDES, SCENEMAP_NSAMPLES),
        "x_mask": jnp.zeros((1, 8), dtype=bool),
    }
    x = jnp.zeros((1, 8, 263))
    t = jnp.zeros((1,), dtype=jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), x, t, cond)
    assert_tree_compatible(converted["params"], variables["params"])
    assert_tree_compatible(converted["batch_stats"], variables["batch_stats"])
    out = model.apply(converted, x, t, cond)
    assert out.shape == (1, 8, 263) and np.isfinite(np.asarray(out)).all()


def test_cdm_perceiver_conversion():
    from afford_motion_tpu.models.cdm import CDM

    q, kv, text, time_d = 512, 256, 512, 128
    sd = {}
    _lin(sd, "timestep_embedder.time_embed.0", time_d, time_d)
    _lin(sd, "timestep_embedder.time_embed.2", time_d, time_d)
    _lin(sd, "contact_layer", 6, kv)
    cm = "contact_model"
    _lin(sd, f"{cm}.encoder_adapter", kv, 6 + 3)
    _lin(sd, f"{cm}.language_adapter", q, text)
    _lin(sd, f"{cm}.time_embedding_adapter", q, time_d)
    _lin(sd, f"{cm}.decoder_adapter", kv, kv)

    def cross(p, qd, kvd):
        _ln(sd, f"{p}.0.module.q_norm", qd)
        _ln(sd, f"{p}.0.module.kv_norm", kvd)
        _lin(sd, f"{p}.0.module.attention.q_proj", qd, qd)
        _lin(sd, f"{p}.0.module.attention.k_proj", qd, kvd)
        _lin(sd, f"{p}.0.module.attention.v_proj", qd, kvd)
        _lin(sd, f"{p}.0.module.attention.o_proj", qd, qd)
        _ln(sd, f"{p}.1.module.0", qd)
        _lin(sd, f"{p}.1.module.1", qd, qd)
        _lin(sd, f"{p}.1.module.3", qd, qd)

    def self_l(p, d):
        _ln(sd, f"{p}.0.module.norm", d)
        _lin(sd, f"{p}.0.module.attention.q_proj", d, d)
        _lin(sd, f"{p}.0.module.attention.k_proj", d, d)
        _lin(sd, f"{p}.0.module.attention.v_proj", d, d)
        _lin(sd, f"{p}.0.module.attention.o_proj", d, d)
        _ln(sd, f"{p}.1.module.0", d)
        _lin(sd, f"{p}.1.module.1", d, d)
        _lin(sd, f"{p}.1.module.3", d, d)

    cross(f"{cm}.encoder_cross_attn", q, kv)
    self_l(f"{cm}.encoder_self_attn.0", q)
    self_l(f"{cm}.encoder_self_attn.1", q)
    cross(f"{cm}.decoder_cross_attn", kv, q)

    converted = convert_cdm_checkpoint(sd, self_attn_layers=2)

    arch_cfg = (
        ("point_pos_emb", True),
        ("encoder_q_input_channels", q), ("encoder_kv_input_channels", kv),
        ("encoder_num_heads", 8), ("encoder_widening_factor", 1),
        ("encoder_dropout", 0.1), ("encoder_residual_dropout", 0.0),
        ("encoder_self_attn_num_layers", 2),
        ("decoder_q_input_channels", kv), ("decoder_kv_input_channels", q),
        ("decoder_num_heads", 8), ("decoder_widening_factor", 1),
        ("decoder_dropout", 0.1), ("decoder_residual_dropout", 0.0),
    )
    model = CDM(contact_dim=6, time_emb_dim=time_d, text_feat_dim=text,
                point_feat_dim=0, use_scene_model=False, arch="Perceiver",
                arch_cfg=arch_cfg, last_dim=kv)
    N = 128
    cond = {
        "text_emb": jnp.zeros((1, 1, text)),
        "c_pc_xyz": jnp.asarray(rng.normal(size=(1, N, 3)).astype(np.float32)),
        "c_pc_feat": jnp.zeros((1, N, 3)),
    }
    x = jnp.zeros((1, N, 6))
    t = jnp.zeros((1,), dtype=jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), x, t, cond)
    assert_tree_compatible(converted["params"], variables["params"])
    out = model.apply({"params": converted["params"]}, x, t, cond)
    assert out.shape == (1, N, 6) and np.isfinite(np.asarray(out)).all()


def test_cmdm_trans_dec_conversion():
    from afford_motion_tpu.models.cmdm import CMDM
    from afford_motion_tpu.models.scene_map import SCENEMAP_NSAMPLES, SCENEMAP_STRIDES
    from afford_motion_tpu.ops import build_point_hierarchy

    planes, blocks, latent, nl = (16, 32, 64, 128), (2, 2, 2, 2), 64, (1, 1, 1)
    sd = make_pt_sd(blocks, planes, (1, 4, 4, 4), c=9, prefix="contact_encoder.",
                    with_decoder=True)
    _lin(sd, "timestep_embedder.time_embed.0", latent, latent)
    _lin(sd, "timestep_embedder.time_embed.2", latent, latent)
    _lin(sd, "language_adapter", latent, 64)
    _lin(sd, "motion_adapter", latent, 66)
    _lin(sd, "motion_layer", 66, latent)

    def enc_layer(p, d, ff):
        sd[f"{p}.self_attn.in_proj_weight"] = (
            rng.normal(size=(3 * d, d)) / np.sqrt(d)).astype(np.float32)
        sd[f"{p}.self_attn.in_proj_bias"] = np.zeros(3 * d, np.float32)
        _lin(sd, f"{p}.self_attn.out_proj", d, d)
        _ln(sd, f"{p}.norm1", d)
        _lin(sd, f"{p}.linear1", ff, d)
        _lin(sd, f"{p}.linear2", d, ff)
        _ln(sd, f"{p}.norm2", d)

    for i, n in enumerate(nl):
        for j in range(n):
            enc_layer(f"self_attn_layers.{i}.layers.{j}", latent, 128)
    for i in range(len(nl) - 1):
        _lin(sd, f"kv_mappling_layers.{i}.0", latent, planes[-1 - i])
        _ln(sd, f"kv_mappling_layers.{i}.1", latent)
        p = f"cross_attn_layers.{i}"
        for attn in ("self_attn", "multihead_attn"):
            sd[f"{p}.{attn}.in_proj_weight"] = (
                rng.normal(size=(3 * latent, latent)) / np.sqrt(latent)).astype(np.float32)
            sd[f"{p}.{attn}.in_proj_bias"] = np.zeros(3 * latent, np.float32)
            _lin(sd, f"{p}.{attn}.out_proj", latent, latent)
        _ln(sd, f"{p}.norm1", latent)
        _ln(sd, f"{p}.norm2", latent)
        _ln(sd, f"{p}.norm3", latent)
        _lin(sd, f"{p}.linear1", 128, latent)
        _lin(sd, f"{p}.linear2", latent, 128)

    converted = convert_cmdm_checkpoint(sd, num_layers=nl, blocks=blocks, arch="trans_dec")

    model = CMDM(motion_dim=66, latent_dim=latent, time_emb_dim=latent,
                 text_feat_dim=64, contact_dim=6, planes=planes, blocks=blocks,
                 arch="trans_dec", num_layers=nl, num_heads=4, dim_feedforward=128)
    xyz = jnp.asarray(rng.normal(size=(1, 256, 3)).astype(np.float32))
    cond = {
        "text_emb": jnp.zeros((1, 1, 64)),
        "c_pc_xyz": xyz,
        "c_pc_contact": jnp.zeros((1, 256, 6)),
        "levels_sm": build_point_hierarchy(xyz, SCENEMAP_STRIDES, SCENEMAP_NSAMPLES),
        "x_mask": jnp.zeros((1, 8), dtype=bool),
    }
    x = jnp.zeros((1, 8, 66))
    t = jnp.zeros((1,), dtype=jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), x, t, cond)
    assert_tree_compatible(converted["params"], variables["params"])
    assert_tree_compatible(converted["batch_stats"], variables["batch_stats"])
    out = model.apply(converted, x, t, cond)
    assert out.shape == (1, 8, 66) and np.isfinite(np.asarray(out)).all()


def test_cdm_mlp_conversion():
    from afford_motion_tpu.models.cdm import CDM

    sd = {}
    _lin(sd, "timestep_embedder.time_embed.0", 32, 32)
    _lin(sd, "timestep_embedder.time_embed.2", 32, 32)
    _lin(sd, "contact_layer", 6, 64)
    dims = [64, 64]
    idim = 6 + 64 + 32  # contact + text + time (no point feats)
    for i, odim in enumerate(dims):
        p = f"contact_model.point_mlp.{i}"
        _ln(sd, f"{p}.mlp_pre.0", idim)
        _lin(sd, f"{p}.mlp_pre.1", idim, idim)
        _lin(sd, f"{p}.mlp_pre.3", odim, idim)
        _ln(sd, f"{p}.mlp_post.0", 2 * odim)
        _lin(sd, f"{p}.mlp_post.1", 2 * odim, 2 * odim)
        _lin(sd, f"{p}.mlp_post.3", odim, 2 * odim)
        idim = odim

    converted = convert_cdm_checkpoint(sd, arch="MLP", mlp_layers=2)

    model = CDM(contact_dim=6, time_emb_dim=32, text_feat_dim=64, point_feat_dim=0,
                use_scene_model=False, arch="MLP",
                arch_cfg=(("point_mlp_dims", (64, 64)),
                          ("point_mlp_widening_factor", 1), ("point_mlp_bias", True)),
                last_dim=64)
    N = 64
    cond = {
        "text_emb": jnp.zeros((1, 1, 64)),
        "c_pc_xyz": jnp.asarray(rng.normal(size=(1, N, 3)).astype(np.float32)),
        "c_pc_feat": jnp.zeros((1, N, 3)),
    }
    x = jnp.zeros((1, N, 6))
    t = jnp.zeros((1,), dtype=jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), x, t, cond)
    assert_tree_compatible(converted["params"], variables["params"])
    out = model.apply({"params": converted["params"]}, x, t, cond)
    assert out.shape == (1, N, 6) and np.isfinite(np.asarray(out)).all()

"""Weights between the JAX package and the port: the flax variable tree of a
CMDM (``trans_enc`` or ``trans_dec``), of a CDM (MLP, Perceiver, PointTrans
or PointTransV2, with or without its frozen scene model), of the scene model
``PointTransformerSeg`` alone, or of the joints-to-SMPL-X regressor, <-> the
port's state_dict (the reference torch layout); the T2M evaluator's numpy parameter dicts <-> its
three state dicts; and the SMPL-X body model's arrays.

One table of (state_dict key, flax path, kind) entries drives both
directions, so they are inverses by construction. Kinds: ``w`` a Dense
kernel (transposed), ``v`` a vector copied as is, ``qkv_w`` / ``qkv_b`` the
three separate q/k/v Dense layers packed into torch's ``in_proj``, and
``q_kv_w`` / ``q_kv_b`` the q Dense and the packed k/v Dense of a
cross-attention whose key is its value, packed likewise. With ``fused_qkv``
a self-attention's ``in_proj`` is its one packed Dense, whole: kinds ``w``
and ``v`` (the flax module's ``fused_qkv=True`` layout).
Numpy only; the leaves may be numpy or jax arrays.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _dense(key: str, path: Path, bias: bool = True):
    yield f"{key}.weight", ("params", *path, "kernel"), "w"
    if bias:
        yield f"{key}.bias", ("params", *path, "bias"), "v"


def _layernorm(key: str, path: Path):
    yield f"{key}.weight", ("params", *path, "scale"), "v"
    yield f"{key}.bias", ("params", *path, "bias"), "v"


def _bn(key: str, path: Path):
    yield f"{key}.weight", ("params", *path, "BatchNorm_0", "scale"), "v"
    yield f"{key}.bias", ("params", *path, "BatchNorm_0", "bias"), "v"
    yield f"{key}.running_mean", ("batch_stats", *path, "BatchNorm_0", "mean"), "v"
    yield f"{key}.running_var", ("batch_stats", *path, "BatchNorm_0", "var"), "v"


def _norm(key: str, path: Path, norm: str):
    """A ``PointNorm_k`` at ``path``: its flax ``BatchNorm_0`` (scale, bias and
    the running statistics) for ``norm="batch"``, its ``LayerNorm_0`` (scale
    and bias, no statistics) for ``"layer"``."""
    if norm == "batch":
        yield from _bn(key, path)
    elif norm == "layer":
        yield from _layernorm(key, (*path, "LayerNorm_0"))
    else:
        raise ValueError(f"norm {norm!r}: expected 'batch' or 'layer'")


def _pt_layer(key: str, path: Path, norm: str):
    for i, name in enumerate(("linear_q", "linear_k", "linear_v")):
        yield from _dense(f"{key}.{name}", (*path, f"Dense_{i}"))
    yield from _dense(f"{key}.linear_p.0", (*path, "Dense_3"))
    yield from _norm(f"{key}.linear_p.1", (*path, "PointNorm_0"), norm)
    yield from _dense(f"{key}.linear_p.3", (*path, "Dense_4"))
    yield from _norm(f"{key}.linear_w.0", (*path, "PointNorm_1"), norm)
    yield from _dense(f"{key}.linear_w.2", (*path, "Dense_5"))
    yield from _norm(f"{key}.linear_w.3", (*path, "PointNorm_2"), norm)
    yield from _dense(f"{key}.linear_w.5", (*path, "Dense_6"))


def _pt_block(key: str, path: Path, norm: str):
    yield from _dense(f"{key}.linear1", (*path, "Dense_0"), bias=False)
    yield from _norm(f"{key}.bn1", (*path, "PointNorm_0"), norm)
    yield from _pt_layer(f"{key}.transformer2", (*path, "PointTransformerLayer_0"), norm)
    yield from _norm(f"{key}.bn2", (*path, "PointNorm_1"), norm)
    yield from _dense(f"{key}.linear3", (*path, "Dense_1"), bias=False)
    yield from _norm(f"{key}.bn3", (*path, "PointNorm_2"), norm)


def _mha(key: str, path: Path, packing: str = "qkv"):
    """A ``TorchMultiHeadAttention`` at ``path``: ``"qkv"`` three Dense layers
    (``Dense_0..2``) and ``Dense_3`` out; ``"fused"`` one packed Dense
    (``Dense_0``, in_proj whole) and ``Dense_1`` out, a fused self-attention;
    ``"q_kv"`` the q Dense, the packed k/v Dense and ``Dense_2`` out, a fused
    cross-attention whose key is its value."""
    if packing == "fused":
        yield f"{key}.in_proj_weight", ("params", *path, "Dense_0", "kernel"), "w"
        yield f"{key}.in_proj_bias", ("params", *path, "Dense_0", "bias"), "v"
        yield from _dense(f"{key}.out_proj", (*path, "Dense_1"))
        return
    kinds, out = {"qkv": (("qkv_w", "qkv_b"), "Dense_3"),
                  "q_kv": (("q_kv_w", "q_kv_b"), "Dense_2")}[packing]
    yield f"{key}.in_proj_weight", ("params", *path), kinds[0]
    yield f"{key}.in_proj_bias", ("params", *path), kinds[1]
    yield from _dense(f"{key}.out_proj", (*path, out))


def _encoder_layer(key: str, path: Path, fused_qkv: bool = False):
    yield from _mha(f"{key}.self_attn", (*path, "TorchMultiHeadAttention_0"),
                    "fused" if fused_qkv else "qkv")
    yield from _layernorm(f"{key}.norm1", (*path, "LayerNorm_0"))
    yield from _dense(f"{key}.linear1", (*path, "Dense_0"))
    yield from _dense(f"{key}.linear2", (*path, "Dense_1"))
    yield from _layernorm(f"{key}.norm2", (*path, "LayerNorm_1"))


def _decoder_layer(key: str, path: Path, fused_qkv: bool = False):
    for j, (name, packing) in enumerate((("self_attn", "fused"), ("multihead_attn", "q_kv"))):
        yield from _mha(f"{key}.{name}", (*path, f"TorchMultiHeadAttention_{j}"),
                        packing if fused_qkv else "qkv")
    for j in range(3):
        yield from _layernorm(f"{key}.norm{j + 1}", (*path, f"LayerNorm_{j}"))
    yield from _dense(f"{key}.linear1", (*path, "Dense_0"))
    yield from _dense(f"{key}.linear2", (*path, "Dense_1"))


def _point_encoder(key: str, path: Path, blocks: Sequence[int], norm: str):
    """``{key}enc{k}`` <-> ``PointEncoderStage_{k - 1}`` under ``path``: a
    TransitionDown and ``blocks[k - 1] - 1`` PointTransformerBlocks."""
    for k, nblocks in enumerate(blocks, start=1):
        stage = (*path, f"PointEncoderStage_{k - 1}")
        yield from _dense(f"{key}enc{k}.0.linear", (*stage, "TransitionDown_0", "Dense_0"),
                          bias=False)
        yield from _norm(f"{key}enc{k}.0.bn", (*stage, "TransitionDown_0", "PointNorm_0"), norm)
        for j in range(1, nblocks):
            yield from _pt_block(f"{key}enc{k}.{j}", (*stage, f"PointTransformerBlock_{j - 1}"),
                                 norm)


def _point_decoder(key: str, path: Path, n_levels: int, norm: str):
    """``{key}dec{k}`` <-> ``PointDecoderStage_{n_levels - k}`` under
    ``path``; stage 0, ``dec{n_levels}``, is the head, whose ``Dense_0`` is
    ``linear2``."""
    for k in range(n_levels, 0, -1):
        stage = (*path, f"PointDecoderStage_{n_levels - k}")
        up, tu = f"{key}dec{k}.0", (*stage, "TransitionUp_0")
        if k == n_levels:
            yield from _dense(f"{up}.linear2.0", (*tu, "Dense_0"))
            yield from _dense(f"{up}.linear1.0", (*tu, "Dense_1"))
            yield from _norm(f"{up}.linear1.1", (*tu, "PointNorm_0"), norm)
        else:
            for j, part in enumerate(("linear1", "linear2")):
                yield from _dense(f"{up}.{part}.0", (*tu, f"Dense_{j}"))
                yield from _norm(f"{up}.{part}.1", (*tu, f"PointNorm_{j}"), norm)
        yield from _pt_block(f"{key}dec{k}.1", (*stage, "PointTransformerBlock_0"), norm)


def pointtransformer_seg_entries(blocks: Sequence[int], key: str = "", path: Path = (),
                                 norm: str = "batch") -> Iterator[Tuple[str, Path, str]]:
    """Every (state_dict key, flax path, kind) of a ``PointTransformerSeg``
    of ``blocks`` (the scene model's are 2/3/4/6/3) and ``norm``, its torch
    keys under the prefix ``key`` and its flax tree under ``path``:
    ``enc{k}`` <-> ``enc/PointEncoderStage_{k - 1}``, ``dec{k}`` <->
    ``dec/PointDecoderStage_*``."""
    yield from _point_encoder(key, (*path, "enc"), blocks, norm)
    yield from _point_decoder(key, (*path, "dec"), len(blocks), norm)


def cmdm_entries(num_layers: Sequence[int], blocks: Sequence[int], arch: str = "trans_enc",
                 norm: str = "batch", fused_qkv: bool = False
                 ) -> Iterator[Tuple[str, Path, str]]:
    """Every (state_dict key, flax path, kind) of a CMDM of ``arch``
    (``trans_enc`` or ``trans_dec``) whose contact encoder has ``norm``
    (``"batch"`` or ``"layer"``); ``fused_qkv``: the flax tree of a model
    built with the flag (the state_dict is the same either way)."""
    if arch not in ("trans_enc", "trans_dec"):
        raise NotImplementedError(f"CMDM arch {arch!r}")
    yield from _dense("timestep_embedder.time_embed.0", ("timestep_embedder", "Dense_0"))
    yield from _dense("timestep_embedder.time_embed.2", ("timestep_embedder", "Dense_1"))
    adapters = ("language_adapter", "motion_adapter", "motion_layer")
    for name in adapters + (("contact_adapter",) if arch == "trans_enc" else ()):
        yield from _dense(name, (name,))
    yield from _point_encoder("contact_encoder.", ("contact_encoder", "enc"), blocks, norm)
    if arch == "trans_enc":
        for i in range(sum(num_layers)):
            yield from _encoder_layer(f"self_attn_layer.layers.{i}",
                                      ("self_attn_layer", f"TransformerEncoderLayer_{i}"),
                                      fused_qkv)
        return
    yield from _point_decoder("contact_encoder.", ("contact_encoder", "dec"), len(blocks), norm)
    for i, n in enumerate(num_layers):
        for j in range(n):
            yield from _encoder_layer(f"self_attn_layers.{i}.layers.{j}",
                                      (f"self_attn_layers_{i}", f"TransformerEncoderLayer_{j}"),
                                      fused_qkv)
    for i in range(len(num_layers) - 1):
        # the reference's own spelling on the torch side
        yield from _dense(f"kv_mappling_layers.{i}.0", (f"kv_mapping_layers_{i}", "Dense_0"))
        yield from _layernorm(f"kv_mappling_layers.{i}.1",
                              (f"kv_mapping_layers_{i}", "LayerNorm_0"))
        yield from _decoder_layer(f"cross_attn_layers.{i}", (f"cross_attn_layers_{i}",),
                                  fused_qkv)


def _perceiver_layer(key: str, path: Path, cross: bool):
    """A krasserm cross- or self-attention layer: ``Sequential(Residual(
    attention), Residual(MLP))``."""
    if cross:
        yield from _layernorm(f"{key}.0.module.q_norm", (*path, "LayerNorm_0"))
        yield from _layernorm(f"{key}.0.module.kv_norm", (*path, "LayerNorm_1"))
    else:
        yield from _layernorm(f"{key}.0.module.norm", (*path, "LayerNorm_0"))
    for i, name in enumerate(("q_proj", "k_proj", "v_proj", "o_proj")):
        yield from _dense(f"{key}.0.module.attention.{name}", (*path, "PerceiverMHA_0", f"Dense_{i}"))
    mlp = (*path, "PerceiverMLP_0")
    yield from _layernorm(f"{key}.1.module.0", (*mlp, "LayerNorm_0"))
    yield from _dense(f"{key}.1.module.1", (*mlp, "Dense_0"))
    yield from _dense(f"{key}.1.module.3", (*mlp, "Dense_1"))


def cdm_entries(arch: str = "Perceiver", *, self_attn_layers: int = 2, mlp_layers: int = 2,
                mlp_bias: bool = True, blocks: Sequence[int] = (2, 2, 2, 2),
                scene_blocks: Optional[Sequence[int]] = None, norm: str = "batch"
                ) -> Iterator[Tuple[str, Path, str]]:
    """Every (state_dict key, flax path, kind) of a CDM: ``Perceiver`` with
    ``self_attn_layers`` latent layers, ``MLP`` with ``mlp_layers``
    point-scene MLPs, ``PointTrans`` / ``PointTransV2`` with ``blocks`` a
    stage; with ``scene_blocks`` also its frozen ``PointTransformerSeg``
    (``scene_model.*``) of those blocks. ``norm`` is the normalisation of
    the scene model and of the PointTrans backbones."""
    yield from _dense("timestep_embedder.time_embed.0", ("timestep_embedder", "Dense_0"))
    yield from _dense("timestep_embedder.time_embed.2", ("timestep_embedder", "Dense_1"))
    yield from _dense("contact_layer", ("contact_layer",))
    if scene_blocks is not None:
        yield from pointtransformer_seg_entries(scene_blocks, "scene_model.", ("scene_model",),
                                                norm)
    cm = ("contact_model",)
    if arch == "MLP":
        for i in range(mlp_layers):
            key, path = f"contact_model.point_mlp.{i}", (*cm, f"PointSceneMLP_{i}")
            for part, (ln, d0, d1) in (("mlp_pre", (0, 0, 1)), ("mlp_post", (1, 2, 3))):
                yield from _layernorm(f"{key}.{part}.0", (*path, f"LayerNorm_{ln}"))
                yield from _dense(f"{key}.{part}.1", (*path, f"Dense_{d0}"), bias=mlp_bias)
                yield from _dense(f"{key}.{part}.3", (*path, f"Dense_{d1}"), bias=mlp_bias)
        return
    if arch in ("PointTrans", "PointTransV2"):
        yield from _point_encoder("contact_model.", cm, blocks, norm)
        yield from _point_decoder("contact_model.", cm, len(blocks), norm)
        # the context MLPs in the order the flax module makes them
        names = ("ctx4", "ctx3", "ctx2") if arch == "PointTransV2" else ("ctx",)
        for i, name in enumerate(names):
            ctx = (*cm, f"_CtxMLP_{i}")
            yield from _dense(f"contact_model.{name}.0", (*ctx, "Dense_0"))
            yield from _norm(f"contact_model.{name}.1", (*ctx, "PointNorm_0"), norm)
            yield from _dense(f"contact_model.{name}.3", (*ctx, "Dense_1"))
        if arch == "PointTransV2":
            yield from _encoder_layer("contact_model.self_attn_layers.layers.0",
                                      (*cm, "TransformerEncoder_0", "TransformerEncoderLayer_0"))
        return
    if arch != "Perceiver":
        raise NotImplementedError(f"CDM arch {arch!r}")
    for i, name in enumerate(("encoder_adapter", "language_adapter", "time_embedding_adapter")):
        yield from _dense(f"contact_model.{name}", (*cm, f"Dense_{i}"))
    yield from _perceiver_layer("contact_model.encoder_cross_attn",
                                (*cm, "CrossAttentionLayer_0"), cross=True)
    for i in range(self_attn_layers):
        yield from _perceiver_layer(f"contact_model.encoder_self_attn.{i}",
                                    (*cm, "SelfAttentionBlock_0", f"SelfAttentionLayer_{i}"),
                                    cross=False)
    yield from _dense("contact_model.decoder_adapter", (*cm, "Dense_3"))
    yield from _perceiver_layer("contact_model.decoder_cross_attn",
                                (*cm, "CrossAttentionLayer_1"), cross=True)


def regressor_entries(num_layers: int = 2) -> Iterator[Tuple[str, Path, str]]:
    """Every (state_dict key, flax path, kind) of the joints-to-SMPL-X
    regressor (``eval/joints_to_smplx.py``)."""
    yield from _dense("input_layer.0", ("Dense_0",))
    yield from _dense("input_layer.2", ("Dense_1",))
    for i in range(num_layers):
        yield from _encoder_layer(f"TransEncoder.layers.{i}",
                                  ("TransformerEncoder_0", f"TransformerEncoderLayer_{i}"))
    yield from _dense("output_layer", ("Dense_2",))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch file's state_dict (a bare dict, or one under ``"state_dict"``)
    on the CPU, with DDP's ``module.`` prefix stripped from its keys."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def _get(tree: Dict, path: Path):
    for name in path:
        tree = tree[name]
    return tree


def _put(tree: Dict, path: Path, value: np.ndarray) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


# the Dense layers a packed in_proj gathers from, in order
_PACKED = {"qkv_w": 3, "qkv_b": 3, "q_kv_w": 2, "q_kv_b": 2}


def _state_dict_from_jax(variables_np: Dict, entries) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, path, kind in entries:
        if kind in _PACKED:
            mha = _get(variables_np, path)
            leaf = "kernel" if kind.endswith("_w") else "bias"
            v = np.concatenate([np.asarray(mha[f"Dense_{i}"][leaf], np.float32).T
                                for i in range(_PACKED[kind])])
        else:
            v = np.asarray(_get(variables_np, path), np.float32)
            v = v.T if kind == "w" else v
        out[key] = torch.tensor(np.ascontiguousarray(v))
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def _jax_tree_from_state_dict(tensors: Dict[str, torch.Tensor], entries) -> Dict:
    tree: Dict = {}
    for key, path, kind in entries:
        if key not in tensors:
            continue
        v = tensors[key].detach().cpu().float().numpy()
        if kind in _PACKED:
            leaf = "kernel" if kind.endswith("_w") else "bias"
            d = v.shape[0] // 3
            cuts = [d, 2 * d] if _PACKED[kind] == 3 else [d]
            for i, part in enumerate(np.split(v, cuts, axis=0)):
                _put(tree, (*path, f"Dense_{i}", leaf), part.T)
        else:
            _put(tree, path, v.T if kind == "w" else v)
    return tree


def cmdm_state_dict_from_jax(variables_np: Dict, *, num_layers: Sequence[int],
                             blocks: Sequence[int], arch: str = "trans_enc",
                             norm: str = "batch", fused_qkv: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a CMDM of ``arch`` (built with
    ``fused_qkv``) -> a state_dict that
    :class:`afford_motion_torch.models.cmdm.CMDM` loads with ``strict=True``,
    BatchNorm running stats included."""
    return _state_dict_from_jax(variables_np,
                                cmdm_entries(num_layers, blocks, arch, norm, fused_qkv))


def cmdm_jax_tree_from_state_dict(tensors: Dict[str, torch.Tensor], *,
                                  num_layers: Sequence[int], blocks: Sequence[int],
                                  arch: str = "trans_enc", norm: str = "batch",
                                  fused_qkv: bool = False) -> Dict:
    """The inverse: a dict of tensors keyed like the state_dict (parameters,
    buffers, or the gradients of the parameters) -> the flax tree
    ``{"params": ..., "batch_stats": ...}`` of a CMDM built with
    ``fused_qkv``, numpy leaves. Keys that are missing from ``tensors``
    (e.g. buffers, when gradients are carried) are left out of the tree."""
    return _jax_tree_from_state_dict(tensors,
                                     cmdm_entries(num_layers, blocks, arch, norm, fused_qkv))


def cdm_state_dict_from_jax(variables_np: Dict, **arch) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a CDM (``batch_stats`` where it
    has BatchNorms) -> a state_dict that
    :class:`afford_motion_torch.models.cdm.CDM` loads with ``strict=True``;
    ``arch``: the keyword arguments of :func:`cdm_entries`."""
    return _state_dict_from_jax(variables_np, cdm_entries(**arch))


def cdm_jax_tree_from_state_dict(tensors: Dict[str, torch.Tensor], **arch) -> Dict:
    """The inverse: a dict of tensors keyed like a CDM's state_dict (its
    parameters and buffers, or the gradients of its parameters) -> the flax
    tree with numpy leaves; keys missing from ``tensors`` are left out."""
    return _jax_tree_from_state_dict(tensors, cdm_entries(**arch))


def pointtransformer_seg_state_dict_from_jax(variables_np: Dict, *, blocks: Sequence[int],
                                             norm: str = "batch") -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a ``PointTransformerSeg`` -> a
    state_dict the port's loads with ``strict=True``."""
    return _state_dict_from_jax(variables_np, pointtransformer_seg_entries(blocks, norm=norm))


def pointtransformer_seg_jax_tree_from_state_dict(tensors: Dict[str, torch.Tensor], *,
                                                  blocks: Sequence[int], norm: str = "batch"
                                                  ) -> Dict:
    """The inverse: a ``PointTransformerSeg`` state_dict -> its flax tree."""
    return _jax_tree_from_state_dict(tensors, pointtransformer_seg_entries(blocks, norm=norm))


def regressor_state_dict_from_jax(variables_np: Dict, *, num_layers: int = 2
                                  ) -> Dict[str, torch.Tensor]:
    """flax ``{"params": ...}`` of the joints-to-SMPL-X regressor -> a
    state_dict that ``JointsToSMPLXRegressor`` loads with ``strict=True``."""
    return _state_dict_from_jax(variables_np, regressor_entries(num_layers))


def regressor_jax_tree_from_state_dict(tensors: Dict[str, torch.Tensor], *,
                                       num_layers: int = 2) -> Dict:
    """The inverse: the regressor's state_dict -> ``{"params": ...}`` with
    numpy leaves."""
    return _jax_tree_from_state_dict(tensors, regressor_entries(num_layers))


SMPLX_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "parents",
                "faces_arr")


def smplx_model_from_arrays(arrays: Dict):
    """The arrays of the JAX package's ``SMPLXModel`` (a dict of numpy
    arrays under its field names) -> the port's ``SMPLXModel`` on the CPU."""
    from ..eval.smplx_lbs import SMPLXModel

    return SMPLXModel.from_numpy(**{name: np.asarray(arrays[name]) for name in SMPLX_FIELDS})


def _t2m_names(net: str) -> Tuple[str, ...]:
    """The parameter names of one T2M evaluator net (``finest.tar``)."""
    if net == "movement_encoder":
        return tuple(f"{k}.{p}" for k in ("main.0", "main.3", "out_net")
                     for p in ("weight", "bias"))
    gru = tuple(f"gru.{p}_l0{d}" for d in ("", "_reverse")
                for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    emb = ("pos_emb", "input_emb") if net == "text_encoder" else ("input_emb",)
    return (tuple(f"{k}.{p}" for k in emb for p in ("weight", "bias")) + gru + ("hidden",)
            + tuple(f"output_net.{i}.{p}" for i in (0, 1, 3) for p in ("weight", "bias")))


def _t2m_rank(name: str) -> int:
    """The rank of a T2M parameter: conv kernels and the initial hidden
    state 3, biases and the LayerNorm's scale 1, the rest 2."""
    if name == "hidden" or (name.startswith("main.") and name.endswith(".weight")):
        return 3
    if name.rsplit(".", 1)[-1].startswith("bias") or name == "output_net.1.weight":
        return 1
    return 2


def t2m_state_dicts_from_jax(params: Dict[str, Dict]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's T2M parameter dicts (``{movement_encoder,
    text_encoder, motion_encoder}`` of numpy arrays under the checkpoint's
    names) -> the three state dicts of ``eval/t2m_models.py``. The names are
    the same on both sides; this checks them, and that every leaf is a
    finite float array of the rank its name gives, and makes f32 tensors.
    ``build_t2m_modules`` checks the sizes when it loads them."""
    from ..eval.t2m_models import NETS

    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for net in NETS:
        names = _t2m_names(net)
        if set(params[net]) != set(names):
            raise KeyError(f"{net}: names {sorted(set(params[net]) ^ set(names))} "
                           "are on one side only")
        sd = {}
        for name in names:
            v = np.asarray(params[net][name])
            rank = _t2m_rank(name)
            if v.dtype.kind != "f" or v.ndim != rank or not np.isfinite(v).all():
                raise ValueError(f"{net}.{name}: {v.dtype} {v.shape}, expected finite floats "
                                 f"of rank {rank}")
            sd[name] = torch.tensor(np.ascontiguousarray(v, dtype=np.float32))
        out[net] = sd
    return out


def t2m_jax_params_from_state_dicts(state_dicts: Dict[str, Dict[str, torch.Tensor]]
                                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse: the three state dicts (or the modules' ``state_dict()``)
    -> f32 numpy parameter dicts under the same names."""
    from ..eval.t2m_models import NETS

    out = {}
    for net in NETS:
        names = _t2m_names(net)
        if set(state_dicts[net]) != set(names):
            raise KeyError(f"{net}: names {sorted(set(state_dicts[net]) ^ set(names))} "
                           "are on one side only")
        out[net] = {k: state_dicts[net][k].detach().cpu().float().numpy() for k in names}
    return out

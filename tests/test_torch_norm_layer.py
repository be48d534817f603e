"""``model.norm: layer`` in the port against the JAX package, on the CPU at
a small width: the point backbones' normalisation as the JAX package's
``PointNorm(kind="layer")`` (flax ``LayerNorm(dtype=float32)``: epsilon
1e-6, scale and bias, no running statistics) in the CMDM's SceneMap encoder
and U-Net, the CDM's frozen ``PointTransformerSeg`` and its PointTrans
backbones with their context MLPs.

Weights cross by the name table (``utils/convert.py``, its
``PointNorm_k/LayerNorm_0`` rows), the LayerNorms' scales and biases set to
non-trivial values; both sides read the same hierarchy index arrays (the
JAX hierarchy on the exact kNN). Tolerances are ``tests/test_torch_train.py``'s:
the CMDM's forward 1e-4 (abs and rel) and its train steps through
``_compare_train_steps``; the CDM's float32 forward 1e-4 of the largest
entry (``tests/test_torch_cmdm.py``'s float32 tolerance; the BatchNorm
build's 1e-5 in ``tests/test_torch_cdm_scene.py`` does not hold: a layer
norm over the positional MLP's 3 channels divides by their spread, small
for some neighbours, and carries each side's rounding further than a
BatchNorm's statistics over thousands of rows do, 5.7e-5 of the largest
entry at most here); the name table bit for bit.
The finest level is 32 planes wide here (16 in those files): the attention
MLP's second norm spans planes / 8 channels, and a layer norm over 2
channels outputs its scale times +-1 (plus its bias), whose gradient is
rounding noise on both sides.
"""
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.models import cdm as jax_cdm
from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.models.pointtransformer import PointTransformerSeg as JaxSeg
from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays
from afford_motion_torch.models.cdm import CDM, build_cdm
from afford_motion_torch.models.cmdm import CMDM, build_cmdm
from afford_motion_torch.models.conditioning import add_hierarchies
from afford_motion_torch.models.layers import LayerNorm
from afford_motion_torch.models.pointtransformer import PointNorm
from afford_motion_torch.ops.hierarchy import geometry_from_arrays
from afford_motion_torch.utils.config import load_config
from afford_motion_torch.utils.convert import (
    cdm_jax_tree_from_state_dict,
    cdm_state_dict_from_jax,
    cmdm_jax_tree_from_state_dict,
    cmdm_state_dict_from_jax,
)
from test_torch_train import ARCH as TRAIN_ARCH
from test_torch_train import BLOCKS, LAYERS, _assert_trees_close, _compare_train_steps

NB, NP, L, D, TEXT = 4, 512, 24, 263, 32
ARCH = dict(TRAIN_ARCH, planes=(32, 32, 64, 128))
SEG_P, SEG_B, SEG_NS = (32, 32, 64, 64, 64), (1, 2, 1, 1, 1), (8, 16, 16, 8, 2)
PT_P, PT_B = (32, 32, 64, 64), (1, 2, 1, 1)
C, TIME = 6, 32


class _JaxSeg(JaxSeg):
    """The JAX scene model at this file's width."""
    planes: Sequence[int] = SEG_P
    blocks: Sequence[int] = SEG_B


class _JaxPointTrans(jax_cdm.ContactPointTrans):
    """The JAX PointTrans backbones at this file's width."""
    planes: Sequence[int] = PT_P


def _perturb_ln(tree, rng):
    """A LayerNorm's scale and bias (flax init: 1 and 0) -> non-trivial values,
    so that a missing or misplaced affine shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_ln(v, rng)
        elif k == "scale":
            out[k] = rng.uniform(0.7, 1.3, size=v.shape).astype(np.float32)
        elif k == "bias" and v.ndim == 1 and not np.any(v):
            out[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _point_norms(module):
    """The kinds of the point normalisations under ``module``."""
    return [type(m) for m in module.modules() if isinstance(m, (PointNorm, LayerNorm))]


@pytest.fixture(scope="module")
def batch():
    """4 clouds of 512 points with both hierarchies (the JAX one on the exact
    kNN, with its up arrays) as arrays for the port, the CMDM's inputs and
    the t and noise of three steps."""
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(NB, NP, 3)).astype(np.float32)
    sm = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 8), with_up=True,
                               knn_method="exact")
    seg = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4, 4), SEG_NS, with_up=True,
                                knn_method="exact")
    x_mask = np.zeros((NB, L), dtype=bool)
    x_mask[1, 15:] = True
    arrays = {"c_pc_xyz": xyz, "c_pc_contact": rng.uniform(size=(NB, NP, 6)).astype(np.float32),
              "c_pc_feat": rng.uniform(size=(NB, NP, 3)).astype(np.float32),
              "text_emb": rng.normal(size=(NB, 1, TEXT)).astype(np.float32), "x_mask": x_mask}
    geo = {k: np.asarray(v) for k, v in {**geometry_to_arrays(sm, prefix="geo_sm"),
                                         **geometry_to_arrays(seg, prefix="geo_seg")}.items()}
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond.update(levels_sm=sm, levels_pt=sm, levels_seg=seg)
    ts = [np.array([10, 700, 0, 999]), np.array([5, 250, 640, 31]), np.array([900, 1, 77, 420])]
    return dict(rng=rng, arrays=arrays, geo=geo, jcond=jcond, ts=ts,
                x=rng.normal(size=(NB, L, D)).astype(np.float32),
                noises=[rng.standard_normal((NB, L, D)).astype(np.float32) for _ in ts])


def _tcond(batch, levels=()):
    tcond = {k: torch.tensor(v) for k, v in {**batch["arrays"], **batch["geo"]}.items()}
    for key, prefix, n in levels:
        tcond[key] = geometry_from_arrays({k: torch.tensor(v) for k, v in batch["geo"].items()},
                                          tcond["c_pc_xyz"], n, prefix=prefix)
    return tcond


# ------------------------------------------------------------- building
def test_cdm_config_norm_layer_builds_layernorms():
    """``task=contact_gen model=cdm model.arch=PointTrans model.norm=layer``
    at the published widths: the frozen scene model, the backbone's U-Net and
    its context MLP normalise with float32 LayerNorms where the batch build
    has its BatchNorms, one for one, and nothing else changes; the trans_enc
    and trans_dec CMDMs likewise."""
    # the entries set input_feats from the data representation
    base = ["task=contact_gen", "model=cdm", "model.arch=PointTrans", "model.input_feats=6"]
    batch_model = build_cdm(load_config("configs", base).model)
    layer_model = build_cdm(load_config("configs", base + ["model.norm=layer"]).model)
    for part in ("scene_model", "contact_model"):
        kinds = _point_norms(getattr(layer_model, part))
        assert kinds and set(kinds) == {LayerNorm}, part
        assert len(kinds) == len(_point_norms(getattr(batch_model, part))), part
        assert set(_point_norms(getattr(batch_model, part))) == {PointNorm}, part
    assert not any(k.endswith(("running_mean", "running_var")) for k in layer_model.state_dict())
    for arch in ("trans_enc", "trans_dec"):
        argv = ["task=contact_motion_gen", "model=cmdm", f"model.arch={arch}",
                "model.input_feats=66"]
        m = build_cmdm(load_config("configs", argv + ["model.norm=layer"]).model)
        kinds = _point_norms(m.contact_encoder)
        assert kinds and set(kinds) == {LayerNorm}, arch
        assert len(kinds) == len(_point_norms(
            build_cmdm(load_config("configs", argv).model).contact_encoder)), arch


@pytest.mark.parametrize("model", ["cdm", "cmdm"])
def test_unknown_norm_raises(model):
    """Any other ``model.norm`` is refused when the model is built, as the
    JAX package's ``PointNorm`` refuses it when it runs."""
    task = "contact_gen" if model == "cdm" else "contact_motion_gen"
    extra = ["model.arch=PointTrans", "model.input_feats=6"] if model == "cdm" else [
        "model.input_feats=66"]
    cfg = load_config("configs", [f"task={task}", f"model={model}", *extra, "model.norm=group"])
    with pytest.raises(ValueError, match="group"):
        (build_cdm if model == "cdm" else build_cmdm)(cfg.model)


# ------------------------------------------------------------------ the CMDM
@pytest.fixture(scope="module")
def cmdm_layer(batch):
    jm = JaxCMDM(**ARCH, dropout=0.0, norm="layer")
    init = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(batch["x"]),
                            jnp.zeros((NB,), jnp.int32), batch["jcond"])
    assert "batch_stats" not in init
    variables = {"params": _perturb_ln(jax.device_get(init["params"]), batch["rng"])}
    return jm, variables


def _cmdm_names(arch="trans_enc"):
    return dict(num_layers=LAYERS, blocks=BLOCKS, arch=arch, norm="layer")


@pytest.mark.parametrize("arch", ["trans_enc", "trans_dec"])
def test_cmdm_names_both_ways(batch, arch):
    """The name table with ``norm="layer"``: the port's state_dict carried to
    flax has exactly the JAX CMDM's init tree (``jax.eval_shape``), every
    ``PointNorm_k`` a ``LayerNorm_0`` of scale and bias, and comes back bit
    for bit."""
    jm = JaxCMDM(**ARCH, dropout=0.0, norm="layer", arch=arch)
    jcond = dict(batch["jcond"])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(batch["x"]),
                            jnp.zeros((NB,), jnp.int32), jcond)
    tm = CMDM(**ARCH, arch=arch, norm="layer")
    tree = cmdm_jax_tree_from_state_dict(tm.state_dict(), **_cmdm_names(arch))
    assert (jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
            == jax.tree_util.tree_map(lambda a: a.shape, tree))
    assert set(tree) == {"params"}
    back = cmdm_state_dict_from_jax(tree, **_cmdm_names(arch))
    assert set(back) == set(tm.state_dict())
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


def test_cmdm_forward_matches_jax(batch, cmdm_layer):
    """``trans_enc`` with ``norm="layer"`` in eval mode, float32: the
    denoiser's output (B, L, 263) within 1e-4 of JAX ``apply``."""
    jm, variables = cmdm_layer
    t = np.array([3, 250, 999, 40])
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(batch["x"]), jnp.asarray(t),
                                                 batch["jcond"]))(variables))
    tm = CMDM(**ARCH, dropout=0.0, norm="layer")
    tm.load_state_dict(cmdm_state_dict_from_jax(variables, **_cmdm_names()), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(batch["x"]), torch.from_numpy(t),
                        add_hierarchies(tm, _tcond(batch)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_cmdm_train_steps_match_jax(batch, cmdm_layer):
    """Three AdamW steps of ``trans_enc`` with ``norm="layer"`` at 4 x 512
    points through ``tests/test_torch_train.py``'s ``_compare_train_steps``
    (first loss 1e-5, parameters after the step 1e-6; a layer norm has no
    buffers to compare). Gradients to 5e-3 of a tensor's largest entry, as
    the U-Nets' in ``tests/test_torch_trans_dec.py``: the positional MLP's
    layer norm spans 3 channels, so the gradient of the Linear(3, 3) bias in
    front of it is a float32 sum over 16k rows that cancels to its part
    orthogonal to (1, 1, 1), summed in other orders on each side (4.8e-3 of
    its largest entry at level 0)."""
    jm, variables = cmdm_layer
    tm = CMDM(**ARCH, dropout=0.0, norm="layer")
    tm.load_state_dict(cmdm_state_dict_from_jax(variables, **_cmdm_names()), strict=True)
    _compare_train_steps(dict(batch, jm=jm), variables, batch["jcond"], _tcond(batch),
                         batch["x"], tm, 0.0, 0, grad_rel_of_max=5e-3,
                         to_tree=lambda t: cmdm_jax_tree_from_state_dict(t, **_cmdm_names()))


# ------------------------------------------------------------------- the CDM
def _cdm_names():
    return dict(arch="PointTrans", blocks=PT_B, scene_blocks=SEG_B, norm="layer")


def test_pointtrans_cdm_with_scene_model_matches_jax(batch, monkeypatch):
    """A ``PointTrans`` CDM with its scene model and ``norm="layer"``, float32,
    eval mode: the name table's tree equals the JAX CDM's init tree
    (``jax.eval_shape``) and comes back bit for bit, and the forward (the
    frozen ``PointTransformerSeg`` inside it) is within 1e-4 of the largest
    entry of JAX ``apply`` (1e-4 of it; see the module's docstring)."""
    monkeypatch.setattr(jax_cdm, "PointTransformerSeg", _JaxSeg)
    monkeypatch.setattr(jax_cdm, "ContactPointTrans", _JaxPointTrans)
    jm = jax_cdm.CDM(contact_dim=C, time_emb_dim=TIME, text_feat_dim=TEXT, point_feat_dim=32,
                     use_scene_model=True, scene_in_dim=6, arch="PointTrans",
                     arch_cfg=(("blocks", PT_B),), norm="layer")
    x = batch["rng"].normal(size=(NB, NP, C)).astype(np.float32)
    t = np.array([10, 400, 0, 499])
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            batch["jcond"])
    torch.manual_seed(0)
    tm = CDM(C, TIME, TEXT, 32, True, False, 6, "PointTrans", {"blocks": PT_B, "planes": PT_P},
             scene_planes=SEG_P, scene_blocks=SEG_B, norm="layer")
    tree = cdm_jax_tree_from_state_dict(tm.state_dict(), **_cdm_names())
    assert (jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
            == jax.tree_util.tree_map(lambda a: a.shape, tree))
    variables = {"params": _perturb_ln(tree["params"], batch["rng"])}
    sd = cdm_state_dict_from_jax(variables, **_cdm_names())
    tm.load_state_dict(sd, strict=True)
    _assert_trees_close(cdm_jax_tree_from_state_dict(tm.state_dict(), **_cdm_names()), variables,
                        atol=0.0, what="roundtrip")
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(t),
                                                 batch["jcond"]))(variables))
    tcond = _tcond(batch, (("levels_seg", "geo_seg", 5), ("levels_pt", "geo_sm", 4)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(t), tcond)
    assert tuple(got.shape) == (NB, NP, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())

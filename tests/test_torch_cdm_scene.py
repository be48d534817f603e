"""Parity of the port's CDM scene features and point-transformer backbones
with the JAX package's, on the CPU at a small width: the frozen
``PointTransformerSeg`` (planes 16/32/32/64/64, blocks 1/2/1/1/1, 5 levels
of 1024 -> 4 points with k 8/16/16/16/4, so that the deepest level has k
points) and the ``PointTrans`` / ``PointTransV2`` backbones (planes
16/32/32/64, blocks 1/2/1/1, V2's bottleneck self-attention 64 wide in 8
heads), batch 2, 1024-point clouds; the JAX side gets the same widths by
subclasses of its modules with those defaults, patched into
``afford_motion_tpu.models.cdm`` for this file only (the JAX CDM builds both
at their published widths, which are held here against ``jax.eval_shape``).

Both sides get the same weights (the port's seeded init carried to a flax
tree by the name table ``utils/convert.py``, BatchNorm statistics and affine
set to non-trivial values), the same hierarchy index arrays (the JAX
hierarchy on the exact kNN, read by both sides) and the same inputs from a
numpy seed. Tolerances: forwards float32 1e-5 and bfloat16 5e-2 of the
output's largest entry (as ``tests/test_torch_cdm.py``); one train step
each through ``tests/test_torch_train.py``'s ``_compare_train_steps``,
gradients to 5e-3 of a tensor's largest entry for the U-Nets (their
float32 ReLU kinks, see ``tests/test_torch_trans_dec.py``); hierarchies and
the name table bit for bit. V2's bottleneck dropout is 0.1 in both packages
and their draws never agree: its train step runs with that dropout forced
to 0 on both sides (the JAX side's ``TransformerEncoder`` patched in this
file), its eval forward with the module as it is.
"""
import contextlib
import logging
from types import SimpleNamespace
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.models import cdm as jax_cdm
from afford_motion_tpu.models import conditioning as jax_conditioning
from afford_motion_tpu.models.pointtransformer import PointTransformerEnc as JaxEnc
from afford_motion_tpu.models.pointtransformer import PointTransformerSeg as JaxSeg
from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays
from afford_motion_tpu.train import device_store as jax_device_store
from afford_motion_tpu.utils.torch_convert import (
    convert_cdm_checkpoint,
    convert_pointtransformer_seg,
    export_cdm_checkpoint,
)
from afford_motion_torch.models import conditioning
from afford_motion_torch.models.cdm import CDM, build_cdm
from afford_motion_torch.models.pointtransformer import (
    SEG_BLOCKS,
    SEG_NSAMPLES,
    SEG_PLANES,
    SEG_STRIDES,
    PointTransformerEnc,
    PointTransformerSeg,
    load_scene_model,
)
from afford_motion_torch.ops.hierarchy import geometry_from_arrays
from afford_motion_torch.train.device_store import DeviceStore
from afford_motion_torch.train.loop import TrainLoop, make_train_step
from afford_motion_torch.train.state import TrainState
from afford_motion_torch.utils.config import DictConfig, load_config
from afford_motion_torch.utils.io import get_logger
from afford_motion_torch.utils.convert import (
    cdm_jax_tree_from_state_dict,
    cdm_state_dict_from_jax,
    pointtransformer_seg_entries,
    pointtransformer_seg_jax_tree_from_state_dict,
    pointtransformer_seg_state_dict_from_jax,
)
from test_torch_cmdm import _perturb_bn
from test_torch_hierarchy import _assert_same
from test_torch_train import _assert_trees_close, _compare_train_steps

B, N, C, TEXT, TIME = 2, 1024, 6, 64, 32
SEG_P, SEG_B, SEG_NS = (16, 32, 32, 64, 64), (1, 2, 1, 1, 1), (8, 16, 16, 16, 4)
PT_P, PT_B = (16, 32, 32, 64), (1, 2, 1, 1)
SM_STRIDES, SM_NSAMPLES = (1, 4, 4, 4), (8, 16, 16, 16)
TOL_F32, TOL_BF16 = 1e-5, 5e-2   # of the output's largest entry
PT_GRAD_REL = 5e-3
PERCEIVER = dict(point_pos_emb=True, encoder_q_input_channels=64, encoder_kv_input_channels=32,
                 encoder_num_heads=2, encoder_self_attn_num_layers=1,
                 decoder_q_input_channels=32, decoder_kv_input_channels=64,
                 decoder_num_heads=2, encoder_dropout=0.0, decoder_dropout=0.0)
# per arch: the JAX arch_cfg, the port's, the name table's keywords
ARCHS = {
    "MLP": (dict(point_mlp_dims=(48, 32)), dict(point_mlp_dims=(48, 32)), dict(mlp_layers=2)),
    "Perceiver": (PERCEIVER, PERCEIVER, dict(self_attn_layers=1)),
    "PointTrans": (dict(blocks=PT_B), dict(blocks=PT_B, planes=PT_P), dict(blocks=PT_B)),
    "PointTransV2": (dict(blocks=PT_B), dict(blocks=PT_B, planes=PT_P), dict(blocks=PT_B)),
}


class _JaxSeg(JaxSeg):
    """The JAX scene model at this file's width."""
    planes: Sequence[int] = SEG_P
    blocks: Sequence[int] = SEG_B


class _JaxEnc(JaxEnc):
    """The JAX scene model's encoder alone at this file's width."""
    planes: Sequence[int] = SEG_P
    blocks: Sequence[int] = SEG_B


class _JaxPointTrans(jax_cdm.ContactPointTrans):
    """The JAX PointTrans backbones at this file's width."""
    planes: Sequence[int] = PT_P


@pytest.fixture(scope="module", autouse=True)
def _jax_widths():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cdm, "PointTransformerSeg", _JaxSeg)
        mp.setattr(jax_cdm, "ContactPointTrans", _JaxPointTrans)
        yield


def _jax_model(arch, dtype="float32", scene=True, openscene=False, pfd=32, **over):
    return jax_cdm.CDM(contact_dim=C, time_emb_dim=TIME, text_feat_dim=TEXT,
                       point_feat_dim=pfd if scene else 0, use_scene_model=scene,
                       use_openscene=openscene, scene_in_dim=6, arch=arch,
                       arch_cfg=tuple(dict(ARCHS[arch][0], **over).items()),
                       dtype=jnp.dtype(dtype))


def _torch_model(arch, sd=None, dtype="float32", scene=True, openscene=False, pfd=32, **over):
    tm = CDM(C, TIME, TEXT, pfd if scene else 0, scene, openscene, 6, arch,
             dict(ARCHS[arch][1], **over), getattr(torch, dtype), scene_planes=SEG_P,
             scene_blocks=SEG_B)
    if sd is not None:
        tm.load_state_dict(sd, strict=True)
    return tm


def _names(arch, scene=True):
    return dict(arch=arch, **ARCHS[arch][2], scene_blocks=SEG_B if scene else None)


def _variables(arch, rng, scene=True, openscene=False):
    """Seeded weights: the port's init carried to a flax tree by the name
    table, BatchNorm statistics and affine made non-trivial."""
    torch.manual_seed(0)
    tree = cdm_jax_tree_from_state_dict(
        _torch_model(arch, scene=scene, openscene=openscene,
                     pfd=1 if openscene else 32).state_dict(), **_names(arch, scene and not openscene))
    out = {"params": _perturb_bn(tree["params"], rng, "params")}
    if "batch_stats" in tree:
        out["batch_stats"] = _perturb_bn(tree["batch_stats"], rng, "stats")
    return out


def _levels(xyz, strides, nsamples):
    return build_point_hierarchy(jnp.asarray(xyz), strides, nsamples, with_up=True,
                                 knn_method="exact")


def _geo(levels, prefix):
    return {k: np.asarray(v) for k, v in geometry_to_arrays(levels, prefix=prefix).items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    arrays = {"c_pc_xyz": xyz,
              "c_pc_feat": rng.uniform(size=(B, N, 3)).astype(np.float32),
              "text_emb": rng.normal(size=(B, 1, TEXT)).astype(np.float32)}
    seg, pt = _levels(xyz, SEG_STRIDES, SEG_NS), _levels(xyz, SM_STRIDES, SM_NSAMPLES)
    geo = {**_geo(seg, "geo_seg"), **_geo(pt, "geo_sm")}
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond.update(levels_seg=seg, levels_pt=pt)
    tcond = {k: torch.from_numpy(v) for k, v in arrays.items()}
    t_xyz = tcond["c_pc_xyz"]
    tg = {k: torch.tensor(v) for k, v in geo.items()}
    tcond.update(levels_seg=geometry_from_arrays(tg, t_xyz, 5, prefix="geo_seg"),
                 levels_pt=geometry_from_arrays(tg, t_xyz, 4, prefix="geo_sm"))
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    t = np.array([10, 400], dtype=np.int32)
    variables = {arch: _variables(arch, rng) for arch in ARCHS}
    return dict(arrays=arrays, jcond=jcond, tcond=tcond, x=x, t=t, variables=variables,
                seg=seg, geo=geo)


# ------------------------------------------------------------ the scene model
@pytest.mark.parametrize("kind", ["Seg", "Enc"])
def test_scene_model_matches_jax(setup, kind):
    """``PointTransformerSeg`` (per-point features (B, N, 16)) and the
    encoder-only ``PointTransformerEnc`` (the coarsest level's points and
    64-wide features) in eval mode against JAX ``apply`` with
    ``train=False``, float32, non-trivial running statistics."""
    var = {k: v["scene_model"] for k, v in setup["variables"]["MLP"].items()}
    sd = pointtransformer_seg_state_dict_from_jax(var, blocks=SEG_B)
    if kind == "Enc":
        var = {k: {"enc": v["enc"]} for k, v in var.items()}
        sd = {k: v for k, v in sd.items() if k.startswith("enc")}
    jm, tm = {"Seg": (_JaxSeg, PointTransformerSeg), "Enc": (_JaxEnc, PointTransformerEnc)}[kind]
    want = jax.jit(jm(c=6).apply)(var, setup["seg"], setup["jcond"]["c_pc_feat"])
    tm = tm(6, SEG_P, SEG_B)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm.eval()(setup["tcond"]["levels_seg"], setup["tcond"]["c_pc_feat"])
    if kind == "Enc":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        got, want = got[1], want[1]
        assert tuple(got.shape) == (B, N // 256, SEG_P[-1])
    else:
        assert tuple(got.shape) == (B, N, SEG_P[0])
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_F32 * np.abs(want).max())


def test_scene_model_names_both_ways(setup, tmp_path):
    """The name table's scene-model entries: the JAX package's
    ``convert_pointtransformer_seg`` reads the table's state_dict (with a
    ``module.`` prefix and a head the filter leaves out, as in the reference's
    file) into the same flax tree bit for bit; the inverse is the identity;
    at the published width the table's tree has JAX's init shapes."""
    var = {k: v["scene_model"] for k, v in setup["variables"]["MLP"].items()}
    sd = pointtransformer_seg_state_dict_from_jax(var, blocks=SEG_B)
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.cls.0.weight"] = torch.zeros(13, 16)
    torch.save({"state_dict": ref}, tmp_path / "model.pth")
    _assert_trees_close(convert_pointtransformer_seg(str(tmp_path / "model.pth"), blocks=SEG_B),
                        var, atol=0.0, what="convert_pointtransformer_seg")
    _assert_trees_close(pointtransformer_seg_jax_tree_from_state_dict(sd, blocks=SEG_B), var,
                        atol=0.0, what="roundtrip")
    full = PointTransformerSeg(6)
    shapes = jax.eval_shape(JaxSeg(c=6).init, jax.random.PRNGKey(0), setup["seg"],
                            setup["jcond"]["c_pc_feat"])
    tree = pointtransformer_seg_jax_tree_from_state_dict(full.state_dict(), blocks=SEG_BLOCKS)
    assert (jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
            == jax.tree_util.tree_map(lambda a: a.shape, tree))
    assert sum(1 for _ in pointtransformer_seg_entries(SEG_BLOCKS)) == len(
        [k for k in full.state_dict() if not k.endswith("num_batches_tracked")])


# ------------------------------------------------------------------ the CDM
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cdm_names_both_ways(setup, arch):
    """A CDM with its scene model: the table's state_dict loads into the
    port with ``strict=True`` and back bit for bit; the JAX package's
    ``export_cdm_checkpoint`` (which leaves the frozen scene model out) writes
    the same arrays under the same keys, its ``convert_cdm_checkpoint`` reads
    them back, and ``convert_pointtransformer_seg`` reads the
    ``scene_model.*`` rows."""
    var = setup["variables"][arch]
    names = _names(arch)
    sd = cdm_state_dict_from_jax(var, **names)
    tm = _torch_model(arch, sd)
    _assert_trees_close(cdm_jax_tree_from_state_dict(tm.state_dict(), **names), var, atol=0.0,
                        what="roundtrip")
    pt = dict(pt_blocks=PT_B) if arch.startswith("PointTrans") else {}
    layers = {k: v for k, v in ARCHS[arch][2].items() if k != "blocks"}
    exported = export_cdm_checkpoint(var, arch=arch, **layers, **pt)
    assert set(exported) == {k for k in sd if not k.startswith("scene_model.")}
    for k, v in exported.items():
        assert np.array_equal(np.asarray(v), sd[k].numpy()), k
    conv = convert_cdm_checkpoint({k: np.asarray(v) for k, v in exported.items()}, arch=arch,
                                  **layers, **pt)
    want = {"params": {k: v for k, v in var["params"].items() if k != "scene_model"},
            "batch_stats": {k: v for k, v in var["batch_stats"].items() if k != "scene_model"}}
    _assert_trees_close({k: v for k, v in conv.items() if v}, {k: v for k, v in want.items() if v},
                        atol=0.0, what="convert_cdm_checkpoint")
    scene = {k[len("scene_model."):]: v.numpy() for k, v in sd.items()
             if k.startswith("scene_model.")}
    _assert_trees_close(convert_pointtransformer_seg(scene, blocks=SEG_B),
                        {k: v["scene_model"] for k, v in var.items()}, atol=0.0,
                        what="scene_model rows")


@pytest.mark.parametrize("arch", ["MLP", "PointTrans", "PointTransV2"])
def test_published_width_tree_matches_jax_init(setup, arch, monkeypatch):
    """At the published widths (the scene model's 32..512 planes and blocks
    2/3/4/6/3, PointTrans planes 64..512 with blocks 2/2/2/2, MLP 512/512)
    the port's state_dict carried by the name table has exactly the shapes
    of the JAX CDM's init (``jax.eval_shape``)."""
    monkeypatch.setattr(jax_cdm, "PointTransformerSeg", JaxSeg)
    monkeypatch.setattr(jax_cdm, "ContactPointTrans", _JaxPointTrans.__mro__[1])
    cfg = {"MLP": dict(point_mlp_dims=(512, 512))}.get(arch, dict(blocks=(2, 2, 2, 2)))
    jm = jax_cdm.CDM(contact_dim=C, time_emb_dim=TIME, text_feat_dim=TEXT, point_feat_dim=32,
                     use_scene_model=True, arch=arch, arch_cfg=tuple(cfg.items()))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(setup["x"]),
                            jnp.asarray(setup["t"]), setup["jcond"])
    tm = CDM(C, TIME, TEXT, 32, True, arch=arch, arch_cfg=cfg)
    names = dict(arch=arch, scene_blocks=SEG_BLOCKS, **({"mlp_layers": 2} if arch == "MLP"
                                                        else {"blocks": (2, 2, 2, 2)}))
    tree = cdm_jax_tree_from_state_dict(tm.state_dict(), **names)
    assert (jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
            == jax.tree_util.tree_map(lambda a: a.shape, tree))
    assert tuple(tm.scene_model.enc5[0].linear.weight.shape) == (SEG_PLANES[4], 3 + SEG_PLANES[3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cdm_forward_matches_jax(setup, arch, dtype):
    """``CDM.apply`` in eval mode (the scene model inside it) against the
    port's forward: the float32 head's (B, N, C)."""
    var = setup["variables"][arch]
    jm = _jax_model(arch, dtype)
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(setup["x"]),
                                                 jnp.asarray(setup["t"]), setup["jcond"]))(var))
    tm = _torch_model(arch, cdm_state_dict_from_jax(var, **_names(arch)), dtype).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(setup["x"]), torch.from_numpy(setup["t"]), setup["tcond"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, N, C)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feat", ["scored", "one channel"])
def test_openscene_forward_matches_jax(setup, feat, dtype):
    """``use_openscene`` with ``point_feat_dim`` 1 (Perceiver): OpenScene
    features of the text embedding's width scored against it, or a
    one-channel feature taken as it is; no scene model, no seg hierarchy."""
    rng = np.random.default_rng(4)
    width = TEXT if feat == "scored" else 1
    pc_feat = rng.normal(size=(B, N, width)).astype(np.float32)
    var = _variables("Perceiver", rng, openscene=True)
    jm = _jax_model("Perceiver", dtype, openscene=True, pfd=1)
    assert not jm.needs_seg_hierarchy
    jcond = dict(setup["jcond"], c_pc_feat=jnp.asarray(pc_feat))
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(setup["x"]),
                                                 jnp.asarray(setup["t"]), jcond))(var))
    tm = _torch_model("Perceiver", cdm_state_dict_from_jax(var, **_names("Perceiver", False)),
                      dtype, openscene=True, pfd=1).eval()
    assert tm.scene_model is None and tm.contact_model.encoder_adapter.in_features == C + 1 + 3
    tcond = {k: v for k, v in setup["tcond"].items() if k != "levels_seg"}
    tcond["c_pc_feat"] = torch.from_numpy(pc_feat)
    with torch.no_grad():
        got = tm(torch.from_numpy(setup["x"]), torch.from_numpy(setup["t"]), tcond).numpy()
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ------------------------------------------------------------- train steps
NT = 512


@pytest.fixture(scope="module")
def train_batch():
    """Batch 4 x 512 points, the JAX hierarchies with their up arrays read by
    both sides as arrays, the t and noise of three steps."""
    rng = np.random.default_rng(3)
    nb = 4
    xyz = rng.normal(size=(nb, NT, 3)).astype(np.float32)
    seg = _levels(xyz, SEG_STRIDES, (8, 16, 16, 8, 2))
    pt = _levels(xyz, SM_STRIDES, (8, 16, 16, 8))
    arrays = {"c_pc_xyz": xyz, "c_pc_feat": rng.uniform(size=(nb, NT, 3)).astype(np.float32),
              "text_emb": rng.normal(size=(nb, 1, TEXT)).astype(np.float32)}
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond.update(levels_seg=seg, levels_pt=pt)
    tcond = {k: torch.tensor(v) for k, v in {**arrays, **_geo(seg, "geo_seg"),
                                               **_geo(pt, "geo_sm")}.items()}
    ts = [np.array([10, 400, 0, 499]), np.array([5, 250, 440, 31]), np.array([300, 1, 77, 420])]
    noises = [rng.standard_normal((nb, NT, C)).astype(np.float32) for _ in ts]
    return dict(jcond=jcond, tcond=tcond, x=rng.normal(size=(nb, NT, C)).astype(np.float32),
                ts=ts, noises=noises)


@pytest.mark.parametrize("arch, scene", [("MLP", True), ("PointTrans", False),
                                         ("PointTransV2", False)],
                         ids=["MLP+scene", "PointTrans", "PointTransV2"])
def test_train_step_matches_jax(train_batch, arch, scene, monkeypatch):
    """Three AdamW steps from the same weights on the same batch, t and
    noise: the first step's loss, every trainable gradient (the frozen
    scene model's: none in the port, exactly zero in JAX), the parameters
    and BatchNorm buffers after it (the scene model's unchanged on both
    sides), the next two losses. PointTrans and V2 on the H3D form (no
    scene model), V2 with its bottleneck dropout at 0 on both sides."""
    s = train_batch
    if arch == "PointTransV2":
        real = jax_cdm.TransformerEncoder
        monkeypatch.setattr(jax_cdm, "TransformerEncoder",
                            lambda **kw: real(**dict(kw, dropout=0.0)))
    jm = _jax_model(arch, scene=scene)
    torch.manual_seed(0)
    tm = _torch_model(arch, scene=scene)
    if arch == "PointTransV2":
        for m in tm.contact_model.self_attn_layers.modules():
            if hasattr(m, "p"):
                m.p = 0.0
    names = _names(arch, scene)
    # copies: the tree's leaves would otherwise share the parameters' memory
    variables = jax.tree_util.tree_map(np.copy, cdm_jax_tree_from_state_dict(tm.state_dict(),
                                                                             **names))
    tm.load_state_dict(cdm_state_dict_from_jax(variables, **names), strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items() if k.startswith("scene_model.")}
    _compare_train_steps(dict(s, jm=jm), variables, s["jcond"], s["tcond"], s["x"], tm, 0.0, 0,
                         to_tree=lambda t: cdm_jax_tree_from_state_dict(t, **names),
                         grad_rel_of_max=1e-3 if arch == "MLP" else PT_GRAD_REL,
                         expect_noise=arch != "MLP")
    assert scene == bool(before)
    for k, v in tm.state_dict().items():
        if k.startswith("scene_model."):
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch", ["MLP", "PointTrans"])
def test_scene_model_stays_frozen(train_batch, arch):
    """A train step of a CDM with its scene model: the model in train mode,
    its scene model in eval mode (so that its BatchNorms neither normalise
    with the batch's statistics nor update their running ones), no gradient
    reaches it, and every parameter and buffer of it is bit for bit as it
    was; the backbone's BatchNorm statistics move."""
    s = train_batch
    torch.manual_seed(1)
    tm = _torch_model(arch)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    state = TrainState.create(tm, lr=1e-3)
    from afford_motion_torch.diffusion import create_gaussian_diffusion

    step = make_train_step(tm, create_gaussian_diffusion(DictConfig({"steps": 500})))
    step(state, torch.from_numpy(s["x"]), s["tcond"], seed=0)
    assert tm.training and not tm.scene_model.training
    assert all(not m.training for m in tm.scene_model.modules())
    assert all(p.grad is None and not p.requires_grad for p in tm.scene_model.parameters())
    after = tm.state_dict()
    for k, v in after.items():
        if k.startswith("scene_model."):
            assert torch.equal(v, before[k]), k
    moved = [k for k in after if k.startswith("contact_model.") and k.endswith("running_mean")
             and not torch.equal(after[k], before[k])]
    assert bool(moved) == (arch == "PointTrans")
    assert not torch.equal(after["contact_layer.weight"], before["contact_layer.weight"])


# ------------------------------------------------------------- hierarchies
def _cloud(n):
    rng = np.random.default_rng(31)
    return (rng.integers(-512, 512, size=(B, n, 3)) / 256.0).astype(np.float32)


@pytest.mark.parametrize("source", ["built", "fps wire", "full cache"])
def test_add_hierarchies_matches_jax(source):
    """``add_hierarchies`` for a CDM with the scene model and the PointTrans
    backbone: ``levels_seg`` (``SEG_*``, with up arrays) and ``levels_pt``
    (the SceneMap constants, with up arrays) against JAX's, index fields bit
    for bit, built from ``c_pc_xyz``, from the fps wire, or read from a full
    cache; 4096-point clouds so that the deepest level has 16 points."""
    xyz = _cloud(4096)
    cond = {"c_pc_xyz": xyz}
    if source != "built":
        for prefix, strides, ns in (("geo_seg", SEG_STRIDES, SEG_NSAMPLES),
                                    ("geo_sm", SM_STRIDES, SM_NSAMPLES)):
            geo = _geo(_levels(xyz, strides, ns), prefix)
            cond.update(geo if source == "full cache"
                        else {k: v for k, v in geo.items() if k.endswith("_fps_idx")})
    jm = jax_cdm.CDM(contact_dim=C, arch="PointTrans", use_scene_model=True, knn_exact=True)
    tm = CDM(C, TIME, TEXT, 32, True, arch="PointTrans", arch_cfg=dict(planes=PT_P),
             scene_planes=SEG_P, scene_blocks=SEG_B, knn_exact=True)
    want = jax_conditioning.add_hierarchies(jm, {k: jnp.asarray(v) for k, v in cond.items()})
    got = conditioning.add_hierarchies(tm, {k: torch.from_numpy(v) for k, v in cond.items()})
    for key in ("levels_seg", "levels_pt"):
        _assert_same(want[key], got[key])
    assert [lv.xyz.shape[1] for lv in got["levels_seg"]] == [4096, 1024, 256, 64, 16]
    assert all(lv.up_idx is not None for lv in got["levels_pt"][1:])
    mlp = CDM(C, TIME, TEXT, arch="MLP")
    assert not any(k.startswith("levels") for k in conditioning.add_hierarchies(
        mlp, {"c_pc_xyz": torch.from_numpy(xyz)}))


def test_store_caches_the_cdm_hierarchies_as_jax():
    """The device store's geometry cache for a CDM with the scene model and
    the PointTrans backbone, on a store of two 4096-point clouds holding the
    fps wire of both hierarchies: both packages cache the same fields of
    ``geo_seg`` and ``geo_sm`` (the up arrays included) from the same
    kernels' plain versions, bit for bit where they are indices."""
    xyz = _cloud(4096)
    arrays = {"xyz16": xyz.astype(np.float16)}
    for prefix, strides, ns in (("geo_seg", SEG_STRIDES, SEG_NSAMPLES),
                                ("geo_sm", SM_STRIDES, SM_NSAMPLES)):
        geo = _geo(_levels(xyz, strides, ns), prefix)
        arrays.update({k: v.astype(np.int16) for k, v in geo.items() if k.endswith("_fps_idx")})
    meta = {"kind": "h3d_contact"}
    jm = jax_cdm.CDM(contact_dim=C, arch="PointTrans", use_scene_model=True, knn_exact=True)
    tm = CDM(C, TIME, TEXT, 32, True, arch="PointTrans", arch_cfg=dict(planes=PT_P),
             scene_planes=SEG_P, scene_blocks=SEG_B, knn_exact=True)
    jst = jax_device_store.DeviceStore(dict(arrays), dict(meta))
    tst = DeviceStore(dict(arrays), dict(meta))
    assert jst.add_geometry_cache(jm) and tst.add_geometry_cache(tm, "cpu")
    added = sorted(k for k in tst.arrays if k not in arrays)
    assert added == sorted(k for k in jst.arrays if k not in arrays)
    assert {k.split("_")[1][:-1] for k in added} == {"seg", "sm"}
    assert "geo_seg4_up_idx" in added and "geo_sm3_up_weight" in added
    for k in added:
        want, got = np.asarray(jst.arrays[k]), tst.arrays[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k.endswith("_up_weight"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    # a model that reads no hierarchy caches nothing
    assert not DeviceStore(dict(arrays), dict(meta)).add_geometry_cache(
        CDM(C, TIME, TEXT, arch="MLP"), "cpu")


# ------------------------------------------------------- the pretrained file
def _loop_cfg(path):
    return DictConfig({"model": {"scene_model": {"pretrained_weight": str(path)}}})


@contextlib.contextmanager
def _log_lines():
    """The port logger's messages inside the block."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    get_logger().addHandler(handler)
    try:
        yield lines
    finally:
        get_logger().removeHandler(handler)


def test_pretrained_scene_model_loads_the_reference_file(tmp_path):
    """The train loop's pretrained load: a ``.pth`` in the reference's
    layout (DDP's ``module.`` prefix, a segmentation head beside the U-Net,
    ``{"state_dict": ...}``) fills the scene model with ``strict=True``; the
    rest of the CDM keeps its weights. ``load_scene_model`` reads the same
    file."""
    torch.manual_seed(5)
    src = PointTransformerSeg(6, SEG_P, SEG_B)
    with torch.no_grad():
        for k, v in src.state_dict().items():
            if v.is_floating_point():
                v.add_(0.1 * torch.randn_like(v))
    ref = {f"module.{k}": v for k, v in src.state_dict().items()}
    ref["module.cls.0.weight"] = torch.zeros(13, 16)
    path = tmp_path / "model.pth"
    torch.save({"state_dict": ref}, path)
    torch.manual_seed(6)
    tm = _torch_model("MLP")
    rest = {k: v.clone() for k, v in tm.state_dict().items() if not k.startswith("scene_model.")}
    with _log_lines() as lines:
        TrainLoop._maybe_load_pretrained_scene(SimpleNamespace(model=tm), _loop_cfg(path))
    assert any("Loaded pretrained scene model" in line for line in lines)
    for k, v in src.state_dict().items():
        assert torch.equal(tm.scene_model.state_dict()[k], v), k
    assert all(torch.equal(tm.state_dict()[k], v) for k, v in rest.items())
    full = load_scene_model("PointTransformerSeg", 6, str(tmp_path / "absent.pth"))
    assert isinstance(full, PointTransformerSeg) and full.enc5[0].linear.out_features == 512
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_scene_model("PointTransformerSeg", 6, str(path))   # another width: strict


def test_absent_pretrained_file_keeps_the_init_with_a_warning(tmp_path):
    """As in the JAX package: without the file the scene model keeps its
    initial weights and the loop warns; a model without a scene model reads
    nothing."""
    tm = _torch_model("MLP")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with _log_lines() as lines:
        TrainLoop._maybe_load_pretrained_scene(SimpleNamespace(model=tm),
                                               _loop_cfg(tmp_path / "model.pth"))
    assert any("pretrained scene weights not found" in line for line in lines)
    assert all(torch.equal(tm.state_dict()[k], v) for k, v in before.items())
    TrainLoop._maybe_load_pretrained_scene(SimpleNamespace(model=CDM(C, TIME, TEXT, arch="MLP")),
                                           _loop_cfg(tmp_path / "model.pth"))


# ------------------------------------------------------- the configuration
def _cfg(task, *extra):
    cfg = load_config("configs", [f"task={task}", "model=cdm", *extra])
    cfg.model.input_feats = 6
    return cfg.model


def test_h3d_task_refuses_the_scene_model_as_jax_fails():
    """On the HumanML3D task ``use_openscene`` and ``use_color`` stay
    unresolved: JAX reads them as true, takes the OpenScene branch and fails
    on the ``c_pc_feat`` those items lack. The port refuses that
    configuration at build time naming ``c_pc_feat``, and an OpenScene CDM's
    forward without it raises naming it; with ``use_scene_model=False``
    every backbone builds."""
    for arch in ARCHS:
        with pytest.raises(ValueError, match="c_pc_feat"):
            build_cdm(_cfg("text_to_motion_contact_gen", f"model.arch={arch}"))
        m = build_cdm(_cfg("text_to_motion_contact_gen", f"model.arch={arch}",
                           "model.scene_model.use_scene_model=False"))
        assert m.scene_model is None and m.needs_pt_hierarchy == arch.startswith("PointTrans")
    jm = _jax_model("Perceiver", openscene=True, pfd=1)
    assert jm.use_openscene and not jm.needs_seg_hierarchy
    tm = _torch_model("Perceiver", openscene=True, pfd=1).eval()
    x = torch.zeros(B, 8, C)
    with pytest.raises(KeyError, match="c_pc_feat"):
        tm(x, torch.zeros(B, dtype=torch.long), {"c_pc_xyz": torch.zeros(B, 8, 3),
                                                  "text_emb": torch.zeros(B, 1, TEXT)})

"""Parity of the port's CMDM ``trans_dec`` (the SceneMap U-Net, the decoder
layers with cross-attention to its four scales) with the JAX package's, at a
small width on the CPU: planes 16/32/64/128, latent 64, 4 heads,
``num_layers`` (1, 1, 1) (two decoder layers, reading the two coarsest
scales), batch 2 and 1024 points.

Both sides get the same weights (flax init, BatchNorm statistics and affine
set to non-trivial values, exported with ``export_cmdm_checkpoint(arch=
"trans_dec")`` and carried by ``utils/convert.py``), the same hierarchy index
arrays (the JAX hierarchy, built ``with_up=True`` on the exact kNN: the 3-NN
up-weights of a coarse parent point are ill-conditioned in the expanded-form
distance, so each side building its own would compare those rows' rounding)
and the same inputs made from a numpy seed. Tolerances: the U-Net outputs
and ``denoise`` as ``tests/test_torch_cmdm.py`` holds ``trans_enc``, float32
1e-4 and bfloat16 5e-2 (abs and rel); one train step at batch 4 x 512 points
to ``tests/test_torch_train.py``'s (``_compare_train_steps``); a DDIM chain
from ``parity_noise`` to 1e-4 as ``tests/test_torch_sampling.py``'s chains.
The name table round trip is bit for bit.

An item whose memory is all masked (``c_pc_mask``) gets, on JAX's einsum
route, uniform weights over every key: the mean of v. The port's einsum route
gives the same, and so does its fused route's wrapper, whose kernels (and
their plain versions, which the CPU runs) give zero rows: both are held to
JAX's einsum, forward and backward.
"""
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.diffusion import create_gaussian_diffusion as jax_diffusion
from afford_motion_tpu.models import layers as jax_layers
from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays
from afford_motion_tpu.train.sampling import make_sample_fn as jax_sample_fn
from afford_motion_tpu.utils.torch_convert import export_cmdm_checkpoint
from afford_motion_torch.data import create_dataset
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.models import layers
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.models.conditioning import host_prepare_cond
from afford_motion_torch.ops.cuda.attention import attention_plain
from afford_motion_torch.ops.hierarchy import geometry_from_arrays
from afford_motion_torch.train.device_store import DeviceStore
from afford_motion_torch.train.loop import TrainLoop
from afford_motion_torch.train.sampling import make_sample_fn, parity_noise
from afford_motion_torch.utils.config import DictConfig
from afford_motion_torch.utils.convert import (
    cmdm_jax_tree_from_state_dict,
    cmdm_state_dict_from_jax,
)
from test_torch_cmdm import _perturb_bn
from test_torch_device_store import _cfg, _HashText, tree  # noqa: F401  (a fixture)
from test_torch_train import _assert_trees_close, _compare_train_steps
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N, L, D, TEXT = 2, 1024, 24, 263, 64
PLANES, BLOCKS, LAYERS = (16, 32, 64, 128), (2, 2, 2, 2), (1, 1, 1, 1, 1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = dict(motion_dim=D, latent_dim=64, time_emb_dim=64, text_feat_dim=TEXT,
            contact_dim=6, planes=PLANES, blocks=BLOCKS, num_layers=LAYERS,
            num_heads=4, dim_feedforward=128, arch="trans_dec")
NAMES = dict(num_layers=LAYERS, blocks=BLOCKS, arch="trans_dec")


def _levels(xyz):
    return build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 16),
                                 with_up=True, knn_method="exact")


def _geo(levels):
    return {k: np.asarray(v) for k, v in geometry_to_arrays(levels, prefix="geo_sm").items()}


def _variables(rng):
    """Seeded weights: the port's init carried to a flax tree by the name
    table, BatchNorm statistics and affine set to non-trivial values (flax
    init is mean 0, var 1, scale 1, bias 0, which would hide a mixed-up
    statistic)."""
    torch.manual_seed(0)
    tree = cmdm_jax_tree_from_state_dict(CMDM(**ARCH).state_dict(), **NAMES)
    return {"params": _perturb_bn(tree["params"], rng, "params"),
            "batch_stats": _perturb_bn(tree["batch_stats"], rng, "stats")}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    contact = rng.uniform(size=(B, N, 6)).astype(np.float32)
    levels = _levels(xyz)
    x_mask = np.zeros((B, L), dtype=bool)
    x_mask[1, 15:] = True
    cond = {
        "levels_sm": levels,
        "c_pc_contact": jnp.asarray(contact),
        "text_emb": jnp.asarray(rng.normal(size=(B, 1, TEXT)).astype(np.float32)),
        "x_mask": jnp.asarray(x_mask),
    }
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    t = np.array([10, 700], dtype=np.int32)
    variables = _variables(rng)
    geo = _geo(levels)
    t_levels = geometry_from_arrays({k: torch.tensor(v) for k, v in geo.items()},
                                    torch.from_numpy(xyz), 4, prefix="geo_sm")
    assert all(lv.up_idx is not None for lv in t_levels[1:])
    return dict(xyz=xyz, contact=contact, cond=cond, x=x, t=t, variables=variables,
                sd=cmdm_state_dict_from_jax(variables, **NAMES), geo=geo, t_levels=t_levels,
                x_mask=x_mask)


@pytest.fixture(scope="module")
def jax_encoded(setup):
    """Per dtype: the U-Net's four scales from JAX, and a jitted denoise."""
    out = {}
    for dtype in TOL:
        jm = JaxCMDM(**ARCH, dtype=jnp.dtype(dtype))
        enc = jax.jit(partial(jm.apply, method=JaxCMDM.encode_contact))(
            setup["variables"], setup["cond"])
        out[dtype] = (enc, jax.jit(partial(jm.apply, method=JaxCMDM.denoise)))
    return out


def _torch_model(sd, dtype="float32", **kw):
    tm = CMDM(**ARCH, dtype=getattr(torch, dtype), **kw)
    tm.load_state_dict(sd, strict=True)
    return tm.eval()


def _torch_cond(setup, jcond):
    cond = {k: torch.tensor(np.asarray(v)) for k, v in jcond.items() if k != "levels_sm"}
    cond["levels_sm"] = setup["t_levels"]
    return cond


def test_names_load_the_jax_export_both_ways(setup):
    """The name table's flax tree has every variable of the JAX model's
    init, at its shape, and no other; the JAX package's own export of it
    loads with ``strict=True`` and equals the table's state_dict; the
    table's inverse gives the flax tree back bit for bit."""
    shapes = jax.eval_shape(JaxCMDM(**ARCH).init, jax.random.PRNGKey(0),
                            jnp.asarray(setup["x"]), jnp.asarray(setup["t"]), setup["cond"])
    assert (jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
            == jax.tree_util.tree_map(lambda a: a.shape, setup["variables"]))
    exported = export_cmdm_checkpoint(setup["variables"], **NAMES)
    tm = CMDM(**ARCH)
    tm.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in exported.items()},
                       strict=True)
    sd = setup["sd"]
    assert set(tm.state_dict()) == set(sd)
    for k, v in exported.items():
        assert torch.equal(torch.as_tensor(np.asarray(v)).to(sd[k].dtype), sd[k]), k
    assert any(k.startswith("kv_mappling_layers.") for k in sd)
    assert any(k.startswith("contact_encoder.dec4.0.linear2.0") for k in sd)
    back = cmdm_jax_tree_from_state_dict(_torch_model(sd).state_dict(), **NAMES)
    _assert_trees_close(back, setup["variables"], atol=0.0, what="roundtrip")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_matches_jax(setup, jax_encoded, dtype):
    """The four scales of ``encode_contact``, coarsest first, eval-mode BN
    with non-trivial running statistics."""
    want = jax_encoded[dtype][0]
    with torch.no_grad():
        got = _torch_model(setup["sd"], dtype).encode_contact(_torch_cond(setup, setup["cond"]))
    shapes = [(B, N // 64, PLANES[3]), (B, N // 16, PLANES[2]), (B, N // 4, PLANES[1]),
              (B, N, PLANES[0])]
    assert [tuple(g.shape) for g in got] == shapes and len(want) == 4
    tol = TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, dtype=np.float32),
                                   rtol=tol, atol=tol)


CFG_FLAGS = {
    "none": {},
    "text_mask+pc_erase": {"c_text_mask": [[True], [False]], "c_pc_erase": [[0.0], [1.0]]},
    "text_erase+pc_mask": {"c_text_erase": [[1.0], [0.0]], "c_pc_mask": [[False], [True]]},
}


@pytest.mark.parametrize("flags", list(CFG_FLAGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoise_matches_jax(setup, jax_encoded, dtype, flags):
    """``denoise`` on the cached U-Net scales with the CFG flags (``c_pc_mask``
    masks item 1's every memory, ``c_pc_erase`` zeroes them) and a padded
    x_mask; valid frames only."""
    tm = _torch_model(setup["sd"], dtype)
    jcond = dict(setup["cond"])
    for k, v in CFG_FLAGS[flags].items():
        jcond[k] = jnp.asarray(np.asarray(v))
    enc, denoise = jax_encoded[dtype]
    want = denoise(setup["variables"], jnp.asarray(setup["x"]), jnp.asarray(setup["t"]),
                   jcond, enc)
    tcond = _torch_cond(setup, jcond)
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(setup["x"]), torch.from_numpy(setup["t"]), tcond,
                         tm.encode_contact(tcond))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L, D)
    valid = ~setup["x_mask"]
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=tol, atol=tol)


# ----------------------------------------------------- the all-masked memory
def _masked_attention_inputs():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(3, n, 64)).astype(np.float32) for n in (7, 40, 40))
    mask = np.zeros((3, 40), dtype=bool)
    mask[1] = True              # every key masked
    mask[2, 25:] = True
    return q, k, v, mask


def _jax_einsum(q, k, v, mask):
    return jax_layers._attention(q, k, v, 4, mask, lambda weights: weights)


@pytest.mark.parametrize("route", ["einsum", "fused"])
def test_all_masked_memory_matches_jax_einsum(monkeypatch, route):
    """The einsum route and the fused route's wrapper (on the CPU its plain
    version, which gives zero rows) against JAX's einsum, a cross-attention
    whose key and value are one memory: the item with no attended key gets
    the mean of v, and its memory the weights' share of the gradient,
    forward and backward; the other items as they were."""
    q, m, _, mask = _masked_attention_inputs()
    g = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: _jax_einsum(a, b, b, jnp.asarray(mask)),
                        *map(jnp.asarray, (q, m)))
    want_grads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(want)[1], np.broadcast_to(m[1].mean(0), (7, 64)),
                               rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(layers, "_flash_enabled", lambda t: route == "fused")
    mha = layers.TorchMultiHeadAttention(64, 4).eval()
    tq, tm = (torch.tensor(a, requires_grad=True) for a in (q, m))
    tmask = torch.from_numpy(mask)
    if route == "fused":
        assert float(attention_plain(tq, tm, tm, 4, tmask)[1].abs().max()) == 0.0
    # the module's projections as identities, to reach the attention itself
    with torch.no_grad():
        mha.in_proj_weight.copy_(torch.cat([torch.eye(64)] * 3))
        mha.out_proj.weight.copy_(torch.eye(64))
        mha.out_proj.bias.zero_()
    got = mha(tq, tm, tm, tmask)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for t, w in zip((tq, tm), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert float(tq.grad[1].abs().max()) == 0.0 and float(tm.grad[1].abs().max()) > 0.0


# ------------------------------------------------------------ train and chain
NT = 512
# the step's model: one block a stage (the encoder's TransitionDowns, the
# decoder's TransitionUps and blocks), which halves the JAX step's compile
TRAIN_ARCH = dict(ARCH, blocks=(1, 1, 1, 1))
TRAIN_NAMES = dict(NAMES, blocks=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def train_setup():
    """Batch 4 x 512 points, dropout 0, a JAX-built hierarchy with its up
    arrays (read by both sides), the t and noise of three steps."""
    rng = np.random.default_rng(3)
    nb = 4
    xyz = rng.normal(size=(nb, NT, 3)).astype(np.float32)
    levels = _levels(xyz)
    x_mask = np.zeros((nb, L), dtype=bool)
    x_mask[1, 15:] = True
    x_mask[3, 20:] = True
    arrays = {
        "c_pc_xyz": xyz,
        "c_pc_contact": rng.uniform(size=(nb, NT, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(nb, 1, TEXT)).astype(np.float32),
        "c_pc_erase": np.array([[0.0], [1.0], [0.0], [0.0]], dtype=np.float32),
        "x_mask": x_mask,
    }
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond["levels_sm"] = levels
    tcond = {k: torch.tensor(v) for k, v in {**arrays, **_geo(levels)}.items()}
    x = rng.normal(size=(nb, L, D)).astype(np.float32)
    jm = JaxCMDM(**TRAIN_ARCH, dropout=0.0)
    torch.manual_seed(0)
    variables = cmdm_jax_tree_from_state_dict(CMDM(**TRAIN_ARCH).state_dict(), **TRAIN_NAMES)
    ts = [np.array([10, 700, 0, 999]), np.array([5, 250, 640, 31]), np.array([900, 1, 77, 420])]
    noises = [rng.standard_normal((nb, L, D)).astype(np.float32) for _ in ts]
    return dict(jm=jm, jcond=jcond, tcond=tcond, x=x, variables=variables, ts=ts, noises=noises)


# Gradients within 5e-3 of each tensor's largest entry, not
# test_torch_train.py's 1e-3: the U-Net's train-mode step has ReLU inputs
# within float32 rounding of 0 (at this size the port in float32 and in
# float64 put 2 of them on opposite sides; with two blocks a stage 5, and at
# 1024 points 196), and train-mode BatchNorm spreads each such kink over its
# layer. The port's float32 gradients are 1.26e-3 of a tensor's largest entry
# from JAX's (dec4's PointTransformerLayer), while both lie up to 0.18 from
# the port's float64 one where they take the same side of a kink, and the
# forward agrees with float64 to 2e-5. Everything else, the loss, the norm,
# the updated parameters and the BatchNorm buffers, is held to that file's
# tolerances.
TRAIN_GRAD_REL = 5e-3


def test_train_step_matches_jax(train_setup):
    """Three AdamW steps from the same weights on the same batch, t and
    noise: the first step's loss, every gradient, the parameters and the
    BatchNorm buffers after it, the next two losses."""
    s = train_setup
    tm = CMDM(**TRAIN_ARCH, dropout=0.0)
    tm.load_state_dict(cmdm_state_dict_from_jax(s["variables"], **TRAIN_NAMES), strict=True)
    _compare_train_steps(s, s["variables"], s["jcond"], s["tcond"], s["x"], tm, 0.0, 0,
                         to_tree=lambda t: cmdm_jax_tree_from_state_dict(t, **TRAIN_NAMES),
                         grad_rel_of_max=TRAIN_GRAD_REL)


def test_ddim_chain_matches_jax(setup):
    """A DDIM chain of 8 steps from ``parity_noise`` through both packages'
    ``make_sample_fn`` (the hierarchy and the U-Net once, the denoiser with
    both decoder layers at every step), on the same geometry arrays."""
    np_cond = {"c_pc_xyz": setup["xyz"], "c_pc_contact": setup["contact"],
               "text_emb": np.asarray(setup["cond"]["text_emb"]),
               "c_text_mask": np.array([[False], [True]]), "x_mask": setup["x_mask"],
               **setup["geo"]}
    cfg = DictConfig({"steps": 8})
    init, _ = parity_noise(11, 0, (B, L, D), 8)
    jm = JaxCMDM(**ARCH)
    want = jax_sample_fn(jm, jax_diffusion(cfg), sampler="ddim")(
        setup["variables"], (B, L, D), {k: jnp.asarray(v) for k, v in np_cond.items()},
        jax.random.PRNGKey(0), jnp.asarray(init))
    tm = _torch_model(setup["sd"])
    timing = {}
    got = make_sample_fn(tm, create_gaussian_diffusion(cfg), sampler="ddim")(
        (B, L, D), {k: torch.from_numpy(v) for k, v in np_cond.items()},
        noise=torch.from_numpy(init), timing=timing)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L, D) and "loop_s" in timing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ the data
@pytest.mark.parametrize("arch", ["trans_enc", "trans_dec"])
def test_data_routes_keep_up_arrays_for_trans_dec(tree, arch):  # noqa: F811
    """On a prepared tree (packed store, the full geometry wire): the
    dataset's items, the host wire and the loop's drop list carry
    ``_up_idx``/``_up_weight`` for ``trans_dec`` (f16 weights from the packed
    store) and leave them out for ``trans_enc``; the device store caches
    them (int16 indices, f32 weights) only for ``trans_dec``."""
    tds = create_dataset(_cfg(tree, DictConfig, geometry_wire="full", geometry_arch=arch),
                         "train")
    item = tds[0]
    up = arch == "trans_dec"
    up_keys = [k for k in item if k.startswith("geo_sm") and k.endswith(("_up_idx",
                                                                         "_up_weight"))]
    assert bool(up_keys) == up and all(f"geo_sm{li}_up_idx" in item for li in (1, 2, 3)) == up
    if up:
        assert item["geo_sm1_up_weight"].dtype == np.float16
    tm = CMDM(**dict(ARCH, planes=(8, 16, 32, 64), arch=arch, text_feat_dim=16))
    drop = TrainLoop._drop_cond_suffixes(SimpleNamespace(model=tm))
    assert drop == (() if up else ("_up_idx", "_up_weight"))
    batch = {k: (np.stack([v]) if isinstance(v, np.ndarray) else [v]) for k, v in item.items()}
    _, cond = host_prepare_cond(batch, _HashText(), drop)
    assert any(k.endswith("_up_weight") for k in cond) == up
    # the device store: the fps wire, the hierarchy cached at upload
    store = DeviceStore.try_build(create_dataset(_cfg(tree, DictConfig, geometry_arch=arch),
                                                 "train"))
    assert store is not None and store.add_geometry_cache(tm, "cpu")
    cached = {k: v for k, v in store.arrays.items() if k.endswith(("_up_idx", "_up_weight"))}
    assert sorted(cached) == (sorted(f"geo_sm{li}_up_{f}" for li in (1, 2, 3)
                                     for f in ("idx", "weight")) if up else [])
    for k, v in cached.items():
        assert v.dtype == (np.int16 if k.endswith("_idx") else np.float32), k

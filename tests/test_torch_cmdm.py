"""Parity of the PyTorch port's CMDM (``afford_motion_torch.models``) with the
JAX package's, at a small width on the CPU.

Both sides get the same weights (flax init, BatchNorm statistics and affine
set to non-trivial values, exported with ``export_cmdm_checkpoint`` and
loaded with ``strict=True``), the same hierarchy index arrays and the same
inputs made from a seed with numpy. Tolerances: float32 1e-4 (abs and rel;
both sides sum in float32, in other orders), bfloat16 5e-2 (the two
frameworks round to bf16 at different points).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.ops.hierarchy import geometry_from_arrays
from afford_motion_torch.utils.convert import cmdm_state_dict_from_jax

B, N, L, D, TEXT = 2, 1024, 24, 263, 64
PLANES, BLOCKS, LAYERS = (16, 32, 64, 128), (2, 2, 2, 2), (1, 1)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = dict(motion_dim=D, latent_dim=64, time_emb_dim=64, text_feat_dim=TEXT,
            contact_dim=6, planes=PLANES, blocks=BLOCKS, num_layers=LAYERS,
            num_heads=4, dim_feedforward=128)


def _perturb_bn(tree, rng, kind):
    """BatchNorm leaves -> non-trivial values (flax init is mean 0, var 1,
    scale 1, bias 0, which would hide a mixed-up statistic)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng, kind)
        elif kind == "stats" and k == "mean":
            out[k] = rng.normal(scale=0.2, size=v.shape).astype(np.float32)
        elif kind == "stats" and k == "var":
            out[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
        elif kind == "params" and k == "scale" and v.ndim == 1:
            out[k] = rng.uniform(0.7, 1.3, size=v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    contact = rng.uniform(size=(B, N, 6)).astype(np.float32)
    levels = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 16),
                                   with_up=False, knn_method="exact")
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
    init = jax.jit(JaxCMDM(**ARCH).init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                         jnp.asarray(t), cond)
    variables = {
        "params": _perturb_bn(jax.device_get(init["params"]), rng, "params"),
        "batch_stats": _perturb_bn(jax.device_get(init["batch_stats"]), rng, "stats"),
    }
    sd = cmdm_state_dict_from_jax(variables, num_layers=LAYERS, blocks=BLOCKS)
    arrays = {k: torch.tensor(np.asarray(v))
              for k, v in geometry_to_arrays(levels, prefix="geo_sm").items()}
    t_levels = geometry_from_arrays(arrays, torch.from_numpy(xyz), 4, prefix="geo_sm")
    return dict(rng=rng, xyz=xyz, contact=contact, cond=cond, x=x, t=t,
                variables=variables, sd=sd, t_levels=t_levels, x_mask=x_mask)


@pytest.fixture(scope="module")
def jax_encoded(setup):
    """Per dtype: the JAX model, its contact encoding of ``setup``'s cloud,
    and a jitted denoise (one compile per condition structure)."""
    out = {}
    for dtype in TOL:
        jm = JaxCMDM(**ARCH, dtype=jnp.dtype(dtype))
        enc = jax.jit(partial(jm.apply, method=JaxCMDM.encode_contact))(
            setup["variables"], setup["cond"])
        out[dtype] = (enc, jax.jit(partial(jm.apply, method=JaxCMDM.denoise)))
    return out


def _torch_model(setup, dtype):
    tm = CMDM(**ARCH, dtype=getattr(torch, dtype))
    tm.load_state_dict(setup["sd"], strict=True)
    return tm.eval()


def _torch_cond(setup, jcond):
    cond = {k: torch.tensor(np.asarray(v)) for k, v in jcond.items() if k != "levels_sm"}
    cond["levels_sm"] = setup["t_levels"]
    return cond


def test_state_dict_names_match_export(setup):
    """Every exported name is a port parameter or buffer, and vice versa."""
    tm = CMDM(**ARCH)
    assert set(tm.state_dict()) == set(setup["sd"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scenemap_encoder_matches_jax(setup, jax_encoded, dtype):
    """SceneMapEncoder (CMDM.encode_contact), eval-mode BN with non-trivial
    running statistics."""
    want = jax_encoded[dtype][0]
    with torch.no_grad():
        got = _torch_model(setup, dtype).encode_contact(_torch_cond(setup, setup["cond"]))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, N // 64, PLANES[-1])
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


CFG_FLAGS = {
    "none": {},
    "text_mask+pc_erase": {"c_text_mask": [[True], [False]], "c_pc_erase": [[0.0], [1.0]]},
    "text_erase+pc_mask": {"c_text_erase": [[1.0], [0.0]], "c_pc_mask": [[False], [True]]},
}


@pytest.mark.parametrize("flags", list(CFG_FLAGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoise_matches_jax(setup, jax_encoded, dtype, flags):
    """CMDM.denoise on the cached contact encoding, with the CFG flags and a
    padded x_mask; compared on valid frames only (padded query rows are
    garbage on both sides)."""
    tm = _torch_model(setup, dtype)
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

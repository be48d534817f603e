"""Parity of the port's SMPL-X linear blend skinning
(``afford_motion_torch.eval.smplx_lbs``) with the JAX package's on the CPU.

The synthetic body model is built from the same seed in both packages (equal
arrays) and also crossed through ``utils/convert.py``. Poses come from a seed
with numpy. Tolerance: 1e-5 abs on vertices and joints (float32 products
over up to 10475 vertices summed in other orders; the values are O(1)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.eval import smplx_lbs as jlbs
from afford_motion_torch.eval import smplx_lbs as tlbs
from afford_motion_torch.utils.convert import SMPLX_FIELDS, smplx_model_from_arrays

TOL = dict(rtol=0, atol=1e-5)


def _pose(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 3)).astype(np.float32),
            rng.normal(size=(b, 3)).astype(np.float32) * 0.5,
            rng.normal(size=(b, 63)).astype(np.float32) * 0.4,
            rng.normal(size=(b, 10)).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    jm = jlbs.SMPLXModel.synthetic(num_verts=96, seed=3, num_faces=150)
    tm = smplx_model_from_arrays({f: np.asarray(getattr(jm, f)) for f in SMPLX_FIELDS})
    return jm, tm


@pytest.mark.parametrize("kw", [dict(num_verts=128), dict(num_verts=64, seed=5, num_faces=200)])
def test_synthetic_gives_equal_arrays(kw):
    jm, tm = jlbs.SMPLXModel.synthetic(**kw), tlbs.SMPLXModel.synthetic(**kw)
    for f in SMPLX_FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(jm.faces, tm.faces)
    assert jm.num_vertices == tm.num_vertices


def test_load_default_grammar(monkeypatch, tmp_path):
    """The same environment grammar as the JAX package: the synthetic switch
    with its sizes, an explicit path, and the error without either."""
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", "70")
    monkeypatch.setenv("SMPLX_SYNTHETIC_FACES", "33")
    m = tlbs.SMPLXModel.load_default()
    assert m.num_vertices == 70 and m.faces.shape == (33, 3)
    monkeypatch.delenv("SMPLX_USE_SYNTHETIC")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tlbs.SMPLXModel.load_default()
    # an official-layout file: posedirs (V, 3, P), kintree_table, f
    syn = tlbs.SMPLXModel.synthetic(num_verts=40)
    V = 40
    np.savez(tmp_path / "SMPLX_NEUTRAL.npz",
             v_template=syn.v_template.numpy(),
             shapedirs=np.concatenate([syn.shapedirs.numpy(), np.zeros((V, 3, 6), np.float32)], -1),
             posedirs=syn.posedirs.numpy().T.reshape(V, 3, -1),
             J_regressor=syn.J_regressor.numpy(), weights=syn.lbs_weights.numpy(),
             kintree_table=np.stack([np.where(syn.parents.numpy() < 0, 2 ** 32 - 1,
                                              syn.parents.numpy()).astype(np.int64),
                                     np.arange(55)]),
             f=syn.faces.astype(np.uint32))
    monkeypatch.setenv("SMPLX_MODEL_PATH", str(tmp_path / "SMPLX_NEUTRAL.npz"))
    loaded = tlbs.SMPLXModel.load_default()
    jloaded = jlbs.SMPLXModel.load(str(tmp_path / "SMPLX_NEUTRAL.npz"))
    for f in SMPLX_FIELDS:
        np.testing.assert_array_equal(getattr(loaded, f).numpy(), getattr(syn, f).numpy(), f)
        np.testing.assert_array_equal(getattr(loaded, f).numpy(),
                                      np.asarray(getattr(jloaded, f)), f)


def test_rodrigues_and_chain_match_jax(models):
    jm, tm = models
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(4, 55, 3)).astype(np.float32)
    aa[0, 3] = 0.0   # the rest pose: the identity, no division by zero
    want = np.asarray(jlbs.rodrigues(jnp.asarray(aa)))
    got = tlbs.rodrigues(torch.from_numpy(aa))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, 3].numpy(), np.eye(3, dtype=np.float32))
    rel = rng.normal(size=(55, 3)).astype(np.float32)
    parents = np.asarray(jm.parents)
    want = np.asarray(jlbs.chain_transforms(jnp.asarray(want[1]), jnp.asarray(rel), parents))
    got = tlbs.chain_transforms(got[1], torch.from_numpy(rel), tm.parents_tuple)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("with_betas", [False, True])
def test_smplx_forward_matches_jax(models, with_betas):
    jm, tm = models
    transl, orient, pose, betas = _pose(1, 5)
    jb, tb = (jnp.asarray(betas), torch.from_numpy(betas)) if with_betas else (None, None)
    want_v, want_j = jlbs.smplx_forward(jm, jnp.asarray(transl), jnp.asarray(orient),
                                        jnp.asarray(pose), jb)
    got_v, got_j = tlbs.smplx_forward(tm, torch.from_numpy(transl), torch.from_numpy(orient),
                                      torch.from_numpy(pose), tb)
    assert tuple(got_v.shape) == (5, 96, 3) and tuple(got_j.shape) == (5, 55, 3)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), **TOL)
    # the joints-only forward is the same function of the pose
    want = jlbs.smplx_joints(jm, jnp.asarray(transl), jnp.asarray(orient), jnp.asarray(pose), jb)
    got = tlbs.smplx_joints(tm, torch.from_numpy(transl), torch.from_numpy(orient),
                            torch.from_numpy(pose), tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), got_j.numpy(), rtol=0, atol=1e-6)


def test_params_helpers_match_jax(models):
    jm, tm = models
    params = np.random.default_rng(2).normal(size=(6, 69)).astype(np.float32) * 0.4
    want_v, want_j = jlbs.params_to_verts_joints(jm, jnp.asarray(params))
    got_v, got_j = tlbs.params_to_verts_joints(tm, torch.from_numpy(params))
    assert tuple(got_j.shape) == (6, 22, 3)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), **TOL)
    np.testing.assert_allclose(tlbs.params_to_joints(tm, torch.from_numpy(params)).numpy(),
                               np.asarray(jlbs.params_to_joints(jm, jnp.asarray(params))), **TOL)


def test_joints_gradient_matches_jax(models):
    """The refinement differentiates a joints error through the chain."""
    import jax

    jm, tm = models
    rng = np.random.default_rng(4)
    params = rng.normal(size=(3, 69)).astype(np.float32) * 0.4
    target = rng.normal(size=(3, 22, 3)).astype(np.float32)
    want = jax.grad(lambda p: jnp.mean(
        (jlbs.params_to_joints(jm, p) - jnp.asarray(target)) ** 2))(jnp.asarray(params))
    p = torch.from_numpy(params).requires_grad_(True)
    torch.mean((tlbs.params_to_joints(tm, p) - torch.from_numpy(target)) ** 2).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)

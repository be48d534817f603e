"""Parity of the port's joints -> SMPL-X fit
(``afford_motion_torch.eval.joints_to_smplx``) with the JAX package's on the
CPU: the regressor forward with weights crossed through ``utils/convert.py``
in both directions (1e-5 abs), the Adam refinement for a few steps, and the
fitter's two weight formats (``.npz`` in the flax flat-key layout, ``.pt`` in
the reference's torch layout).

The refinement's first Adam steps move every entry by about ``lr`` whatever
its gradient's size, with the sign of the gradient: where a gradient is at
rounding level its sign is noise and two correct implementations part by up
to ``2 * lr`` a step. The refined params are therefore held to 1e-4 on all
but 1% of the entries, and to ``2 * lr * steps`` everywhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.eval import joints_to_smplx as jfit
from afford_motion_tpu.eval import smplx_lbs as jlbs
from afford_motion_torch.eval import joints_to_smplx as tfit
from afford_motion_torch.eval import smplx_lbs as tlbs
from afford_motion_torch.utils.convert import (
    regressor_jax_tree_from_state_dict,
    regressor_state_dict_from_jax,
)

B, L = 3, 12


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x_mask = np.zeros((B, L), dtype=bool)
    x_mask[0, 9:] = True
    x_mask[2, 5:] = True
    return rng.normal(size=(B, L, 66)).astype(np.float32) * 0.5, x_mask


@pytest.fixture(scope="module")
def regressors():
    jreg = jfit.JointsToSMPLXRegressor()
    variables = jax.device_get(jreg.init({"params": jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 8, 66)), jnp.zeros((1, 8), bool),
                                         train=False))
    # biases and LayerNorm offsets start at zero: move them so they count
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32) * 0.02, variables)
    treg = tfit.JointsToSMPLXRegressor().eval()
    treg.load_state_dict(regressor_state_dict_from_jax(variables), strict=True)
    return jreg, variables, treg


def test_regressor_names_are_the_reference_layout(regressors):
    _, variables, treg = regressors
    keys = set(treg.state_dict())
    for name in ("input_layer.0.weight", "input_layer.2.bias", "output_layer.weight",
                 "TransEncoder.layers.1.self_attn.in_proj_weight",
                 "TransEncoder.layers.0.self_attn.out_proj.bias",
                 "TransEncoder.layers.0.linear1.weight", "TransEncoder.layers.1.norm2.bias"):
        assert name in keys, name
    assert len(keys) == 6 + 2 * 12
    # both directions of the table are inverses
    back = regressor_jax_tree_from_state_dict(treg.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_regressor_forward_matches_jax(regressors, inputs):
    jreg, variables, treg = regressors
    joints, x_mask = inputs
    want = np.asarray(jreg.apply(variables, jnp.asarray(joints), jnp.asarray(x_mask), train=False))
    with torch.no_grad():
        got = treg(torch.from_numpy(joints), torch.from_numpy(x_mask)).numpy()
    assert got.shape == (B, L, 69)
    valid = ~x_mask
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)


@pytest.mark.parametrize("steps", [1, 5])
def test_refine_matches_jax(inputs, steps):
    """``steps=5`` switches the smoothness term on from step 3."""
    joints, x_mask = inputs
    lr = 0.02
    jm = jlbs.SMPLXModel.synthetic(num_verts=64)
    tm = tlbs.SMPLXModel.synthetic(num_verts=64)
    init = np.random.default_rng(2).normal(size=(B, L, 69)).astype(np.float32) * 0.3
    want = np.asarray(jfit.make_refine_fn(jm, lr, steps)(
        jnp.asarray(init), jnp.asarray(joints), jnp.asarray(x_mask)))
    got = tfit.make_refine_fn(tm, lr, steps)(
        torch.from_numpy(init), torch.from_numpy(joints), torch.from_numpy(x_mask)).numpy()
    assert got.shape == init.shape and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr * steps + 1e-6
    assert (diff > 1e-4).mean() <= 0.01, f"{(diff > 1e-4).mean():.4f} of the entries differ"
    # padded frames carry no gradient: they stay where they started
    np.testing.assert_array_equal(got[0, 10:], init[0, 10:])
    assert np.abs(got - init).max() > 0.5 * lr


def test_refine_lowers_the_joint_error(inputs):
    """Targets that a pose reaches, a start beside that pose: the error falls."""
    _, x_mask = inputs
    tm = tlbs.SMPLXModel.synthetic(num_verts=64)
    rng = np.random.default_rng(3)
    true = torch.from_numpy(rng.normal(size=(B, L, 69)).astype(np.float32) * 0.3)
    init = true + torch.from_numpy(rng.normal(size=(B, L, 69)).astype(np.float32) * 0.1)
    target = tlbs.params_to_joints(tm, true.reshape(B * L, 69)).reshape(B, L, 66)

    def err(p):
        j = tlbs.params_to_joints(tm, p.reshape(B * L, 69)).reshape(B, L, 66)
        return float(((j - target) ** 2)[torch.from_numpy(~x_mask)].mean())

    refined = tfit.make_refine_fn(tm, 0.02, 30)(init, target, torch.from_numpy(x_mask))
    assert err(refined) < 0.3 * err(init)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_fitter_loads_both_formats_and_matches_jax(regressors, inputs, fmt, tmp_path, monkeypatch):
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", "64")
    _, variables, treg = regressors
    joints, x_mask = inputs
    npz = str(tmp_path / "regressor.npz")
    jfit.save_regressor_npz(npz, variables["params"])
    path = npz
    if fmt == "pt":
        path = str(tmp_path / "060.pt")
        # a stored positional table rides along in such a file and is passed over
        torch.save({**treg.state_dict(), "sequence_pos_encoder.pe": torch.zeros(4, 1, 256)}, path)
    fitter = tfit.JointsToSMPLXFitter(path, opt_rate=0.02, opt_steps=2, device="cpu")
    jfitter = jfit.JointsToSMPLXFitter(path, opt_rate=0.02, opt_steps=2)
    got, want = fitter.fit(joints, x_mask), jfitter.fit(joints, x_mask)
    assert got.shape == (B, L, 69) and got.dtype == np.float32
    diff = np.abs(got - want)[~x_mask]
    assert diff.max() <= 2 * 0.02 * 2 + 1e-6 and (diff > 1e-4).mean() <= 0.01
    verts = fitter.vertices(got[0])
    assert verts.shape == (L, 64, 3)
    np.testing.assert_allclose(verts, jfitter.vertices(got[0]), rtol=0, atol=1e-5)
    assert torch.equal(fitter.vertices_device(got[0]).cpu(), torch.from_numpy(verts))
    np.testing.assert_array_equal(fitter.faces, jfitter.faces)


def test_fitter_refuses_missing_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    with pytest.raises(FileNotFoundError):
        tfit.JointsToSMPLXFitter(str(tmp_path / "none.pt"), device="cpu")
    torch.save({"input_layer.0.weight": torch.zeros(128, 66)}, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="lack"):
        tfit.JointsToSMPLXFitter(str(tmp_path / "short.pt"), device="cpu")

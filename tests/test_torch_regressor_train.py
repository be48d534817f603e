"""The port's trainer of the joints -> SMPL-X regressor
(``afford_motion_torch.tools.train_joints_to_smplx``) against the root
``tools/train_joints_to_smplx.py`` on the CPU, on a synthetic
``{set}/motions`` tree and the synthetic SMPL-X body (``synthetic``: the
same draws in both packages).

- ``build_pairs``: the same sequences in the same order (24..196 frames),
  the params equal, the joints within 1e-5 + 1e-5 |x| (the two LBS sum in
  other orders); ``pad_batch`` equal.
- One Adam step at dropout 0 against the root tool's step body (optax's
  ``adam``, ``params_to_verts_joints``) on the same batch and weights: the
  three losses within 1e-5 (rel), every gradient within 1e-4 of its tensor's
  largest entry, and the parameters after the step within 1e-6 where the
  gradient is not rounding noise, else within 2 lr (Adam moves a noise
  entry by lr with the noise's sign; ``tests/test_torch_train.py`` holds
  AdamW the same way).
- The written ``.npz``: the keys and arrays of the JAX package's
  ``save_regressor_npz`` for the same weights; it loads into both packages'
  ``JointsToSMPLXFitter`` with the same fit (the refine's tolerance of
  ``tests/test_torch_fit.py``).
- The CLI for 3 steps on the CPU.
"""
import importlib.util
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from afford_motion_tpu.eval import joints_to_smplx as jfit
from afford_motion_tpu.eval import smplx_lbs as jlbs
from afford_motion_torch.eval import joints_to_smplx as tfit
from afford_motion_torch.eval import smplx_lbs as tlbs
from afford_motion_torch.tools import train_joints_to_smplx as ttool
from afford_motion_torch.utils.convert import regressor_jax_tree_from_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
VERTS = 64
LENGTHS = (30, 10, 196, 24, 197, 57, 23, 88, 140)   # 10, 197 and 23 are left out


def _root_tool():
    spec = importlib.util.spec_from_file_location("root_train_joints_to_smplx",
                                                  REPO / "tools" / "train_joints_to_smplx.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two sets of motion pickles in the prepare layout: pose_seq (L, 75)
    (69 parameters and more columns, as the releases carry) and betas."""
    root = tmp_path_factory.mktemp("motions")
    rng = np.random.default_rng(0)
    for s, lengths in (("HUMANISE", LENGTHS[:6]), ("PROX", LENGTHS[6:])):
        mdir = root / s / "motions"
        mdir.mkdir(parents=True)
        for i, n in enumerate(lengths):
            pose = (rng.normal(size=(n, 75)) * 0.3).astype(np.float32)
            pose[:, :3] *= 2.0
            with open(mdir / f"{i:06d}.pkl", "wb") as f:
                pickle.dump((pose, rng.normal(size=10).astype(np.float32)), f)
    return root


@pytest.fixture(scope="module")
def pairs(data):
    """Both tools' pairs; the root tool's LBS jitted over its model for the
    fixture (eager, a call costs seconds)."""
    root = _root_tool()
    body = jlbs.SMPLXModel.synthetic(VERTS)
    real = jlbs.smplx_forward
    fast = jax.jit(lambda *a: real(body, *a))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlbs, "smplx_forward", lambda model, *a: fast(*a))
        want = root.build_pairs(str(data), ["HUMANISE", "PROX"], body)
    got = ttool.build_pairs(str(data), ["HUMANISE", "PROX"], tlbs.SMPLXModel.synthetic(VERTS))
    return root, want, got


def test_build_pairs_and_pad_batch_match_the_root_tool(pairs):
    root, want, got = pairs
    assert len(got) == len(want) == 6
    assert [len(p) for _, p in got] == [30, 196, 24, 57, 88, 140]
    for (gj, gp), (wj, wp) in zip(got, want):
        assert gj.dtype == gp.dtype == np.float32 and gj.shape == (len(gp), 66)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_allclose(gj, wj, rtol=1e-5, atol=1e-5)
    idxs = np.random.default_rng(0).integers(0, len(got), size=5)
    for a, b in zip(ttool.pad_batch(got, idxs), root.pad_batch(got, idxs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ttool.build_pairs(str(REPO / "nowhere"), ["HUMANISE"],
                             tlbs.SMPLXModel.synthetic(VERTS)) == []


def _perturbed_regressor(seed=0):
    """The port's init with biases and LayerNorm offsets moved off zero, so
    that they count, at dropout 0."""
    torch.manual_seed(seed)
    reg = tfit.JointsToSMPLXRegressor(dropout=0.0)
    with torch.no_grad():
        for p in reg.parameters():
            p.add_(torch.randn(p.shape) * 0.02)
    return reg


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_adam_step_matches_the_root_step(pairs):
    _, want_pairs, got_pairs = pairs
    lr = 1e-4
    idxs = np.random.default_rng(0).integers(0, len(got_pairs), size=4)
    joints, gt, mask = ttool.pad_batch(got_pairs, idxs)
    treg = _perturbed_regressor().train()
    params = regressor_jax_tree_from_state_dict(treg.state_dict())["params"]

    # the root tool's step body at dropout 0
    jreg = jfit.JointsToSMPLXRegressor(dropout=0.0)
    body = jlbs.SMPLXModel.synthetic(VERTS)
    tx = optax.adam(lr)

    def loss_fn(p):
        pred = jreg.apply({"params": p}, jnp.asarray(joints), jnp.asarray(mask), train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        valid = (~jnp.asarray(mask)).astype(jnp.float32)[..., None]
        p_loss = jnp.sum(((pred - jnp.asarray(gt)) ** 2) * valid) / jnp.maximum(
            jnp.sum(valid) * jfit.PARAM_DIM, 1.0)
        B, L, _ = pred.shape
        _, j = jlbs.params_to_verts_joints(body, pred.reshape(B * L, jfit.PARAM_DIM))
        j = j.reshape(B, L, 66)
        j_loss = jnp.sum(((j - jnp.asarray(joints)) ** 2) * valid) / jnp.maximum(
            jnp.sum(valid) * 66, 1.0)
        return p_loss + j_loss, (p_loss, j_loss)

    (jloss, (jpl, jjl)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jafter = _flat(jax.device_get(optax.apply_updates(params, updates)))
    jgrads = _flat(jax.device_get(jgrads))

    trainer = ttool.RegressorTrainer(treg, tlbs.SMPLXModel.synthetic(VERTS), lr, 1.0)
    tj, tg, tm = (torch.from_numpy(a) for a in (joints, gt, mask))
    loss, _, _ = trainer.losses(tj, tg, tm)
    grads = dict(zip([k for k, _ in treg.named_parameters()],
                     torch.autograd.grad(loss, trainer.params)))
    got = trainer.step(tj, tg, tm)
    for g, w in zip(got, (jloss, jpl, jjl)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    tgrads = _flat(regressor_jax_tree_from_state_dict(grads)["params"])
    tafter = _flat(regressor_jax_tree_from_state_dict(treg.state_dict())["params"])
    assert sorted(tgrads) == sorted(jgrads) == sorted(tafter) == sorted(jafter)
    top = max(np.abs(g).max() for g in jgrads.values())
    noise = [k for k, w in jgrads.items() if np.abs(w).max() < 1e-5 * top]
    # the attention's key bias: a softmax does not move with it, so its true
    # gradient is 0 and both sides give rounding noise
    assert noise and all("Dense_1/bias" in k for k in noise), noise
    for k, w in jgrads.items():
        assert np.abs(tafter[k] - jafter[k]).max() <= 2 * lr * 1.001, k
        if k in noise:
            continue
        scale = np.abs(w).max()
        np.testing.assert_allclose(tgrads[k], w, rtol=0, atol=1e-4 * scale, err_msg=k)
        real = np.abs(w) >= max(1e-6, 1e-4 * scale)
        np.testing.assert_allclose(tafter[k][real], jafter[k][real], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert trainer.count == 1


def test_npz_is_the_jax_writers_and_loads_in_both_fitters(tmp_path, monkeypatch):
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", str(VERTS))
    reg = _perturbed_regressor(1)
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    tfit.save_regressor_npz(str(ours), reg)
    jfit.save_regressor_npz(str(theirs),
                            regressor_jax_tree_from_state_dict(reg.state_dict())["params"])
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 3 * 2 + 2 * 16
    for k in a.files:
        assert a[k].dtype == b[k].dtype == np.float32 and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    steps, lr = 3, 0.02
    rng = np.random.default_rng(5)
    joints = rng.normal(size=(2, 20, 66)).astype(np.float32) * 0.3
    x_mask = np.zeros((2, 20), dtype=bool)
    x_mask[1, 12:] = True
    port = tfit.JointsToSMPLXFitter(str(ours), opt_rate=lr, opt_steps=steps, device="cpu")
    sd = reg.state_dict()
    assert all(torch.equal(port.regressor.state_dict()[k], sd[k]) for k in sd)
    got = port.fit(joints, x_mask)
    want = jfit.JointsToSMPLXFitter(str(ours), opt_rate=lr, opt_steps=steps).fit(joints, x_mask)
    assert got.shape == want.shape == (2, 20, 69)
    diff = np.abs(got - want)
    assert diff.max() <= 2 * lr * steps + 1e-5
    assert (diff > 1e-4).mean() <= 0.01, f"{(diff > 1e-4).mean():.4f} of the entries differ"


def test_cli_trains_three_steps_on_the_cpu(data, tmp_path, monkeypatch):
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", str(VERTS))
    out = tmp_path / "out" / "regressor.npz"
    summary = ttool.main(["--data_dir", str(data), "--sets", "HUMANISE", "PROX", "--steps", "3",
                          "--batch_size", "4", "--out", str(out), "--device", "cpu"])
    assert summary["pairs"] == 6 and [e["step"] for e in summary["logged"]] == [0, 2]
    assert all(np.isfinite([e["loss"], e["params"], e["joints"]]).all()
               for e in summary["logged"])
    fitter = tfit.JointsToSMPLXFitter(str(out), opt_steps=2, device="cpu")
    x_mask = np.zeros((1, 8), dtype=bool)
    params = fitter.fit(np.zeros((1, 8, 66), np.float32), x_mask)
    assert params.shape == (1, 8, 69) and np.isfinite(params).all()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttool.main(["--data_dir", str(data), "--steps", "1", "--out", str(out)])

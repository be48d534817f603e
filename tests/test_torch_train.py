"""Parity of the PyTorch port's training slice with the JAX package's, on the
CPU at a small width (2 transformer layers, latent 64, planes 16/32/64/128,
512 points, batch 4, float32, dropout 0 where the two are compared).

Inputs, weights, timesteps and noise come from numpy seeds and go through
both sides; weights cross through ``utils/convert.py`` in both directions.
Both sides read the same hierarchy index arrays. Tolerances, each stated at
its test: train-mode BatchNorm 1e-5; encoder gradients 1e-4 of each
tensor's largest entry; diffusion MSE terms 1e-5 and bound terms 1e-4; the
full step's loss 1e-5
(rel), gradients 1e-3 of each tensor's largest entry (float32 sums in other
orders through ~40 layers, and XLA's scatter-add order under ``jnp.take``),
parameters after one AdamW step 1e-6 (abs) and BatchNorm buffers 1e-5, three
steps' losses 1e-4. Resume on the CPU is bit-exact.

The banded slice has the same tests on curve-sorted clouds of the 2^-8 grid
(512 points, batch 4: the windowed kNN with static and per-cloud starts, a
full window, and the fallbacks): the JAX side builds its hierarchy with
``banded.available`` patched to true (its Pallas kernels in interpret mode)
and gathers with ``jnp.take``, which equals the windowed gather for in-window
indices; the port goes the way the loop sends it, from the cached ``fps_idx``
through its banded routing with ``AM_BANDED_DEBUG=1``, and backward through
the banded scatter. Same tolerances.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.diffusion import create_gaussian_diffusion as jax_diffusion
from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.models.pointtransformer import PointNorm as JaxPointNorm
from afford_motion_tpu.ops.hierarchy import build_point_hierarchy, geometry_to_arrays
from afford_motion_tpu.ops.pallas import banded as jax_banded
from afford_motion_tpu.train.state import TrainState as JaxTrainState
from afford_motion_tpu.train.state import make_optimizer as jax_make_optimizer
from afford_motion_tpu.utils.config import DictConfig
from afford_motion_torch import test as test_entry
from afford_motion_torch import prepare as port_prepare
from afford_motion_torch import train as train_pkg
from afford_motion_torch.data.synthetic import make_synthetic_h3d
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.diffusion.resample import (
    LossSecondMomentResampler,
    UniformSampler,
    create_schedule_sampler,
)
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.models.layers import Dropout, set_dropout_generator
from afford_motion_torch.models.pointtransformer import PointNorm
from afford_motion_torch.ops.cuda import banded as torch_banded
from afford_motion_torch.ops.curves import curve_order
from afford_motion_torch.train.loop import make_train_step, step_seed
from afford_motion_torch.train.state import TrainState, annealed_lr
from afford_motion_torch.utils.convert import (
    cmdm_jax_tree_from_state_dict,
    cmdm_state_dict_from_jax,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, N, L, D, TEXT = 4, 512, 24, 263, 32
PLANES, BLOCKS, LAYERS = (16, 32, 64, 128), (2, 2, 2, 2), (1, 1)
ARCH = dict(motion_dim=D, latent_dim=64, time_emb_dim=64, text_feat_dim=TEXT,
            contact_dim=6, planes=PLANES, blocks=BLOCKS, num_layers=LAYERS,
            num_heads=4, dim_feedforward=128)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, want, *, rel_of_max=None, atol=0.0, what=""):
    """Leaf by leaf: within ``atol``, or within ``rel_of_max`` of the
    reference leaf's largest entry. A gradient leaf whose largest entry is
    below 1e-5 of the largest entry of the whole tree is numerically zero
    and is held to that bound on both sides instead. Those are the biases
    whose true gradient is 0, so that what either framework computes for
    them is rounding noise: every bias inside a PointTransformerLayer feeds
    a train-mode BatchNorm or the softmax over the neighbours, and so does
    every bias of a U-Net's TransitionUp but the head's ``Dense_0`` (a
    ReLU); the key projection's bias of an attention layer (self or cross)
    shifts all of a query's logits alike; both cancel a constant shift."""
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want), what
    zero = 1e-5 * max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        name = f"{what} {'/'.join(path)}"
        if rel_of_max is None:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=atol, err_msg=name)
        elif np.abs(w).max() < zero:
            up_bn = path[-3] == "TransitionUp_0" and (
                path[-2] == "Dense_1" or "PointDecoderStage_0" not in path)
            # a PointTrans CDM's context MLPs: each a Linear and a
            # train-mode BatchNorm, which the time embedder's last bias and
            # V2's bottleneck encoder's last LayerNorm bias reach only
            # through; V2's ctx3 and ctx2 feed a TransitionUp's linear1 (a
            # Linear and a train-mode BatchNorm) only
            ctx_bn = (path[-3].startswith("_CtxMLP_")
                      and (path[-2] == "Dense_0" or path[-3] != "_CtxMLP_0")) or path[-3:-1] in (
                ("timestep_embedder", "Dense_1"), ("TransformerEncoderLayer_0", "LayerNorm_1"))
            assert path[-1] == "bias" and ("PointTransformerLayer" in name or up_bn or ctx_bn
                                           or path[-3:-1] in (
                ("TorchMultiHeadAttention_0", "Dense_1"), ("TorchMultiHeadAttention_1", "Dense_1"),
                ("PerceiverMHA_0", "Dense_1"))), name
            assert np.abs(got[path]).max() < zero, name
        else:
            np.testing.assert_allclose(got[path], w, rtol=0, atol=rel_of_max * np.abs(w).max(),
                                       err_msg=name)


# --------------------------------------------------------------- (a) BatchNorm
def test_pointnorm_train_mode_matches_flax():
    """n = 8 rows: torch's own BatchNorm would store var * 8/7, a 14% gap;
    flax stores the biased variance, computed as max(E[x^2] - E[x]^2, 0).
    Output and running statistics after one call, rtol 1e-5."""
    rng = np.random.default_rng(0)
    C = 5
    x = (rng.normal(size=(2, 4, C)) * 3 + 1).astype(np.float32)
    stats = {"mean": rng.normal(size=C).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=C).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, size=C).astype(np.float32),
              "bias": rng.normal(size=C).astype(np.float32)}
    want, upd = JaxPointNorm().apply(
        {"params": {"BatchNorm_0": params}, "batch_stats": {"BatchNorm_0": stats}},
        jnp.asarray(x), train=True, mutable=["batch_stats"])
    pn = PointNorm(C).train()
    pn.load_state_dict({"weight": torch.tensor(params["scale"]),
                        "bias": torch.tensor(params["bias"]),
                        "running_mean": torch.tensor(stats["mean"]),
                        "running_var": torch.tensor(stats["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    got = pn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    new = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(pn.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-5)
    np.testing.assert_allclose(pn.running_var.numpy(), np.asarray(new["var"]), rtol=1e-5)
    # pinned: the biased variance, through E[x^2] - E[x]^2, momentum on the old value
    flat = x.reshape(-1, C).astype(np.float64)
    biased = (flat ** 2).mean(0) - flat.mean(0) ** 2
    np.testing.assert_allclose(pn.running_var.numpy(), 0.9 * stats["var"] + 0.1 * biased,
                               rtol=1e-5)
    assert int(pn.num_batches_tracked) == 1
    # eval mode reads the updated statistics and leaves them alone
    before = pn.running_var.clone()
    pn.eval()(torch.from_numpy(x))
    assert torch.equal(pn.running_var, before)


def test_pointnorm_variance_is_clipped_at_zero():
    """A constant channel at a large offset: E[x^2] - E[x]^2 rounds below
    zero in float32; the clip keeps rsqrt finite."""
    x = torch.full((64, 3), 4097.3)
    pn = PointNorm(3).train()
    y = pn(x)
    assert torch.isfinite(y).all() and (pn.running_var >= 0).all()


# ------------------------------------------------- shared model and batch setup
@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    levels = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 16),
                                   with_up=False, knn_method="exact")
    x_mask = np.zeros((B, L), dtype=bool)
    x_mask[1, 15:] = True
    x_mask[3, 20:] = True
    arrays = {
        "c_pc_xyz": xyz,
        "c_pc_contact": rng.uniform(size=(B, N, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(B, 1, TEXT)).astype(np.float32),
        "c_pc_erase": np.array([[0.0], [1.0], [0.0], [0.0]], dtype=np.float32),
        "x_mask": x_mask,
    }
    geo = {k: np.asarray(v) for k, v in geometry_to_arrays(levels, prefix="geo_sm").items()}
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond["levels_sm"] = levels
    tcond = {k: torch.tensor(v) for k, v in {**arrays, **geo}.items()}
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    jm = JaxCMDM(**ARCH, dropout=0.0)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.zeros((B,), jnp.int32), jcond)
    variables = jax.device_get({"params": init["params"], "batch_stats": init["batch_stats"]})
    ts = [np.array([10, 700, 0, 999]), np.array([5, 250, 640, 31]), np.array([900, 1, 77, 420])]
    noises = [rng.standard_normal((B, L, D)).astype(np.float32) for _ in ts]
    return dict(rng=rng, jm=jm, jcond=jcond, tcond=tcond, x=x, variables=variables,
                ts=ts, noises=noises)


def _torch_model(variables):
    tm = CMDM(**ARCH, dropout=0.0)
    tm.load_state_dict(cmdm_state_dict_from_jax(variables, num_layers=LAYERS, blocks=BLOCKS),
                       strict=True)
    return tm


def _to_tree(tensors):
    return cmdm_jax_tree_from_state_dict(tensors, num_layers=LAYERS, blocks=BLOCKS)


def test_convert_roundtrip(setup):
    """state_dict -> flax tree is the inverse of flax tree -> state_dict."""
    tm = _torch_model(setup["variables"])
    back = _to_tree(tm.state_dict())
    _assert_trees_close(back, setup["variables"], atol=0.0, what="roundtrip")


# ------------------------------------------------------ (b) encoder gradients
def test_scenemap_encoder_train_gradients_match_jax(setup):
    """SceneMap encoder in train mode (batch statistics): output, gradient
    of every parameter (1e-4 of the tensor's largest entry) and the updated
    running statistics (1e-5)."""
    jm, variables, jcond = setup["jm"], setup["variables"], setup["jcond"]
    w = setup["rng"].normal(size=(B, N // 64, PLANES[-1])).astype(np.float32)

    def loss_fn(params):
        enc, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jcond, train=True, method=JaxCMDM.encode_contact,
                            mutable=["batch_stats"])
        return jnp.sum(enc * jnp.asarray(w)), (enc, upd["batch_stats"])

    (_, (want_enc, want_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    tm = _torch_model(variables).train()
    from afford_motion_torch.models.conditioning import add_hierarchies
    enc = tm.encode_contact(add_hierarchies(tm, setup["tcond"]))
    (enc * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(want_enc), rtol=1e-4, atol=1e-4)
    got = _to_tree({k: p.grad for k, p in tm.named_parameters() if p.grad is not None})
    _assert_trees_close(got["params"]["contact_encoder"],
                        jax.device_get(grads)["contact_encoder"], rel_of_max=1e-4,
                        what="encoder grad")
    got_bs = _to_tree(dict(tm.named_buffers()))["batch_stats"]
    _assert_trees_close(got_bs, jax.device_get(want_bs), atol=1e-5, what="batch_stats")


# ------------------------------------------------------------ (c) diffusion terms
def _oracle_sqrt_ac(T):
    from afford_motion_torch.diffusion.schedule import get_named_beta_schedule
    ac = np.cumprod(1.0 - get_named_beta_schedule("cosine", T))
    return np.sqrt(ac), np.sqrt(1 - ac)


def test_q_sample_matches_jax_and_oracle():
    cfg = DictConfig({"steps": 50})
    jd, td = jax_diffusion(cfg), create_gaussian_diffusion(cfg)
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(4, 8, 6)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 10, 25, 49])
    got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)).numpy()
    want = np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a, b = _oracle_sqrt_ac(50)
    np.testing.assert_allclose(got, a[t, None, None] * x0 + b[t, None, None] * noise,
                               rtol=1e-4, atol=1e-5)
    for g, w in zip(td.q_mean_variance(torch.from_numpy(x0), torch.from_numpy(t)),
                    jd.q_mean_variance(jnp.asarray(x0), jnp.asarray(t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["mse", "mse-masked", "eps-masked", "learn-sigma",
                                  "learn-sigma-rescaled", "kl", "rescaled-kl"])
def test_training_losses_match_jax(case):
    """Every loss type on a fixed model output: the MSE terms 1e-5, the
    variational-bound terms 1e-4 (rel; at t = 0 they are logs of small
    differences of tanh-approximated CDFs, which amplify the last-bit
    differences of the two frameworks' tanh and exp). The masked MSE also
    against the oracle (mean of the squared error over valid frames x
    features)."""
    cfg = {"steps": 50}
    if case.startswith("eps"):
        cfg["predict_xstart"] = False
    if case.startswith("learn-sigma"):
        cfg["learn_sigma"] = True
    cfg["loss_type"] = {"learn-sigma-rescaled": "RESCALED_MSE", "kl": "KL",
                        "rescaled-kl": "RESCALED_KL"}.get(case, "MSE")
    cfg = DictConfig(cfg)
    jd, td = jax_diffusion(cfg), create_gaussian_diffusion(cfg)
    assert td.config.loss_type.value == jd.config.loss_type.value
    rng = np.random.default_rng(4)
    Bq, Lq, Dq = 3, 8, 4
    x0 = rng.uniform(-1, 1, size=(Bq, Lq, Dq)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 10, 49])
    x_mask = None
    if "masked" in case:
        x_mask = np.zeros((Bq, Lq), dtype=bool)
        x_mask[0, 4:] = True
        x_mask[1, 1:] = True
    width = 2 * Dq if case.startswith("learn-sigma") else Dq
    out = rng.uniform(-1, 1, size=(Bq, Lq, width)).astype(np.float32)
    want = jd.training_losses(lambda *_: jnp.asarray(out), jnp.asarray(x0), jnp.asarray(t),
                              jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                              x_mask=None if x_mask is None else jnp.asarray(x_mask))
    got = td.training_losses(lambda *_: torch.from_numpy(out), torch.from_numpy(x0),
                             torch.from_numpy(t), noise=torch.from_numpy(noise),
                             x_mask=None if x_mask is None else torch.from_numpy(x_mask))
    assert sorted(got) == sorted(want)
    for k in want:
        rtol = 1e-5 if k == "mse" else 1e-4
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=1e-5,
                                   err_msg=k)
    if case == "mse-masked":
        for b, n_valid in [(0, 4), (1, 1), (2, 8)]:
            oracle = ((x0[b, :n_valid] - out[b, :n_valid]) ** 2).sum() / (n_valid * Dq)
            np.testing.assert_allclose(float(got["mse"][b]), oracle, rtol=1e-4)


def test_training_losses_draw_noise_from_the_generator():
    td = create_gaussian_diffusion(DictConfig({"steps": 50}))
    x0, t = torch.zeros(2, 4, 3), torch.tensor([3, 40])
    losses = [td.training_losses(lambda x_t, ts: x_t, x0, t,
                                 generator=torch.Generator().manual_seed(s))["loss"]
              for s in (7, 7, 8)]
    assert torch.equal(losses[0], losses[1]) and not torch.equal(losses[0], losses[2])


# ------------------------------------------------------------- (d) the full step
def _jax_step(jm, jd, state, x, cond, t, noise):
    def loss_fn(params):
        captured = {}

        def model_fn(x_t, ts):
            out, upd = jm.apply({"params": params, "batch_stats": state.batch_stats}, x_t, ts,
                                cond, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
            captured["bs"] = upd.get("batch_stats", {})  # a CDM has no BatchNorm
            return out

        terms = jd.training_losses(model_fn, x, t, jax.random.PRNGKey(0),
                                   x_mask=cond.get("x_mask"), noise=noise)
        return terms["loss"].mean(), captured["bs"]

    (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    return state.apply_gradients(grads, new_batch_stats=bs), loss, grads


@pytest.mark.parametrize("weight_decay, lr_anneal_steps", [(0.0, 0), (0.01, 10)],
                         ids=["config-default", "decay+anneal"])
def test_train_steps_match_jax(setup, weight_decay, lr_anneal_steps):
    _compare_train_steps(setup, setup["variables"], setup["jcond"], setup["tcond"], setup["x"],
                         _torch_model(setup["variables"]), weight_decay, lr_anneal_steps)


def _without(tree, paths, prefix=()):
    """``tree`` without the leaves at ``paths`` (and the branches left empty)."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            sub = _without(v, paths, path)
            if sub:
                out[k] = sub
        elif path not in paths:
            out[k] = v
    return out


def _compare_train_steps(setup, variables, jcond, tcond, x, tm, weight_decay, lr_anneal_steps,
                         first_loss_rtol=1e-5, jm=None, to_tree=_to_tree, grad_rel_of_max=1e-3,
                         expect_noise=True):
    """Three optimizer steps from the same weights on the same batch with
    injected t and noise. Step 1: loss rtol 1e-5, every gradient within
    ``grad_rel_of_max`` (1e-3) of its tensor's largest entry, every parameter
    after the AdamW update within 1e-6 and every BatchNorm buffer within
    1e-5, grad_norm rtol 1e-4. Steps 2 and 3: loss
    1e-4 (the anneal makes their learning rates 0.9 and 0.8 of the first).
    ``jm`` (default ``setup["jm"]``) and ``to_tree`` (state_dict -> flax
    tree) name the model on each side. Frozen parameters (a CDM's scene
    model: no ``requires_grad`` once the optimizer is made) get no gradient
    in the port and an exactly zero one in JAX, and stay bit for bit as they
    were on both sides. ``expect_noise``: whether some trainable leaves have
    a true gradient of 0 (see ``_assert_trees_close``); a model without
    BatchNorms or attention has none."""
    jm = setup["jm"] if jm is None else jm
    lr = 1e-4  # the config's; Adam's first update is +-lr, so 1e-6 is 1% of it
    cfg = DictConfig({"steps": 1000})
    jd, td = jax_diffusion(cfg), create_gaussian_diffusion(cfg)
    jstate = JaxTrainState.create(
        params=variables["params"], batch_stats=variables.get("batch_stats", {}),
        tx=jax_make_optimizer(lr, weight_decay, lr_anneal_steps, params=variables["params"]))
    jstep = jax.jit(lambda s, t, n: _jax_step(jm, jd, s, jnp.asarray(x), jcond, t, n))
    state = TrainState.create(tm, lr=lr, weight_decay=weight_decay,
                              lr_anneal_steps=lr_anneal_steps)
    train_step = make_train_step(tm, td)
    names = {id(p): k for k, p in tm.named_parameters()}
    frozen = set(dict(_flat(to_tree({k: p.detach() for k, p in tm.named_parameters()
                                     if not p.requires_grad}).get("params", {}))))
    nb = x.shape[0]
    for i, (t, noise) in enumerate(zip(setup["ts"], setup["noises"])):
        t, noise = t[:nb], noise[:nb]
        jstate, jloss, jgrads = jstep(jstate, jnp.asarray(t), jnp.asarray(noise))
        m = train_step(state, torch.from_numpy(x), tcond, seed=i,
                       t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=first_loss_rtol if i == 0 else 1e-4)
        if i > 0:
            continue
        assert float(m["mse"]) == float(m["loss"]) and state.step == 1 and tm.training
        jgrads = jax.device_get(jgrads)
        all_grads = dict(_flat(jgrads))
        assert all(not np.any(all_grads[path]) for path in frozen)
        want_norm = np.sqrt(sum(float((g ** 2).sum()) for g in all_grads.values()))
        jgrads = _without(jgrads, frozen)
        got = to_tree({names[id(p)]: p.grad for p in tm.parameters() if p.requires_grad})["params"]
        _assert_trees_close(got, jgrads, rel_of_max=grad_rel_of_max, what="grad")
        np.testing.assert_allclose(float(m["grad_norm"]), want_norm, rtol=1e-4)
        assert all(p.grad.dtype == torch.float32 if p.requires_grad else p.grad is None
                   for p in tm.parameters())
        # Adam divides a gradient by its own magnitude, so the numerically
        # zero gradients (see _assert_trees_close) become updates of size lr
        # whose signs are rounding noise, on both sides: those leaves are held
        # to |update| <= lr. In the other leaves the first update is
        # lr * g / (|g| + 1e-8): entries with |g| >= 1e-6 are held to 1e-6 of
        # the JAX package's; below that the epsilon makes the update follow
        # g's absolute value at the 1e-8 level, beyond what the gradients
        # agree to, and the entry is held to 2 * lr (either sign)
        after = to_tree(tm.state_dict())
        zero = 1e-5 * max(np.abs(g).max() for _, g in _flat(jgrads))
        noise = {path for path, g in _flat(jgrads) if np.abs(g).max() < zero}
        before, jafter = dict(_flat(variables["params"])), dict(_flat(jax.device_get(jstate.params)))
        jg = dict(_flat(jgrads))
        assert (0 < len(noise) if expect_noise else not noise)
        assert len(noise) < (len(before) - len(frozen)) / 2
        for path, v in _flat(after["params"]):
            if path in frozen:
                assert np.array_equal(v, before[path]) and np.array_equal(jafter[path],
                                                                          before[path])
            elif path in noise:
                for side in (v, jafter[path]):
                    assert np.abs(side - before[path]).max() <= lr * (1 + weight_decay) * 1.001
            else:
                big = np.abs(jg[path]) >= 1e-6
                # entries behind a ReLU that is off for every row have an
                # exact 0 gradient: held to 2 * lr with the rest below
                dead = jg[path] == 0
                assert (big | dead).mean() > 0.5, "/".join(path)
                np.testing.assert_allclose(v[big], jafter[path][big], rtol=0, atol=1e-6,
                                           err_msg="/".join(path))
                assert np.abs(v - jafter[path]).max() <= 2 * lr * 1.001, "/".join(path)
        # the running statistics are O(1) float32 sums over up to 16k rows
        if "batch_stats" in variables:
            _assert_trees_close(after["batch_stats"], jax.device_get(jstate.batch_stats),
                                atol=1e-5, what="buffer after step")
    assert state.step == 3 == int(jstate.step)



# -------------------------------------------------------- (d') the banded step
NB = 512


@pytest.fixture
def banded_on(monkeypatch):
    """``banded.available()`` true for the JAX side on the CPU, and the
    port's containment check on; jit caches cleared around the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jax_banded, "available", lambda: True)
    monkeypatch.setenv("AM_BANDED_DEBUG", "1")
    for name in ("AM_BANDED_WINDOW", "AM_BANDED_ADAPTIVE"):
        monkeypatch.delenv(name, raising=False)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _count_calls(monkeypatch, module, names):
    calls = {name: 0 for name in names}
    for name in names:
        def counting(*args, _real=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, counting)
    return calls


def test_banded_train_steps_match_jax(setup, banded_on, monkeypatch):
    """The banded step at the size of ``test_train_steps_match_jax`` (batch
    4, 512-point sorted clouds, levels 512/128/32/8: a windowed self kNN with
    S = 384, a down kNN with per-cloud starts whose window is the whole
    parent, a full-window gather at 128, fallbacks below): same weights,
    batch, t and noise through both sides, three steps, to the same
    tolerances, the first loss to 1e-6 (rel). (Larger clouds at this narrow width are no test of the route:
    at 1024 to 2048 points the two frameworks' float32 gradients differ by
    0.2 to 1.5% of a tensor's largest entry whichever gather the port takes,
    while the port's two routes agree to 1e-6.)"""
    rng = np.random.default_rng(13)
    xyz = (rng.integers(-512, 512, size=(B, NB, 3)) / 256.0).astype(np.float32)
    xyz = np.stack([p[curve_order(p, "hilbert")] for p in xyz])
    levels = build_point_hierarchy(jnp.asarray(xyz), (1, 4, 4, 4), (8, 16, 16, 16),
                                   with_up=False, banded=True, knn_method="exact")
    assert levels[0].banded and levels[1].down_starts.shape == (B, NB // 512)  # per cloud and tile
    arrays = {k: np.asarray(v) for k, v in setup["jcond"].items() if k != "levels_sm"}
    arrays["c_pc_xyz"] = xyz
    arrays["c_pc_contact"] = rng.uniform(size=(B, NB, 6)).astype(np.float32)
    jcond = {k: jnp.asarray(v) for k, v in arrays.items()}
    jcond["levels_sm"] = levels
    # the port gets what the fps wire ships: the cloud and int16 FPS indices
    tcond = {k: torch.tensor(v) for k, v in arrays.items()}
    for li, lvl in enumerate(levels):
        if lvl.fps_idx is not None:
            tcond[f"geo_sm{li}_fps_idx"] = torch.tensor(np.asarray(lvl.fps_idx).astype(np.int16))
    tm = _torch_model(setup["variables"])
    tm.use_banded, tm.knn_exact = True, True
    calls = _count_calls(monkeypatch, torch_banded,
                         ["knn_banded_plain", "gather_banded_plain", "scatter_banded_plain"])
    _compare_train_steps(setup, setup["variables"], jcond, tcond, setup["x"], tm, 0.0, 0,
                         first_loss_rtol=1e-6)
    # per step: self kNN at 512, down kNN 128 over 512; gathers of two
    # levels' blocks and of the first TransitionDown, each with a backward
    assert calls == {"knn_banded_plain": 6, "gather_banded_plain": 9, "scatter_banded_plain": 9}


def test_annealed_lr_and_frozen_prefix():
    assert annealed_lr(1e-4, 7, 0) == 1e-4
    assert annealed_lr(1e-4, 0, 10) == 1e-4
    np.testing.assert_allclose(annealed_lr(1e-4, 3, 10), 0.7e-4)
    assert annealed_lr(1e-4, 12, 10) == 0.0

    class WithScene(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.scene_model = torch.nn.Linear(2, 2)
            self.head = torch.nn.Linear(2, 2)

    m = WithScene()
    state = TrainState.create(m, lr=1e-3)
    held = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert len(held) == 2 and all(p is q for p, q in zip(held, m.head.parameters()))
    assert not any(p.requires_grad for p in m.scene_model.parameters())
    assert state.optimizer.defaults["weight_decay"] == 0.0


# ------------------------------------------------------------------ (e) dropout
def test_dropout_mask_repeats_drops_p_and_is_off_in_eval():
    p, shape = 0.1, (64, 1000)
    drop = Dropout(p).train()
    x = torch.ones(shape)
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(5)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(5)
    b = drop(x)
    assert torch.equal(a, b)
    n = x.numel()
    dropped = int((a == 0).sum())
    assert abs(dropped - p * n) <= 3 * np.sqrt(n * p * (1 - p))
    np.testing.assert_allclose(a[a != 0].numpy(), 1 / (1 - p), rtol=1e-6)
    assert drop.eval()(x) is x
    assert Dropout(0.0).train()(x) is x


def test_model_dropout_follows_the_generator_and_mode(setup):
    tm = CMDM(**ARCH, dropout=0.1)
    tm.load_state_dict(_torch_model(setup["variables"]).state_dict())
    from afford_motion_torch.models.conditioning import add_hierarchies
    cond = add_hierarchies(tm, setup["tcond"])
    x, t = torch.from_numpy(setup["x"]), torch.from_numpy(setup["ts"][0])
    outs = []
    for seed in (1, 1, 2):
        set_dropout_generator(tm.train(), torch.Generator().manual_seed(seed))
        with torch.no_grad():
            enc = tm.eval().encode_contact(cond)
            outs.append(tm.train().denoise(x, t, cond, enc))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with torch.no_grad():
        e1, e2 = (tm.eval().denoise(x, t, cond, enc) for _ in range(2))
    assert torch.equal(e1, e2)
    assert sum(isinstance(m, Dropout) for m in tm.modules()) == 1 + 2 * sum(LAYERS)


def test_schedule_samplers():
    gen = lambda: torch.Generator().manual_seed(0)
    uni = create_schedule_sampler("uniform", 50)
    assert isinstance(uni, UniformSampler)
    t, w = uni.sample(gen(), 64, "cpu")
    assert t.min() >= 0 and t.max() < 50 and torch.equal(w, torch.ones(64))
    assert torch.equal(t, uni.sample(gen(), 64, "cpu")[0])
    lsm = create_schedule_sampler("loss-second-moment", 4)
    assert isinstance(lsm, LossSecondMomentResampler)
    state = lsm.init_state()
    np.testing.assert_allclose(lsm.weights(state).numpy(), 0.25)
    for _ in range(10):  # fill every timestep's history; t=3 has 3x the loss
        state = lsm.update(state, torch.arange(4), torch.tensor([1.0, 1.0, 1.0, 3.0]))
    w = lsm.weights(state).numpy()
    np.testing.assert_allclose(w, np.array([1, 1, 1, 3]) / 6 * 0.999 + 0.001 / 4, rtol=1e-6)
    t, iw = lsm.sample(gen(), 8, "cpu", state)
    np.testing.assert_allclose(iw.numpy(), 1 / (4 * w[t.numpy()]), rtol=1e-6)
    state = lsm.update(state, torch.tensor([0]), torch.tensor([5.0]))  # shifts left
    assert state["loss_history"][0].tolist() == [1.0] * 9 + [5.0]


# ------------------------------------------------------- (f), (g) entry and resume
def _entry_args(root, exp, *extra):
    return [
        "task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
        "model.data_repr=h3d", "diffusion.steps=1000", f"task.dataset.data_dir={root}/data",
        f"exp_dir={root}/{exp}", "task.dataset.num_points=256", "model.latent_dim=32",
        "model.time_emb_dim=32", "model.num_heads=4", "model.dim_feedforward=64",
        "model.num_layers=[1,1]", "model.contact_model.planes=[8,16,32,64]",
        "task.train.batch_size=2", "task.train.save_every_step=4", "task.train.log_every_step=2",
        "task.dataset.train_transforms=['RandomEraseLang','RandomEraseContact','NumpyToTensor']",
        "platform=jsonl", f"text_encoder.table_path={root}/none",
        f"text_encoder.weights_dir={root}/none", "device=cpu", *extra,
    ]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("h3d")
    make_synthetic_h3d(str(root / "data"), n_items=24, num_points=256, horizon_range=(40, 100))
    pred = root / "contacts" / "H3D" / "pred_contact"
    pred.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in (root / "data" / "H3D" / "test.txt").read_text().split():
        np.save(pred / f"{name}-0.npy", rng.uniform(size=(1, 256, 6)).astype(np.float32))
    return root


def _same_file_tensors(a, b):
    sa, sb = (torch.load(p, weights_only=True) for p in (a, b))

    def flat(obj, prefix=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from flat(v, f"{prefix}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                yield from flat(v, f"{prefix}/{i}")
        else:
            yield prefix, obj

    fa, fb = dict(flat(sa)), dict(flat(sb))
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        same = torch.equal(v, fb[k]) if isinstance(v, torch.Tensor) else v == fb[k]
        assert same, k


def test_entry_trains_and_resumes_bit_exact(tree, monkeypatch):
    """The train entry on a synthetic tree, on the CPU, in the config's
    bfloat16 with dropout 0.1: 8 steps straight, and 4 steps + a run resumed
    from ``model000004.pt`` to step 8, end in the same weights, BatchNorm
    buffers and optimizer moments bit for bit. The data stream, the timestep
    and noise draws and the dropout masks are functions of (seed, step)."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    straight = train_pkg.main(_entry_args(tree, "straight", "task.train.max_steps=8"))
    assert straight["step"] == 8 and [e["step"] for e in straight["logged"]] == [2, 4, 6, 8]
    assert all(np.isfinite(e["loss"]) for e in straight["logged"])
    first = train_pkg.main(_entry_args(tree, "resumed", "task.train.max_steps=4"))
    assert first["last_ckpt"].endswith("model000004.pt")
    resumed = train_pkg.main(_entry_args(
        tree, "resumed", "task.train.max_steps=8",
        f"task.train.resume_ckpt={tree}/resumed/ckpt/model000004.pt"))
    assert resumed["step"] == 8 and [e["step"] for e in resumed["logged"]] == [6, 8]
    for name in ("model000004.pt", "model000008.pt", "train_state000008.pt"):
        _same_file_tensors(tree / "straight" / "ckpt" / name, tree / "resumed" / "ckpt" / name)
    assert [e["loss"] for e in straight["logged"][2:]] == [e["loss"] for e in resumed["logged"]]
    for f in ("config.yaml", "log/runtime.log"):
        assert (tree / "straight" / f).exists()
    # the weights moved, and a different seed gives a different run
    a = torch.load(tree / "straight" / "ckpt" / "model000004.pt", weights_only=True)
    b = torch.load(tree / "straight" / "ckpt" / "model000008.pt", weights_only=True)
    assert not torch.equal(a["motion_layer.weight"], b["motion_layer.weight"])
    assert step_seed(2023, 4) != step_seed(2023, 5) != step_seed(2024, 5)


def test_trained_checkpoint_loads_in_the_test_entry(tree, monkeypatch):
    """``afford_motion_torch.train.main`` writes ``model000004.pt``, a bare
    state_dict, which ``afford_motion_torch.test.main`` loads strictly and
    samples from."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = _entry_args(tree, "handoff", "task.train.max_steps=4")
    train_pkg.main(args)
    sd = torch.load(tree / "handoff" / "ckpt" / "model000004.pt", weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in sd.values())
    out = test_entry.main(args + [
        f"task.test.contact_folder={tree}/contacts", "task.test.batch_size=2",
        "task.evaluator.eval_nbatch=1", "diffusion.timestep_respacing=ddim4",
        "task.test.sampler=ddim"])
    z = np.load(os.path.join(out, "samples.npz"))
    assert z["sample"].shape == (2, 196, 263) and np.isfinite(z["sample"]).all()


@pytest.fixture(scope="module")
def banded_tree(tmp_path_factory):
    """A curve-sorted, geometry-cached, packed tree of 512-point clouds
    (levels 512/128/32/8: a windowed self kNN, a full-window down kNN and
    the fallbacks), through the port's prepare stages on the CPU."""
    root = tmp_path_factory.mktemp("h3d_banded")
    make_synthetic_h3d(str(root / "data"), n_items=24, num_points=512, horizon_range=(40, 100))
    for stage in ("sort", "geometry", "pack"):
        port_prepare.main([stage, "--dataset", "H3D", "--out_dir", str(root / "data"),
                           "--device", "cpu"])
    pred = root / "contacts" / "H3D" / "pred_contact"
    pred.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in (root / "data" / "H3D" / "test.txt").read_text().split():
        np.save(pred / f"{name}-0.npy", rng.uniform(size=(1, 512, 6)).astype(np.float32))
    return root


def _banded_args(root, exp, *extra):
    return [a for a in _entry_args(root, exp, *extra) if not a.startswith("task.dataset.num_points")
            ] + ["task.dataset.num_points=512"]


def test_banded_entry_trains_resumes_and_hands_off(banded_tree, monkeypatch):
    """On a sorted, cached, packed tree the loop itself switches the banded
    kernels on (nothing in the arguments names them) and says so in its log;
    the flagship configuration's default device store holds the corpus and
    the hierarchy, cached at upload; 8 steps straight and 4 + 4 resumed end
    bit-equal; with ``task.train.device_store=off`` each step rebuilds the
    hierarchy from the fps wire; the test entry samples from the checkpoint
    with ``model.use_banded=true``, once from the cached FPS indices and once
    building the hierarchy (FPS + sort) in the chain."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.setenv("AM_BANDED_DEBUG", "1")
    calls = _count_calls(monkeypatch, torch_banded,
                         ["knn_banded_plain", "gather_banded_plain", "scatter_banded_plain"])
    from afford_motion_torch.ops.cuda import fps as fps_mod
    fps_calls = _count_calls(monkeypatch, fps_mod, ["fps_plain"])
    tree = banded_tree
    straight = train_pkg.main(_banded_args(tree, "straight", "task.train.max_steps=8"))
    assert straight["step"] == 8 and all(np.isfinite(e["loss"]) for e in straight["logged"])
    log = (tree / "straight" / "log" / "runtime.log").read_text()
    assert "banded windowed-neighborhood kernels enabled (hilbert-sorted packed data" in log
    assert "packed store: 24 items" in log
    assert "device store: staging" in log and "device store: caching hierarchy geometry" in log
    # at upload, for the one chunk of 24 scenes: kNN 512 self and 128 over
    # 512; per step: gathers of level 0's block, the first TransitionDown,
    # and level 1's block (S = n = 128); no FPS at all
    assert calls == {"knn_banded_plain": 2, "gather_banded_plain": 24,
                     "scatter_banded_plain": 24} and fps_calls == {"fps_plain": 0}
    # the host route rebuilds the hierarchy from the fps wire in every step
    for k in calls:
        calls[k] = 0
    train_pkg.main(_banded_args(tree, "host", "task.train.max_steps=2",
                                "task.train.device_store=off"))
    assert "device store" not in (tree / "host" / "log" / "runtime.log").read_text()
    assert calls == {"knn_banded_plain": 4, "gather_banded_plain": 6,
                     "scatter_banded_plain": 6} and fps_calls == {"fps_plain": 0}
    train_pkg.main(_banded_args(tree, "resumed", "task.train.max_steps=4"))
    resumed = train_pkg.main(_banded_args(
        tree, "resumed", "task.train.max_steps=8",
        f"task.train.resume_ckpt={tree}/resumed/ckpt/model000004.pt"))
    assert [e["step"] for e in resumed["logged"]] == [6, 8]
    for name in ("model000004.pt", "model000008.pt", "train_state000008.pt"):
        _same_file_tensors(tree / "straight" / "ckpt" / name, tree / "resumed" / "ckpt" / name)
    # a loop on the same tree with the switch off stays on the row gather
    for k in calls:
        calls[k] = 0
    train_pkg.main(_banded_args(tree, "off", "task.train.max_steps=2",
                                "task.dataset.use_banded=false"))
    assert not any(calls.values())
    assert "kernels enabled" not in (tree / "off" / "log" / "runtime.log").read_text()

    test_args = _banded_args(tree, "straight") + [
        f"task.test.contact_folder={tree}/contacts", "task.test.batch_size=2",
        "task.evaluator.eval_nbatch=1", "diffusion.timestep_respacing=ddim4",
        "task.test.sampler=ddim", "model.use_banded=true"]
    for extra, n_fps in (([], 0), (["task.dataset.use_geometry_cache=false"], 3)):
        for counts in (calls, fps_calls):
            for k in counts:
                counts[k] = 0
        out = test_entry.main(test_args + extra)
        z = np.load(os.path.join(out, "samples.npz"))
        assert z["sample"].shape == (2, 196, 263) and np.isfinite(z["sample"]).all()
        assert calls == {"knn_banded_plain": 2, "gather_banded_plain": 3,
                         "scatter_banded_plain": 0} and fps_calls == {"fps_plain": n_fps}


def test_entries_raise_without_the_card(tree, monkeypatch):
    """Without ``device=cpu`` both entries ask for ``cuda:<gpu>`` and raise
    where there is none, instead of running on the CPU."""
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _entry_args(tree, "nocard", "task.train.max_steps=1") if a != "device=cpu"]
    for entry in (train_pkg.main, test_entry.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pkg.main(args, device="cuda:0")

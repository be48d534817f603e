"""Parity of the PyTorch port's sampling slice with the JAX package's, on
the CPU at a small width: the diffusion schedule and ``p_mean_variance``
(1e-6), host-side condition preparation (equal arrays), the whole chain
(hierarchy, contact encoding, 8-step DDPM with an injected ``parity_noise``
stream and DDIM with eta=0), and the ``python -m afford_motion_torch.test``
entry.

Both chains use the exact kNN (``knn_exact``) so their hierarchies are
equal, and the same weights and inputs. Tolerance on x0: 1e-4 (abs and
rel), float32 sums in other orders compounding over eight steps.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.diffusion import create_gaussian_diffusion as jax_diffusion
from afford_motion_tpu.models import text as jax_text
from afford_motion_tpu.models.conditioning import add_hierarchies
from afford_motion_tpu.models.conditioning import host_prepare_cond as jax_host_prepare_cond
from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.train.sampling import make_sample_fn as jax_sample_fn
from afford_motion_tpu.train.sampling import parity_noise as jax_parity_noise
from afford_motion_tpu.utils.config import DictConfig
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.diffusion.gaussian import _SCHEDULE_FIELDS
from afford_motion_torch.models import text
from afford_motion_torch.models.conditioning import host_prepare_cond
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.train.sampling import make_sample_fn, parity_noise
from afford_motion_torch.utils.convert import cmdm_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
B, N, L, D, TEXT = 2, 1024, 20, 263, 32
ARCH = dict(motion_dim=D, latent_dim=64, time_emb_dim=64, text_feat_dim=TEXT,
            contact_dim=6, planes=(16, 32, 64, 128), blocks=(2, 2, 2, 2),
            num_layers=(1,), num_heads=4, dim_feedforward=128, knn_exact=True)


@pytest.mark.parametrize("respacing", ["", "ddim4", "4,2"])
def test_schedule_matches_jax(respacing):
    cfg = DictConfig({"steps": 8, "timestep_respacing": respacing})
    a, b = jax_diffusion(cfg), create_gaussian_diffusion(cfg)
    assert a.num_timesteps == b.num_timesteps
    np.testing.assert_array_equal(b.timestep_map.numpy(), np.asarray(a.timestep_map))
    for name in _SCHEDULE_FIELDS:
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)


@pytest.mark.parametrize("cfg", [
    {"predict_xstart": True, "sigma_small": True},
    {"predict_xstart": False, "sigma_small": False},
    {"predict_xstart": True, "learn_sigma": True},
])
def test_p_mean_variance_matches_jax(cfg):
    """Every mean/variance parametrization, on a fixed model output."""
    cfg = DictConfig({"steps": 8, "timestep_respacing": "ddim4", **cfg})
    a, b = jax_diffusion(cfg), create_gaussian_diffusion(cfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    width = 6 if cfg.get("learn_sigma", False) else 3
    out = rng.uniform(-1, 1, size=(2, 5, width)).astype(np.float32)
    t = np.array([3, 1])
    want = a.p_mean_variance(lambda *_: jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
    got = b.p_mean_variance(lambda *_: torch.from_numpy(out), torch.from_numpy(x),
                            torch.from_numpy(t))
    for key in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_host_prepare_cond_matches_jax(tmp_path):
    """Text providers (hash, table with hash fallback) and condition arrays."""
    np.savez(tmp_path / "table.npz", texts=np.array(["walk"]),
             embeddings=np.arange(8, dtype=np.float32)[None])
    rng = np.random.default_rng(2)
    batch = {"x": rng.normal(size=(3, 4, 5)).astype(np.float32),
             "x_mask": np.zeros((3, 4), dtype=bool),
             "c_pc_xyz": rng.normal(size=(3, 16, 3)).astype(np.float32),
             "c_text_mask": np.array([True, False, True]),
             "geo_sm1_fps_idx": np.zeros((3, 4), dtype=np.int32),
             "c_text": ["walk", "", "sit down"], "info_index": ["a", "b", "c"]}
    assert text.get_lang_feat_dim_type("bert-base") == jax_text.get_lang_feat_dim_type("bert-base")
    for kw in ({"table_path": str(tmp_path / "none")}, {"table_path": str(tmp_path / "table.npz")}):
        version = "ViT-B/32" if "none" in kw["table_path"] else "ViT-L/14"
        enc = text.create_text_encoder(version, **kw)
        jenc = jax_text.create_text_encoder(version, **kw)
        assert type(enc).__name__ == type(jenc).__name__
        (x, cond), (jx, jcond) = host_prepare_cond(batch, enc), jax_host_prepare_cond(batch, jenc)
        np.testing.assert_array_equal(x, jx)
        assert sorted(cond) == sorted(jcond)
        for k in cond:
            np.testing.assert_array_equal(cond[k], jcond[k], err_msg=k)


def test_parity_noise_is_the_jax_stream():
    for x, y in zip(parity_noise(3, 1, (2, 5, 7), 4), jax_parity_noise(3, 1, (2, 5, 7), 4)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def chain_setup():
    rng = np.random.default_rng(5)
    x_mask = np.zeros((B, L), dtype=bool)
    x_mask[0, 14:] = True
    np_cond = {
        "c_pc_xyz": rng.normal(size=(B, N, 3)).astype(np.float32),
        "c_pc_contact": rng.uniform(size=(B, N, 6)).astype(np.float32),
        "text_emb": rng.normal(size=(B, 1, TEXT)).astype(np.float32),
        "c_text_mask": np.array([[False], [True]]),
        "x_mask": x_mask,
    }
    jm = JaxCMDM(**ARCH)
    jcond = {k: jnp.asarray(v) for k, v in np_cond.items()}
    variables = jax.device_get(jax.jit(
        lambda c: jm.init(jax.random.PRNGKey(1), jnp.zeros((B, L, D)),
                          jnp.zeros((B,), jnp.int32), add_hierarchies(jm, c)))(jcond))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.5, size=v.shape).astype(np.float32),
        variables["batch_stats"])
    tm = CMDM(**ARCH)
    tm.load_state_dict(cmdm_state_dict_from_jax(variables, num_layers=(1,),
                                                blocks=(2, 2, 2, 2)), strict=True)
    tcond = {k: torch.from_numpy(v) for k, v in np_cond.items()}
    return jm, variables, jcond, tm.eval(), tcond


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_chain_matches_jax(chain_setup, sampler):
    jm, variables, jcond, tm, tcond = chain_setup
    cfg = DictConfig({"steps": 8})
    jd, td = jax_diffusion(cfg), create_gaussian_diffusion(cfg)
    init, seq = parity_noise(11, 0, (B, L, D), td.num_timesteps)
    jfn = jax_sample_fn(jm, jd, sampler=sampler)
    tfn = make_sample_fn(tm, td, sampler=sampler)
    if sampler == "ddpm":
        want = jfn(variables, (B, L, D), jcond, jax.random.PRNGKey(0),
                   jnp.asarray(init), jnp.asarray(seq))
        got = tfn((B, L, D), tcond, noise=torch.from_numpy(init),
                  noise_seq=torch.from_numpy(seq))
    else:
        want = jfn(variables, (B, L, D), jcond, jax.random.PRNGKey(0), jnp.asarray(init))
        got = tfn((B, L, D), tcond, noise=torch.from_numpy(init))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_entry_runs_without_jax(tmp_path):
    """``python -m afford_motion_torch.test`` on a tiny synthetic tree: the
    natsort-latest checkpoint is loaded strictly, the k-th pre-generated
    contact is sliced, samples.npz, timing.json and the evaluator's
    ``humanml/*.pkl`` files are written, and neither jax nor the JAX package
    is ever imported. Without ``device=cpu`` the entry
    asks for the card and raises here, where there is none."""
    script = textwrap.dedent(f"""
        import importlib, os, pkgutil, runpy, sys
        import numpy as np, torch
        import afford_motion_torch
        from afford_motion_torch.data.synthetic import make_synthetic_h3d
        from afford_motion_torch.utils.config import load_config
        from afford_motion_torch.utils.misc import compute_repr_dimension
        from afford_motion_torch.models.base import create_model
        from afford_motion_torch.train.checkpoint import save_ckpt
        root = {str(tmp_path)!r}
        data, contacts, exp = (os.path.join(root, d) for d in ("data", "contacts", "exp"))
        make_synthetic_h3d(data, n_items=8, num_points=512, horizon_range=(40, 100))
        pred = os.path.join(contacts, "H3D", "pred_contact")
        os.makedirs(pred)
        rng = np.random.default_rng(0)
        for name in open(os.path.join(data, "H3D", "test.txt")).read().split():
            np.save(os.path.join(pred, name + "-0.npy"),
                    rng.uniform(size=(2, 512, 6)).astype(np.float32))
        argv = ["task=text_to_motion_contact_motion_gen", "model=cmdm",
                "model.data_repr=h3d", "task.dataset.data_dir=" + data,
                "task.test.contact_folder=" + contacts, "exp_dir=" + exp,
                "task.test.batch_size=2", "task.evaluator.eval_nbatch=1",
                "task.evaluator.k_samples=2", "task.evaluator.num_k_samples=2",
                "diffusion.steps=4", "model.latent_dim=32", "model.time_emb_dim=32",
                "model.num_heads=4", "model.dim_feedforward=64", "model.num_layers=[1]",
                "model.contact_model.planes=[8,16,32,64]",
                "text_encoder.table_path=" + os.path.join(root, "none"),
                "text_encoder.weights_dir=" + os.path.join(root, "none")]
        cfg = load_config("configs", argv)
        cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
        torch.manual_seed(0)
        save_ckpt(create_model(cfg.model, torch.device("cpu")), os.path.join(exp, "ckpt"), 0)
        from afford_motion_torch import test as entry
        if not torch.cuda.is_available():
            try:
                entry.main(argv)
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("the entry ran without a card and without device=cpu")
        sys.argv = ["afford_motion_torch.test"] + argv + ["device=cpu"]
        runpy.run_module("afford_motion_torch.test", run_name="__main__")
        out, = [os.path.join(exp, "eval", d) for d in os.listdir(os.path.join(exp, "eval"))]
        z = np.load(os.path.join(out, "samples.npz"))
        assert z["sample"].shape == (2, 196, 263) and np.isfinite(z["sample"]).all()
        assert z["k_samples"].shape == (2, 2, 196, 263)
        assert os.path.exists(os.path.join(out, "timing.json"))
        assert len(os.listdir(os.path.join(out, "humanml"))) == 2
        assert os.path.exists(os.path.join(out, "metrics.txt"))
        for m in pkgutil.walk_packages(afford_motion_torch.__path__, "afford_motion_torch."):
            if not m.name.endswith("__main__"):
                importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("afford_motion_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "not ported yet" not in proc.stderr


def test_port_refuses_what_is_not_ported(tmp_path):
    """The configurations the port does not run yet are refused by name,
    not run some other way: a CDM's local CLIP directory that holds no
    ``config.json`` raises, naming the file. ``fused_qkv`` builds for
    ``trans_enc`` and ``trans_dec`` the model the default builds (every
    attention computes its projections fused either way): the same modules
    and, from one seed, the same state_dict.
    Every dataset of the MotionX family builds. The CMDM's ``trans_dec``
    builds, with its U-Net and its decoder layers, and so does every CDM
    backbone, with the frozen scene model and without. ``use_banded``, a packed dataset tree under the training
    wire format, ``data_repr: pos`` with ``ContactMotionDataset``, the two
    stage-2 evaluators with the in-process HumanML3D metrics and the two
    stage-1 ones are ported."""
    from afford_motion_torch.data import create_dataset
    from afford_motion_torch.eval import (
        Text2MotionInSceneEvaluator,
        Text2MotionInSceneHumanML3DEvaluator,
        create_evaluator,
    )
    from afford_motion_torch.data.synthetic import make_synthetic_h3d
    from afford_motion_torch.models.cmdm import build_cmdm
    from afford_motion_torch.utils.config import load_config

    base = ["task=text_to_motion_contact_motion_gen", "model=cmdm", "model.data_repr=h3d",
            f"task.dataset.data_dir={tmp_path}", "task.dataset.num_points=64"]

    def model_cfg(*extra):
        cfg = load_config(str(REPO / "configs"), base + list(extra))
        cfg.model.input_feats = 263
        return cfg.model

    assert isinstance(build_cmdm(model_cfg()), CMDM) and not build_cmdm(model_cfg()).use_banded
    banded = build_cmdm(model_cfg("model.use_banded=true", "model.banded_window=256",
                                  "model.banded_adaptive=false"))
    assert (banded.use_banded, banded.banded_window, banded.banded_adaptive) == (True, 256, False)
    dec = build_cmdm(model_cfg("model.arch=trans_dec"))
    assert dec.arch == "trans_dec" and dec.needs_up_interpolation
    assert len(dec.cross_attn_layers) == len(dec.self_attn_layers) - 1 == 4
    for arch in ("trans_enc", "trans_dec"):
        torch.manual_seed(0)
        default = build_cmdm(model_cfg(f"model.arch={arch}")).eval()
        torch.manual_seed(0)
        fused = build_cmdm(model_cfg("model.fused_qkv=true", f"model.arch={arch}")).eval()
        want, got = default.state_dict(), fused.state_dict()
        assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
        assert repr(fused) == repr(default)

    # stage 1: every CDM backbone, with the frozen scene model (the shipped
    # default) and without; an empty local text-encoder directory raises
    from afford_motion_torch.models.cdm import CDM, build_cdm
    from afford_motion_torch.models.text import create_text_encoder
    from afford_motion_torch.eval import ContactEvaluator

    def cdm_cfg(*extra):
        cfg = load_config(str(REPO / "configs"), ["task=contact_gen", "model=cdm", *extra])
        cfg.model.input_feats = 6
        return cfg

    for arch in ("Perceiver", "MLP", "PointTrans", "PointTransV2"):
        bare = build_cdm(cdm_cfg(f"model.arch={arch}",
                                 "model.scene_model.use_scene_model=False").model)
        assert isinstance(bare, CDM) and bare.scene_model is None
        scene = build_cdm(cdm_cfg(f"model.arch={arch}").model)
        assert scene.needs_seg_hierarchy and scene.scene_model.enc1[0].linear.in_features == 6
    (tmp_path / "clip").mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        create_text_encoder(cdm_cfg().model.text_model.version, weights_dir=str(tmp_path / "clip"))
    assert isinstance(create_evaluator(cdm_cfg().task, device="cpu"), ContactEvaluator)

    # the scene protocol's configuration: 66-d joint positions
    scene = load_config(str(REPO / "configs"), ["task=contact_motion_gen", "model=cmdm"])
    scene.model.input_feats = 66
    assert build_cmdm(scene.model).motion_adapter.in_features == 66
    assert isinstance(create_evaluator(scene.task, device="cpu"), Text2MotionInSceneEvaluator)
    for override in ("task.evaluator.eval_metrics=['apd','Rprecison']",
                     "task.evaluator.eval_metrics=['apd','fid']"):
        cfg = load_config(str(REPO / "configs"),
                          ["task=contact_motion_gen", "model=cmdm", override])
        assert isinstance(create_evaluator(cfg.task, device="cpu"), Text2MotionInSceneEvaluator)
    # the whole MotionX family is ported: its plain text-to-motion set
    # builds through the factory (tests/test_torch_sample.py holds the
    # example and custom sets against the JAX package's)
    from afford_motion_torch.data.synthetic import make_synthetic_motionx_set

    make_synthetic_motionx_set(str(tmp_path / "motionx"), "HUMANISE", n_items=8, num_points=64,
                               horizon_range=(30, 60))
    cfg = load_config(str(REPO / "configs"), [
        "task=contact_motion_gen", "model=cmdm", "task.dataset.name=MotionXDataset",
        "task.dataset.use_color=true", "task.dataset.sets=[HUMANISE]",
        f"task.dataset.data_dir={tmp_path / 'motionx'}"])
    motionx = create_dataset(cfg.task.dataset, "test")
    assert type(motionx).__name__ == "MotionXDataset" and motionx[0]["x"].shape == (196, 66)

    make_synthetic_h3d(str(tmp_path), n_items=8, num_points=64, horizon_range=(40, 60))
    cfg = load_config(str(REPO / "configs"), base)
    assert isinstance(create_evaluator(cfg.task, device="cpu"), Text2MotionInSceneHumanML3DEvaluator)
    assert len(create_dataset(cfg.task.dataset, "train")) > 0
    # a store that cannot be opened is passed over for the live path
    (tmp_path / "H3D" / "packed").mkdir()
    train = create_dataset(cfg.task.dataset, "train")
    assert train._packed is None and train[0]["c_pc_xyz"].shape == (64, 3)
    # the test split never reads the packed store
    cfg.task.test.contact_folder = str(tmp_path)
    assert len(create_dataset(cfg.task.dataset, "test", contact_folder=str(tmp_path))) > 0

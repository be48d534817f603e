"""The port's evaluators (``afford_motion_torch.eval.evaluate``) and its test
entry against the JAX package's, on the CPU at a small size.

1. ``Text2MotionInSceneEvaluator`` on the same numpy samples in both
   packages (synthetic SMPL-X, the same regressor file): the same
   ``metrics.txt`` keys and line format, the same pickle fields, and metrics
   within the limits below.
2. The whole slice: ``afford_motion_torch.test`` (``device=cpu``) against the
   root ``test.py`` from the same weights, on one synthetic HUMANISE tree with
   the ``parity_noise`` stream injected and the exact kNN: generated joints to
   the chain tolerance of ``tests/test_torch_sampling.py`` (1e-4), then the
   evaluator's outputs as in 1.
3. ``Text2MotionInSceneHumanML3DEvaluator``: equal pickles.

Limits on the metrics, with their reasons. The refinement is Adam: an entry
whose gradient is at rounding level moves by ``lr`` with a sign that is noise
(``tests/test_torch_fit.py``), so a few of a sequence's fitted parameters
differ by up to ``2 * lr * steps`` between two correct implementations, and
the body's vertices with them. ``apd`` does not pass through the fit: 1e-4
relative. ``non_collision`` is a share of points: 2e-3 (measured: 2e-5).
``contact`` is a share of frames, and equal here. ``dist``: 1e-3. Fitted
``params``: as in ``tests/test_torch_fit.py``.
"""
import importlib.util
import os
import pickle
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.eval import evaluate as jeval
from afford_motion_tpu.eval import joints_to_smplx as jfit
from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.models.conditioning import add_hierarchies
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import test as port_entry
from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
from afford_motion_torch.eval import evaluate as teval
from afford_motion_torch.utils.config import DictConfig
from afford_motion_torch.utils.convert import cmdm_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
LR, STEPS = 0.02, 3
LIMITS = {"apd": None, "non_collision": 2e-3, "contact": 1e-6, "dist": 1e-3}


@pytest.fixture(scope="module")
def regressor_npz(tmp_path_factory):
    reg = jfit.JointsToSMPLXRegressor()
    variables = reg.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8, 66)),
                         jnp.zeros((1, 8), bool), train=False)
    path = tmp_path_factory.mktemp("regressor") / "regressor.npz"
    jfit.save_regressor_npz(str(path), variables["params"])
    return str(path)


@pytest.fixture()
def synthetic_body(monkeypatch):
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", "64")
    monkeypatch.setenv("SMPLX_SYNTHETIC_FACES", "100")


class _Dataset:
    def denormalize(self, x, clip=False):
        return x * 0.5 + 0.1


class _Loader:
    dataset = _Dataset()


def _evaluator_cfg(weights, **extra):
    return {"evaluator": {
        "name": "Text2MotionInSceneEvaluator", "njoints": 22, "k_samples": 2,
        "num_k_samples": 2, "eval_nbatch": 1,
        "eval_metrics": ["apd", "non_collision", "contact", "dist"], "save_results": True,
        "opt_rate": LR, "opt_steps": STEPS, "fit_batch": 2,
        "joints_to_smplx_model_weights": weights, **extra}}


def _samples(n=3, L=10, N=128):
    rng = np.random.default_rng(0)
    samples, k_samples = [], []
    for i in range(n):
        x_mask = np.arange(L) >= (L - 2 * i)
        # the second scene lies off the body: no contact, a negative dist
        xyz = rng.normal(size=(N, 3)).astype(np.float32) * 0.4 + (3.0 if i == 1 else 0.0)
        case = {"x_mask": x_mask, "c_pc_xyz": xyz,
                "c_text": "stand up from the chair" if i == 1 else "sit on the chair",
                "info_set": "HUMANISE", "info_index": i,
                "info_obj_mask": rng.random(N) < 0.2 if i < 2 else None,
                "info_scene_trans": np.eye(4, dtype=np.float32), "info_scene_mesh": "x.ply"}
        samples.append({"sample": rng.normal(size=(L, 66)).astype(np.float32) * 0.3, **case})
        k_samples.append({"k_samples": rng.normal(size=(2, L, 66)).astype(np.float32), **case})
    return samples, k_samples


def _assert_outputs_agree(port_dir, jax_dir, n_cases):
    """metrics.txt / metrics.json / joints pickles of the two packages."""
    lines = {}
    for tag, d in (("port", port_dir), ("jax", jax_dir)):
        text = (Path(d) / "metrics.txt").read_text().splitlines()
        assert all(re.fullmatch(r"[a-z_]+: -?\d+\.\d{6}", line) for line in text), text
        lines[tag] = dict(line.split(": ") for line in text)
    assert list(lines["port"]) == list(lines["jax"]) == ["non_collision", "contact", "dist", "apd"]
    for key, limit in LIMITS.items():
        a, b = float(lines["port"][key]), float(lines["jax"][key])
        assert np.isfinite(a)
        assert abs(a - b) <= (1e-4 * abs(b) + 1e-6 if limit is None else limit), (key, a, b)
    assert 0.0 <= float(lines["port"]["non_collision"]) <= 1.0
    ja = __import__("json").loads((Path(port_dir) / "metrics.json").read_text())
    jb = __import__("json").loads((Path(jax_dir) / "metrics.json").read_text())
    assert list(ja) == list(jb) and ja["_name"] == jb["_name"] and ja["_length"] == jb["_length"]
    assert all(len(ja[k]) == len(jb[k]) for k in ja)
    names = sorted(os.listdir(Path(port_dir) / "joints"))
    assert names == sorted(os.listdir(Path(jax_dir) / "joints")) and len(names) == n_cases
    for name in names:
        a = pickle.loads((Path(port_dir) / "joints" / name).read_bytes())
        b = pickle.loads((Path(jax_dir) / "joints" / name).read_bytes())
        assert list(a) == list(b) == ["joints", "text", "set", "index", "scene_trans",
                                      "scene_mesh", "params"]
        assert a["text"] == b["text"] and a["set"] == b["set"] and a["index"] == b["index"]
        np.testing.assert_allclose(a["joints"], b["joints"], rtol=1e-4, atol=1e-4)
        assert a["params"].shape == b["params"].shape and a["params"].shape[1] == 69
        valid = slice(0, a["joints"].shape[0])
        diff = np.abs(a["params"][valid] - b["params"][valid])
        assert diff.max() <= 2 * LR * STEPS + 1e-6 and (diff > 1e-3).mean() <= 0.02


@pytest.mark.parametrize("sdf_kernel", ["auto", "xla"])
def test_scene_evaluator_matches_jax(tmp_path, regressor_npz, synthetic_body, sdf_kernel):
    samples, k_samples = _samples()
    tev = teval.create_evaluator(DictConfig(_evaluator_cfg(regressor_npz, sdf_kernel=sdf_kernel)),
                                 device="cpu")
    # on the CPU the JAX package's "auto" is its matmul-form path; the fused
    # kernel is asked for by name, in interpret mode
    jev = jeval.create_evaluator(JaxDictConfig(_evaluator_cfg(
        regressor_npz, sdf_kernel="pallas" if sdf_kernel == "auto" else "xla")))
    assert isinstance(tev, teval.Text2MotionInSceneEvaluator) and tev._fitter is not None
    assert (tev.k_samples, tev.num_k_samples, tev.eval_nbatch, tev.fit_batch) == (2, 2, 1, 2)
    for ev, d in ((tev, tmp_path / "port"), (jev, tmp_path / "jax")):
        ev.evaluate(samples, k_samples, str(d), _Loader())
        ev.report(str(d))
    _assert_outputs_agree(tmp_path / "port", tmp_path / "jax", 3)
    assert len(tev.metrics["dist"]) == 2 and len(tev.metrics["non_collision"]) == 3
    assert set(tev.timing) == {"fit_s", "physics_s", "apd_s"}


def test_scene_evaluator_without_the_fitter(tmp_path, synthetic_body, monkeypatch):
    """Missing weights: a warning, no physics metrics, joints saved raw, as
    the JAX package documents. Anything else the fitter raises comes out."""
    samples, k_samples = _samples(n=1)
    ev = teval.create_evaluator(DictConfig(_evaluator_cfg(str(tmp_path / "none.pt"))),
                                device="cpu")
    assert ev._fitter is None
    ev.evaluate(samples, k_samples, str(tmp_path), _Loader())
    ev.report(str(tmp_path))
    assert (tmp_path / "metrics.txt").read_text().startswith("apd: ")
    payload = pickle.loads((tmp_path / "joints" / "00000.pkl").read_bytes())
    assert "params" not in payload and payload["joints"].shape == (10, 66)
    torch.save({"input_layer.0.weight": torch.zeros(128, 66)}, tmp_path / "short.pt")
    with pytest.raises(KeyError, match="lack"):
        teval.create_evaluator(DictConfig(_evaluator_cfg(str(tmp_path / "short.pt"))),
                               device="cpu")


def test_evaluator_refusals(regressor_npz, synthetic_body):
    """The in-process HumanML3D metrics build (their values:
    ``tests/test_torch_eval_humanml.py``); the stage-1 evaluators are ported
    (``tests/test_torch_stage1.py``); an unknown name is refused."""
    for name in ("ContactEvaluator", "ContactHumanML3DEvaluator"):
        ev = teval.create_evaluator(DictConfig({"evaluator": {"name": name}}), device="cpu")
        assert type(ev).__name__ == name
    for metric in ("Rprecison", "fid"):
        ev = teval.create_evaluator(DictConfig(_evaluator_cfg(regressor_npz,
                                                              eval_metrics=["apd", metric])),
                                    device="cpu")
        assert isinstance(ev, teval.Text2MotionInSceneEvaluator) and metric in ev.eval_metrics
    with pytest.raises(KeyError):
        teval.create_evaluator(DictConfig({"evaluator": {"name": "NoSuchEvaluator"}}))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a CUDA device")
def test_evaluator_and_fitter_default_to_the_card(regressor_npz, synthetic_body):
    """No ``device``: the card, and an error without one, never the CPU."""
    from afford_motion_torch.eval.joints_to_smplx import JointsToSMPLXFitter

    with pytest.raises(RuntimeError, match="device=cpu"):
        teval.create_evaluator(DictConfig(_evaluator_cfg(regressor_npz)))
    with pytest.raises(RuntimeError, match="device=cpu"):
        JointsToSMPLXFitter(regressor_npz)


def test_h3d_evaluator_pickles_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    cfg = {"evaluator": {"name": "Text2MotionInSceneHumanML3DEvaluator", "njoints": 22,
                         "k_samples": 2, "num_k_samples": 2, "eval_nbatch": 1,
                         "eval_metrics": [], "save_results": True}}
    case = {"x_mask": np.arange(12) >= 9, "c_text": "a person walks",
            "info_tokens": ["a/DET", "person/NOUN"], "info_index": "000003",
            "info_caption_index": 1}
    samples = [{"sample": rng.normal(size=(12, 263)).astype(np.float32), **case}]
    k_samples = [{"k_samples": rng.normal(size=(2, 12, 263)).astype(np.float32),
                  **{**case, "info_index": "000004"}}]
    for pkg, cfg_cls, kw, d in ((teval, DictConfig, {"device": "cpu"}, tmp_path / "port"),
                                (jeval, JaxDictConfig, {}, tmp_path / "jax")):
        ev = pkg.create_evaluator(cfg_cls(cfg), **kw)
        ev.evaluate(samples, k_samples, str(d), _Loader())
        ev.report(str(d))
    assert sorted(os.listdir(tmp_path / "port" / "humanml")) == ["000003-1.pkl", "000004-1.pkl"]
    for name in ("000003-1.pkl", "000004-1.pkl"):
        a = pickle.loads((tmp_path / "port" / "humanml" / name).read_bytes())
        b = pickle.loads((tmp_path / "jax" / "humanml" / name).read_bytes())
        assert list(a) == list(b) == ["name", "text", "tokens", "motion", "m_len"]
        np.testing.assert_array_equal(a["motion"], b["motion"])
        assert {k: a[k] for k in a if k != "motion"} == {k: b[k] for k in b if k != "motion"}
    assert (tmp_path / "port" / "metrics.txt").read_text() == \
        (tmp_path / "jax" / "metrics.txt").read_text() == ""


def test_scene_slice_entry_matches_root_entry(tmp_path, regressor_npz, synthetic_body,
                                              monkeypatch):
    """entry -> samples -> evaluator -> metrics.txt, both packages."""
    import orbax.checkpoint as ocp

    monkeypatch.chdir(REPO)
    n_points, B = 1024, 2
    data, contacts = tmp_path / "data", tmp_path / "contacts"
    make_synthetic_motionx_set(str(data), "HUMANISE", n_items=12, num_points=n_points,
                               horizon_range=(30, 70))
    rng = np.random.default_rng(0)
    pred = contacts / "HUMANISE" / "pred_contact"
    pred.mkdir(parents=True)
    for i in range(12):
        np.save(pred / f"{i:05d}.npy", np.abs(rng.normal(size=(2, n_points, 6))).astype(np.float32))

    arch = dict(motion_dim=66, latent_dim=32, time_emb_dim=32, text_feat_dim=512, contact_dim=6,
                planes=(8, 16, 32, 64), blocks=(2, 2, 2, 2), num_layers=(1,), num_heads=4,
                dim_feedforward=64, knn_exact=True)
    jm = JaxCMDM(**arch)
    cond = {"c_pc_xyz": jnp.asarray(rng.normal(size=(B, n_points, 3)).astype(np.float32)),
            "c_pc_contact": jnp.zeros((B, n_points, 6)), "text_emb": jnp.zeros((B, 1, 512)),
            "x_mask": jnp.zeros((B, 196), bool)}
    variables = jax.device_get(jax.jit(
        lambda c: jm.init(jax.random.PRNGKey(1), jnp.zeros((B, 196, 66)),
                          jnp.zeros((B,), jnp.int32), add_hierarchies(jm, c)))(cond))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "jax_exp" / "ckpt" / "model000000"),
               {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    ckptr.wait_until_finished()
    (tmp_path / "port_exp" / "ckpt").mkdir(parents=True)
    torch.save(cmdm_state_dict_from_jax(variables, num_layers=(1,), blocks=(2, 2, 2, 2)),
               tmp_path / "port_exp" / "ckpt" / "model000000.pt")

    argv = ["task=contact_motion_gen", "model=cmdm", "diffusion.steps=4",
            "task.dataset.sets=[HUMANISE]", f"task.dataset.data_dir={data}",
            f"task.dataset.num_points={n_points}", f"task.test.contact_folder={contacts}",
            f"task.test.batch_size={B}", "task.test.noise_inject_seed=7",
            "task.evaluator.eval_nbatch=1", "task.evaluator.k_samples=2",
            f"task.evaluator.num_k_samples={B}", f"task.evaluator.opt_steps={STEPS}",
            f"task.evaluator.joints_to_smplx_model_weights={regressor_npz}",
            "model.latent_dim=32", "model.time_emb_dim=32", "model.num_heads=4",
            "model.dim_feedforward=64", "model.num_layers=[1]", "model.dtype=float32",
            "model.contact_model.planes=[8,16,32,64]", "model.knn_exact=true",
            f"text_encoder.table_path={tmp_path / 'none'}",
            f"text_encoder.weights_dir={tmp_path / 'none'}"]
    out = Path(port_entry.main(argv + [f"exp_dir={tmp_path / 'port_exp'}", "device=cpu"]))
    spec = importlib.util.spec_from_file_location("root_test_entry", REPO / "test.py")
    root_entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_entry)
    root_entry.main(argv + [f"exp_dir={tmp_path / 'jax_exp'}", "task.evaluator.sdf_kernel=pallas"])
    jax_out, = (tmp_path / "jax_exp" / "eval").iterdir()

    z = np.load(out / "samples.npz")
    assert z["sample"].shape == (B, 196, 66) and z["k_samples"].shape == (B, 2, 196, 66)
    assert np.isfinite(z["sample"]).all() and list(z["info_set"]) == ["HUMANISE"] * B
    timing = __import__("json").loads((out / "timing.json").read_text())
    assert timing["evaluator_s"] > 0 and set(timing["evaluator"]) == {"fit_s", "physics_s", "apd_s"}
    assert len(timing["chains"]) == 2 and timing["n_motions"] == 2 * B
    _assert_outputs_agree(out, jax_out, B)

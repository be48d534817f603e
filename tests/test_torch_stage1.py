"""Stage 1 of the port (the CDM's data, store, evaluators, chain and entries)
against the JAX package's, on the CPU at a small size.

- ``ContactMapDataset`` items, test and train phase (random rotation, the
  global streams seeded alike), equal to JAX's bit for bit;
- both contact evaluators over the same samples: the same ``.npy`` files bit
  for bit and the same ``metrics.txt`` / ``metrics.json`` byte for byte;
- the stage-1 H3D device store on ``tests/test_torch_device_store.py``'s
  packed tree: staged arrays and host draws equal to JAX's, the assembled
  ``c_pc_xyz`` and fps wire bit for bit, the target ``x`` within one f32 ulp
  of |contact| + |mean|, over ``std``, of JAX's and of the host wire's (the
  kernel is an f32 ``exp`` in each, and numpy's, XLA's and torch's may
  differ in the last bit; the reading is 0.875 and 1.0);
- a 10-step CDM chain with the shared ``parity_noise`` stream against the
  JAX sampler, float32, 1e-4 (abs and rel; the reading is ~1e-6);
- the root ``test.py`` against ``afford_motion_torch.test`` (``device=cpu``)
  from one set of weights, 10 DDPM steps, the ts2m and the t2m task: the
  handoff files' contacts to 1e-5 (their distances are ill-conditioned near
  a contact of 0), ``metrics.txt`` to 1e-5;
- the entries: 4 steps straight and 2 + 2 resumed equal bit for bit, on the
  host route and through the stage-1 store; then the t2m chain through files:
  the stage-1 test writes ``H3D/pred_contact`` for every test item, and the
  stage-2 test reads them (its ``c_pc_contact`` is the sigma kernel of the
  file).
"""
import importlib.util
import os
import random
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.diffusion import create_gaussian_diffusion as jax_diffusion
from afford_motion_tpu.eval import create_evaluator as jax_create_evaluator
from afford_motion_tpu.models.cdm import CDM as JaxCDM
from afford_motion_tpu.train import device_store as jds_mod
from afford_motion_tpu.train.sampling import make_sample_fn as jax_make_sample_fn
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_tpu.utils.config import load_config as jax_load_config
from afford_motion_torch import test as test_entry
from afford_motion_torch import train as train_pkg
from afford_motion_torch.data import create_dataset, gaussian_contact
from afford_motion_torch.data.loader import collate_fn_general
from afford_motion_torch.data.packed import pack_h3d
from afford_motion_torch.data.synthetic import make_synthetic_h3d, make_synthetic_motionx_set
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.eval import create_evaluator
from afford_motion_torch.models.cdm import CDM
from afford_motion_torch.models.conditioning import host_prepare_cond
from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
from afford_motion_torch.train.sampling import make_sample_fn, parity_noise
from afford_motion_torch.utils.config import DictConfig, load_config
from afford_motion_torch.utils.convert import cdm_state_dict_from_jax
from test_torch_device_store import _cfg, _gens, _HashText, tree  # noqa: F401  (a fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
N_POINTS = 64
JOINTS = [0, 10, 11, 12, 20, 21]


def _assert_items_equal(a, b):
    assert list(a) == list(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


@pytest.fixture
def scene_tree(tmp_path):
    """A synthetic HUMANISE + PROX tree of 12 items each."""
    data = tmp_path / "data"
    for k, name in enumerate(("HUMANISE", "PROX")):
        make_synthetic_motionx_set(str(data), name, n_items=12, num_points=N_POINTS,
                                   horizon_range=(20, 70), seed=k)
    return data


def _scene_args(data, *extra):
    return ["task=contact_gen", "model=cdm", f"task.dataset.data_dir={data}",
            "task.dataset.sets=[HUMANISE,PROX]", f"task.dataset.num_points={N_POINTS}",
            "task.dataset.sigma=0.8", *extra]


# ---------------------------------------------------------------- the dataset
@pytest.mark.parametrize("phase", ["test", "train"])
def test_contact_map_dataset_items_equal_jax(scene_tree, phase):
    """The same cases in the same order; every field of every item, with
    the captions, the rotation and the half-precision wire drawn from the
    global streams seeded alike."""
    argv = _scene_args(scene_tree)
    tcfg, jcfg = load_config("configs", argv), jax_load_config("configs", argv)
    random.seed(3), np.random.seed(3)
    tds = create_dataset(tcfg.task.dataset, phase)
    for stats in scene_tree.glob("Mean_Std_*.npz"):
        stats.unlink()   # so each package computes its own statistics
    random.seed(3), np.random.seed(3)
    jds = jax_create_dataset(jcfg.task.dataset, phase)
    np.testing.assert_array_equal(tds.mean, jds.mean)
    np.testing.assert_array_equal(tds.std, jds.std)
    assert len(tds) == len(jds) == (6 if phase == "test" else 18)
    assert tds.indices == jds.indices
    for i in range(len(tds)):
        random.seed(i), np.random.seed(i)
        a = tds[i]
        random.seed(i), np.random.seed(i)
        b = jds[i]
        _assert_items_equal(a, b)
        assert a["x"].shape == (N_POINTS, 6) and a["c_pc_feat"].shape == (N_POINTS, 3)
        if phase == "test":
            assert (a["info_obj_mask"] is None) == (a["info_set"] == "PROX")
        else:
            assert a["c_pc_xyz"].dtype == np.float16 and "info_obj_mask" not in a


# --------------------------------------------------------------- evaluators
@pytest.mark.parametrize("name", ["ContactEvaluator", "ContactHumanML3DEvaluator"])
def test_contact_evaluators_write_what_jax_writes(scene_tree, tmp_path, name):
    """The same samples (one per case, and k = 2 for the first two) through
    both packages' evaluator: identical ``pred_contact`` files, ``(1, N, 6)``
    for a sample and ``(2, N, 6)`` for k samples, and identical metrics."""
    argv = _scene_args(scene_tree, f"task.evaluator.name={name}", "task.evaluator.k_samples=2")
    ds = create_dataset(load_config("configs", argv).task.dataset, "test")
    rng = np.random.default_rng(4)
    samples, k_samples = [], []
    for i in range(len(ds)):
        case = {k: v for k, v in ds[i].items() if k != "x"}
        case["info_caption_index"] = i % 2
        samples.append({"sample": rng.normal(size=(N_POINTS, 6)).astype(np.float32), **case})
        if i < 2:
            k_samples.append({"k_samples": rng.normal(size=(2, N_POINTS, 6)).astype(np.float32),
                              **case})

    class Loader:
        dataset = ds

    out = {}
    for pkg, load, create, kw in (("port", load_config, create_evaluator, {"device": "cpu"}),
                                  ("jax", jax_load_config, jax_create_evaluator, {})):
        ev = create(load("configs", argv).task, **kw)
        out[pkg] = tmp_path / pkg
        ev.evaluate(samples, k_samples, str(out[pkg]), Loader())
        ev.report(str(out[pkg]))
    files = sorted(p.relative_to(out["port"]) for p in out["port"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(out["jax"]) for p in out["jax"].rglob("*")
                           if p.is_file())
    npy = [f for f in files if f.suffix == ".npy"]
    assert len(npy) == len(samples)   # the k-sample files replace their cases' files
    for f in files:
        assert (out["port"] / f).read_bytes() == (out["jax"] / f).read_bytes(), f
    shapes = {np.load(out["port"] / f).shape for f in npy}
    assert shapes == {(1, N_POINTS, 6), (2, N_POINTS, 6)}
    metrics = (out["port"] / "metrics.txt").read_text()
    if name == "ContactEvaluator":
        assert [line.split(":")[0] for line in metrics.splitlines()] == [
            "dist_to_target_0.1", "dist_to_target_0.3", "dist_to_target_0.5",
            "dist_to_target_average", "dist_to_target_pelvis_average",
            "dist_to_target_min_average"]
    else:
        assert metrics == "" and all(str(f).startswith("H3D/pred_contact/") for f in npy)


# ------------------------------------------------------------ the H3D store
def _stage1_datasets(tree):  # noqa: F811
    out = []
    for factory, cls in ((jax_create_dataset, JaxDictConfig), (create_dataset, DictConfig)):
        random.seed(3), np.random.seed(3)
        out.append(factory(_cfg(tree, cls, name="ContactHumanML3DDataset",
                                data_repr="contact_cont_joints", data_repr_joints=JOINTS,
                                train_transforms=["NumpyToTensor"]), "train"))
    return out


def _f32_ulps(got, want, scale):
    """Largest |got - want| in f32 ulps of ``scale``."""
    return float((np.abs(got - want) / np.spacing(np.abs(scale).astype(np.float32))).max())


def test_stage1_store_matches_jax_and_the_host_wire(tree):  # noqa: F811
    jds, tds = _stage1_datasets(tree)
    jstore, tstore = jds_mod.DeviceStore.try_build(jds), DeviceStore.try_build(tds)
    assert jstore is not None and tstore is not None and tstore.meta["kind"] == "h3d_contact"
    assert sorted(tstore.arrays) == sorted(jstore.arrays)
    assert tstore.arrays["dist32"].dtype == np.float32
    for k, v in jstore.arrays.items():
        np.testing.assert_array_equal(np.asarray(tstore.arrays[k]), np.asarray(v), err_msg=k)
    for k in ("kind", "n_items", "sigma", "use_raw_dist"):
        assert tstore.meta[k] == jstore.meta[k], k
    for k in ("mean", "std"):
        np.testing.assert_array_equal(tstore.meta[k], jstore.meta[k])
    # the model builds no hierarchy: nothing is cached
    assert not tstore.add_geometry_cache(CDM(6, 16, 16, arch_cfg=dict(
        encoder_q_input_channels=16, encoder_kv_input_channels=8, decoder_q_input_channels=8,
        decoder_kv_input_channels=16, encoder_num_heads=2, decoder_num_heads=2)), "cpu")

    ids = list(range(len(tds)))
    seed = 31
    want_meta = jstore.draw_batch(jds, ids, *_gens(seed))
    got_meta = tstore.draw_batch(tds, ids, *_gens(seed))
    assert sorted(got_meta) == ["c_text", "item_row"] and got_meta["c_text"] == want_meta["c_text"]
    np.testing.assert_array_equal(got_meta["item_row"], want_meta["item_row"])
    assert len(set(got_meta["c_text"])) > 1

    def assembled(store, make, meta, to_backend):
        meta = dict(meta)
        meta["text_emb"] = _HashText().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
        return make(store)({k: to_backend(v) for k, v in meta.items()})

    jx, jc = assembled(jstore, jds_mod.make_assemble_fn, want_meta, jnp.asarray)
    tx, tc = assembled(tstore, lambda s: make_assemble_fn(s, "cpu"), got_meta, torch.from_numpy)
    random.seed(seed)   # the host wire's captions from the global stream
    hx, hc = host_prepare_cond(collate_fn_general([tds[i] for i in ids]), _HashText())
    assert tx.dtype == torch.float32 and tx.shape == (len(ids), 128, 6)
    # the target: one f32 ulp of the kernel's value, carried through (c - mean) / std
    mean, std = tstore.meta["mean"], tstore.meta["std"]
    contact = tx.numpy() * std + mean
    for want in (np.asarray(jx), hx):
        assert _f32_ulps(tx.numpy(), want, (np.abs(contact) + np.abs(mean)) / std) <= 1.0
    assert sorted(tc) == sorted(k for k in hc if k != "text_emb") + ["text_emb"]
    for k in tc:
        if k != "text_emb":
            np.testing.assert_array_equal(tc[k].numpy(), hc[k].astype(tc[k].numpy().dtype),
                                          err_msg=k)
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    assert any(k.endswith("_fps_idx") for k in tc)


# ------------------------------------------------------------- the chain
def test_cdm_chain_matches_jax_sampler():
    """10 DDPM steps of a Perceiver CDM from the same x_T and noise stream."""
    B, N, T = 2, 256, 10
    kw = dict(encoder_q_input_channels=32, encoder_kv_input_channels=16,
              decoder_q_input_channels=16, decoder_kv_input_channels=32, encoder_num_heads=2,
              decoder_num_heads=2, encoder_self_attn_num_layers=1)
    rng = np.random.default_rng(6)
    cond = {"c_pc_xyz": rng.normal(size=(B, N, 3)).astype(np.float32),
            "text_emb": rng.normal(size=(B, 1, 32)).astype(np.float32)}
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    jm = JaxCDM(contact_dim=6, time_emb_dim=16, text_feat_dim=32, point_feat_dim=0,
                use_scene_model=False, arch="Perceiver", arch_cfg=tuple(kw.items()))
    var = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((B, N, 6)),
                                          jnp.zeros((B,), jnp.int32), jc))
    init_n, seq_n = parity_noise(11, 0, (B, N, 6), T)
    dcfg = JaxDictConfig({"steps": T})
    want = np.asarray(jax.jit(lambda v: jax_make_sample_fn(jm, jax_diffusion(dcfg))(
        v, (B, N, 6), jc, jax.random.PRNGKey(0), jnp.asarray(init_n), jnp.asarray(seq_n)))(var))
    tm = CDM(6, 16, 32, arch_cfg=kw)
    tm.load_state_dict(cdm_state_dict_from_jax(var, self_attn_layers=1), strict=True)
    got = make_sample_fn(tm.eval(), create_gaussian_diffusion(DictConfig({"steps": T})))(
        (B, N, 6), {k: torch.from_numpy(v) for k, v in cond.items()}, None,
        torch.from_numpy(init_n), torch.from_numpy(seq_n))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


SMALL = ["model.arch_perceiver.encoder_q_input_channels=32",
         "model.arch_perceiver.encoder_kv_input_channels=16",
         "model.arch_perceiver.decoder_q_input_channels=16",
         "model.arch_perceiver.decoder_kv_input_channels=32",
         "model.arch_perceiver.encoder_num_heads=2", "model.arch_perceiver.decoder_num_heads=2",
         "model.arch_perceiver.encoder_self_attn_num_layers=1", "model.time_emb_dim=16"]


def _load_root_test():
    spec = importlib.util.spec_from_file_location("root_test_entry", REPO / "test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("task", ["ts2m", "t2m"])
def test_root_test_entry_matches_port_entry(task, tmp_path, monkeypatch, request):
    """``scripts/{ts2m,t2m}_contact/test.sh`` at 10 DDPM steps on the CPU,
    with the injected noise stream: both entries from one set of float32
    weights write the same handoff files (1e-4) and the same metrics."""
    import orbax.checkpoint as ocp

    monkeypatch.chdir(REPO)
    if task == "ts2m":
        n, data = N_POINTS, _scene_args(request.getfixturevalue("scene_tree"))
    else:
        root = request.getfixturevalue("h3d")
        n, data = 128, ["task=text_to_motion_contact_gen", "model=cdm",
                        f"task.dataset.data_dir={root}/data", "task.dataset.num_points=128"]
    argv = data + ["model.arch=Perceiver", "model.scene_model.use_scene_model=False",
                   "model.dtype=float32", "diffusion.steps=10", "task.test.batch_size=2",
                   "task.test.noise_inject_seed=7", "task.evaluator.eval_nbatch=100",
                   "task.evaluator.k_samples=2", "task.evaluator.num_k_samples=2",
                   f"text_encoder.table_path={tmp_path / 'none'}",
                   f"text_encoder.weights_dir={tmp_path / 'none'}", *SMALL]
    kw = {k.split(".")[-1].split("=")[0]: int(k.split("=")[1]) for k in SMALL[:-1]}
    jm = JaxCDM(contact_dim=6, time_emb_dim=16, text_feat_dim=512, point_feat_dim=0,
                use_scene_model=False, arch="Perceiver", arch_cfg=tuple(kw.items()))
    cond = {"c_pc_xyz": jnp.zeros((2, n, 3)), "text_emb": jnp.zeros((2, 1, 512))}
    var = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(9), jnp.zeros((2, n, 6)),
                                          jnp.zeros((2,), jnp.int32), cond))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "jax_exp" / "ckpt" / "model000000"), {"params": var["params"]})
    ckptr.wait_until_finished()
    (tmp_path / "port_exp" / "ckpt").mkdir(parents=True)
    torch.save(cdm_state_dict_from_jax(var, self_attn_layers=1),
               tmp_path / "port_exp" / "ckpt" / "model000000.pt")

    out = Path(test_entry.main(argv + [f"exp_dir={tmp_path / 'port_exp'}", "device=cpu"]))
    _load_root_test().main(argv + [f"exp_dir={tmp_path / 'jax_exp'}"])
    jax_out, = (tmp_path / "jax_exp" / "eval").iterdir()
    files = sorted(p.relative_to(out) for p in out.rglob("*.npy"))
    assert files == sorted(p.relative_to(jax_out) for p in jax_out.rglob("*.npy"))
    assert len(files) == 6 and {f.parts[0] for f in files} == (
        {"HUMANISE", "PROX"} if task == "ts2m" else {"H3D"})
    # a file holds distances sqrt(-2 sigma^2 ln c) of the denormalized
    # contact c, whose slope -sigma^2 / (c d) is ~1e4 where c ~ 1e-5: so the
    # files are compared as the contacts they encode, to 1e-5 (readings up to
    # 7.8e-7; 1.2e-7 in c gave 1.6e-3 in distance)
    sigma = 0.8 if task == "ts2m" else 0.5

    def contact(d):
        return np.exp(-0.5 * d.astype(np.float64) ** 2 / sigma ** 2)

    for f in files:
        got, want = np.load(out / f), np.load(jax_out / f)
        assert got.shape == want.shape and got.shape[1:] == (n, 6), f
        np.testing.assert_allclose(contact(got), contact(want), rtol=0, atol=1e-5,
                                   err_msg=str(f))
    got, want = ((d / "metrics.txt").read_text().splitlines() for d in (out, jax_out))
    assert [line.split(":")[0] for line in got] == [line.split(":")[0] for line in want]
    assert bool(got) == (task == "ts2m")
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a.split(": ")[1]), float(b.split(": ")[1]), atol=1e-5)
    z = np.load(out / "samples.npz")
    assert z["sample"].shape == (6, n, 6) and z["k_samples"].shape == (2, 2, n, 6)


# --------------------------------------------------------------- the entries
@pytest.fixture(scope="module")
def h3d(tmp_path_factory):
    """A synthetic HumanML3D tree of 24 items of 128 points, and a packed
    copy of it (``pack`` alone: stage 1 reads no geometry)."""
    root = tmp_path_factory.mktemp("stage1")
    make_synthetic_h3d(str(root / "data"), n_items=24, num_points=128, horizon_range=(40, 100))
    shutil.copytree(root / "data", root / "packed")
    pack_h3d(str(root / "packed"))
    return root


def _stage1_args(root, data, exp, *extra):
    return ["task=text_to_motion_contact_gen", "model=cdm", "model.arch=Perceiver",
            "model.scene_model.use_scene_model=False", "diffusion.steps=10",
            "task.dataset.sigma=0.8", "model.text_model.max_length=20",
            f"task.dataset.data_dir={root}/{data}", "task.dataset.num_points=128",
            f"exp_dir={root}/{exp}", "task.train.batch_size=4", "task.train.save_every_step=2",
            "task.train.steps_per_dispatch=2",
            "task.train.log_every_step=1", "platform=jsonl", f"text_encoder.table_path={root}/none",
            f"text_encoder.weights_dir={root}/none", "device=cpu", *SMALL, *extra]


@pytest.mark.parametrize("data", ["data", "packed"], ids=["host", "store"])
def test_stage1_entry_trains_and_resumes_bit_exact(h3d, data, monkeypatch):
    """The published t2m configuration (bf16, dropout 0.1) at a small width:
    4 steps straight and 2 + 2 resumed end in the same weights and optimizer
    state bit for bit, on the host route and through the stage-1 store."""
    from test_torch_train import _same_file_tensors

    monkeypatch.chdir(REPO)
    straight = train_pkg.main(_stage1_args(h3d, data, f"{data}_straight",
                                           "task.train.max_steps=4"))
    assert [e["step"] for e in straight["logged"]] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) for e in straight["logged"])
    log = (h3d / f"{data}_straight" / "log" / "runtime.log").read_text()
    assert ("device store: staging" in log) == (data == "packed")
    train_pkg.main(_stage1_args(h3d, data, f"{data}_resumed", "task.train.max_steps=2"))
    resumed = train_pkg.main(_stage1_args(
        h3d, data, f"{data}_resumed", "task.train.max_steps=4",
        f"task.train.resume_ckpt={h3d}/{data}_resumed/ckpt/model000002.pt"))
    assert [e["step"] for e in resumed["logged"]] == [3, 4]
    for name in ("model000004.pt", "train_state000004.pt"):
        _same_file_tensors(h3d / f"{data}_straight" / "ckpt" / name,
                           h3d / f"{data}_resumed" / "ckpt" / name)


def test_t2m_chain_through_pred_contact_files(h3d, monkeypatch):
    """Stage 1's test writes ``H3D/pred_contact/{id}-0.npy`` for every test
    item (batch 2, eval_nbatch over the split); stage 2's test, pointed at
    that directory with ``task.test.contact_folder``, reads them: its
    dataset's ``c_pc_contact`` is the sigma kernel of the file."""
    monkeypatch.chdir(REPO)
    s1 = _stage1_args(h3d, "data", "chain_s1", "task.train.max_steps=2")
    train_pkg.main(s1)
    stage1_test = [a for a in s1 if not a.startswith("task.dataset.sigma")]  # test.sh's
    out = Path(test_entry.main(stage1_test + ["task.test.batch_size=2",
                                              "task.evaluator.eval_nbatch=100"]))
    names = (h3d / "data" / "H3D" / "test.txt").read_text().split()
    files = sorted((out / "H3D" / "pred_contact").glob("*.npy"))
    assert [f.name for f in files] == sorted(f"{n}-0.npy" for n in names)
    for f in files:
        d = np.load(f)
        assert d.shape == (1, 128, 6) and d.dtype == np.float32 and np.isfinite(d).all()
        assert (d >= 0).all()

    s2 = ["task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
          "model.data_repr=h3d", "diffusion.steps=10", "task.dataset.sigma=0.8",
          f"task.dataset.data_dir={h3d}/data", "task.dataset.num_points=128",
          f"exp_dir={h3d}/chain_s2", f"task.test.contact_folder={out}",
          "model.latent_dim=32", "model.time_emb_dim=32", "model.num_heads=4",
          "model.dim_feedforward=64", "model.num_layers=[1,1]",
          "model.contact_model.planes=[8,16,32,64]", "task.train.batch_size=2",
          "task.train.max_steps=1", "task.test.batch_size=2", "task.evaluator.eval_nbatch=1",
          "platform=jsonl", f"text_encoder.table_path={h3d}/none",
          f"text_encoder.weights_dir={h3d}/none", "device=cpu"]
    train_pkg.main(s2)
    cfg = load_config("configs", s2)
    ds = create_dataset(cfg.task.dataset, "test", contact_folder=str(out))
    for i in range(2):
        item = ds[i]
        want = gaussian_contact(np.load(out / "H3D" / "pred_contact" /
                                        f"{item['info_index']}-0.npy"), 0.8)
        np.testing.assert_array_equal(item["c_pc_contact"], want.astype(np.float32))
    z = np.load(Path(test_entry.main(s2)) / "samples.npz")
    assert z["sample"].shape == (2, 196, 263) and np.isfinite(z["sample"]).all()

"""``sample.py``'s half of the port against the JAX package's, on the CPU:
the example and custom datasets of the MotionX family, the visualizers and
the mesh toolkit, and ``python -m afford_motion_torch.sample`` end to end.

- every example and custom dataset (and ``MotionXDataset``, train and test
  phase) over one synthetic HUMANISE + PROX + ``custom/`` tree and the same
  prompt files: the same items in the same order, every field equal (arrays
  bit for bit), the global ``random`` / ``np.random`` streams seeded alike;
- every visualizer fed the same arrays writes the same files, byte for
  byte (``contact.npy``, the contact PLYs with their colours, the skeleton
  frame PLYs with the scene mesh), and ``colormap_values`` (the port's own
  viridis table) equals the JAX package's matplotlib call byte for byte,
  clipping, both ends and NaN included;
- the two-stage demo chain through the port's entry at a tiny width
  (``device=cpu``, 10 diffusion steps): stage 1 (CDM-Perceiver, DDPM) writes
  one ``contact.npy`` of (N, 3 + 6) finite f32 a case, the same bytes again
  from the same seed; stage 2 (CMDM ``trans_enc``, DDIM) reads them through
  ``task.sample.contact_folder`` and writes one skeleton PLY a frame of each
  case. The JAX ``sample.py`` is not run here (its sampler's compile is why
  ``tests/test_sample_entry.py`` is marked slow); the sampler's numerics are
  held by ``tests/test_torch_sampling.py``.
"""
import json
import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.eval import visualize as jvis
from afford_motion_tpu.utils import mesh as jmesh
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import sample as sample_entry
from afford_motion_torch.data import create_dataset
from afford_motion_torch.data.synthetic import make_synthetic_custom, make_synthetic_motionx_set
from afford_motion_torch.eval import visualize as tvis
from afford_motion_torch.models.base import create_model
from afford_motion_torch.train.checkpoint import save_ckpt
from afford_motion_torch.utils import mesh as tmesh
from afford_motion_torch.utils.config import DictConfig, load_config

N_POINTS, JOINTS = 256, [0, 10, 11, 12, 20, 21]
SETS = ["HUMANISE", "PROX"]
CONTACT_LINES = ("walk to the chair#HUMANISE#6\nsit down#PROX#7\nlie on the bed#HUMANISE#2\n"
                 "stand up#PROX#0\n")
MOTION_LINES = ("walk to the chair#HUMANISE#6#28\nsit down#PROX#7#40\n"
                "lie on the bed#HUMANISE#2#33\nstand up#PROX#0#25\n")
FRAMES = (28, 40, 33, 25)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The data tree, the prompt files, a stage-1 sample folder
    (``*-*/contact.npy``) and a custom handoff folder."""
    root = tmp_path_factory.mktemp("sample")
    data = root / "data"
    for k, s in enumerate(SETS):
        make_synthetic_motionx_set(str(data), s, n_items=10, num_points=N_POINTS,
                                   horizon_range=(20, 60), seed=k)
    make_synthetic_custom(str(data), n_items=3, num_points=N_POINTS)
    ex = data / "examples"
    ex.mkdir()
    (ex / "contact_examples.txt").write_text(CONTACT_LINES)
    (ex / "contact_motion_examples.txt").write_text(MOTION_LINES)
    (ex / "motionx_examples.txt").write_text("walk to the door#HUMANISE#3#30\n#PROX#4#\n")
    rng = np.random.default_rng(3)
    stage1 = root / "stage1"
    for i, line in enumerate(CONTACT_LINES.splitlines()):
        case = stage1 / f"{i:03d}-{line.split('#')[0]}"
        case.mkdir(parents=True)
        xyz = rng.normal(size=(N_POINTS, 3))
        dist = np.abs(rng.normal(size=(N_POINTS, 6)))
        np.save(case / "contact.npy", np.concatenate([xyz, dist], -1).astype(np.float32))
    pred = root / "handoff" / "custom" / "pred_contact"
    pred.mkdir(parents=True)
    for i in range(3):
        np.save(pred / f"{i:05d}.npy", np.abs(rng.normal(size=(2, N_POINTS, 6))).astype(np.float32))
    # the statistics the custom sets read, from the train sets' configs
    for name in ("MotionXDataset", "ContactMapDataset", "ContactMotionDataset"):
        create_dataset(_cfg(data, DictConfig, name), "train")
    return {"data": data, "ex": ex, "stage1": stage1, "handoff": root / "handoff"}


def _cfg(data, cls, name):
    stage1 = name.startswith("ContactMap")
    cfg = {
        "name": name, "data_dir": str(data), "shuffle_seed": 2023, "sets": SETS,
        "sets_config": {s: {"ratio": 1.0} for s in SETS}, "num_points": N_POINTS,
        "use_raw_dist": False, "sigma": 0.5, "use_color": True,
        "train_transforms": ["RandomRotation", "ApplyTransformCMDM", "NumpyToTensor"],
        "test_transforms": ["NumpyToTensor"], "transform_cfg": {"gravity_dim": 2},
    }
    if stage1:
        cfg.update(data_repr="contact_cont_joints", data_repr_joints=JOINTS,
                   use_openscene=False, point_feat_dim=32,
                   train_transforms=["RandomRotation", "ApplyTransformCDM", "NumpyToTensor"])
    else:
        cfg.update(data_repr="pos", contact_type="contact_cont_joints", contact_joints=JOINTS,
                   min_horizon=24, max_horizon=196, mix_train_ratio=0.0)
    return cls(cfg)


CASES = {
    "MotionXDataset": ("train", {}),
    "MotionXDataset-test": ("test", {}),
    "MotionXExampleDataset": ("test", {"data_path": "motionx_examples.txt"}),
    "ContactMapExampleDataset": ("test", {"data_path": "contact_examples.txt"}),
    "ContactMotionExampleOriginDataset": ("test", {"data_path": "contact_motion_examples.txt"}),
    "ContactMotionExampleDataset": ("test", {"data_path": "contact_motion_examples.txt",
                                             "contact_folder": "stage1"}),
    "MotionXCustomDataset": ("test", {}),
    "ContactMapCustomDataset": ("test", {}),
    "ContactMotionCustomDataset": ("test", {"contact_folder": "handoff"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_items_equal_jax(tree, case):
    name = case.split("-")[0]
    phase, kw = CASES[case]
    kwargs = {}
    if "data_path" in kw:
        kwargs["data_path"] = str(tree["ex"] / kw["data_path"])
    if "contact_folder" in kw:
        kwargs["contact_folder"] = str(tree[kw["contact_folder"]])
    sets = []
    for factory, cls in ((jax_create_dataset, JaxDictConfig), (create_dataset, DictConfig)):
        random.seed(11)
        np.random.seed(11)
        sets.append(factory(_cfg(tree["data"], cls, name), phase, **kwargs))
    jds, tds = sets
    assert type(tds).__name__ == name and len(tds) == len(jds) > 0
    np.testing.assert_array_equal(tds.mean, jds.mean)
    np.testing.assert_array_equal(tds.std, jds.std)
    for idx in range(len(tds)):
        items = []
        for ds in (jds, tds):
            random.seed(20 + idx)
            np.random.seed(20 + idx)
            items.append(ds[idx])
        want, got = items
        assert list(got) == list(want), idx
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
    if name == "ContactMotionExampleDataset":
        contact = np.load(tree["stage1"] / "000-walk to the chair" / "contact.npy")
        np.testing.assert_array_equal(tds[0]["c_pc_xyz"], contact[:, :3])
        assert [int((~tds[i]["x_mask"]).sum()) for i in range(len(tds))] == list(FRAMES)


# ------------------------------------------------------------- visualizers
def test_colormap_values_match_matplotlib_byte_for_byte():
    rng = np.random.default_rng(0)
    edges = np.concatenate([np.arange(257) / 256, np.nextafter(np.arange(1, 257) / 256, 0),
                            [0.0, 1.0, -0.0, -1.0, 2.0, np.nan, np.inf, -np.inf]])
    for dt in (np.float32, np.float64):
        v = np.concatenate([rng.uniform(-0.5, 1.5, 20000), edges]).astype(dt)
        got, want = tmesh.colormap_values(v), jmesh.colormap_values(v)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (len(v), 3)
        np.testing.assert_array_equal(got, want)
    assert tmesh.VIRIDIS.shape == (256, 3)


class _Dataset:
    sigma = 0.5

    def __init__(self, use_raw_dist, dim):
        self.use_raw_dist = use_raw_dist
        rng = np.random.default_rng(dim)
        self.mean = rng.normal(size=(1, dim)).astype(np.float32) * 0.1
        self.std = rng.uniform(0.5, 1.5, size=(1, dim)).astype(np.float32)

    def denormalize(self, x, clip=False):
        x = x * self.std + self.mean
        if clip:
            x = x.clip(0.0, None) if self.use_raw_dist else x.clip(1e-20, 1.0)
        return x


class _Loader:
    def __init__(self, dataset):
        self.dataset = dataset


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _visualize(tmp_path, cfg, sample, loader, kwargs):
    """Each package's visualizer over the same arrays; returns both trees'
    files."""
    out = []
    for tag, mod, dcls in (("jax", jvis, JaxDictConfig), ("port", tvis, DictConfig)):
        vis = mod.create_visualizer(dcls(cfg))
        vis.visualize(sample, str(tmp_path / tag), 1, loader, **kwargs)
        out.append(_files(tmp_path / tag))
    return out


@pytest.mark.parametrize("repr_", [("contact_cont_joints", False), ("contact_all_joints", False),
                                   ("contact_cont_joints", True)],
                         ids=["cont", "all_joints", "raw_dist"])
def test_contact_visualizer_files_equal_jax(tmp_path, repr_):
    data_repr, raw = repr_
    dim = 22 if data_repr == "contact_all_joints" else 6
    rng = np.random.default_rng(1)
    B, N = 2, 300
    sample = rng.normal(size=(B, N, dim)).astype(np.float32)
    kwargs = {"c_pc_xyz": rng.normal(size=(B, N, 3)).astype(np.float32),
              "c_text": ["walk to the chair", "sit down"]}
    cfg = {"visualizer": {"name": "ContactVisualizer", "vis_joints": [0, 10, 21]},
           "dataset": {"data_repr": data_repr, "data_repr_joints": JOINTS}}
    want, got = _visualize(tmp_path, cfg, sample, _Loader(_Dataset(raw, dim)), kwargs)
    assert list(got) == list(want) and got == want
    assert "002-walk to the chair/contact.npy" in got
    link = np.load(tmp_path / "port" / "002-walk to the chair" / "contact.npy")
    assert link.shape == (N, 3 + dim) and link.dtype == np.float32
    n_ply = 3 if data_repr == "contact_all_joints" else 6
    assert sum(k.startswith("003-sit down/contact_joint_") for k in got) == n_ply


def _motion_batch(tmp_path, dim, scene: bool):
    rng = np.random.default_rng(2)
    B, L = 2, 30
    sample = (rng.normal(size=(B, L, dim)) * 0.3).astype(np.float32)
    mask = np.zeros((B, L), bool)
    mask[0, 12:] = True
    mask[1, 20:] = True
    path = tmp_path / "scene.ply"
    tmesh.uv_sphere(0.4, center=(0.5, 0.0, 0.2)).export(str(path))
    trans = np.eye(4, dtype=np.float32)
    trans[:3, 3] = [0.1, -0.2, 0.3]
    kwargs = {"c_text": ["walk", "sit down"], "x_mask": mask,
              "info_scene_mesh": [str(path) if scene else "", str(tmp_path / "missing.ply")],
              "info_scene_trans": np.stack([trans, trans])}
    return sample, kwargs


@pytest.mark.parametrize("name", ["ContactMotionVisualizer", "MotionXVisualizer",
                                  "H3DVisualizer"])
def test_motion_visualizer_files_equal_jax(tmp_path, name):
    """Without a scene mesh on disk (the H3D visualizer reads none)."""
    dim = 263 if name == "H3DVisualizer" else 66
    sample, kwargs = _motion_batch(tmp_path, dim, scene=False)
    cfg = {"visualizer": {"name": name, "njoints": 22}}
    want, got = _visualize(tmp_path, cfg, sample, _Loader(_Dataset(False, dim)), kwargs)
    assert list(got) == list(want) and got == want
    assert sum(k.startswith("002-walk/frame_") for k in got) == 12
    assert sum(k.startswith("003-sit down/frame_") for k in got) == 20


def test_motion_visualizer_with_a_scene_mesh(tmp_path):
    """A case with its scene mesh: the JAX package's ``concatenate`` gives
    the uncoloured scene 4 colour channels beside the skeleton's 3 and
    raises; the port colours it grey in 3 and writes the frames, each the
    JAX frame's skeleton and axis marker followed by the scene moved by
    ``info_scene_trans``."""
    sample, kwargs = _motion_batch(tmp_path, 66, scene=True)
    cfg = {"visualizer": {"name": "ContactMotionVisualizer", "njoints": 22}}
    loader = _Loader(_Dataset(False, 66))
    with pytest.raises(ValueError, match="dimension"):
        jvis.create_visualizer(JaxDictConfig(cfg)).visualize(sample, str(tmp_path / "jax"), 1,
                                                             loader, **kwargs)
    tvis.create_visualizer(DictConfig(cfg)).visualize(sample, str(tmp_path / "port"), 1, loader,
                                                      **kwargs)
    bare = dict(kwargs, info_scene_mesh=["", ""])
    jvis.create_visualizer(JaxDictConfig(cfg)).visualize(sample, str(tmp_path / "bare"), 1,
                                                         loader, **bare)
    scene = tmesh.load_mesh_ply(str(tmp_path / "scene.ply"))
    scene.apply_transform(kwargs["info_scene_trans"][0])
    frames = sorted((tmp_path / "port" / "002-walk").glob("frame_*.ply"))
    assert len(frames) == 12
    for f in frames:
        got = tmesh.load_mesh_ply(str(f))
        want = jmesh.load_mesh_ply(str(tmp_path / "bare" / "002-walk" / f.name))
        n = len(want.vertices)
        np.testing.assert_array_equal(got.vertices[:n], want.vertices)
        np.testing.assert_array_equal(got.faces[: len(want.faces)], want.faces)
        np.testing.assert_array_equal(got.vertices[n:], scene.vertices)
        np.testing.assert_array_equal(got.faces[len(want.faces):], scene.faces + n)


def test_mesh_toolkit_equals_jax(tmp_path):
    """Primitives, concatenation, transforms and both PLY readers."""
    rng = np.random.default_rng(4)
    parts = []
    p0, p1 = rng.normal(size=3), rng.normal(size=3)
    for mod in (jmesh, tmesh):
        # coloured with coloured, uncoloured with uncoloured (see
        # test_motion_visualizer_with_a_scene_mesh for the mix)
        coloured = mod.concatenate([mod.cylinder_between(p0, p1, 0.05, color=[10, 20, 30]),
                                    mod.axis_marker(0.05)])
        plain = mod.concatenate([mod.box((0.1, 0.2, 0.3), (1, 2, 3)),
                                 mod.uv_sphere(0.2, (0, 1, 0))])
        for m in (coloured, plain):
            m.apply_transform(np.diag([1.0, -1.0, 2.0, 1.0]))
            m.apply_translation([0.5, 0, 0])
        parts.append((coloured, plain))
    for i, (a, b) in enumerate(zip(*parts)):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        assert (a.vertex_colors is None) == (b.vertex_colors is None) == bool(i)
        if not i:
            np.testing.assert_array_equal(a.vertex_colors, b.vertex_colors)
        a.export(str(tmp_path / f"j{i}.ply"))
        b.export(str(tmp_path / f"t{i}.ply"))
        assert (tmp_path / f"j{i}.ply").read_bytes() == (tmp_path / f"t{i}.ply").read_bytes()
    ascii_ply = tmp_path / "ascii.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                         "property float y\nproperty float z\nelement face 1\n"
                         "property list uchar int vertex_indices\nend_header\n"
                         "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for path in (ascii_ply, tmp_path / "t0.ply", tmp_path / "t1.ply"):
        j, t = jmesh.load_mesh_ply(str(path)), tmesh.load_mesh_ply(str(path))
        np.testing.assert_array_equal(t.vertices, j.vertices)
        np.testing.assert_array_equal(t.faces, j.faces)
    cloud = rng.normal(size=(50, 3)).astype(np.float32)
    colors = tmesh.colormap_values(rng.uniform(size=50))
    jmesh.export_pointcloud_ply(str(tmp_path / "jc.ply"), cloud, colors)
    tmesh.export_pointcloud_ply(str(tmp_path / "tc.ply"), cloud, colors)
    assert (tmp_path / "jc.ply").read_bytes() == (tmp_path / "tc.ply").read_bytes()


# --------------------------------------------------------- the entry, twice
CDM_SMALL = ["model=cdm", "model.arch=Perceiver", "model.scene_model.use_scene_model=False",
             "model.arch_perceiver.encoder_q_input_channels=32",
             "model.arch_perceiver.encoder_kv_input_channels=16",
             "model.arch_perceiver.decoder_q_input_channels=16",
             "model.arch_perceiver.decoder_kv_input_channels=32",
             "model.arch_perceiver.encoder_num_heads=2", "model.arch_perceiver.decoder_num_heads=2",
             "model.arch_perceiver.encoder_self_attn_num_layers=1", "model.time_emb_dim=16"]
CMDM_SMALL = ["model=cmdm", "model.arch=trans_enc", "model.latent_dim=32",
              "model.time_emb_dim=32", "model.num_heads=4", "model.dim_feedforward=64",
              "model.num_layers=[1,1]", "model.contact_model.planes=[8,16,32,64]"]


def _entry_args(tree, exp, *extra):
    # float32: the chain's flow is under test here, not its bf16 numerics
    # (tests/test_torch_sampling.py), and the CPU runs it faster
    return [f"exp_dir={exp}", "model.dtype=float32", f"task.dataset.data_dir={tree['data']}",
            f"task.dataset.num_points={N_POINTS}", f"task.dataset.sets={SETS}".replace(" ", ""),
            "diffusion.steps=10", "task.sample.batch_size=2", "seed=2023",
            f"text_encoder.table_path={exp}/none", f"text_encoder.weights_dir={exp}/none",
            "platform=jsonl", *extra]


def _seeded_ckpt(args, exp, dim):
    cfg = load_config("configs", args)
    cfg.model.input_feats = dim
    torch.manual_seed(3)
    save_ckpt(create_model(cfg.model, torch.device("cpu")), str(exp / "ckpt"), 0)


def test_sample_entry_runs_the_two_stage_chain(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(Path(__file__).resolve().parents[1])
    s1_exp, s2_exp = tmp_path / "cdm", tmp_path / "cmdm"
    s1 = _entry_args(tree, s1_exp, "task=contact_gen", *CDM_SMALL,
                     f"task.sample.data_path={tree['ex'] / 'contact_examples.txt'}")
    _seeded_ckpt(s1, s1_exp, 6)
    out1 = Path(sample_entry.main(s1, device="cpu"))
    # two batches of two cases, numbered in the prompt file's order
    cases = sorted(p.name for p in out1.iterdir() if p.is_dir())
    assert cases == [f"{i:03d}-{line.split('#')[0]}"
                     for i, line in enumerate(CONTACT_LINES.splitlines())]
    for case in cases:
        c = np.load(out1 / case / "contact.npy")
        assert c.shape == (N_POINTS, 3 + 6) and c.dtype == np.float32 and np.isfinite(c).all()
        assert (c[:, 3:] >= 0).all()
        assert len(list((out1 / case).glob("contact_joint_*.ply"))) == 6
    assert (out1 / "sample.log").exists()
    timing = json.loads((out1 / "timing.json").read_text())
    assert timing["device"] == "cpu" and len(timing["chains"]) == len(timing["visualize_s"]) == 2
    assert all(c["steps"] == 10 and c["loop_s"] > 0 for c in timing["chains"])
    # the chain's noise comes from the seed: the same files again
    shutil.copytree(s1_exp / "ckpt", tmp_path / "cdm_again" / "ckpt")
    again = Path(sample_entry.main(s1 + [f"exp_dir={tmp_path / 'cdm_again'}"], device="cpu"))
    assert _files(again).keys() == _files(out1).keys()  # timing.json too
    for case in cases:
        assert (again / case / "contact.npy").read_bytes() == (
            out1 / case / "contact.npy").read_bytes()

    s2 = _entry_args(tree, s2_exp, "task=contact_motion_gen", *CMDM_SMALL,
                     f"task.sample.data_path={tree['ex'] / 'contact_motion_examples.txt'}",
                     f"task.sample.contact_folder={out1}", "task.sample.sampler=ddim",
                     "diffusion.timestep_respacing=ddim5", "task.dataset.mix_train_ratio=0.0")
    _seeded_ckpt(s2, s2_exp, 66)
    out2 = Path(sample_entry.main(s2, device="cpu"))
    assert sorted(p.name for p in out2.iterdir() if p.is_dir()) == cases
    for case, frames in zip(cases, FRAMES):
        plys = sorted((out2 / case).glob("frame_*.ply"))
        assert len(plys) == frames and plys[-1].name == f"frame_{frames - 1:04d}.ply"
        assert tmesh.load_mesh_ply(str(plys[0])).vertices.shape[0] > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        sample_entry.main(s2)

"""The port's visualizer entries, data-loader checks and video render against
the JAX package's, on the CPU at a small size.

``afford_motion_torch.visualize`` against the root ``visualize.py`` on
result pickles of 6 frames: with ``--render_joint`` and without a body
model (the skeleton route) every file byte for byte; through the synthetic
SMPL-X at 128 vertices the same files, the faces exact and the vertices
within 1e-5 + 1e-5 rel (the two frameworks' float32 LBS).
``afford_motion_torch.visualize_h3d`` against the root ``visualize_h3d.py``
on 263-d results (one a k-sample file): every file byte for byte.
``utils/debug.py``'s dumps over the port's and the JAX package's loaders
of the same synthetic HUMANISE set: byte for byte. The render to video
(``eval/visualize._render_frames_to_video``) runs against stand-in
``pyrender``, ``trimesh`` and ``PIL`` modules and an ``ffmpeg`` script on
the ``PATH``, which neither machine has: the same calls with the same
arrays and the same files as the JAX package's under the same stand-ins.
"""
import hashlib
import importlib.machinery
import os
import pickle
import random
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from afford_motion_torch import visualize as port_vis
from afford_motion_torch import visualize_h3d as port_vis_h3d
from afford_motion_torch.utils.mesh import load_mesh_ply

LBS_TOL = dict(rtol=1e-5, atol=1e-5)


def _root(name):
    import importlib

    return importlib.import_module(name)


def _run_root(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _root(name).main()


def _tree_bytes(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Result pickles as the evaluators write them: ``joints/`` (joints and
    69-d params of 6 frames) and ``humanml/`` (a 263-d motion of 7 frames
    with its length and text, and a k-sample file of 2)."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(0)
    joints = root / "joints"
    joints.mkdir()
    for i in range(2):
        with open(joints / f"{i:05d}.pkl", "wb") as f:
            pickle.dump({"joints": rng.normal(size=(6, 66)).astype(np.float32),
                         "params": rng.normal(scale=0.3, size=(6, 69)).astype(np.float32),
                         "text": f"walk {i}"}, f)
    humanml = root / "humanml"
    humanml.mkdir()
    for i, shape in enumerate(((9, 263), (2, 9, 263))):
        with open(humanml / f"{i:05d}.pkl", "wb") as f:
            pickle.dump({"motion": rng.normal(scale=0.2, size=shape).astype(np.float32),
                         "m_len": 7, "text": f"a person walks {i}"}, f)
    return root


@pytest.mark.parametrize("route", ["skeleton", "no body model"])
def test_visualize_skeleton_files_equal(results, route, tmp_path, monkeypatch):
    """``--render_joint --save_mesh``, and the params route where no body
    model is found (both fall back to the skeleton): every frame and
    skeleton PLY byte for byte."""
    monkeypatch.delenv("SMPLX_USE_SYNTHETIC", raising=False)
    monkeypatch.setenv("SMPLX_MODEL_PATH", str(tmp_path / "absent.npz"))
    monkeypatch.chdir(tmp_path)
    args = ["--folder", str(results / "joints"), "--save_mesh",
            *(["--render_joint"] if route == "skeleton" else [])]
    _run_root(monkeypatch, "visualize", args + ["--out_dir", str(tmp_path / "jax")])
    port_vis.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want = _tree_bytes(tmp_path / "jax")
    assert len(want) == 2 * 12 and want == _tree_bytes(tmp_path / "port")


def test_visualize_smplx_meshes_match_jax(results, tmp_path, monkeypatch):
    """Without ``--render_joint``: one SMPL-X mesh a frame through the LBS
    beside the axis marker. The root ``visualize.py`` raises there (its mesh
    toolkit cannot join the uncoloured body to the coloured marker: the
    divergence ``utils/mesh.concatenate`` of the port documents); the port
    writes one frame a row of params, the body's faces and, within 1e-5 +
    1e-5 rel, its vertices those of the JAX package's
    ``params_to_verts_joints``, the marker's rows those of the skeleton
    route's frames."""
    import jax.numpy as jnp

    from afford_motion_tpu.eval.smplx_lbs import SMPLXModel, params_to_verts_joints

    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", "128")
    path = results / "joints" / "00001.pkl"
    with pytest.raises(ValueError, match="dimensions"):
        _run_root(monkeypatch, "visualize", ["--file", str(path), "--out_dir",
                                             str(tmp_path / "jax")])
    port_vis.main(["--file", str(path), "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    port_vis.main(["--file", str(path), "--out_dir", str(tmp_path / "skel"), "--render_joint"])
    with open(path, "rb") as f:
        params = pickle.load(f)["params"]
    model = SMPLXModel.load_default()
    want = np.asarray(params_to_verts_joints(model, jnp.asarray(params))[0])
    names = sorted(_tree_bytes(tmp_path / "port"))
    assert names == [f"00001/frame_{f:04d}.ply" for f in range(6)]
    for f, name in enumerate(names):
        got, skel = (load_mesh_ply(str(tmp_path / d / name)) for d in ("port", "skel"))
        nv, nf = want.shape[1], len(model.faces)
        np.testing.assert_allclose(got.vertices[:nv], want[f], **LBS_TOL, err_msg=name)
        assert np.array_equal(got.faces[:nf], np.asarray(model.faces))
        n_marker = len(got.vertices) - nv
        assert np.array_equal(got.vertices[nv:], skel.vertices[-n_marker:])


def test_visualize_needs_the_card_unless_told(results, tmp_path):
    """The LBS route runs on ``cuda:0`` by default: without a card it raises
    instead of running on the CPU; the skeleton route needs no device."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_vis.main(["--folder", str(results / "joints"), "--out_dir", str(tmp_path / "a")])
    port_vis.main(["--folder", str(results / "joints"), "--render_joint", "--cnt", "1",
                   "--out_dir", str(tmp_path / "b")])
    assert len(list((tmp_path / "b").rglob("*.ply"))) == 6


def test_visualize_h3d_files_equal(results, tmp_path, monkeypatch):
    """263-d results (and a k-sample file's first sample) to skeleton frames,
    every file byte for byte."""
    args = ["--folder", str(results / "humanml"), "--save_mesh"]
    _run_root(monkeypatch, "visualize_h3d", args + ["--out_dir", str(tmp_path / "jax")])
    port_vis_h3d.main(args + ["--out_dir", str(tmp_path / "port")])
    want = _tree_bytes(tmp_path / "jax")
    assert len(want) == 2 * 2 * 7 and want == _tree_bytes(tmp_path / "port")


# ------------------------------------------------------------ loader checks
def _loader_cfg(data, cls, name):
    stage1 = name == "ContactMapDataset"
    cfg = {"name": name, "data_dir": str(data), "shuffle_seed": 2023, "sets": ["HUMANISE"],
           "sets_config": {"HUMANISE": {"ratio": 1.0}}, "num_points": 128,
           "use_raw_dist": False, "sigma": 0.5, "use_color": True,
           "train_transforms": ["NumpyToTensor"], "test_transforms": ["NumpyToTensor"],
           "transform_cfg": {"gravity_dim": 2}}
    if stage1:
        cfg.update(data_repr="contact_cont_joints", data_repr_joints=[0, 10, 11, 12, 20, 21],
                   use_openscene=False, point_feat_dim=32)
    else:
        cfg.update(data_repr="pos", contact_type="contact_cont_joints",
                   contact_joints=[0, 10, 11, 12, 20, 21], min_horizon=24, max_horizon=196,
                   mix_train_ratio=0.0)
    return cls(cfg)


@pytest.mark.parametrize("name", ["MotionXDataset", "ContactMapDataset"])
def test_debug_dumps_equal(name, tmp_path):
    """``debug_motionx_dataloader`` (the scene clouds of two batches) and
    ``debug_contact_map_dataloader`` (the contact maps of joint 2 as coloured
    clouds) over each package's own loader of the same set, batch 4: the
    PLYs byte for byte."""
    from afford_motion_tpu.data import create_dataset as jax_create_dataset
    from afford_motion_tpu.data.loader import DataLoader as JaxLoader
    from afford_motion_tpu.utils import debug as jax_debug
    from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
    from afford_motion_torch.data import create_dataset
    from afford_motion_torch.data.loader import DataLoader
    from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
    from afford_motion_torch.utils import debug as port_debug
    from afford_motion_torch.utils.config import DictConfig

    make_synthetic_motionx_set(str(tmp_path / "data"), "HUMANISE", n_items=12, num_points=128,
                               horizon_range=(24, 40), seed=3, test_items=8)
    for side, factory, cfg_cls, loader_cls, mod in (
            ("jax", jax_create_dataset, JaxDictConfig, JaxLoader, jax_debug),
            ("port", create_dataset, DictConfig, DataLoader, port_debug)):
        random.seed(11)
        np.random.seed(11)
        ds = factory(_loader_cfg(tmp_path / "data", cfg_cls, name), "test")
        loader = loader_cls(ds, batch_size=4, shuffle=False)
        if name == "MotionXDataset":
            mod.debug_motionx_dataloader(loader, str(tmp_path / side), n_batches=2)
        else:
            mod.debug_contact_map_dataloader(loader, str(tmp_path / side), n_batches=2, joint=2)
    want = _tree_bytes(tmp_path / "jax")
    assert len(want) == 4 and want == _tree_bytes(tmp_path / "port")


# ------------------------------------------------------------------- render
def _digest(a) -> str:
    a = np.ascontiguousarray(a)
    return f"{a.dtype}{a.shape}:{hashlib.sha256(a.tobytes()).hexdigest()[:16]}"


def _stand_ins(calls: list) -> dict:
    """``pyrender``, ``trimesh`` and ``PIL`` modules that log every call with
    digests of its arrays; the renderer returns an image made from the
    scene's meshes, PIL writes the array's bytes."""
    def module(name):
        m = types.ModuleType(name)
        m.__spec__ = importlib.machinery.ModuleSpec(name, None)
        return m

    pyrender, trimesh, pil, image = (module(n) for n in ("pyrender", "trimesh", "PIL",
                                                         "PIL.Image"))

    class Trimesh:
        def __init__(self, vertices, faces, vertex_colors):
            self.arrays = (vertices, faces, vertex_colors)
            calls.append(("Trimesh", *map(_digest, self.arrays)))

    class Mesh:
        @staticmethod
        def from_trimesh(tm, smooth=True):
            calls.append(("Mesh.from_trimesh", smooth))
            return tm

    class Scene:
        def __init__(self):
            self.nodes = []

        def add(self, obj, pose=None):
            calls.append(("Scene.add", type(obj).__name__,
                          None if pose is None else _digest(pose)))
            self.nodes.append(obj)

    class OffscreenRenderer:
        def __init__(self, viewport_width, viewport_height):
            calls.append(("OffscreenRenderer", viewport_width, viewport_height))
            self.size = (viewport_height, viewport_width)

        def render(self, scene):
            v = np.concatenate([n.arrays[0].ravel() for n in scene.nodes if
                                isinstance(n, Trimesh)])
            img = np.zeros(self.size + (3,), np.uint8)
            img.reshape(-1)[: v.size] = (np.abs(v) * 100).astype(np.uint8)
            return img, np.zeros(self.size, np.float32)

        def delete(self):
            calls.append(("OffscreenRenderer.delete",))

    def camera(yfov):
        calls.append(("PerspectiveCamera", yfov))
        return types.SimpleNamespace()

    def light(color, intensity):
        calls.append(("DirectionalLight", _digest(color), intensity))
        return types.SimpleNamespace()

    class Image:
        def __init__(self, arr):
            self.arr = arr

        def save(self, path):
            calls.append(("Image.save", os.path.basename(path), _digest(self.arr)))
            Path(path).write_bytes(self.arr.tobytes())

    pyrender.Mesh, pyrender.Scene, pyrender.OffscreenRenderer = Mesh, Scene, OffscreenRenderer
    pyrender.PerspectiveCamera, pyrender.DirectionalLight = camera, light
    trimesh.Trimesh = Trimesh
    image.fromarray = Image
    pil.Image = image
    return {"pyrender": pyrender, "trimesh": trimesh, "PIL": pil, "PIL.Image": image}


def test_render_to_video_matches_jax(tmp_path, monkeypatch):
    """``export_animation`` with pyrender found: per frame a Trimesh of the
    frame's mesh with the appendix, its scene (mesh, camera and light at the
    same pose), one render saved as ``render_{f:04d}.png``, then ffmpeg at 20
    fps into ``animation.mp4``; the same calls and arrays and the same files
    as the JAX package's."""
    from afford_motion_tpu.eval import visualize as jax_vis
    from afford_motion_tpu.utils import mesh as jax_mesh
    from afford_motion_torch.eval import visualize as port_eval_vis
    from afford_motion_torch.utils import mesh as port_mesh

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    ffmpeg = bin_dir / "ffmpeg"
    ffmpeg.write_text('#!/bin/sh\nfor a; do last="$a"; done\necho "$@" > "$last"\n')
    ffmpeg.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    skeleton = np.random.default_rng(1).normal(size=(3, 22, 3)).astype(np.float32)
    logs = {}
    for side, vis, mesh in (("jax", jax_vis, jax_mesh), ("port", port_eval_vis, port_mesh)):
        calls = []
        for name, mod in _stand_ins(calls).items():
            monkeypatch.setitem(sys.modules, name, mod)
        vis.export_animation(str(tmp_path / side), vis.skeleton_to_mesh(skeleton),
                             [mesh.axis_marker(0.05)])
        logs[side] = calls
    assert logs["port"] == logs["jax"]
    assert sum(c[0] == "Image.save" for c in logs["port"]) == 3
    jax_files, port_files = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files) and "animation.mp4" in port_files
    assert port_files["animation.mp4"].decode().split()[:5] == ["-y", "-framerate", "20", "-i",
                                                                  str(tmp_path / "port" /
                                                                      "render_%04d.png")]
    assert all(port_files[k] == jax_files[k] for k in port_files if k != "animation.mp4")


def test_render_raises_where_ffmpeg_fails(tmp_path, monkeypatch):
    """A failing ``ffmpeg`` raises (the JAX package ignores its exit code)."""
    import subprocess

    from afford_motion_torch.eval import visualize as port_eval_vis
    from afford_motion_torch.utils.mesh import axis_marker

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "ffmpeg").write_text("#!/bin/sh\nexit 1\n")
    (bin_dir / "ffmpeg").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    for name, mod in _stand_ins([]).items():
        monkeypatch.setitem(sys.modules, name, mod)
    with pytest.raises(subprocess.CalledProcessError):
        port_eval_vis.export_animation(str(tmp_path / "out"), [axis_marker(0.05)])

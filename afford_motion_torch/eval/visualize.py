"""Visualizers (counterpart of ``afford_motion_tpu/eval/visualize.py``;
reference: utils/visualize.py:22-409), host-side numpy.

Same registry names and output protocols:
- ContactVisualizer writes per-joint contact heatmap PLYs and
  ``contact.npy`` (xyz then dist), the sample-mode stage-1 -> stage-2 link
  that ContactMotionExampleDataset reads (reference: motionx.py:984-992);
- the motion visualizers export per-frame skeleton meshes as PLYs, and
  render them to ``animation.mp4`` where pyrender is installed
  (:func:`_render_frames_to_video`: pyrender, trimesh and PIL, then
  ``ffmpeg`` on the ``PATH``).
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
from typing import Any, List

import numpy as np

from ..utils.io import get_logger
from ..utils.mesh import (
    SimpleMesh,
    axis_marker,
    colormap_values,
    concatenate,
    cylinder_between,
    export_pointcloud_ply,
    load_mesh_ply,
    uv_sphere,
)
from ..utils.registry import VISUALIZER
from .motion_repr import recover_from_ric

logger = get_logger()

# SMPL-H body kinematic chain without hands/jaw/eyes
# (reference: smplkit.constants.SKELETON_CHAIN.SMPLH, visualize.py:18)
KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]

_CHAIN_COLORS = ["#DD5A37", "#D69E00", "#B75A39", "#FF6D00", "#DDB50E"]


def _hex_to_rgb(h: str) -> np.ndarray:
    h = h.lstrip("#")
    return np.array([int(h[i: i + 2], 16) for i in (0, 2, 4)], dtype=np.uint8)


def skeleton_to_mesh(skeleton: np.ndarray, kinematic_chain=KINEMATIC_CHAIN,
                     njoints: int = 22) -> List[SimpleMesh]:
    """Per-frame bone meshes (reference: visualize.py:230-285)."""
    meshes = []
    if kinematic_chain is None:
        for f in range(skeleton.shape[0]):
            joints = [uv_sphere(0.02, center=j) for j in skeleton[f]]
            meshes.append(concatenate(joints))
        return meshes
    for f in range(skeleton.shape[0]):
        joints = skeleton[f]
        parts = []
        for i, chain in enumerate(kinematic_chain):
            width = 0.02 if i < 5 else 0.01
            color = _hex_to_rgb(_CHAIN_COLORS[i % len(_CHAIN_COLORS)])
            for a, b in zip(chain[:-1], chain[1:]):
                parts.append(cylinder_between(joints[a], joints[b], width, color=color))
        meshes.append(concatenate(parts))
    return meshes


def _load_scene_mesh(scene_path: str, scene_trans) -> SimpleMesh | None:
    if not scene_path or not os.path.exists(scene_path):
        return None
    try:
        mesh = load_mesh_ply(scene_path)
    except Exception as e:
        logger.warning(f"could not load scene mesh {scene_path}: {e}")
        return None
    scene_trans = np.asarray(scene_trans)
    if scene_trans.ndim == 1:
        mesh.apply_translation(scene_trans)
    else:
        mesh.apply_transform(scene_trans)
    return mesh


def export_animation(save_dir: str, meshes: List[SimpleMesh],
                     appendix_meshes: List[SimpleMesh] | None = None,
                     ext: str = "mp4") -> None:
    """One ``frame_{f:04d}.ply`` a frame, the frame's mesh with the
    ``appendix_meshes``, and where pyrender is installed their render to
    ``animation.{ext}`` (reference: render_meshes_to_animation,
    visualize.py:339-409)."""
    os.makedirs(save_dir, exist_ok=True)
    static = concatenate(appendix_meshes) if appendix_meshes else None
    for f, mesh in enumerate(meshes):
        full = concatenate([mesh, static]) if static is not None else mesh
        full.export(os.path.join(save_dir, f"frame_{f:04d}.ply"))
    if importlib.util.find_spec("pyrender") is not None:
        _render_frames_to_video(save_dir, meshes, static, ext)
    else:
        logger.info(f"pyrender unavailable; exported {len(meshes)} frame meshes to {save_dir}")


def _render_frames_to_video(save_dir: str, meshes: List[SimpleMesh], static, ext: str) -> None:
    """Each frame's mesh (with ``static``) rendered offscreen at 960 x 540 by
    a camera 3 m behind and 2 m above the origin to ``render_{f:04d}.png``,
    then ``ffmpeg`` joins them at 20 fps into ``animation.{ext}``; a failing
    ``ffmpeg`` raises."""
    import pyrender
    import trimesh
    from PIL import Image

    r = pyrender.OffscreenRenderer(viewport_width=960, viewport_height=540)
    for f, mesh in enumerate(meshes):
        scene = pyrender.Scene()
        full = concatenate([mesh, static]) if static is not None else mesh
        tm = trimesh.Trimesh(vertices=full.vertices, faces=full.faces,
                             vertex_colors=full.vertex_colors)
        scene.add(pyrender.Mesh.from_trimesh(tm, smooth=False))
        cam = pyrender.PerspectiveCamera(yfov=np.pi / 3)
        pose = np.eye(4)
        pose[:3, 3] = [0, -3.0, 2.0]
        scene.add(cam, pose=pose)
        scene.add(pyrender.DirectionalLight(color=np.ones(3), intensity=3.0), pose=pose)
        color, _ = r.render(scene)
        Image.fromarray(color).save(os.path.join(save_dir, f"render_{f:04d}.png"))
    r.delete()
    subprocess.run(["ffmpeg", "-y", "-framerate", "20", "-i",
                    os.path.join(save_dir, "render_%04d.png"),
                    os.path.join(save_dir, f"animation.{ext}")],
                   check=True, capture_output=True)


class BaseVisualizer:
    def __init__(self, cfg: Any, *args, **kwargs):
        self.cfg = cfg.visualizer

    def visualize(self, sample, save_dir, *args, **kwargs):
        raise NotImplementedError


@VISUALIZER.register()
class ContactVisualizer(BaseVisualizer):
    """(reference: visualize.py:22-76)."""

    def __init__(self, cfg: Any, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.data_repr = cfg.dataset.data_repr
        joints = list(cfg.dataset.get("data_repr_joints", [0]))
        if self.data_repr in ("contact_one_joints", "contact_pelvis"):
            self.vis_joints = [0]
        elif self.data_repr == "contact_all_joints":
            self.vis_joints = list(self.cfg.get("vis_joints", joints))
        elif self.data_repr == "contact_cont_joints":
            self.vis_joints = list(range(len(joints)))
        else:
            raise ValueError(f"unknown contact representation: {self.data_repr}")

    def visualize(self, sample: np.ndarray, save_dir: str, *args, **kwargs) -> None:
        ibatch, dataloader = args[0], args[1]
        b = sample.shape[0]
        for i in range(b):
            contact = dataloader.dataset.denormalize(np.asarray(sample[i]), clip=True)
            if dataloader.dataset.use_raw_dist:
                dist = contact.copy()
                contact = 1 - contact.clip(0, 2.0) / 2.0
            else:
                from ..data.base import contact_to_dist
                dist = contact_to_dist(contact, dataloader.dataset.sigma)
            xyz = np.asarray(kwargs["c_pc_xyz"][i])
            text = kwargs["c_text"][i]
            case_dir = os.path.join(save_dir, f"{ibatch * b + i:03d}-{text}")
            for j in self.vis_joints:
                colors = colormap_values(contact[:, j])
                export_pointcloud_ply(
                    os.path.join(case_dir, f"contact_joint_{j:02d}.ply"), xyz, colors
                )
            # the stage-1 -> stage-2 sample-mode link
            os.makedirs(case_dir, exist_ok=True)
            np.save(os.path.join(case_dir, "contact.npy"),
                    np.concatenate([xyz, dist], axis=-1).astype(np.float32))


@VISUALIZER.register()
class ContactMotionVisualizer(BaseVisualizer):
    """(reference: visualize.py:78-121)."""

    def visualize(self, sample: np.ndarray, save_dir: str, *args, **kwargs) -> None:
        ibatch, dataloader = args[0], args[1]
        njoints = int(self.cfg.get("njoints", 22))
        b = sample.shape[0]
        for i in range(b):
            text = kwargs["c_text"][i]
            mask = np.asarray(kwargs["x_mask"][i])
            pose_seq = dataloader.dataset.denormalize(np.asarray(sample[i])[~mask])
            skeleton = pose_seq[:, : njoints * 3].reshape(-1, njoints, 3)
            meshes = skeleton_to_mesh(skeleton, KINEMATIC_CHAIN, njoints)

            appendix = [axis_marker(0.05)]
            scene = _load_scene_mesh(
                kwargs.get("info_scene_mesh", [""] * b)[i],
                kwargs.get("info_scene_trans", [np.zeros(3)] * b)[i],
            )
            if scene is not None:
                appendix.append(scene)
            export_animation(
                os.path.join(save_dir, f"{ibatch * b + i:03d}-{text}"), meshes, appendix
            )


@VISUALIZER.register()
class MotionXVisualizer(ContactMotionVisualizer):
    """(reference: visualize.py:123-177)."""


@VISUALIZER.register()
class H3DVisualizer(BaseVisualizer):
    """263-d HumanML3D vectors -> joints -> skeleton animation
    (reference: visualize.py:179-215)."""

    def visualize(self, sample: np.ndarray, save_dir: str, *args, **kwargs) -> None:
        ibatch, dataloader = args[0], args[1]
        njoints = int(self.cfg.get("njoints", 22))
        b = sample.shape[0]
        for i in range(b):
            text = kwargs["c_text"][i]
            mask = np.asarray(kwargs["x_mask"][i])
            vec = dataloader.dataset.denormalize(np.asarray(sample[i])[~mask])
            skeleton = recover_from_ric(vec.astype(np.float32), njoints)
            meshes = skeleton_to_mesh(skeleton, KINEMATIC_CHAIN, njoints)
            export_animation(
                os.path.join(save_dir, f"{ibatch * b + i:03d}-{text}"), meshes,
                [axis_marker(0.05)],
            )


def create_visualizer(cfg: Any, *args, **kwargs):
    """(reference: visualize.py:217-226)."""
    return VISUALIZER.get(cfg.visualizer.name)(cfg, *args, **kwargs)

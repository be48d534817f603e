"""Generated motions to meshes (counterpart of the root ``visualize.py``;
reference: visualize.py:26-143):

    python -m afford_motion_torch.visualize --folder <test dir>/joints [--cnt 30] [--save_mesh]
        [--render_joint] [--out_dir <dir>] [--device cuda:0|cpu]

Reads the pickles ``Text2MotionInSceneEvaluator`` writes (``joints/*.pkl``:
the joints, and the SMPL-X params where it fitted them) and exports one
``frame_{f:04d}.ply`` a frame (``sk_{f:03d}.ply`` too with
``--save_mesh``), rendered to ``animation.mp4`` where pyrender and ffmpeg
are found. Without ``--render_joint`` a pickle with params is meshed
through the SMPL-X LBS (``eval/smplx_lbs.params_to_verts_joints``) on the
device; where the body model is missing, through the skeleton, as with
``--render_joint``.
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np
import torch

from .eval.visualize import KINEMATIC_CHAIN, export_animation, skeleton_to_mesh
from .utils.io import get_logger
from .utils.mesh import SimpleMesh, axis_marker
from .utils.misc import natsorted

logger = get_logger()


def smplx_meshes(params: np.ndarray, device) -> list | None:
    """One SMPL-X mesh a row of 69-d params, the vertices from the LBS on
    ``device``; None where the body model is not found."""
    from .eval.smplx_lbs import SMPLXModel, params_to_verts_joints

    try:
        model = SMPLXModel.load_default()
    except FileNotFoundError:
        logger.warning("SMPL-X model unavailable; falling back to skeleton")
        return None
    with torch.no_grad():
        verts, _ = params_to_verts_joints(
            model.to(device), torch.from_numpy(np.ascontiguousarray(params, np.float32)).to(device))
    verts = verts.cpu().numpy()
    return [SimpleMesh(verts[i], model.faces) for i in range(len(verts))]


def visualize_case(path: str, out_dir: str, render_joint: bool = True, save_mesh: bool = False,
                   device="cuda") -> None:
    with open(path, "rb") as f:
        data = pickle.load(f)
    joints = np.asarray(data["joints"]).reshape(-1, 22, 3)
    meshes = None
    if not render_joint and "params" in data:
        meshes = smplx_meshes(np.asarray(data["params"]).reshape(-1, 69)[: len(joints)], device)
    if meshes is None:
        meshes = skeleton_to_mesh(joints, KINEMATIC_CHAIN)
    case_dir = os.path.join(out_dir, os.path.splitext(os.path.basename(path))[0])
    if save_mesh:
        os.makedirs(case_dir, exist_ok=True)
        for i, m in enumerate(meshes):
            m.export(os.path.join(case_dir, f"sk_{i:03d}.ply"))
    export_animation(case_dir, meshes, [axis_marker(0.05)])
    logger.info(f"visualized {path} -> {case_dir}")


def case_files(parser, args) -> list:
    """``--file``, or the first ``--cnt`` pickles of ``--folder``."""
    files = [args.file] if args.file else (
        natsorted(glob.glob(os.path.join(args.folder, "*.pkl")))[: args.cnt] if args.folder
        else [])
    if not files:
        parser.error("provide --file or --folder")
    return files


def main(argv=None) -> None:
    from .utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--folder", type=str, default="")
    parser.add_argument("--file", type=str, default="")
    parser.add_argument("--cnt", type=int, default=30)
    parser.add_argument("--save_mesh", action="store_true")
    parser.add_argument("--save_scene", action="store_true")
    parser.add_argument("--render_joint", action="store_true")
    parser.add_argument("--out_dir", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda:0",
                        help="device of the SMPL-X LBS (cuda:0, or cpu)")
    args = parser.parse_args(argv)
    files = case_files(parser, args)
    device = None if args.render_joint else resolve_device({}, args.device)
    out_dir = args.out_dir or (args.folder or os.path.dirname(args.file)) + "_vis"
    for f in files:
        visualize_case(f, out_dir, render_joint=args.render_joint, save_mesh=args.save_mesh,
                       device=device)


if __name__ == "__main__":
    main()

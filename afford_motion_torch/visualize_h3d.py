"""HumanML3D (263-d) generation results to skeleton meshes (counterpart of
the root ``visualize_h3d.py``; reference: visualize_h3d.py:89-210):

    python -m afford_motion_torch.visualize_h3d --folder <test dir>/humanml [--cnt 30]
        [--njoints 22] [--save_mesh] [--out_dir <dir>]

Reads the pickles ``Text2MotionInSceneHumanML3DEvaluator`` writes
(``humanml/*.pkl``: the denormalized 263-d motion, its length and text;
a k-sample file's first sample), recovers the joints with
``eval/motion_repr.recover_from_ric`` and exports the skeleton's frames as
``visualize`` does. Numpy only.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from .eval.motion_repr import recover_from_ric
from .eval.visualize import KINEMATIC_CHAIN, export_animation, skeleton_to_mesh
from .utils.io import get_logger
from .utils.mesh import axis_marker
from .visualize import case_files

logger = get_logger()


def visualize_case(path: str, out_dir: str, njoints: int = 22, save_mesh: bool = False) -> None:
    with open(path, "rb") as f:
        data = pickle.load(f)
    motion = np.asarray(data["motion"], dtype=np.float32)
    m_len = int(data.get("m_len", len(motion)))
    if motion.ndim == 3:  # a k-sample file: its first sample
        motion = motion[0]
    joints = recover_from_ric(motion[:m_len], njoints)
    case_dir = os.path.join(out_dir, os.path.splitext(os.path.basename(path))[0])
    meshes = skeleton_to_mesh(joints, KINEMATIC_CHAIN, njoints)
    if save_mesh:
        os.makedirs(case_dir, exist_ok=True)
        for i, m in enumerate(meshes):
            m.export(os.path.join(case_dir, f"sk_{i:03d}.ply"))
    export_animation(case_dir, meshes, [axis_marker(0.05)])
    logger.info(f"visualized {path} ({data.get('text', '')!r}) -> {case_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--folder", type=str, default="")
    parser.add_argument("--file", type=str, default="")
    parser.add_argument("--cnt", type=int, default=30)
    parser.add_argument("--njoints", type=int, default=22)
    parser.add_argument("--save_mesh", action="store_true")
    parser.add_argument("--out_dir", type=str, default="")
    args = parser.parse_args(argv)
    files = case_files(parser, args)
    out_dir = args.out_dir or (args.folder or os.path.dirname(args.file)) + "_vis"
    for f in files:
        visualize_case(f, out_dir, njoints=args.njoints, save_mesh=args.save_mesh)


if __name__ == "__main__":
    main()

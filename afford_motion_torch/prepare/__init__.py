"""Data preparation of the port (counterpart of the root ``prepare.py``,
same stages and arguments, plus ``--device``): from the raw releases to the
packed store the train loop reads. The stage modules are
``raw_datasets``, ``smplx_to_vec``, ``process_scene``, ``contact_data``,
``split`` and ``target_object_mask`` beside this file. In order:

    python -m afford_motion_torch.prepare process --dataset HUMANISE --data_dir <raw> --out_dir <data>
    python -m afford_motion_torch.prepare smplx_to_vec --dataset HUMANISE --out_dir <data>
    python -m afford_motion_torch.prepare process_scene --out_dir <data>
    python -m afford_motion_torch.prepare contact_data --dataset HUMANISE --out_dir <data>
        [--num_points 8192 --region_size 4.0 --seed 0]
    python -m afford_motion_torch.prepare split --dataset HUMANISE --out_dir <data>
    python -m afford_motion_torch.prepare target_mask --dataset HUMANISE --out_dir <data>
    python -m afford_motion_torch.prepare sort --dataset HUMANISE --out_dir <data> [--curve hilbert]
    python -m afford_motion_torch.prepare geometry --dataset HUMANISE --out_dir <data> [--kind sm]
    python -m afford_motion_torch.prepare pack --dataset HUMANISE --out_dir <data>

``process`` turns a raw release (HUMANISE's ``align_data_release`` and
``pure_motion``, PROX's fittings, AMASS for HumanML3D) into SMPL-X
parameter pickles under ``<data>/<set>/motions/``; HUMANISE's also writes
``<data>/HUMANISE/annotations.csv``, and PROX reads ``cam2world/`` and
``scenes/`` from ``<data>/PROX``. ``smplx_to_vec`` gives each sequence's
22 joints (``motions_pos/``) through the SMPL-X LBS (the body model of
``SMPLX_MODEL_PATH``, or ``SMPLX_USE_SYNTHETIC=1``); ``process_scene`` every
scene PLY of every set to ``points/``; ``contact_data`` pairs each motion
with its scene (from ``annotations.csv``, which only HUMANISE has: PROX and
HumanML3D fail there, as in the JAX package) and writes
``contact_motion/``; ``split`` writes the set's ``train``/``test``/``all``
lists (``--dataset all``: every set, failing on one without its
``anno.csv``); ``target_mask`` (HUMANISE) marks each item's points on its
target object: it reads the contacts' row indices, so it runs before
``sort``.

A set's contacts are under ``<data>/H3D/`` for H3D and under
``<data>/<set>/contact_motion/`` for a MotionX set. ``sort`` rewrites every
contacts ``.npz`` with its point rows in space-filling-curve order, and a
MotionX item's per-point sidecars (``target_mask/``, ``affordance/``) in the
same order; ``geometry`` caches each item's FPS / kNN
hierarchy (ascending ``fps_idx``, int16 indices, a crc32 of the points it
was built from); ``pack`` bakes contacts and caches into the memmap store the
train loop reads. Run them in this order: the caches hold row positions.
``process`` (PROX's pelvis), ``smplx_to_vec``, ``contact_data`` and
``geometry`` run on ``cuda:0`` unless ``--device cpu`` is given (TF32 off);
the other stages are numpy only.
"""
from __future__ import annotations

import argparse
import glob
import os
import zlib

import numpy as np

from ..utils.io import get_logger
from ..utils.misc import natsorted

logger = get_logger()


# per-point files beside a MotionX item's contacts, one row a point
SIDECARS = ("target_mask", "affordance")


def _set_dir(args) -> str:
    """The directory of the dataset's ``contacts/`` and caches."""
    if args.dataset == "H3D":
        return os.path.join(args.out_dir, "H3D")
    return os.path.join(args.out_dir, args.dataset, "contact_motion")


def _contact_files(args) -> list:
    files = natsorted(glob.glob(os.path.join(_set_dir(args), "contacts", "*.npz")))
    if not files:
        raise FileNotFoundError(f"prepare: no contacts under {_set_dir(args)}/contacts")
    return files


def cmd_sort(args) -> None:
    """Rewrite per-item point rows of the contacts npz, and of a MotionX
    item's sidecars, in curve order (``ops/curves.py``) so the banded
    kernels apply. Idempotent per curve."""
    from ..ops.curves import curve_order

    base = _set_dir(args)
    files = _contact_files(args)
    sidecars = () if args.dataset == "H3D" else SIDECARS
    for n, f in enumerate(files):
        data = dict(np.load(f))
        order = curve_order(np.asarray(data["points"])[:, :3], args.curve)
        for key, v in data.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == len(order):
                data[key] = v[order]
        np.savez(f, **data)
        name = os.path.basename(f)[: -len(".npz")]
        for sub in sidecars:
            side = os.path.join(base, sub, f"{name}.npy")
            if os.path.exists(side):
                v = np.load(side)
                if v.ndim >= 1 and v.shape[0] == len(order):
                    np.save(side, v[order])
        if (n + 1) % 500 == 0 or n + 1 == len(files):
            logger.info(f"sort {n + 1}/{len(files)}")
    logger.info(f"{args.curve}-sorted {len(files)} items under {base}")


def cmd_geometry(args) -> None:
    """Cache every item's rigid-invariant FPS / kNN geometry, built on the
    device. ``--kind sm`` (4-level SceneMap) or ``seg`` (5-level)."""
    import torch

    from ..models.pointtransformer import (
        SCENEMAP_NSAMPLES, SCENEMAP_STRIDES, SEG_NSAMPLES, SEG_STRIDES)
    from ..ops.hierarchy import build_point_hierarchy, geometry_to_arrays
    device = _device(args)
    strides, nsamples = ((SCENEMAP_STRIDES, SCENEMAP_NSAMPLES) if args.kind == "sm"
                         else (SEG_STRIDES, SEG_NSAMPLES))
    files = _contact_files(args)
    out_dir = os.path.join(_set_dir(args), f"geometry_{args.kind}")
    os.makedirs(out_dir, exist_ok=True)
    for start in range(0, len(files), args.batch_size):
        chunk = files[start: start + args.batch_size]
        xyz = np.stack([np.load(f)["points"][:, :3].astype(np.float32) for f in chunk])
        # sort_fps: cached indices must keep the curve's locality per level
        # so the fps-only wire can run the banded kernels on them
        with torch.no_grad():
            levels = build_point_hierarchy(torch.from_numpy(xyz).to(device), strides, nsamples,
                                           sort_fps=True)
        arrays = {}
        for k, v in geometry_to_arrays(levels, prefix=f"geo_{args.kind}").items():
            v = v.cpu().numpy()
            if v.dtype.kind == "i" and v.max(initial=0) < 32768:
                v = v.astype(np.int16)  # halves wire and disk size; cast back on the device
            arrays[k] = v
        for b, f in enumerate(chunk):
            # fingerprint of the exact point bytes the cache was built from:
            # `pack` verifies it, so a cache made before a `sort` re-run
            # (stale row order) is detected
            fp = np.uint32(zlib.crc32(xyz[b].tobytes()) & 0xFFFFFFFF)
            name = os.path.basename(f)[: -len(".npz")]
            np.savez(os.path.join(out_dir, f"{name}.npz"), fp=fp,
                     **{k: v[b] for k, v in arrays.items()})
        logger.info(f"geometry {start + len(chunk)}/{len(files)}")
    logger.info(f"wrote geometry cache to {out_dir}")


def cmd_pack(args) -> None:
    """Bake contacts and geometry caches (and a MotionX set's raw motions)
    into the packed memmap training store (``data/packed.py``)."""
    from ..data.packed import pack_h3d, pack_motionx

    _contact_files(args)
    joints = [int(j) for j in args.contact_joints.split(",") if j != ""]
    if args.dataset == "H3D":
        pack_h3d(args.out_dir, contact_type=args.contact_type, contact_joints=joints)
    else:
        pack_motionx(args.out_dir, args.dataset, contact_type=args.contact_type,
                     contact_joints=joints)


def _device(args):
    from ..utils.device import resolve_device

    return resolve_device({}, args.device)


def cmd_process(args) -> None:
    from .raw_datasets import create_extractor

    device = _device(args) if args.dataset == "PROX" else "cpu"
    create_extractor(args.dataset, args.data_dir, args.out_dir, device).process()


def cmd_smplx_to_vec(args) -> None:
    import pickle

    from ..eval.smplx_lbs import SMPLXModel
    from .smplx_to_vec import smplx_to_vec

    model = SMPLXModel.load_default().to(_device(args))
    motion_dir = os.path.join(args.out_dir, args.dataset, "motions")
    save_dir = os.path.join(args.out_dir, args.dataset, "motions_pos")
    for pkl in natsorted(glob.glob(os.path.join(motion_dir, "*.pkl"))):
        with open(pkl, "rb") as f:
            smplx = pickle.load(f)
        name = os.path.basename(pkl).replace(".pkl", ".npy")
        smplx_to_vec(smplx, args.dataset, os.path.join(save_dir, name), model)
    logger.info(f"wrote joint vectors to {save_dir}")


def cmd_process_scene(args) -> None:
    from .process_scene import process_all

    process_all(args.out_dir)


def _load_pairs(base: str):
    """The (motion, scene) pairs of ``contact_data``: each ``motions_pos``
    sequence with its row of ``<base>/annotations.csv`` (the scene, its
    translation, the text) and the scenes' points, as the JAX package's
    root ``prepare.py`` reads them. A row without text raises, as it does
    there (pandas reads an empty caption as NaN)."""
    import pandas as pd

    csv_path = os.path.join(base, "annotations.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(
            f"contact_data reads {csv_path}, which only HUMANISE's process stage writes")
    anno = pd.read_csv(csv_path)
    scene_data, motions = {}, []
    for path in natsorted(glob.glob(os.path.join(base, "motions_pos", "*.npy"))):
        pose_seq = np.load(path)
        idx = int(os.path.basename(path).split(".")[0])
        row = anno.loc[idx]
        scene_id = row["scene_id"]
        if scene_id not in scene_data:
            scene_data[scene_id] = {"pcd": np.load(os.path.join(base, "points", f"{scene_id}.npy"))}
        trans = np.eye(4, dtype=np.float32)
        trans[0:3, -1] = [row[f"scene_trans_{a}"] for a in "xyz"]
        text = row.get("text", "")
        if not isinstance(text, str):
            raise TypeError(f"{csv_path}: motion {idx} has no text ({text!r}); the utterances "
                            "are joined as strings")
        motions.append((pose_seq, [text], (scene_id, trans), {}))
    return motions, scene_data


def cmd_contact_data(args) -> None:
    """Pair ``motions_pos`` with the scenes' points and build
    ``contact_motion/`` (reference: generate_contact_data.py load_* and
    process)."""
    from .contact_data import process

    base = os.path.join(args.out_dir, args.dataset)
    motions, scene_data = _load_pairs(base)
    process(motions, scene_data, os.path.join(base, "contact_motion"),
            num_points=args.num_points, region_size=args.region_size,
            rng=np.random.default_rng(args.seed), device=_device(args))
    logger.info(f"wrote contact_motion data for {args.dataset}")


def cmd_split(args) -> None:
    from .split import SPLITS, split_all

    if args.dataset == "all":
        split_all(args.out_dir)
    elif args.dataset in SPLITS:
        SPLITS[args.dataset](args.out_dir)
    else:
        raise ValueError(f"split: no split for {args.dataset!r} (one of {sorted(SPLITS)} or all)")


def cmd_target_mask(args) -> None:
    from .target_object_mask import generate_target_object_masks

    if args.dataset != "HUMANISE":
        raise ValueError(f"target_mask: HUMANISE has target objects, not {args.dataset!r}")
    generate_target_object_masks(args.out_dir)


STAGES = {"process": cmd_process, "smplx_to_vec": cmd_smplx_to_vec,
          "process_scene": cmd_process_scene, "contact_data": cmd_contact_data,
          "split": cmd_split, "target_mask": cmd_target_mask, "sort": cmd_sort,
          "geometry": cmd_geometry, "pack": cmd_pack}


def main(argv=None) -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("stage", choices=list(STAGES),
                        help="in this order; target_mask before sort (it reads the contacts' "
                             "row indices, which sort reorders)")
    parser.add_argument("--dataset", type=str, default="H3D")
    parser.add_argument("--data_dir", type=str, default="./data/raw",
                        help="the raw release the process stage reads")
    parser.add_argument("--out_dir", type=str, default="./data")
    parser.add_argument("--num_points", type=int, default=8192)
    parser.add_argument("--region_size", type=float, default=4.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kind", type=str, default="sm", choices=["sm", "seg"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--contact_type", type=str, default="contact_cont_joints")
    parser.add_argument("--contact_joints", type=str, default="0,10,11,12,20,21")
    parser.add_argument("--curve", type=str, default="hilbert", choices=["hilbert", "morton"])
    parser.add_argument("--device", type=str, default="cuda:0",
                        help="device of process (PROX), smplx_to_vec, contact_data and "
                             "geometry (cuda:0, or cpu)")
    args = parser.parse_args(argv)
    # TF32 off for the stage's matmuls, the caller's flags back after it
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        STAGES[args.stage](args)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = flags


if __name__ == "__main__":
    main()

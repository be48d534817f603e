"""Data preparation of the port, the three stages the banded training
deployment needs (counterpart of the root ``prepare.py``'s ``sort``,
``geometry`` and ``pack``, same arguments), for the HumanML3D tree ``H3D``
and for the MotionX sets (``HUMANISE``, ``PROX``, ``HumanML3D``):

    python -m afford_motion_torch.prepare sort --dataset HUMANISE --out_dir <data> [--curve hilbert]
    python -m afford_motion_torch.prepare geometry --dataset HUMANISE --out_dir <data> [--kind sm]
    python -m afford_motion_torch.prepare pack --dataset HUMANISE --out_dir <data>

A set's files are under ``<data>/H3D/`` for H3D and under
``<data>/<set>/contact_motion/`` for a MotionX set. ``sort`` rewrites every
contacts ``.npz`` with its point rows in space-filling-curve order, and a
MotionX item's per-point sidecars (``target_mask/``, ``affordance/``) in the
same order; ``geometry`` caches each item's FPS / kNN
hierarchy (ascending ``fps_idx``, int16 indices, a crc32 of the points it
was built from); ``pack`` bakes contacts and caches into the memmap store the
train loop reads. Run them in this order: the caches hold row positions.
``geometry`` runs on ``cuda:0`` through the port's kernels unless
``--device cpu`` is given; the other two stages are numpy only.
"""
from __future__ import annotations

import argparse
import glob
import os
import zlib

import numpy as np

from .utils.io import get_logger
from .utils.misc import natsorted

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
    from .ops.curves import curve_order

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

    from .models.pointtransformer import (
        SCENEMAP_NSAMPLES, SCENEMAP_STRIDES, SEG_NSAMPLES, SEG_STRIDES)
    from .ops.hierarchy import build_point_hierarchy, geometry_to_arrays
    from .utils.device import resolve_device

    device = resolve_device({}, args.device)
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
    from .data.packed import pack_h3d, pack_motionx

    _contact_files(args)
    joints = [int(j) for j in args.contact_joints.split(",") if j != ""]
    if args.dataset == "H3D":
        pack_h3d(args.out_dir, contact_type=args.contact_type, contact_joints=joints)
    else:
        pack_motionx(args.out_dir, args.dataset, contact_type=args.contact_type,
                     contact_joints=joints)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("stage", choices=["sort", "geometry", "pack"])
    parser.add_argument("--dataset", type=str, default="H3D")
    parser.add_argument("--out_dir", type=str, default="./data")
    parser.add_argument("--kind", type=str, default="sm", choices=["sm", "seg"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--contact_type", type=str, default="contact_cont_joints")
    parser.add_argument("--contact_joints", type=str, default="0,10,11,12,20,21")
    parser.add_argument("--curve", type=str, default="hilbert", choices=["hilbert", "morton"])
    parser.add_argument("--device", type=str, default="cuda:0",
                        help="device of the geometry stage (cuda:0, or cpu)")
    args = parser.parse_args(argv)
    {"sort": cmd_sort, "geometry": cmd_geometry, "pack": cmd_pack}[args.stage](args)


if __name__ == "__main__":
    main()

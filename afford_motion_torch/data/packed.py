"""Packed memory-mapped training store, the host fast path (numpy-only
copy of ``afford_motion_tpu/data/packed.py``).

The live path reads, per item and per epoch, a contacts ``.npz`` (zip parse
plus the full 22-joint dist payload) and a geometry-cache ``.npz``, then
re-runs joint extraction and f16 casts on the host. ``python -m
afford_motion_torch.prepare pack`` bakes the per-item wire format once into
flat ``(N, ...)`` arrays, one ``.npy`` per field, opened with
``mmap_mode='r'``:

- ``xyz16``   (N, P, 3)  f16: scene points (conditioning wire dtype)
- ``dist16``  (N, P, C)  f16: extracted per-joint distances (stage-2
                              conditioning; the sigma kernel is cheap and
                              stays live so one store serves every sigma)
- ``dist32``  (N, P, C)  f32: same, full precision (stage-1 diffusion
                              target; bit-identical to the live path)
- ``geo_*``              geometry-cache fields verbatim (idx int16,
                              up_weight f16)

A field that a consumer never touches costs nothing (mmap pages are only
faulted in on read). ``__getitem__`` becomes a handful of row-view lookups;
the collate stack is the only host copy.

The store is used in train/"all" phases only and only when the dataset's
``half_wire`` wire format is on (the packed f16 fields are that format);
eval/test keep the full-precision live path. Anything missing (store absent,
meta mismatch, base not packed) falls back to the live path per item.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.io import get_logger
from .base import extract_contact

logger = get_logger()

META_NAME = "meta.json"
VERSION = 1


class PackedStore:
    """Read side: memmapped field files + base-name index."""

    def __init__(self, directory: str, meta: Dict, fields: Dict[str, np.ndarray]):
        self.directory = directory
        self.meta = meta
        self.fields = fields
        self.index = {b: i for i, b in enumerate(meta["bases"])}
        self.geo_keys = [k for k in fields if k.startswith("geo_")]

    @classmethod
    def try_open(cls, directory: str, expect: Optional[Dict] = None) -> Optional["PackedStore"]:
        """Open if present and compatible with ``expect``ed meta keys;
        None (with a log line) otherwise."""
        meta_path = os.path.join(directory, META_NAME)
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("version") != VERSION:
                logger.warning(f"packed store {directory}: version mismatch; ignoring")
                return None
            for k, v in (expect or {}).items():
                have = meta.get(k)
                if isinstance(v, (list, tuple)):
                    v, have = list(v), list(have or [])
                if have != v:
                    logger.warning(
                        f"packed store {directory}: {k}={have!r} != expected {v!r}; ignoring"
                    )
                    return None
            fields = {}
            for name in meta["fields"]:
                fields[name] = np.load(
                    os.path.join(directory, name + ".npy"), mmap_mode="r"
                )
            logger.info(
                f"packed store: {len(meta['bases'])} items x "
                f"{len(fields)} fields from {directory}"
            )
            return cls(directory, meta, fields)
        except Exception as e:  # corrupt store -> live path
            logger.warning(f"packed store {directory}: open failed ({e}); ignoring")
            return None

    def row(self, base: str) -> Optional[Dict[str, np.ndarray]]:
        """Per-field row views for one item; None if not packed."""
        i = self.index.get(base)
        if i is None:
            return None
        return {k: v[i] for k, v in self.fields.items()}

    def attach_geometry(self, data: Dict, row: Dict, skip_up: bool,
                        fps_only: bool = False) -> None:
        """Copy the packed geometry-cache fields into a sample dict,
        honouring the fps-only wire and the trans_enc up-array skip (same
        rules as the live ``_load_geometry`` paths). Unread fields never
        fault their mmap pages in."""
        for k in self.geo_keys:
            if fps_only and "_fps_idx" not in k:
                continue
            if skip_up and k.startswith("geo_sm") and (
                "_up_idx" in k or "_up_weight" in k
            ):
                continue
            data[k] = row[k]


def pack_h3d(
    data_dir: str,
    contact_type: str = "contact_cont_joints",
    contact_joints: Sequence[int] = (0, 10, 11, 12, 20, 21),
    out_name: str = "packed",
    kinds: Sequence[str] = ("sm", "seg"),
    limit: int = 0,
) -> str:
    """Bake the H3D contacts + geometry caches into a PackedStore."""
    h3d = os.path.join(data_dir, "H3D")
    bases = [
        os.path.basename(f)[: -len(".npz")]
        for f in sorted(glob.glob(os.path.join(h3d, "contacts", "*.npz")))
    ]
    if limit:
        bases = bases[:limit]
    assert bases, f"no contacts under {h3d}/contacts"
    out_dir = os.path.join(h3d, out_name)

    def geo_files(base: str) -> Dict[str, str]:
        return {
            kind: os.path.join(h3d, f"geometry_{kind}", base + ".npz")
            for kind in kinds
        }

    return _pack(
        out_dir, bases,
        contact_npz=lambda b: os.path.join(h3d, "contacts", b + ".npz"),
        geo_npz=geo_files,
        contact_type=contact_type, contact_joints=list(contact_joints),
    )


def pack_motionx(
    data_dir: str,
    set_name: str,
    contact_type: str = "contact_cont_joints",
    contact_joints: Sequence[int] = (0, 10, 11, 12, 20, 21),
    out_name: str = "packed",
    kinds: Sequence[str] = ("sm", "seg"),
    limit: int = 0,
) -> str:
    """Bake one MotionX set's contact_motion/contacts + geometry caches."""
    base_dir = os.path.join(data_dir, set_name, "contact_motion")
    bases = [
        os.path.basename(f)[: -len(".npz")]
        for f in sorted(glob.glob(os.path.join(base_dir, "contacts", "*.npz")))
    ]
    if limit:
        bases = bases[:limit]
    assert bases, f"no contacts under {base_dir}/contacts"
    out_dir = os.path.join(base_dir, out_name)

    def geo_files(base: str) -> Dict[str, str]:
        return {
            kind: os.path.join(base_dir, f"geometry_{kind}", base + ".npz")
            for kind in kinds
        }

    return _pack(
        out_dir, bases,
        contact_npz=lambda b: os.path.join(base_dir, "contacts", b + ".npz"),
        geo_npz=geo_files,
        contact_type=contact_type, contact_joints=list(contact_joints),
        motion_npy=lambda b: os.path.join(base_dir, "motions", b + ".npy"),
    )


def _pack(out_dir, bases, contact_npz, geo_npz, contact_type, contact_joints,
          motion_npy=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    n = len(bases)

    # geometry-cache staleness guard: caches built BEFORE a `sort` re-run
    # reference pre-sort row positions — their indices would silently
    # train wrong neighborhoods. Each cache npz carries an `fp` crc32 of
    # the exact point bytes it was built from (the prepare geometry stage);
    # load_item verifies it against the points it just read, and any
    # mismatch strips ALL geo fields from the finished pack (fields must
    # be uniform across items; train falls back to the in-step hierarchy
    # build). Caches without `fp` predate the guard and are trusted.
    import zlib

    stale_geo: set = set()  # item bases with any mismatching cache file

    # motion padding cap: one cheap header-only pass over the lengths
    max_len = 0
    if motion_npy is not None:
        for b in bases:
            f = motion_npy(b)
            if not os.path.exists(f):
                motion_npy = None
                break
            max_len = max(max_len, np.load(f, mmap_mode="r").shape[0])

    # per-item Morton monotonicity, ANDed over the WHOLE corpus: a
    # partially sorted corpus (an interrupted `sort` stage, items added
    # after sorting) must not enable the banded windowed kernels. Checked
    # on the full-precision source points (the f16 wire copy would
    # tie-break differently and fail the monotonicity check).
    from ..ops.curves import matching_curves

    curve_flags: list = []

    def load_item(base: str) -> Dict[str, np.ndarray]:
        npz = np.load(contact_npz(base))
        pts = npz["points"].astype(np.float32)
        curve_flags.append(matching_curves(pts[:, :3]))
        dist = extract_contact(
            npz["dist"].astype(np.float32), contact_type, contact_joints
        )
        out = {
            "xyz16": pts[:, :3].astype(np.float16),
            "dist16": dist.astype(np.float16),
            "dist32": dist,
        }
        if pts.shape[1] >= 6:
            out["rgb16"] = pts[:, 3:6].astype(np.float16)
        if motion_npy is not None:
            m = np.load(motion_npy(base)).astype(np.float32)
            m = m.reshape(m.shape[0], -1)
            padded = np.zeros((max_len, m.shape[1]), dtype=np.float32)
            padded[: m.shape[0]] = m
            out["motion32"] = padded
            out["motion_len"] = np.int32(m.shape[0])
        for kind, f in geo_npz(base).items():
            if not os.path.exists(f):
                continue
            g = np.load(f)
            if "fp" in g.files and np.uint32(
                zlib.crc32(pts[:, :3].astype(np.float32).tobytes()) & 0xFFFFFFFF
            ) != g["fp"]:
                stale_geo.add(base)
            for k in g.files:
                if k == "fp":
                    continue
                v = g[k]
                if v.dtype == np.float32 and k.endswith("_up_weight"):
                    v = v.astype(np.float16)
                out[k] = v
        return out

    first = load_item(bases[0])
    writers = {
        k: np.lib.format.open_memmap(
            os.path.join(out_dir, k + ".npy"), mode="w+",
            dtype=v.dtype, shape=(n,) + v.shape,
        )
        for k, v in first.items()
    }
    for i, base in enumerate(bases):
        item = first if i == 0 else load_item(base)
        for k, w in writers.items():
            assert k in item, f"field {k} missing for {base}"
            w[i] = item[k]
        if (i + 1) % 500 == 0 or i + 1 == n:
            logger.info(f"pack {i + 1}/{n}")
    for w in writers.values():
        w.flush()
        del w

    if stale_geo:
        geo_keys = [k for k in writers if k.startswith("geo_")]
        logger.warning(
            f"geometry cache fingerprint mismatch on {len(stale_geo)}/{n} "
            "items (points changed after the cache was built — e.g. "
            "the prepare `sort` stage ran after `geometry`); stripping "
            f"{len(geo_keys)} cached geometry fields from the pack. Re-run "
            "the `geometry` stage then `pack` to restore the fps wire."
        )
        for k in geo_keys:
            del writers[k]
            try:
                os.remove(os.path.join(out_dir, k + ".npy"))
            except OSError:
                pass

    # banded-eligibility: every item must be monotone under SOME locality
    # curve (window locality is per-item; the label itself is irrelevant
    # at runtime — degenerate clouds can match both). meta['morton'] keeps
    # its historical name ("banded-eligible order"); meta['curve'] reports
    # a curve every item matches, else 'mixed'.
    is_sorted = bool(curve_flags) and all(curve_flags)
    curve = None
    if is_sorted:
        common = set(curve_flags[0])
        for flags in curve_flags[1:]:
            common &= set(flags)
        curve = min(common) if common else "mixed"
    elif curve_flags:
        n_bad = sum(1 for flags in curve_flags if not flags)
        logger.warning(
            f"{n_bad}/{len(curve_flags)} items are not curve-sorted; "
            "banded kernels will stay off for this store "
            "(run the prepare `sort` stage then re-run geometry + pack)"
        )
    meta = {
        "version": VERSION,
        "contact_type": contact_type,
        "contact_joints": list(contact_joints),
        "bases": list(bases),
        "fields": sorted(writers.keys()),
        "morton": is_sorted,
        "curve": curve if is_sorted else None,
    }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    logger.info(f"packed {n} items -> {out_dir}")
    return out_dir

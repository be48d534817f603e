"""Device-resident training corpus (counterpart of
``afford_motion_tpu/train/device_store.py``): the corpus is uploaded to the
card once and the host streams only indices.

On a prepared tree (``prepare sort|geometry|pack``, the fps geometry wire,
``half_wire_x``) the store holds, on the card:

- ``motion16``  (n_names, L_max, D) f16: normalized motions, the exact
  ``half_wire_x`` wire values (normalization is per frame, so cropping
  commutes with it);
- ``length``    (n_names,) int32 and ``scene_row`` (n_names,) int32;
- ``xyz16``     (n_scenes, P, 3) f16 and ``dist16`` (n_scenes, P, C) f16,
  straight from the packed store (``data/packed.py``);
- ``geo_*_fps_idx``, the fps-only geometry wire, and (``add_geometry_cache``)
  the rest of each scene's hierarchy, computed once at upload with the same
  kernels the in-step rebuild would launch.

The caption choice, the crop start, the contact-mix draw and the CFG flag
draws stay on the host (:meth:`DeviceStore.draw_batch`, the dataset's
``__getitem__`` semantics and generator order); their results ride in a
batch of a few hundred bytes plus the caption embedding, and
:func:`make_assemble_fn` builds ``(x, cond)`` from it on the card.
``mix_train_ratio`` > 0 ships the mixed items' contact override as a
(B, P, C) f16 operand.

The stage-1 store (``ContactHumanML3DDataset``, the t2m contact set) holds
``xyz16``, the f32 distances ``dist32`` and the fps wire: the host draws
only the captions, and the card computes the diffusion target
normalize(exp(-0.5 dist^2 / sigma^2)) in f32, as the dataset's ``__getitem__``
does on the host.

The MotionX stores (``ContactMotionDataset`` and ``ContactMapDataset`` over
the per-set packed stores, concatenated in set order) hold the raw motions
in f32 (``motion32``: they are normalized after the rotation, by per-channel
stds that can be small, so an f16 copy would amplify its rounding), their
lengths, the f16 clouds and distances (stage 1: the f32 distances and the
f16 colours ``rgb16``) and the fps wire. The ``RandomRotation`` of the train
chain moves onto the card: the host draws the angle at the chain's place in
the numpy stream, and the card rotates the cloud (and the motion's joints)
about the z axis in f32, then normalizes; padding frames normalize to
(0 - mean) / std, as on the host.

:meth:`DeviceStore.try_build` returns None, and the loop takes the host
pipeline, wherever a requirement does not hold.
"""
from __future__ import annotations

import os
import random
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import from_bits, to_bits
from ..utils.io import get_logger

logger = get_logger()


def max_bytes_from_env() -> int:
    """The store's budget on the card: ``AM_DEVICE_STORE_MAX_GB`` (default
    8) GiB, the corpus and the geometry cache together."""
    return int(float(os.environ.get("AM_DEVICE_STORE_MAX_GB", "8")) * (1 << 30))


# CFG transforms that are one np.random draw per item each
# (data/transforms.py): draw_batch replays them in chain order, after the
# item's other draws, and ships the outcomes as (B, 1) bool flags. This
# covers the flagship stage-2 chain ['RandomEraseLang', 'RandomEraseContact',
# 'NumpyToTensor'].
_FLAG_TRANSFORMS = {
    "RandomMaskLang": ("c_text_mask", "random_mask_prob"),
    "RandomEraseLang": ("c_text_erase", "random_mask_prob"),
    "RandomMaskContact": ("c_pc_mask", "random_mask_prob_pc"),
    "RandomEraseContact": ("c_pc_erase", "random_mask_prob_pc"),
    "RandomSetLangNull": ("__lang_null__", "random_mask_prob"),
    # RandomSetContactNull is not here: it zeroes the cloud itself, which
    # the cached hierarchy is built from. Chains with it take the host
    # pipeline.
}

# scenes a hierarchy build of the geometry cache takes at once
GEOMETRY_CHUNK = 64

# arrays of at most this many bytes stay replicated when the store shards
# its rows over the ranks, as in the JAX store (``shard_over_mesh``); the
# item -> scene table stays replicated at any size, since it addresses the
# scene arrays
SHARD_MIN_BYTES = 1 << 20
REPLICATED = ("scene_row",)

# the MotionX train chains the stores replay: the rotation (stage 2 moves
# points and motion, stage 1 points only) or nothing
MOTIONX_CHAIN = ["RandomRotation", "ApplyTransformCMDM", "NumpyToTensor"]
MOTIONX_CONTACT_CHAINS = [["NumpyToTensor"],
                          ["RandomRotation", "ApplyTransformCDM", "NumpyToTensor"]]


def _flag_chain(dataset, base=("NumpyToTensor",)):
    """Ordered (key, prob) draw plan of the CFG flag transforms in the
    dataset's train chain; None if the chain holds anything beyond ``base``
    and flag transforms."""
    tcfg = dict(dataset.cfg.get("transform_cfg", {}) or {})
    chain = []
    for t in list(dataset.cfg.get("train_transforms", [])):
        if t in base:
            continue
        if t not in _FLAG_TRANSFORMS:
            return None
        key, pk = _FLAG_TRANSFORMS[t]
        chain.append((key, float(tcfg.get(pk, 0.0) or 0.0)))
    return chain


def _draw_flags(chain, j, captions, flags, npr) -> None:
    """Replay the flag-transform chain for item ``j``: one ``npr`` draw per
    transform, as the dataset's transform chain makes it."""
    for key, prob in chain:
        draw = bool(npr.rand() < prob)
        if key == "__lang_null__":
            if draw:
                captions[j] = ""
        else:
            flags[key][j, 0] = draw


def _to_device(v, device: torch.device) -> torch.Tensor:
    """A host array (possibly a read-only memmap) or a tensor, copied to
    ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    with warnings.catch_warnings():
        # a read-only memmap: torch only reads it here, into a copy
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(v)).to(device, copy=True)


class DeviceStore:
    """The corpus's arrays (host numpy until :meth:`ensure_device`) and what
    the host needs to draw batches from it (``meta``).

    In a data-parallel run (``dp``, a :class:`~..parallel.mesh.DataParallel`)
    every rank holds the index batch of the global batch and :meth:`fetch`
    returns this rank's rows of ``arrays[key][rows]``: from a replicated
    array by a local gather, from one :meth:`shard_rows` split over the
    ranks by the owners' gathers and a sum-reduce-scatter. ``sharded`` maps
    each split array to (the rows a rank holds, the rows of the whole)."""

    def __init__(self, arrays: Dict[str, Any], meta: Dict[str, Any]):
        self.arrays = arrays
        self.meta = meta
        self.dp = None
        self.sharded: Dict[str, Tuple[int, int]] = {}

    def ensure_device(self, device="cuda") -> None:
        """Upload every array still on the host to ``device`` (the card
        unless the caller names another); arrays already there stay."""
        dev = torch.device(device)
        for k, v in self.arrays.items():
            if not (isinstance(v, torch.Tensor) and v.device == dev):
                self.arrays[k] = _to_device(v, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def nbytes(self) -> int:
        """Bytes this process holds (its shard of a sharded array)."""
        return sum(int(np.prod(v.shape)) * v.dtype.itemsize if isinstance(v, np.ndarray)
                   else v.numel() * v.element_size() for v in self.arrays.values())

    def shard_rows(self, dp, min_bytes: Optional[int] = None) -> None:
        """Split the corpus's rows over the ranks of ``dp`` (counterpart of
        the JAX store's ``shard_over_mesh``), before the upload: an array of
        more than ``min_bytes`` is padded with zero rows to a multiple of the
        world and each rank keeps rows ``[r n, (r + 1) n)`` of it, host-staged,
        so that the whole corpus never passes through one card; smaller ones,
        and the item -> scene table that addresses other arrays, stay
        replicated. The pad rows are never addressed: every index comes from
        the real item and scene tables. :meth:`add_geometry_cache` then
        computes the cache of this rank's scenes only. ``min_bytes``
        defaults to ``SHARD_MIN_BYTES``."""
        min_bytes = SHARD_MIN_BYTES if min_bytes is None else min_bytes
        self.dp = dp
        W, r = dp.world, dp.rank
        for k, v in list(self.arrays.items()):
            if W == 1 or k in REPLICATED or v.ndim == 0 or v.nbytes <= min_bytes:
                continue
            n = -(-v.shape[0] // W)
            local = np.zeros((n,) + v.shape[1:], v.dtype)
            real = v[r * n:min((r + 1) * n, v.shape[0])]
            local[:real.shape[0]] = real
            self.arrays[k] = local
            self.sharded[k] = (n, v.shape[0])
        if self.sharded:
            logger.info(f"device store: {len(self.sharded)} arrays sharded over {W} ranks, "
                        f"{self.nbytes() / 1e9:.3f}GB on this rank")

    def local_block(self, key: str, n_rows: int) -> np.ndarray:
        """The rows of host array ``key`` that this rank owns when an array of
        ``n_rows`` rows is split over the ranks: its own shard, or the same
        range of a replicated array, the pad rows left out."""
        n = -(-n_rows // self.dp.world)
        lo = self.dp.rank * n
        v = self.arrays[key]
        if key in self.sharded:
            return v[:max(0, min(n, n_rows - lo))]
        return v[lo:min(lo + n, n_rows)]

    def fetch(self, key: str, rows: torch.Tensor) -> torch.Tensor:
        """This process's rows of ``arrays[key][rows]`` on the store's
        device, ``rows`` the index list of the global batch: all of it
        without a group. A sharded array: each rank gathers the rows it owns
        for the whole list and zeros elsewhere, as integers of the rows'
        bits, and a sum-reduce-scatter hands each rank its slice. One owner
        a row, so the result is the replicated fetch's bit for bit."""
        A = self.arrays[key]
        if self.dp is None:
            return A.index_select(0, rows)
        if key not in self.sharded:
            return A.index_select(0, rows[self.dp.local_rows(rows.shape[0])])
        n = self.sharded[key][0]
        local = rows.long() - self.dp.rank * n
        owned = (local >= 0) & (local < n)
        picked = to_bits(A.index_select(0, local.clamp(0, n - 1)))
        picked = torch.where(owned.reshape((-1,) + (1,) * (picked.ndim - 1)), picked,
                             torch.zeros((), dtype=picked.dtype, device=picked.device))
        return from_bits(self.dp.reduce_scatter_rows(picked), A.dtype)

    def lookup(self, key: str, rows: torch.Tensor) -> torch.Tensor:
        """``arrays[key][rows]`` whole, for a replicated table that addresses
        other arrays (the item -> scene rows)."""
        if key in self.sharded:
            raise KeyError(f"{key} is sharded; lookup reads replicated tables only")
        return self.arrays[key].index_select(0, rows)

    # -------------------------------------------------------------- build
    @classmethod
    def try_build(cls, dataset, max_bytes: Optional[int] = None) -> Optional["DeviceStore"]:
        """The store of ``dataset`` (by its exact class: the sample-mode
        subclasses do not match), or None where the requirements do not
        hold or the corpus exceeds ``max_bytes`` (default: one card's
        budget); the caller then takes the host pipeline."""
        builders = {"ContactMotionHumanML3DDataset": cls._try_build_h3d,
                    "ContactMotionDataset": cls._try_build_motionx,
                    "ContactHumanML3DDataset": cls._try_build_h3d_contact,
                    "ContactMapDataset": cls._try_build_motionx_contact}
        build = builders.get(type(dataset).__name__)
        budget = max_bytes_from_env() if max_bytes is None else max_bytes
        return build(dataset, budget) if build else None

    @staticmethod
    def _common_gate(dataset, allowed_transforms) -> bool:
        """A train phase, a train transform chain among
        ``allowed_transforms`` and the fps geometry wire."""
        if getattr(dataset, "phase", "") not in ("train", "all"):
            return False
        if list(dataset.cfg.get("train_transforms", [])) not in allowed_transforms:
            return False
        return str(dataset.cfg.get("geometry_wire", "full")) == "fps"

    @classmethod
    def _try_build_h3d(cls, dataset, max_bytes: int) -> Optional["DeviceStore"]:
        """ContactMotionHumanML3D: motions from the in-memory corpus, scenes
        from the packed store."""
        needed = ("name_list", "data_dict", "mean", "std", "max_horizon",
                  "unit_length", "sigma", "use_raw_dist")
        if not all(hasattr(dataset, a) for a in needed):
            return None
        if getattr(dataset, "phase", "") not in ("train", "all"):
            return None
        if getattr(dataset, "_x16", False) is False:
            return None  # the motion store is the f16 wire format
        packed = getattr(dataset, "_packed", None)
        if packed is None or isinstance(packed, dict):
            return None
        if "xyz16" not in packed.fields or "dist16" not in packed.fields:
            return None
        flag_chain = _flag_chain(dataset)
        if flag_chain is None:
            return None
        if str(dataset.cfg.get("geometry_wire", "full")) != "fps":
            return None

        names = list(dataset.name_list)
        bases = [n.split("_")[-1] for n in names]
        if any(b not in packed.index for b in bases):
            return None

        lengths = np.array([int(dataset.data_dict[n]["length"]) for n in names], dtype=np.int32)
        L_max = int(lengths.max())
        D = dataset.data_dict[names[0]]["motion"].shape[-1]
        motion16 = np.zeros((len(names), L_max, D), dtype=np.float16)
        for i, n in enumerate(names):
            m = dataset.data_dict[n]["motion"][: lengths[i]]
            motion16[i, : lengths[i]] = dataset.normalize(
                np.asarray(m, dtype=np.float32)).astype(np.float16)

        host: Dict[str, np.ndarray] = {
            "motion16": motion16,
            "length": lengths,
            "scene_row": np.array([packed.index[b] for b in bases], dtype=np.int32),
            "xyz16": packed.fields["xyz16"],
            "dist16": packed.fields["dist16"],
        }
        for k in packed.geo_keys:
            if "_fps_idx" in k:
                host[k] = packed.fields[k]

        total = sum(v.nbytes for v in host.values())
        if total > max_bytes:
            logger.info(f"device store: corpus {total / 1e9:.2f}GB exceeds the "
                        f"{max_bytes / 1e9:.1f}GB budget; using the host pipeline")
            return None
        logger.info(f"device store: staging {total / 1e9:.2f}GB ({len(names)} motions, "
                    f"{host['xyz16'].shape[0]} scenes) for the device upload")
        meta = {
            "kind": "h3d",
            "n_items": len(names),
            "max_horizon": int(dataset.max_horizon),
            "unit_length": int(dataset.unit_length),
            "sigma": float(dataset.sigma),
            "use_raw_dist": bool(dataset.use_raw_dist),
            "motion_dim": int(D),
            "mix": float(dataset.cfg.get("mix_train_ratio", 0.0) or 0.0) > 0
            and bool(getattr(dataset, "pred_contact_dict", None)),
            "flag_chain": flag_chain,
        }
        return cls(host, meta)

    @classmethod
    def _try_build_h3d_contact(cls, dataset, max_bytes: int) -> Optional["DeviceStore"]:
        """ContactHumanML3D (stage 1): the packed store's clouds and f32
        distances, whose kernel the card computes in f32, so that the
        diffusion target is the host path's."""
        packed = getattr(dataset, "_packed", None)
        if packed is None or isinstance(packed, dict):
            return None
        if not cls._common_gate(dataset, [["NumpyToTensor"]]) or "dist32" not in packed.fields:
            return None
        names = list(dataset.name_list)
        bases = [n.split("_")[-1] for n in names]
        if any(b not in packed.index for b in bases):
            return None
        host: Dict[str, Any] = {
            "scene_row": np.array([packed.index[b] for b in bases], dtype=np.int32),
            "xyz16": packed.fields["xyz16"],
            "dist32": packed.fields["dist32"],
        }
        for k in packed.geo_keys:
            if "_fps_idx" in k:
                host[k] = packed.fields[k]
        total = sum(v.nbytes for v in host.values())
        if total > max_bytes:
            logger.info(f"device store: corpus {total / 1e9:.2f}GB exceeds the "
                        f"{max_bytes / 1e9:.1f}GB budget; using the host pipeline")
            return None
        logger.info(f"device store: staging {total / 1e9:.2f}GB ({len(names)} stage-1 items, "
                    f"{host['xyz16'].shape[0]} scenes) for the device upload")
        meta = {
            "kind": "h3d_contact",
            "n_items": len(names),
            "sigma": float(dataset.sigma),
            "use_raw_dist": bool(dataset.use_raw_dist),
            "mean": np.asarray(dataset.mean, dtype=np.float32),
            "std": np.asarray(dataset.std, dtype=np.float32),
        }
        return cls(host, meta)

    @classmethod
    def _try_build_motionx(cls, dataset, max_bytes: int) -> Optional["DeviceStore"]:
        """ContactMotionDataset over the MotionX sets: motions and scenes
        from the per-set packed stores; the rotation of the train chain runs
        on the card."""
        needed = ("all_data", "mean", "std", "max_horizon", "sigma", "use_raw_dist",
                  "contact_type")
        if not all(hasattr(dataset, a) for a in needed):
            return None
        if getattr(dataset, "phase", "") not in ("train", "all"):
            return None
        if getattr(dataset, "_x16", False) is False:
            return None
        stores = getattr(dataset, "_packed", None)
        if not isinstance(stores, dict) or not stores:
            return None
        tlist = list(dataset.cfg.get("train_transforms", []))
        rotate = tlist == MOTIONX_CHAIN
        if not rotate and any(t != "NumpyToTensor" for t in tlist):
            return None
        if rotate and _gravity_dim(dataset) != 2:
            return None  # the published configs are z-up
        if str(dataset.cfg.get("geometry_wire", "full")) != "fps":
            return None
        if any(not {"xyz16", "dist16", "motion32", "motion_len"} <= set(st.fields)
               for st in stores.values()):
            return None
        sets, offsets, rows = _store_rows(dataset, stores)
        if rows is None:
            return None

        n_sc = sum(len(stores[s].meta["bases"]) for s in sets)
        L_max = max(int(stores[s].fields["motion32"].shape[1]) for s in sets)
        D = int(stores[sets[0]].fields["motion32"].shape[2])
        motion = np.zeros((n_sc, L_max, D), dtype=np.float32)
        length = np.zeros((n_sc,), dtype=np.int32)
        for s in sets:
            st = stores[s]
            a, b = offsets[s], offsets[s] + len(st.meta["bases"])
            m = np.asarray(st.fields["motion32"])
            motion[a:b, : m.shape[1]] = m
            length[a:b] = np.asarray(st.fields["motion_len"])
        host: Dict[str, np.ndarray] = {"motion32": motion, "length": length}
        host.update(_concat_fields(stores, sets, ["xyz16", "dist16"]))
        host["scene_row"] = np.arange(n_sc, dtype=np.int32)  # one scene an item

        total = sum(v.nbytes for v in host.values())
        if total > max_bytes:
            logger.info(f"device store: corpus {total / 1e9:.2f}GB exceeds the "
                        f"{max_bytes / 1e9:.1f}GB budget; using the host pipeline")
            return None
        logger.info(f"device store: staging {total / 1e9:.2f}GB ({len(rows)} items over "
                    f"{sets}) for the device upload")
        meta = {
            "kind": "motionx",
            "item_store_row": np.asarray(rows, dtype=np.int32),
            "n_items": len(rows),
            "max_horizon": int(dataset.max_horizon),
            "sigma": float(dataset.sigma),
            "use_raw_dist": bool(dataset.use_raw_dist),
            "motion_dim": D,
            "rotate": rotate,
            "mean": np.asarray(dataset.mean, dtype=np.float32),
            "std": np.asarray(dataset.std, dtype=np.float32),
            "mix": float(dataset.cfg.get("mix_train_ratio", 0.0) or 0.0) > 0,
        }
        return cls(host, meta)

    @classmethod
    def _try_build_motionx_contact(cls, dataset, max_bytes: int) -> Optional["DeviceStore"]:
        """ContactMapDataset (stage 1) over the MotionX sets: the h3d_contact
        store's fields, plus the f16 colours where the dataset reads them,
        and the rotation of the cloud on the card (the contact target does
        not move)."""
        stores = getattr(dataset, "_packed", None)
        if not isinstance(stores, dict) or not stores:
            return None
        if not cls._common_gate(dataset, MOTIONX_CONTACT_CHAINS):
            return None
        rotate = "RandomRotation" in list(dataset.cfg.get("train_transforms", []))
        if rotate and _gravity_dim(dataset) != 2:
            return None
        use_color = bool(getattr(dataset, "use_color", False))
        need = {"xyz16", "dist32"} | ({"rgb16"} if use_color else set())
        if any(not need <= set(st.fields) for st in stores.values()):
            return None
        sets, _, rows = _store_rows(dataset, stores)
        if rows is None:
            return None
        n_sc = sum(len(stores[s].meta["bases"]) for s in sets)
        host = {"scene_row": np.arange(n_sc, dtype=np.int32)}
        host.update(_concat_fields(stores, sets,
                                   ["xyz16", "dist32"] + (["rgb16"] if use_color else [])))
        total = sum(v.nbytes for v in host.values())
        if total > max_bytes:
            logger.info(f"device store: corpus {total / 1e9:.2f}GB exceeds the "
                        f"{max_bytes / 1e9:.1f}GB budget; using the host pipeline")
            return None
        logger.info(f"device store: staging {total / 1e9:.2f}GB ({len(rows)} stage-1 items, "
                    f"{n_sc} scenes) for the device upload")
        meta = {
            "kind": "motionx_contact",
            "item_store_row": np.asarray(rows, dtype=np.int32),
            "n_items": len(rows),
            "sigma": float(dataset.sigma),
            "use_raw_dist": bool(dataset.use_raw_dist),
            "rotate": rotate,
            "use_color": use_color,
            "mean": np.asarray(dataset.mean, dtype=np.float32),
            "std": np.asarray(dataset.std, dtype=np.float32),
        }
        return cls(host, meta)

    # ----------------------------------------------------- geometry cache
    def add_geometry_cache(self, model, device="cuda", max_bytes: Optional[int] = None) -> bool:
        """Compute each scene's whole hierarchy (kNN, down-kNN and, where the
        model reads it, the 3-NN up) from the stored fps wire once, on
        ``device``, ``GEOMETRY_CHUNK`` scenes at a time, and keep it with the
        corpus, so that the step's ``add_hierarchies`` takes its cached
        branch instead of running the kNN every step: each hierarchy the
        model reads (``conditioning.hierarchy_specs``) whose fps wire the
        store holds. The cache comes from the kernels the in-step rebuild
        would launch (the banded kNN when ``model.use_banded``), so the
        numerics do not change. Every index field depends on distances only,
        so it holds under rigid augmentation.

        Index fields are stored as int16 below 2^15 parents. Within
        ``max_bytes`` (the corpus included) whole levels are kept from the
        deepest up and the first that does not fit, and every shallower one,
        is rebuilt in the step; ``AM_DEVICE_GEO=off`` turns the cache off.
        Returns True when anything was cached."""
        if os.environ.get("AM_DEVICE_GEO", "auto") == "off":
            return False
        from ..models.conditioning import hierarchy_specs
        from ..ops.hierarchy import build_point_hierarchy_from_fps, geometry_to_arrays

        max_bytes = max_bytes_from_env() if max_bytes is None else max_bytes
        specs = [s[1:] for s in hierarchy_specs(model) if f"{s[1]}1_fps_idx" in self.arrays
                 and f"{s[1]}0_knn_idx" not in self.arrays]
        if not specs:
            return False
        dev = torch.device(device)
        knobs = dict(banded=bool(model.use_banded),
                     knn_method="exact" if model.knn_exact else None,
                     window=int(model.banded_window or 0), adaptive=model.banded_adaptive)
        # a sharded cloud array: the cache of this rank's scenes, sharded
        # with them (pad rows zero, never addressed)
        shard = "xyz16" in self.sharded
        n_sc = self.sharded["xyz16"][1] if shard else self.arrays["xyz16"].shape[0]
        xyz = self.local_block("xyz16", n_sc) if shard else self.arrays["xyz16"]

        outs: Dict[str, list] = {}
        with torch.no_grad():
            for prefix, strides, nsamples, with_up in specs:
                fps_keys = [k for k in self.arrays
                            if k.startswith(prefix) and k.endswith("_fps_idx")]
                fps_host = {k: self.local_block(k, n_sc) if shard else self.arrays[k]
                            for k in fps_keys}
                for a in range(0, xyz.shape[0], GEOMETRY_CHUNK):
                    b = min(a + GEOMETRY_CHUNK, xyz.shape[0])
                    fps = {k: _to_device(v[a:b], dev) for k, v in fps_host.items()}
                    levels = build_point_hierarchy_from_fps(
                        _to_device(xyz[a:b], dev).float(), fps, strides, nsamples,
                        prefix=prefix, with_up=with_up, **knobs)
                    for k, v in geometry_to_arrays(levels, prefix=prefix).items():
                        if k.endswith("_fps_idx"):
                            continue  # stored already: the wire itself
                        outs.setdefault(k, []).append(v.cpu().numpy())
        new_host = {k: np.concatenate(parts, axis=0) for k, parts in outs.items()}
        if not new_host:
            return False
        # index fields as int16 below 2^15 parents, the same type on every rank
        top = {k: int(v.max(initial=0)) for k, v in new_host.items() if k.endswith("_idx")}
        if shard:
            top = {k: max(t[k] for t in self.dp.gather_objects(top)) for k in top}
        for k, t in top.items():
            new_host[k] = new_host[k].astype(np.int16 if t + 1 < (1 << 15) else np.int32)
        if shard:  # pad to the rows a rank holds
            n = self.sharded["xyz16"][0]
            for k, v in new_host.items():
                new_host[k] = np.concatenate([v, np.zeros((n - len(v),) + v.shape[1:], v.dtype)])

        # partial caching under the budget, deepest levels first: at the
        # real corpus's scale the full cache may not fit beside the corpus;
        # deep levels are small (a scene's bytes shrink ~4x a level) while
        # level 0's kNN is the largest field. build_point_hierarchy_from_fps
        # takes any cached subset and computes what is missing.
        def level_of(key):   # geo_sm2_knn_idx -> 2
            return int(key.split("_")[1].lstrip("abcdefghijklmnopqrstuvwxyz"))

        level_bytes: Dict[int, int] = {}
        for k, v in new_host.items():
            level_bytes[level_of(k)] = level_bytes.get(level_of(k), 0) + v.nbytes
        budget_left = max_bytes - self.nbytes()
        kept_levels = set()
        for level in sorted(level_bytes, reverse=True):
            if level_bytes[level] > budget_left:
                break  # the kept levels stay a contiguous deep suffix
            kept_levels.add(level)
            budget_left -= level_bytes[level]
        kept = {k: v for k, v in new_host.items() if level_of(k) in kept_levels}
        if not kept:
            logger.info(f"device store: geometry cache "
                        f"({sum(v.nbytes for v in new_host.values()) / 1e9:.2f}GB) exceeds the "
                        f"{max_bytes / 1e9:.1f}GB budget; keeping the in-step kNN rebuild")
            return False
        dropped = len(new_host) - len(kept)
        add = sum(v.nbytes for v in kept.values())
        logger.info(f"device store: caching hierarchy geometry ({add / 1e9:.2f}GB, "
                    f"{len(kept)}/{len(new_host)} fields for {n_sc} scenes) on the device"
                    + (f"; {dropped} shallow-level fields rebuilt in-step (budget)"
                       if dropped else ""))
        self.arrays.update(kept)
        if shard:
            self.sharded.update({k: self.sharded["xyz16"] for k in kept})
        return True

    # ---------------------------------------------------------- host side
    def draw_batch(self, dataset, item_ids, py_rng: random.Random,
                   np_rng: np.random.RandomState,
                   own: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """The host's random choices for a batch of dataset item ids, with
        the dataset's ``__getitem__`` semantics and generator order: per
        item the caption and the crop start from ``py_rng``, then one
        ``np_rng`` draw for the contact mix (whatever the mix ratio), then
        the flag chain; for the MotionX sets the caption from ``py_rng``,
        then from ``np_rng`` the mix draw (stage 2) and the rotation angle.
        Explicit generators keep the stream a function of the caller's seed
        whatever other threads draw. ``own`` (positions in ``item_ids``): the
        rows this process keeps; every draw is made for every row, but a
        mix file is read for these rows only (the others' stay zero)."""
        loads = np.ones((len(item_ids),), bool)
        if own is not None:
            loads[:] = False
            loads[own] = True
        if self.meta["kind"] == "motionx":
            return self._draw_batch_motionx(dataset, item_ids, py_rng, np_rng, loads)
        if self.meta["kind"] == "h3d_contact":
            return self._draw_batch_contact(dataset, item_ids, py_rng)
        if self.meta["kind"] == "motionx_contact":
            return self._draw_batch_motionx_contact(dataset, item_ids, py_rng, np_rng)
        rnd, npr = py_rng, np_rng
        B = len(item_ids)
        crop_start = np.zeros((B,), np.int32)
        crop_len = np.zeros((B,), np.int32)
        captions = []
        mix_contact = mix_mask = None
        if self.meta["mix"]:
            P, C = self.arrays["dist16"].shape[1:]
            mix_contact = np.zeros((B, P, C), np.float16)
            mix_mask = np.zeros((B,), bool)
        chain = self.meta.get("flag_chain") or []
        flags = {k: np.zeros((B, 1), bool) for k, _ in chain if k != "__lang_null__"}
        u = self.meta["unit_length"]
        for j, idx in enumerate(item_ids):
            name = dataset.name_list[dataset.indices[idx]]
            item = dataset.data_dict[name]
            captions.append(dataset._pick_caption(item["text"], rnd)["caption"])
            L = int(item["length"])
            m_len = (L // u) * u
            crop_start[j] = rnd.randint(0, L - m_len)
            crop_len[j] = m_len
            mixed = npr.random() < getattr(dataset, "mix_train_ratio", 0.0)
            if mixed and mix_contact is not None:
                cands = getattr(dataset, "pred_contact_dict", {}).get(name.split("_")[-1], [])
                if cands:
                    from .. import native as nio

                    path = npr.choice(cands)
                    if loads[j]:
                        mix_contact[j] = nio.load(path).squeeze(0).astype(np.float16)
                    mix_mask[j] = True
            _draw_flags(chain, j, captions, flags, npr)
        out = {
            "item_row": np.array([dataset.indices[i] for i in item_ids], dtype=np.int32),
            "crop_start": crop_start,
            "crop_len": crop_len,
            "c_text": captions,
        }
        if mix_contact is not None:
            out["mix_contact"] = mix_contact
            out["mix_mask"] = mix_mask
        out.update(flags)
        return out


    @staticmethod
    def _draw_batch_contact(dataset, item_ids, py_rng: random.Random) -> Dict[str, Any]:
        """Stage 1: the caption of each item, from ``py_rng`` as
        ``__getitem__`` draws it."""
        rows = np.array([dataset.indices[i] for i in item_ids], dtype=np.int32)
        captions = [dataset._pick_caption(dataset.data_dict[dataset.name_list[r]]["text"],
                                          py_rng)["caption"] for r in rows]
        return {"item_row": rows, "c_text": captions}

    def _draw_batch_motionx(self, dataset, item_ids, py_rng: random.Random,
                            np_rng: np.random.RandomState,
                            loads: np.ndarray) -> Dict[str, Any]:
        """Stage 2 over the MotionX sets. Per item: the caption from
        ``py_rng``; from ``np_rng`` the mix draw (``_load_contact``), where
        it hits, the item's ``pred_contact`` file, if there is one, as its
        contact (f16); then the rotation angle (``RandomRotation``)."""
        B = len(item_ids)
        rows = np.zeros((B,), np.int32)
        captions = []
        angle = np.zeros((B,), np.float32) if self.meta["rotate"] else None
        mix_contact = mix_mask = None
        if self.meta["mix"]:
            P, C = self.arrays["dist16"].shape[1:]
            mix_contact = np.zeros((B, P, C), np.float16)
            mix_mask = np.zeros((B,), bool)
        store_rows = self.meta["item_store_row"]
        for j, idx in enumerate(item_ids):
            resolved = dataset.indices[idx]
            s, i, _scene_id, _trans, desc = dataset.all_data[resolved]
            rows[j] = store_rows[resolved]
            captions.append(dataset._pick_text(desc, py_rng))
            mixed = np_rng.random() < getattr(dataset, "mix_train_ratio", 0.0)
            if mixed and mix_contact is not None:
                f = os.path.join(dataset.data_dir, s, "pred_contact", f"{i:05d}.npy")
                if os.path.exists(f):
                    from .. import native as nio

                    if loads[j]:
                        mix_contact[j] = nio.load(f).squeeze(0).astype(np.float16)
                    mix_mask[j] = True
            if angle is not None:
                angle[j] = np_rng.uniform(-1.0, 1.0) * np.pi
        out: Dict[str, Any] = {"item_row": rows, "c_text": captions}
        if angle is not None:
            out["aug_angle"] = angle
        if mix_contact is not None:
            out["mix_contact"] = mix_contact
            out["mix_mask"] = mix_mask
        return out

    def _draw_batch_motionx_contact(self, dataset, item_ids, py_rng: random.Random,
                                    np_rng: np.random.RandomState) -> Dict[str, Any]:
        """Stage 1 over the MotionX sets: per item the caption from
        ``py_rng``, then the rotation angle from ``np_rng``."""
        rows = np.zeros((len(item_ids),), np.int32)
        captions = []
        angle = np.zeros((len(item_ids),), np.float32) if self.meta["rotate"] else None
        for j, idx in enumerate(item_ids):
            resolved = dataset.indices[idx]
            rows[j] = self.meta["item_store_row"][resolved]
            captions.append(dataset._pick_text(dataset.all_data[resolved][4], py_rng))
            if angle is not None:
                angle[j] = np_rng.uniform(-1.0, 1.0) * np.pi
        out: Dict[str, Any] = {"item_row": rows, "c_text": captions}
        if angle is not None:
            out["aug_angle"] = angle
        return out


def _gravity_dim(dataset) -> int:
    return int(dataset.cfg.get("transform_cfg", {}).get("gravity_dim", 2))


def _store_rows(dataset, stores):
    """(the sets in order, each set's first row in the concatenated store,
    each dataset item's row there); the rows are None where an item is not
    in its set's store."""
    sets = sorted(stores)
    offsets, off = {}, 0
    for s in sets:
        offsets[s] = off
        off += len(stores[s].meta["bases"])
    rows = []
    for s, i, *_ in dataset.all_data:
        st = stores.get(s)
        if st is None or f"{i:05d}" not in st.index:
            return sets, offsets, None
        rows.append(offsets[s] + st.index[f"{i:05d}"])
    return sets, offsets, rows


def _concat_fields(stores, sets, fields) -> Dict[str, np.ndarray]:
    """``fields`` and the fps wire of the first set's store, each the sets'
    rows concatenated in order."""
    fields = list(fields) + [k for k in stores[sets[0]].geo_keys if "_fps_idx" in k]
    return {f: np.concatenate([np.asarray(stores[s].fields[f]) for s in sets], axis=0)
            for f in fields}


def index_stream(n_items: int, G: int, B: int, start_step: int, base_seed: int,
                 loader_seed: int) -> Iterator[np.ndarray]:
    """Endless stream of (G*B,) dataset-index chunks, the store route's only
    data-selection state. Each pass over the corpus draws one seeded
    permutation (the loop's seed and the loader's shuffle seed folded in),
    cut into G*B chunks; a resume at ``start_step`` re-enters the chunk the
    straight run would be at."""
    chunk = G * B
    chunks_per_ep = max(1, n_items // chunk)
    steps_per_pass = chunks_per_ep * G
    ep = start_step // steps_per_pass
    skip = (start_step % steps_per_pass) // G
    while True:
        order = np.random.default_rng(
            (base_seed * 977 + loader_seed * 9176 + ep) & 0x7FFFFFFF).permutation(n_items)
        for s in range(skip * chunk, chunks_per_ep * chunk, chunk):
            yield order[s: s + chunk]
        skip = 0
        ep += 1


def make_assemble_fn(store: DeviceStore, device="cuda"):
    """``assemble(batch) -> (x, cond)`` on the store's device, from an index
    batch of tensors there (``item_row``, ``crop_start``, ``crop_len``,
    ``text_emb`` and the optional mix and flag fields): the crop gather and
    its mask, the f16 motion rows, the cloud, the contact through
    exp(-0.5 c^2 / sigma^2) unless ``use_raw_dist``, the mix override, the
    flags and every ``geo_*`` field, the int16 index fields widened to int32
    on the device; the MotionX and stage-1 stores' own assembly otherwise
    (:func:`_make_assemble_motionx`, :func:`_make_assemble_contact`).
    Uploads the store to ``device`` first if it is not there."""
    store.ensure_device(device)
    if store.meta["kind"] == "motionx":
        return _make_assemble_motionx(store)
    if store.meta["kind"].endswith("_contact"):
        return _make_assemble_contact(store)
    A = store.arrays
    H = store.meta["max_horizon"]
    use_raw = store.meta["use_raw_dist"]
    dev = A["motion16"].device
    # a 0-d tensor, not a Python scalar: a scalar divisor is multiplied by
    # its reciprocal on the card, a tensor divisor is divided by
    sigma2 = torch.tensor(store.meta["sigma"] ** 2, dtype=torch.float32, device=dev)
    t_idx = torch.arange(H, dtype=torch.int32, device=dev)
    L_max, D = A["motion16"].shape[1:]

    def assemble(batch: Dict[str, torch.Tensor]):
        rows = batch["item_row"]  # the global batch's; every other field this rank's
        s_rows = store.lookup("scene_row", rows)
        src = batch["crop_start"][:, None] + t_idx[None]             # (B, H)
        valid = t_idx[None] < batch["crop_len"][:, None]              # (B, H)
        motions = store.fetch("motion16", rows)                       # (B, L_max, D)
        x = torch.gather(motions, 1, src.clamp(0, L_max - 1).long()[..., None].expand(-1, -1, D))
        x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=dev))

        contact = store.fetch("dist16", s_rows).float()
        if "mix_contact" in batch:
            contact = torch.where(batch["mix_mask"][:, None, None],
                                  batch["mix_contact"].float(), contact)
        if not use_raw:
            contact = torch.exp(-0.5 * (contact * contact) / sigma2)
        cond = {
            "x_mask": ~valid,
            "text_emb": batch["text_emb"],
            "c_pc_xyz": store.fetch("xyz16", s_rows),
            "c_pc_contact": contact.half(),
        }
        for k in ("text_token_mask", "c_text_mask", "c_text_erase", "c_pc_mask", "c_pc_erase"):
            if k in batch:
                cond[k] = batch[k]
        cond.update(_geometry(store, s_rows))  # the fps wire and the cached hierarchy
        return x, cond

    return assemble


def _geometry(store: DeviceStore, s_rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every ``geo_*`` field of the scenes ``s_rows``, int16 indices widened
    to int32."""
    out = {}
    for k in store.arrays:
        if k.startswith("geo_"):
            v = store.fetch(k, s_rows)
            out[k] = v.int() if v.dtype == torch.int16 else v
    return out


def _rotate_z(points: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 points rotated about the z (gravity) axis by the angle
    whose cosine and sine are ``c`` and ``s`` (broadcast over the points):
    ``RandomRotation``'s matrix for ``gravity_dim`` 2, applied in f32."""
    x0, x1, x2 = points.unbind(-1)
    return torch.stack([c * x0 - s * x1, s * x0 + c * x1, x2], dim=-1)


def _make_assemble_motionx(store: DeviceStore):
    """Stage 2 over the MotionX sets: ``x`` the raw f32 motion padded to the
    horizon, rotated by the batch's ``aug_angle`` (the joints' xyz triples),
    normalized after the padding (padding frames become (0 - mean) / std) and
    rounded to f16; ``cond`` the mask, the caption embedding, the rotated f16
    cloud, the contact through exp(-0.5 c^2 / sigma^2) unless
    ``use_raw_dist`` (the mix override first) and every ``geo_*`` field."""
    A = store.arrays
    H = store.meta["max_horizon"]
    use_raw = store.meta["use_raw_dist"]
    dev = A["motion32"].device
    # 0-d / (1, D) tensor divisors: true division on the card, as on the host
    sigma2 = torch.tensor(store.meta["sigma"] ** 2, dtype=torch.float32, device=dev)
    mean = torch.as_tensor(store.meta["mean"], device=dev)
    std = torch.as_tensor(store.meta["std"], device=dev)
    t_idx = torch.arange(H, dtype=torch.int32, device=dev)
    L_max, D = A["motion32"].shape[1:]

    def assemble(batch: Dict[str, torch.Tensor]):
        rows = batch["item_row"]
        motion = store.fetch("motion32", rows)
        B = motion.shape[0]
        motion = (torch.nn.functional.pad(motion, (0, 0, 0, H - L_max)) if L_max < H
                  else motion[:, :H])
        valid = t_idx[None] < store.fetch("length", rows)[:, None]          # (B, H)
        xyz = store.fetch("xyz16", rows).float()
        if "aug_angle" in batch:
            ang = batch["aug_angle"].float()
            c, s = torch.cos(ang), torch.sin(ang)
            xyz = _rotate_z(xyz, c[:, None], s[:, None])
            motion = _rotate_z(motion.reshape(B, H, D // 3, 3), c[:, None, None],
                               s[:, None, None]).reshape(B, H, D)
        x = ((motion - mean) / std).half()

        contact = store.fetch("dist16", rows).float()
        if "mix_contact" in batch:
            contact = torch.where(batch["mix_mask"][:, None, None],
                                  batch["mix_contact"].float(), contact)
        if not use_raw:
            contact = torch.exp(-0.5 * (contact * contact) / sigma2)
        cond = {
            "x_mask": ~valid,
            "text_emb": batch["text_emb"],
            "c_pc_xyz": xyz.half(),
            "c_pc_contact": contact.half(),
        }
        if "text_token_mask" in batch:
            cond["text_token_mask"] = batch["text_token_mask"]
        cond.update(_geometry(store, rows))  # the fps wire and the cached hierarchy
        return x, cond

    return assemble


def _make_assemble_contact(store: DeviceStore):
    """Stage 1's ``assemble(batch) -> (x, cond)``: ``x`` the normalized
    kernel of the f32 distances (or the raw distances), in f32; ``cond`` the
    caption embedding, the f16 cloud (rotated by ``aug_angle`` where the
    batch has one), for the MotionX sets the f16 colour features (empty
    without ``use_color``), and the fps wire."""
    A = store.arrays
    dev = A["dist32"].device
    use_raw = store.meta["use_raw_dist"]
    motionx = store.meta["kind"] == "motionx_contact"
    use_color = motionx and store.meta["use_color"]
    # a 0-d tensor divisor, as make_assemble_fn's
    sigma2 = torch.tensor(store.meta["sigma"] ** 2, dtype=torch.float32, device=dev)
    mean = torch.as_tensor(store.meta["mean"], device=dev)
    std = torch.as_tensor(store.meta["std"], device=dev)

    def assemble(batch: Dict[str, torch.Tensor]):
        s_rows = store.lookup("scene_row", batch["item_row"])
        contact = store.fetch("dist32", s_rows)
        if not use_raw:
            contact = torch.exp(-0.5 * (contact * contact) / sigma2)
        xyz = store.fetch("xyz16", s_rows)
        if "aug_angle" in batch:
            ang = batch["aug_angle"].float()
            xyz = _rotate_z(xyz.float(), torch.cos(ang)[:, None],
                            torch.sin(ang)[:, None]).half()
        cond = {"text_emb": batch["text_emb"], "c_pc_xyz": xyz}
        if use_color:
            cond["c_pc_feat"] = ((store.fetch("rgb16", s_rows).float() + 1.0) / 2.0).half()
        elif motionx:
            cond["c_pc_feat"] = xyz.new_zeros(xyz.shape[:-1] + (0,))
        cond.update(_geometry(store, s_rows))
        return (contact - mean) / std, cond

    return assemble

"""The port's data chain that switches the banded kernels on, against the
JAX package's: curve codes, ``python -m afford_motion_torch.prepare`` ``sort``
-> ``geometry`` -> ``pack`` against the root ``prepare.py`` on a copy of the
same tiny tree, the packed dataset item, and ``TrainLoop._maybe_enable_banded``.

The trees hold 512-point clouds on the 2^-8 grid (levels 512/128/32/8), and
the JAX side's geometry stage is routed through its Pallas FPS and packed kNN
in interpret mode, as it runs on the TPU: the port's geometry stage takes the
plain versions of the same kernels, so every cached index must be equal
(see tests/test_torch_hierarchy.py). up_weight is held to 1e-3 in the
store's f16.
"""
import argparse
import json
import os
import random
import shutil
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.ops import curves as jcurves
from afford_motion_tpu.ops import hierarchy as jh
from afford_motion_tpu.ops import morton as jmorton
from afford_motion_tpu.ops.pallas import knn as jknn
from afford_motion_tpu.ops.pallas.fps import fps_pallas
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import prepare as port_prepare
from afford_motion_torch.data import create_dataset
from afford_motion_torch.data.packed import PackedStore
from afford_motion_torch.data.synthetic import make_synthetic_h3d
from afford_motion_torch.ops import curves, morton
from afford_motion_torch.train.loop import TrainLoop
from afford_motion_torch.utils.config import DictConfig

REPO = Path(__file__).resolve().parents[1]
N_POINTS, N_ITEMS = 512, 6


# -------------------------------------------------------------------- curves
@pytest.mark.parametrize("kind", ["normal", "grid", "flat"])
def test_curve_codes_match_jax_package(kind):
    rng = np.random.default_rng(5)
    pts = {"normal": rng.normal(size=(700, 3)),
           "grid": rng.integers(0, 8, size=(700, 3)) * 0.5,
           "flat": np.concatenate([rng.normal(size=(700, 2)), np.ones((700, 1))], axis=1)}[kind]
    pts = pts.astype(np.float32)
    np.testing.assert_array_equal(morton.morton_codes(pts), jmorton.morton_codes(pts))
    np.testing.assert_array_equal(morton.morton_order(pts), jmorton.morton_order(pts))
    np.testing.assert_array_equal(curves.hilbert_codes(pts), jcurves.hilbert_codes(pts))
    for bits in (4, 10):
        grid = rng.integers(0, 1 << bits, size=(300, 3)).astype(np.uint64)
        np.testing.assert_array_equal(curves.hilbert_from_ints(grid, bits),
                                      jcurves.hilbert_from_ints(grid, bits))
    assert curves.CURVES == jcurves.CURVES
    for curve in curves.CURVES:
        order = curves.curve_order(pts, curve)
        np.testing.assert_array_equal(order, jcurves.curve_order(pts, curve))
        assert curves.matching_curves(pts[order]) == jcurves.matching_curves(pts[order])
        assert curve in curves.matching_curves(pts[order])
        assert curves.detect_curve(pts[order]) == jcurves.detect_curve(pts[order])
    assert curves.detect_curve(pts) is None or kind != "normal"
    with pytest.raises(ValueError, match="unknown curve"):
        curves.curve_codes(pts, "peano")


def test_sort_contact_npz_matches_jax_package(tmp_path):
    rng = np.random.default_rng(6)
    data = {"points": rng.normal(size=(64, 6)).astype(np.float32),
            "dist": rng.normal(size=(64, 22)).astype(np.float32), "other": np.arange(3)}
    for name in ("a", "b"):
        np.savez(tmp_path / f"{name}.npz", **data)
    assert morton.sort_contact_npz(str(tmp_path / "a.npz"), curve="hilbert")
    assert jmorton.sort_contact_npz(str(tmp_path / "b.npz"), curve="hilbert")
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    assert curves.detect_curve(a["points"][:, :3]) == "hilbert"


# ------------------------------------------------------ sort, geometry, pack
def _args(out_dir, **over):
    ns = dict(out_dir=str(out_dir), dataset="H3D", kind="sm", batch_size=4, curve="hilbert",
              contact_type="contact_cont_joints", contact_joints="0,10,11,12,20,21", device="cpu")
    ns.update(over)
    return argparse.Namespace(**ns)


def _make_tree(root):
    make_synthetic_h3d(str(root), n_items=N_ITEMS, num_points=N_POINTS, horizon_range=(40, 60))
    rng = np.random.default_rng(8)
    for f in sorted((root / "H3D" / "contacts").glob("*.npz")):
        data = dict(np.load(f))
        data["points"][:, :3] = rng.integers(-512, 512, size=(N_POINTS, 3)) / 256.0
        np.savez(f, **data)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tiny tree prepared by the port's stages and a copy of it prepared
    by the root ``prepare.py`` (JAX), geometry through its Pallas kernels."""
    root = tmp_path_factory.mktemp("packed")
    port, ref = root / "port", root / "ref"
    _make_tree(port)
    shutil.copytree(port, ref)
    for stage in ("sort", "geometry", "pack"):
        port_prepare.main([stage, "--dataset", "H3D", "--out_dir", str(port), "--batch_size", "4",
                           "--device", "cpu"])

    sys.path.insert(0, str(REPO))
    try:
        import prepare as root_prepare
    finally:
        sys.path.remove(str(REPO))
    real_knn, real_fps = jh.batched_knn, jh.batched_fps

    def knn_via_pallas(query, support, k, method=None):
        if method != "exact" and jknn.supports(query.shape[1], support.shape[1], k):
            return jknn.knn_pallas(query, support, k)
        return real_knn(query, support, k, method)

    jax.clear_caches()
    jh.batched_knn, jh.batched_fps = knn_via_pallas, fps_pallas
    try:
        root_prepare.cmd_sort(_args(ref))
        root_prepare.cmd_geometry(_args(ref))
        root_prepare.cmd_pack(_args(ref))
    finally:
        jh.batched_knn, jh.batched_fps = real_knn, real_fps
        jax.clear_caches()
    return port, ref


def test_prepare_stages_match_root_prepare(trees):
    port, ref = trees
    for f in sorted((ref / "H3D" / "contacts").glob("*.npz")):
        a, b = np.load(port / "H3D" / "contacts" / f.name), np.load(f)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name} {k}")
        assert curves.detect_curve(a["points"][:, :3]) == "hilbert"
    for f in sorted((ref / "H3D" / "geometry_sm").glob("*.npz")):
        a, b = np.load(port / "H3D" / "geometry_sm" / f.name), np.load(f)
        assert sorted(a.files) == sorted(b.files)
        assert a["fp"] == b["fp"] and a["fp"].dtype == np.uint32
        for k in b.files:
            if k.endswith("_up_weight"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-5, err_msg=k)
            else:
                assert a[k].dtype == b[k].dtype, k   # int16 on disk
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name} {k}")
        fps = a["geo_sm1_fps_idx"]
        assert fps.dtype == np.int16 and (fps[1:] > fps[:-1]).all()
    meta_a = json.loads((port / "H3D" / "packed" / "meta.json").read_text())
    meta_b = json.loads((ref / "H3D" / "packed" / "meta.json").read_text())
    assert meta_a == meta_b
    assert meta_a["morton"] is True and meta_a["curve"] == "hilbert"
    assert any(k.startswith("geo_sm") for k in meta_a["fields"])
    for name in meta_a["fields"]:
        a = np.load(port / "H3D" / "packed" / f"{name}.npy")
        b = np.load(ref / "H3D" / "packed" / f"{name}.npy")
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.endswith("_up_weight"):
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=0,
                                       atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_prepare_refuses_other_datasets_and_needs_the_card_by_default(trees, monkeypatch):
    """Every stage takes the MotionX sets too (``tests/test_torch_motionx_store.py``);
    a set with no contacts under its directory is refused, by every stage,
    and the geometry stage needs the card unless ``--device cpu`` is given."""
    for stage in ("sort", "geometry", "pack"):
        with pytest.raises(FileNotFoundError, match="HUMANISE/contact_motion/contacts"):
            port_prepare.main([stage, "--dataset", "HUMANISE", "--out_dir", str(trees[0]),
                               "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_prepare.main(["geometry", "--dataset", "H3D", "--out_dir", str(trees[0])])


def test_pack_strips_stale_geometry(tmp_path):
    """``geometry`` before ``sort``: the caches hold pre-sort row positions,
    their crc32 no longer matches the points, and ``pack`` leaves every
    ``geo_*`` field out (the store is still curve-sorted)."""
    _make_tree(tmp_path)
    for stage in ("geometry", "sort", "pack"):
        port_prepare.main([stage, "--dataset", "H3D", "--out_dir", str(tmp_path), "--device", "cpu"])
    store = PackedStore.try_open(str(tmp_path / "H3D" / "packed"))
    assert store.meta["morton"] is True and not store.geo_keys
    assert sorted(store.meta["fields"]) == ["dist16", "dist32", "rgb16", "xyz16"]
    assert not list((tmp_path / "H3D" / "packed").glob("geo_*.npy"))
    # re-running geometry then pack restores the fps wire
    for stage in ("geometry", "pack"):
        port_prepare.main([stage, "--dataset", "H3D", "--out_dir", str(tmp_path), "--device", "cpu"])
    assert PackedStore.try_open(str(tmp_path / "H3D" / "packed")).geo_keys


# ------------------------------------------------------------- packed items
def _cfg(data_dir, cls=DictConfig, **over):
    cfg = {
        "name": "ContactMotionHumanML3DDataset", "data_dir": str(data_dir), "shuffle_seed": 2023,
        "data_repr": "h3d", "contact_type": "contact_cont_joints",
        "contact_joints": [0, 10, 11, 12, 20, 21], "use_raw_dist": False, "sigma": 0.8,
        "num_points": N_POINTS, "min_horizon": 24, "max_horizon": 196, "mix_train_ratio": 0.0,
        "half_wire": True, "half_wire_x": True, "geometry_wire": "fps",
        "geometry_arch": "trans_enc", "train_transforms": ["NumpyToTensor"],
        "test_transforms": ["NumpyToTensor"], "transform_cfg": {"gravity_dim": 2},
    }
    cfg.update(over)
    return cls(cfg)


def _dataset(factory, cfg, phase="train"):
    random.seed(3)
    np.random.seed(3)
    return factory(cfg, phase)


def _item(ds, idx=1):
    random.seed(7)
    np.random.seed(7)
    return ds[idx]


@pytest.mark.parametrize("name", ["ContactMotionHumanML3DDataset", "ContactHumanML3DDataset"])
def test_packed_item_matches_live_and_jax_package(trees, name):
    port, _ = trees
    over = {"name": name}
    if name == "ContactHumanML3DDataset":
        over.update(data_repr="contact_cont_joints", data_repr_joints=[0, 10, 11, 12, 20, 21])
    packed = _dataset(create_dataset, _cfg(port, **over))
    live = _dataset(create_dataset, _cfg(port, use_packed=False, **over))
    ref = _dataset(jax_create_dataset, _cfg(port, JaxDictConfig, **over))
    assert packed._packed is not None and live._packed is None and ref._packed is not None
    assert packed.indices == live.indices == ref.indices
    a, b, c = _item(packed), _item(live), _item(ref)
    assert sorted(a) == sorted(b) == sorted(c)
    for k, v in c.items():   # the JAX package's packed item: equal in every field
        if isinstance(v, np.ndarray):
            assert a[k].dtype == v.dtype, k
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            assert a[k] == v, k
    # the live half-wire item: same wire types; the stage-2 contact goes
    # through the store's f16 distances, so it agrees to 2e-2
    geo = [k for k in a if k.startswith("geo_")]
    assert geo == ["geo_sm1_fps_idx", "geo_sm2_fps_idx", "geo_sm3_fps_idx"]
    for k in ["x", "c_pc_xyz"] + geo + (["x_mask"] if "x_mask" in a else []):
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["c_pc_xyz"].dtype == np.float16 and a["geo_sm1_fps_idx"].dtype == np.int16
    if "c_pc_contact" in a:
        assert a["x"].dtype == np.float16 and a["c_pc_contact"].dtype == np.float16
        np.testing.assert_allclose(a["c_pc_contact"].astype(np.float32),
                                   b["c_pc_contact"].astype(np.float32), atol=2e-2)
    # the test split never reads the store
    test_ds = _dataset(create_dataset, _cfg(port, **over), "test") \
        if name == "ContactHumanML3DDataset" else None
    assert test_ds is None or test_ds._packed is None


def test_packed_store_refuses_a_mismatching_meta(trees):
    port, _ = trees
    directory = str(port / "H3D" / "packed")
    assert PackedStore.try_open(directory).row("does_not_exist") is None
    assert PackedStore.try_open(directory, expect={"contact_type": "contact_all_joints"}) is None
    ds = _dataset(create_dataset, _cfg(port, contact_joints=[0, 10]))
    assert ds._packed is None and ds[0]["c_pc_contact"].shape == (N_POINTS, 2)


# ------------------------------------------------------ _maybe_enable_banded
def _enabled(dataset) -> bool:
    loop = types.SimpleNamespace(dataloader=types.SimpleNamespace(dataset=dataset),
                                 model=types.SimpleNamespace(use_banded=False))
    TrainLoop._maybe_enable_banded(loop)
    return loop.model.use_banded


def test_maybe_enable_banded(trees, tmp_path):
    port, _ = trees
    assert _enabled(_dataset(create_dataset, _cfg(port)))
    assert not _enabled(_dataset(create_dataset, _cfg(port, geometry_wire="full")))
    assert not _enabled(_dataset(create_dataset, _cfg(port, use_banded=False)))
    assert not _enabled(_dataset(create_dataset, _cfg(port, use_packed=False)))
    assert not _enabled(_dataset(create_dataset, _cfg(port, half_wire=False)))
    # an unsorted store: geometry and pack without sort
    _make_tree(tmp_path)
    for stage in ("geometry", "pack"):
        port_prepare.main([stage, "--dataset", "H3D", "--out_dir", str(tmp_path), "--device", "cpu"])
    ds = _dataset(create_dataset, _cfg(tmp_path))
    assert ds._packed is not None and ds._packed.meta["morton"] is False
    assert ds._packed.meta["curve"] is None and not _enabled(ds)

"""The shipped stage-1 default (``task=contact_gen model=cdm``: a CDM with its
frozen scene model) through the ``motionx_contact`` device store, on the CPU.

One synthetic HUMANISE tree (8 items, 512 coloured points on the 2^-8 grid,
so that every distance is exact in both frameworks) is prepared by the
port's ``prepare sort``, ``geometry`` (``--kind sm``), ``geometry --kind seg``
and ``pack``, and both packages' ``ContactMapDataset`` and stores read it:

- the staged arrays and the meta, the fps wire of both hierarchies
  (``geo_seg1..4_fps_idx``, ``geo_sm1..3_fps_idx``) among them, bit for bit
  against the JAX package's store;
- the upload's geometry cache: every hierarchy the model reads whose wire is
  staged (the scene model's 5-level ``geo_seg``; with PointTrans also the
  4-level ``geo_sm``), each index field bit for bit (the 3-NN weights to
  5e-5, as ``tests/test_torch_motionx_store.py`` holds them) against the JAX
  package's cache of the same store, and against the hierarchy the step
  rebuilds from the wire;
- one train step of a small MLP + scene CDM through the store against the
  host wire of the same items, without the rotation (bit-equal inputs):
  ``tests/test_torch_train.py``'s tolerances (loss 1e-5 rel, gradients 1e-3
  of each tensor's largest entry, parameters after AdamW 1e-6).
"""
import copy
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.models import cdm as jax_cdm
from afford_motion_tpu.train import device_store as jds_mod
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import prepare as port_prepare
from afford_motion_torch.data import create_dataset
from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.models.cdm import CDM
from afford_motion_torch.models.conditioning import add_hierarchies
from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
from afford_motion_torch.train.loop import make_train_step
from afford_motion_torch.train.state import TrainState
from afford_motion_torch.utils.config import DictConfig
from test_torch_device_store import _gens, _HashText
from test_torch_motionx_store import JOINTS, _host_wire
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_POINTS, N_ITEMS, SET = 512, 8, "HUMANISE"
SEG_P, SEG_B = (16, 32, 32, 64, 64), (1, 1, 1, 1, 1)
WIRE = {"geo_seg": [f"geo_seg{i}_fps_idx" for i in range(1, 5)],
        "geo_sm": [f"geo_sm{i}_fps_idx" for i in range(1, 4)]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cdm_scene_store")
    make_synthetic_motionx_set(str(root), SET, n_items=N_ITEMS, num_points=N_POINTS,
                               horizon_range=(20, 70), seed=11)
    rng = np.random.default_rng(12)
    for f in sorted((root / SET / "contact_motion" / "contacts").glob("*.npz")):
        data = dict(np.load(f))
        data["points"][:, :3] = rng.integers(-512, 512, size=(N_POINTS, 3)) / 256.0
        np.savez(f, **data)
    for stage in (["sort"], ["geometry"], ["geometry", "--kind", "seg"], ["pack"]):
        port_prepare.main([*stage, "--dataset", SET, "--out_dir", str(root), "--batch_size", "8",
                           "--device", "cpu"])
    assert (root / SET / "contact_motion" / "geometry_seg").is_dir()
    shutil.rmtree(root / SET / "contact_motion" / "contacts_fur", ignore_errors=True)
    return root


def _cfg(tree, cls, transforms):
    return cls({
        "name": "ContactMapDataset", "data_dir": str(tree), "shuffle_seed": 2023, "sets": [SET],
        "sets_config": {SET: {"ratio": 1.0}}, "data_repr": "contact_cont_joints",
        "data_repr_joints": JOINTS, "contact_type": "contact_cont_joints",
        "contact_joints": JOINTS, "use_raw_dist": False, "sigma": 0.5, "num_points": N_POINTS,
        "use_color": True, "use_openscene": False, "point_feat_dim": 32, "min_horizon": 24,
        "max_horizon": 196, "half_wire": True, "geometry_wire": "fps",
        "train_transforms": transforms, "test_transforms": ["NumpyToTensor"],
        "transform_cfg": {"gravity_dim": 2}})


@pytest.fixture(scope="module")
def stores(tree):
    """The JAX package's and the port's dataset and store, with the rotation."""
    out = []
    for factory, cls, build in ((jax_create_dataset, JaxDictConfig, jds_mod.DeviceStore),
                                (create_dataset, DictConfig, DeviceStore)):
        ds = factory(_cfg(tree, cls, ["RandomRotation", "ApplyTransformCDM", "NumpyToTensor"]),
                     "train")
        out += [ds, build.try_build(ds)]
    assert out[1] is not None and out[3] is not None
    return out


def _cdm(arch, use_banded=False):
    torch.manual_seed(0)
    cfg = dict(point_mlp_dims=(32, 32)) if arch == "MLP" else dict(blocks=(1, 1, 1, 1),
                                                                   planes=(8, 16, 16, 32))
    return CDM(6, 32, 16, 32, True, arch=arch, arch_cfg=cfg, scene_planes=SEG_P,
               scene_blocks=SEG_B, knn_exact=True, use_banded=use_banded)


def test_staged_arrays_carry_both_wires_as_jax(stores):
    jds, jstore, tds, tstore = stores
    assert tstore.meta["kind"] == "motionx_contact" and tstore.meta["use_color"]
    assert list(tstore.arrays) == list(jstore.arrays)
    assert all(k in tstore.arrays for wire in WIRE.values() for k in wire)
    for k, v in jstore.arrays.items():
        got = tstore.arrays[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert sorted(tstore.meta) == sorted(jstore.meta)
    for k, v in jstore.meta.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tstore.meta[k], v, err_msg=k)
        else:
            assert tstore.meta[k] == v, k


@pytest.mark.parametrize("arch", ["MLP", "PointTrans"])
def test_geometry_cache_covers_every_hierarchy_as_jax(stores, arch):
    """The MLP reads the scene model's hierarchy, PointTrans both: the cache
    holds each, equal to JAX's cache and to the step's rebuild from the
    wire (the unrotated stored cloud)."""
    jds, jstore, tds, tstore = stores
    tm = _cdm(arch)
    jm = jax_cdm.CDM(contact_dim=6, arch=arch, use_scene_model=True, knn_exact=True)
    assert (tm.needs_seg_hierarchy, tm.needs_pt_hierarchy) == (True, arch == "PointTrans")
    st = DeviceStore(dict(tstore.arrays), dict(tstore.meta))
    js = jds_mod.DeviceStore(dict(jstore.arrays), dict(jstore.meta))
    assert st.add_geometry_cache(tm, "cpu") and js.add_geometry_cache(jm)
    prefixes = ["geo_seg"] + ["geo_sm"] * (arch == "PointTrans")
    for prefix in ("geo_seg", "geo_sm"):
        cached = sorted(k for k in st.arrays if k.startswith(prefix) and "fps" not in k)
        assert bool(cached) == (prefix in prefixes), (prefix, cached)
        assert f"{prefix}0_knn_idx" in cached or prefix not in prefixes
    new = sorted(k for k in st.arrays if k not in tstore.arrays)
    assert new == sorted(k for k in js.arrays if k not in jstore.arrays)
    for k in new:
        want = np.asarray(js.arrays[k])
        assert st.arrays[k].dtype == want.dtype, k
        if k.endswith("_up_weight"):   # float weights, summed in other orders
            np.testing.assert_allclose(st.arrays[k], want, rtol=0, atol=5e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(st.arrays[k], want, err_msg=k)
    rows = torch.arange(4)
    xyz = torch.from_numpy(st.arrays["xyz16"])[rows].float()
    arrays = {k: torch.from_numpy(np.asarray(v))[rows] for k, v in st.arrays.items()
              if k.startswith("geo_")}
    cached = add_hierarchies(tm, dict(arrays, c_pc_xyz=xyz))
    rebuilt = add_hierarchies(tm, dict({k: v for k, v in arrays.items() if "fps" in k},
                                       c_pc_xyz=xyz))
    for key in ("levels_seg", "levels_pt"):
        if key not in cached:
            continue
        for lc, lw in zip(cached[key], rebuilt[key]):
            for f in ("knn_idx", "fps_idx", "down_knn_idx", "up_idx"):
                a, b = getattr(lc, f, None), getattr(lw, f, None)
                assert (a is None) == (b is None), (key, f)
                if a is not None:
                    assert torch.equal(a.long(), b.long()), (key, f)


def test_scene_cdm_step_through_the_store_matches_the_host_wire(tree):
    """4 items through the store (its cached scene hierarchy, the colours
    from ``rgb16``) against the host wire's in-step rebuild, without the
    rotation."""
    tds = create_dataset(_cfg(tree, DictConfig, ["NumpyToTensor"]), "train")
    tstore = DeviceStore.try_build(tds)
    tm = _cdm("MLP")
    th = copy.deepcopy(tm)
    assert tstore.add_geometry_cache(tm, "cpu")
    assemble = make_assemble_fn(tstore, "cpu")
    ids, seed = [0, 1, 2, 3], 31
    meta = tstore.draw_batch(tds, ids, *_gens(seed))
    meta["text_emb"] = _HashText().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
    index_batch = {k: torch.from_numpy(v) for k, v in meta.items()}
    hx, hc = _host_wire(tds, ids, seed)
    hc["text_emb"] = hc["text_emb"].astype(np.float16)
    x, cond = assemble(index_batch)
    np.testing.assert_array_equal(cond["c_pc_xyz"].numpy(), hc["c_pc_xyz"])
    np.testing.assert_array_equal(cond["c_pc_feat"].numpy(), hc["c_pc_feat"])
    assert "geo_seg0_knn_idx" in cond and "geo_seg0_knn_idx" not in hc
    np.testing.assert_allclose(x.numpy(), hx, rtol=0, atol=2e-6 * np.abs(hx).max())

    diffusion = create_gaussian_diffusion(DictConfig({"steps": 500}))
    rng = np.random.default_rng(4)
    t = torch.from_numpy(np.array([10, 300, 0, 499]))
    noise = torch.from_numpy(rng.standard_normal(hx.shape).astype(np.float32))
    s_store, s_host = TrainState.create(tm, lr=1e-4), TrainState.create(th, lr=1e-4)
    m_store = make_train_step(tm, diffusion, assemble=assemble)(
        s_store, None, index_batch, 0, t=t, noise=noise)
    m_host = make_train_step(th, diffusion)(s_host, torch.from_numpy(hx),
                                            {k: torch.from_numpy(v) for k, v in hc.items()},
                                            0, t=t, noise=noise)
    np.testing.assert_allclose(float(m_store["loss"]), float(m_host["loss"]), rtol=1e-5)
    for (name, p), q in zip(tm.named_parameters(), th.parameters()):
        if not p.requires_grad:
            assert p.grad is None and torch.equal(p, q), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=0,
                                   atol=1e-3 * float(q.grad.abs().max()) + 1e-30, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)

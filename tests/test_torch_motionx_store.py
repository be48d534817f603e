"""The MotionX training route of the port against the JAX package's, on the
CPU: ``python -m afford_motion_torch.prepare sort|geometry|pack --dataset
HUMANISE`` against the root ``prepare.py`` (sidecars included), the packed
MotionX items, both MotionX device stores (stage 2 ``motionx`` and stage 1
``motionx_contact``), the banded switch and a train step through the store.

One module-scoped synthetic HUMANISE tree (16 items, 512-point clouds on the
2^-8 grid, so that every distance is exact in both frameworks and every
coordinate exact in f16; 66-d joint motions of 20..69 frames; a per-point
``affordance`` sidecar beside the ``target_mask`` one; stage-1
``pred_contact`` files on the f16 grid for every other item) is prepared
twice: by the root ``prepare.py`` with JAX's geometry stage routed through
its Pallas FPS and packed kNN in interpret mode, as ``tests/test_torch_packed.py``
does, and, on a copy, by the port's stages on the CPU (the plain versions of
the same kernels). Every output must be equal; ``up_weight`` to 5e-5 (1e-3
in the store's f16). Both packages' datasets and stores then read the JAX
package's tree.

Held bit for bit: the staged arrays and the meta of both stores, the host
draws (captions, the mix and its files, the rotation angles) from the same
seeded generators, with and without the mix files on disk, the packed items
of both classes against JAX's, and ``x_mask``, the fps wire and the stage-1
colours of the assembled batches. The rotation runs in f32 on the card (the
store) and in ``RandomRotation``'s matrix on the host: ``x`` and
``c_pc_xyz`` (f16) are held, against JAX's assembly and the host wire alike,
to one f16 ulp of the larger value plus ``chip_smoke.MX_ROT_UNITS`` f32 unit
roundoffs of (r + |mean|) / std, r the distance from the z axis
(``chip_smoke.rotation_excess``: the cosines and sines may differ by ulps,
and the normalization divides by small stds); ``c_pc_contact`` (not
rotated) to one f16 ulp; the stage-1 target (f32) to two
f32 ulps of (|c| + |mean|) / std: the kernel's f32 ``exp`` (each
framework's within an ulp of the other's), then (c - mean) / std, two more
roundings. A packed
item against the live ``.npz`` item: the f16 wire's rounding (``x`` 1e-5,
``c_pc_xyz`` 1e-2, ``c_pc_contact`` 2e-2, as ``tests/test_packed.py``).
The train step: a tiny CMDM at 4 x 512 points through the store against the
host wire of the same items, without the rotation (bit-equal inputs):
``tests/test_torch_train.py``'s tolerances, loss 1e-5 (rel), gradients 1e-3
of each tensor's largest entry, parameters after AdamW 1e-6, BatchNorm
buffers 1e-5.
"""
import argparse
import copy
import random
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.ops import hierarchy as jh
from afford_motion_tpu.ops.pallas import knn as jknn
from afford_motion_tpu.ops.pallas.fps import fps_pallas
from afford_motion_tpu.train import device_store as jds_mod
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import prepare as port_prepare
from afford_motion_torch.data import create_dataset
from afford_motion_torch.data.loader import collate_fn_general
from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.models.conditioning import add_hierarchies, host_prepare_cond
from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
from afford_motion_torch.train.loop import TrainLoop, make_train_step
from afford_motion_torch.train.state import TrainState
from afford_motion_torch.utils.config import DictConfig
from chip_smoke import rotation_excess, rotation_scales
from test_torch_device_store import _gens, _HashText

REPO = Path(__file__).resolve().parents[1]
N_POINTS, N_ITEMS, SET = 512, 16, "HUMANISE"
JOINTS = [0, 10, 11, 12, 20, 21]
ROTATE = ["RandomRotation", "ApplyTransformCMDM", "NumpyToTensor"]
ROTATE_CDM = ["RandomRotation", "ApplyTransformCDM", "NumpyToTensor"]
SEED_STEP = 32  # two of the four items take their pred_contact file


def _args(out_dir):
    return argparse.Namespace(out_dir=str(out_dir), dataset=SET, kind="sm", batch_size=8,
                              curve="hilbert", contact_type="contact_cont_joints",
                              contact_joints=",".join(map(str, JOINTS)))


def _make_tree(root: Path) -> None:
    make_synthetic_motionx_set(str(root), SET, n_items=N_ITEMS, num_points=N_POINTS,
                               horizon_range=(20, 70), seed=5)
    base = root / SET / "contact_motion"
    rng = np.random.default_rng(8)
    (base / "affordance").mkdir()
    for f in sorted((base / "contacts").glob("*.npz")):
        data = dict(np.load(f))
        data["points"][:, :3] = rng.integers(-512, 512, size=(N_POINTS, 3)) / 256.0
        np.savez(f, **data)
        np.save(base / "affordance" / f"{f.stem}.npy",
                rng.random((N_POINTS, 1)).astype(np.float32))
    pred = root / SET / "pred_contact"
    pred.mkdir()
    for i in range(0, N_ITEMS, 2):
        c = rng.uniform(0, 2, size=(1, N_POINTS, 6)).astype(np.float16).astype(np.float32)
        np.save(pred / f"{i:05d}.npy", c)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(the tree the root prepare.py prepared, the copy the port's stages
    prepared, the unsorted original)."""
    root = tmp_path_factory.mktemp("motionx_store")
    ref, port, raw = root / "ref", root / "port", root / "raw"
    _make_tree(raw)
    shutil.copytree(raw, ref)
    shutil.copytree(raw, port)
    for stage in ("sort", "geometry", "pack"):
        port_prepare.main([stage, "--dataset", SET, "--out_dir", str(port), "--batch_size", "8",
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
        for stage in (root_prepare.cmd_sort, root_prepare.cmd_geometry, root_prepare.cmd_pack):
            stage(_args(ref))
    finally:
        jh.batched_knn, jh.batched_fps = real_knn, real_fps
        jax.clear_caches()
    return ref, port, raw


def _cfg(data_dir, cls=DictConfig, **over):
    cfg = {
        "name": "ContactMotionDataset", "data_dir": str(data_dir), "shuffle_seed": 2023,
        "sets": [SET], "sets_config": {SET: {"ratio": 1.0}}, "data_repr": "pos",
        "contact_type": "contact_cont_joints", "contact_joints": JOINTS,
        "use_raw_dist": False, "sigma": 0.5, "num_points": N_POINTS, "min_horizon": 24,
        "max_horizon": 196, "mix_train_ratio": 0.5, "half_wire": True, "half_wire_x": True,
        "geometry_wire": "fps", "geometry_arch": "trans_enc", "train_transforms": ROTATE,
        "test_transforms": ["NumpyToTensor"], "transform_cfg": {"gravity_dim": 2},
    }
    cfg.update(over)
    return cls(cfg)


def _stage1(**over):
    return dict({"name": "ContactMapDataset", "data_repr": "contact_cont_joints",
                 "data_repr_joints": JOINTS, "use_color": True, "use_openscene": False,
                 "point_feat_dim": 32, "train_transforms": ROTATE_CDM}, **over)


def _datasets(tree, **over):
    """The JAX package's and the port's train dataset over ``tree``, seeded
    alike."""
    out = []
    for factory, cls in ((jax_create_dataset, JaxDictConfig), (create_dataset, DictConfig)):
        random.seed(3)
        np.random.seed(3)
        out.append(factory(_cfg(tree, cls, **over), "train"))
    assert out[0].all_data.__len__() == len(out[1].all_data) and out[0].indices == out[1].indices
    return out


@pytest.fixture(scope="module")
def both(trees):
    """{kind: (JAX dataset, port dataset, JAX store, port store)} on the
    JAX-prepared tree, for the stage-2 and the stage-1 store."""
    out = {}
    for kind, over in (("motionx", {}), ("motionx_contact", _stage1())):
        jds, tds = _datasets(trees[0], **over)
        jstore, tstore = jds_mod.DeviceStore.try_build(jds), DeviceStore.try_build(tds)
        assert jstore is not None and tstore is not None and tstore.meta["kind"] == kind
        out[kind] = (jds, tds, jstore, tstore)
    return out


def _fresh(store):
    return type(store)(dict(store.arrays), dict(store.meta))


# ------------------------------------------------------------------ prepare
def test_prepare_stages_match_root_prepare(trees):
    ref, port, raw = trees
    base = Path(SET) / "contact_motion"
    moved = 0
    for f in sorted((ref / base / "contacts").glob("*.npz")):
        a, b, r = (np.load(t / base / "contacts" / f.name) for t in (port, ref, raw))
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name} {k}")
        order = [np.flatnonzero((r["points"] == p).all(axis=1))[0] for p in b["points"]]
        moved += order != sorted(order)
        # the sidecars follow the rows they describe
        for sub in ("target_mask", "affordance"):
            side = [np.load(t / base / sub / f"{f.stem}.npy") for t in (port, ref, raw)]
            np.testing.assert_array_equal(side[0], side[1], err_msg=f"{sub} {f.stem}")
            np.testing.assert_array_equal(side[1], side[2][order], err_msg=f"{sub} {f.stem}")
    assert moved == N_ITEMS
    for f in sorted((ref / base / "geometry_sm").glob("*.npz")):
        a, b = np.load(port / base / "geometry_sm" / f.name), np.load(f)
        assert sorted(a.files) == sorted(b.files) and a["fp"] == b["fp"]
        for k in b.files:
            if k.endswith("_up_weight"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=5e-5, err_msg=k)
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name} {k}")
    meta_a = (port / base / "packed" / "meta.json").read_text()
    assert meta_a == (ref / base / "packed" / "meta.json").read_text()
    fields = sorted(p.stem for p in (ref / base / "packed").glob("*.npy"))
    assert {"motion32", "motion_len", "xyz16", "dist16", "dist32", "rgb16",
            "geo_sm1_fps_idx"} <= set(fields)
    for name in fields:
        a, b = np.load(port / base / "packed" / f"{name}.npy"), np.load(
            ref / base / "packed" / f"{name}.npy")
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.endswith("_up_weight"):
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), rtol=0,
                                       atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# --------------------------------------------------------------- the items
@pytest.mark.parametrize("stage", ["motionx", "motionx_contact"])
def test_packed_item_matches_jax_and_the_live_item(trees, stage):
    ref = trees[0]
    over = _stage1() if stage == "motionx_contact" else {}
    jds, tds = _datasets(ref, **over)
    live = _datasets(ref, use_packed=False, **over)[1]
    assert list(tds._packed) == [SET] and live._packed == {}
    for idx in (0, 3, 5):
        items = []
        for ds in (jds, tds, live):
            random.seed(40 + idx)
            np.random.seed(40 + idx)
            items.append(ds[idx])
        want, got, lv = items
        assert list(got) == list(want) == list(lv)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        # against the live .npz item: the store's f16 rounding
        atol = {"x": 1e-5, "c_pc_xyz": 1e-2, "c_pc_contact": 2e-2, "c_pc_feat": 1e-2}
        for k, v in lv.items():
            if isinstance(v, np.ndarray) and v.dtype != np.bool_:
                np.testing.assert_allclose(got[k].astype(np.float32), v.astype(np.float32),
                                           rtol=0, atol=atol.get(k, 0), err_msg=k)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------- staging
@pytest.mark.parametrize("kind", ["motionx", "motionx_contact"])
def test_staged_arrays_and_meta_match_jax(both, kind):
    jds, tds, jstore, tstore = both[kind]
    assert list(tstore.arrays) == list(jstore.arrays)
    for k, v in jstore.arrays.items():
        got = tstore.arrays[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert sorted(tstore.meta) == sorted(jstore.meta)
    for k, v in jstore.meta.items():
        if isinstance(v, np.ndarray):
            assert tstore.meta[k].dtype == v.dtype, k
            np.testing.assert_array_equal(tstore.meta[k], v, err_msg=k)
        else:
            assert tstore.meta[k] == v, k
    assert tstore.meta["rotate"] is True and tstore.meta["n_items"] == len(tds.all_data)
    if kind == "motionx":
        assert tstore.meta["mix"] is True and tstore.arrays["motion32"].dtype == np.float32
    else:
        assert tstore.meta["use_color"] is True and tstore.arrays["rgb16"].dtype == np.float16


@pytest.mark.parametrize("mix_files", [True, False], ids=["mix_files", "no_mix_files"])
@pytest.mark.parametrize("kind", ["motionx", "motionx_contact"])
def test_draw_batch_matches_jax(trees, both, kind, mix_files):
    jds, tds, jstore, tstore = both[kind]
    pred = trees[0] / SET / "pred_contact"
    if not mix_files:
        pred.rename(pred.with_name("pred_contact_off"))
    try:
        ids = list(range(len(tds)))
        for seed in (5, 6):
            want = jstore.draw_batch(jds, ids, *_gens(seed))
            got = tstore.draw_batch(tds, ids, *_gens(seed))
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                if k == "c_text":
                    assert got[k] == v
                else:
                    assert got[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
            assert len(np.unique(got["aug_angle"])) == len(ids)
            if kind == "motionx":
                assert got["mix_mask"].any() == mix_files and not got["mix_mask"].all()
    finally:
        if not mix_files:
            pred.with_name("pred_contact_off").rename(pred)


# --------------------------------------------------------------- assembly
def _assembled(store, assemble, ds, ids, seed, to_backend):
    meta = store.draw_batch(ds, ids, *_gens(seed))
    meta["text_emb"] = _HashText().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
    return assemble({k: to_backend(v) for k, v in meta.items()})


def _host_wire(ds, ids, seed):
    """The port's packed host path for the same items and draws: the global
    streams seeded as the generators are."""
    random.seed(seed)
    np.random.seed(seed + 1)
    return host_prepare_cond(collate_fn_general([ds[i] for i in ids]), _HashText())


def _f32_ulps(got, want, scale):
    return float((np.abs(got - want) / np.spacing(np.abs(scale).astype(np.float32))).max())


@pytest.mark.parametrize("kind", ["motionx", "motionx_contact"])
def test_assembled_batch_matches_jax_and_the_host_wire(both, kind):
    jds, tds, jstore, tstore = both[kind]
    ids, seed = list(range(len(tds))), 21
    jx, jc = _assembled(jstore, jds_mod.make_assemble_fn(_fresh(jstore)), jds, ids, seed,
                        jnp.asarray)
    tx, tc = _assembled(tstore, make_assemble_fn(_fresh(tstore), "cpu"), tds, ids, seed,
                        torch.from_numpy)
    hx, hc = _host_wire(tds, ids, seed)
    wants = (("jax", np.asarray(jx), {k: np.asarray(v) for k, v in jc.items()}), ("host", hx, hc))
    assert sorted(tc) == sorted(k for k in hc) == sorted(jc)
    rows = tstore.meta["item_store_row"][[tds.indices[i] for i in ids]]
    xyz = tstore.arrays["xyz16"][rows].astype(np.float32)
    scales = (rotation_scales(tstore, rows) if kind == "motionx" else
              {"c_pc_xyz": np.repeat(np.hypot(xyz[..., :1], xyz[..., 1:2]), 3, axis=-1)})
    if kind == "motionx":
        assert tx.dtype == torch.float16 and tx.shape == (len(ids), 196, 66)
        for name, wx, _ in wants:
            assert rotation_excess(tx.numpy(), wx, scales["x"]) <= 1.0, name
        exact = ["x_mask"]
    else:
        # the kernel's value (an f32 exp in each framework, within an ulp of
        # the other's) carried through the subtraction and the division, each
        # rounding once: 2 f32 ulps of (|c| + |mean|) / std
        mean, std = tstore.meta["mean"], tstore.meta["std"]
        contact = tx.numpy() * std + mean
        for name, wx, _ in wants:
            assert _f32_ulps(tx.numpy(), wx, (np.abs(contact) + np.abs(mean)) / std) <= 2.0, name
        exact = ["c_pc_feat"]
    fps = [k for k in tc if k.startswith("geo_")]
    assert fps == ["geo_sm1_fps_idx", "geo_sm2_fps_idx", "geo_sm3_fps_idx"]
    for name, _, wc in wants:
        for k in exact + fps:
            np.testing.assert_array_equal(tc[k].numpy(), wc[k].astype(tc[k].numpy().dtype),
                                          err_msg=f"{name} {k}")
        for k in ("c_pc_xyz", "c_pc_contact"):
            if k in tc:
                assert tc[k].dtype == torch.float16 and wc[k].dtype == np.float16
                # c_pc_contact is not rotated: scale 0, one f16 ulp
                scale = scales.get(k, np.zeros(tc[k].shape))
                assert rotation_excess(tc[k].numpy(), wc[k], scale) <= 1.0, f"{name} {k}"
    # the rotation moved the cloud
    assert not np.array_equal(tc["c_pc_xyz"].numpy(), tstore.arrays["xyz16"][rows])


def test_geometry_cache_matches_the_rebuild_on_the_unrotated_cloud(both):
    """The cache comes from the stored (unrotated) cloud and holds under the
    rotation: it equals the hierarchy the step would rebuild from the fps
    wire on the unrotated cloud, through the banded kNN as the loop runs
    it."""
    _, tds, _, tstore = both["motionx"]
    tm = _tiny_cmdm()
    tm.use_banded = True
    st = _fresh(tstore)
    assert st.add_geometry_cache(tm, "cpu")
    assert "geo_sm0_knn_idx" in st.arrays and "geo_sm0_up_idx" not in st.arrays
    ids = [0, 1, 2, 3]
    _, cond = _assembled(st, make_assemble_fn(st, "cpu"), tds, ids, 9, torch.from_numpy)
    rows = torch.from_numpy(tstore.meta["item_store_row"][[tds.indices[i] for i in ids]])
    wire = {k: v for k, v in cond.items() if not k.startswith("geo_") or k.endswith("_fps_idx")}
    wire["c_pc_xyz"] = torch.from_numpy(tstore.arrays["xyz16"])[rows.long()]
    cached = add_hierarchies(tm, cond)["levels_sm"]
    rebuilt = add_hierarchies(tm, wire)["levels_sm"]
    for lc, lw in zip(cached, rebuilt):
        for f in ("knn_idx", "fps_idx", "down_knn_idx"):
            a, b = getattr(lc, f), getattr(lw, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert torch.equal(a, b), f


# -------------------------------------------------------------- the gates
def _without_field(ds, field):
    """``ds``'s packed stores with ``field`` left out of the HUMANISE one's
    fields (a copy; the module's stores stay whole)."""
    st = copy.copy(ds._packed[SET])
    st.fields = {k: v for k, v in st.fields.items() if k != field}
    return {SET: st}


def test_try_build_rejects_what_jax_rejects(trees, both, monkeypatch):
    """Every branch of JAX's two MotionX gates, on both sides: the phase,
    the f16 motion wire, no packed stores, the train chain, gravity, the
    geometry wire, a field missing from a store, an item missing from its
    store, the budget."""
    ref = trees[0]
    jds, tds, _, _ = both["motionx"]
    for attr, value in (("phase", "test"), ("_x16", False), ("_packed", {})):
        saved = (getattr(jds, attr), getattr(tds, attr))
        setattr(jds, attr, value)
        setattr(tds, attr, value)
        try:
            assert jds_mod.DeviceStore.try_build(jds) is None
            assert DeviceStore.try_build(tds) is None
        finally:
            setattr(jds, attr, saved[0])
            setattr(tds, attr, saved[1])
    for over in ({"train_transforms": ["RandomEraseLang", "NumpyToTensor"]},
                 {"transform_cfg": {"gravity_dim": 1}}, {"geometry_wire": "full"},
                 _stage1(train_transforms=ROTATE), _stage1(transform_cfg={"gravity_dim": 1}),
                 _stage1(geometry_wire="full")):
        j, t = _datasets(ref, **over)
        assert jds_mod.DeviceStore.try_build(j) is None
        assert DeviceStore.try_build(t) is None
    # no rotation is a chain the stores take too
    for over in ({"train_transforms": ["NumpyToTensor"]},
                 _stage1(train_transforms=["NumpyToTensor"], use_color=False)):
        j, t = _datasets(ref, **over)
        js, ts = jds_mod.DeviceStore.try_build(j), DeviceStore.try_build(t)
        assert ts.meta["rotate"] is js.meta["rotate"] is False
    # an item that is not in its set's store
    j, t = _datasets(ref)
    for ds in (j, t):
        ds.all_data = ds.all_data + [(SET, 999, "scene", np.zeros(3, np.float32), ["x"])]
    assert jds_mod.DeviceStore.try_build(j) is None and DeviceStore.try_build(t) is None
    # a field the store needs is not packed: the motions (stage 2), the
    # colours where stage 1 reads them
    for kind, field in (("motionx", "motion32"), ("motionx", "dist16"),
                        ("motionx_contact", "rgb16"), ("motionx_contact", "dist32")):
        j, t, _, _ = both[kind]
        saved = (j._packed, t._packed)
        j._packed, t._packed = _without_field(j, field), _without_field(t, field)
        try:
            assert jds_mod.DeviceStore.try_build(j) is None, field
            assert DeviceStore.try_build(t) is None, field
        finally:
            j._packed, t._packed = saved
    # a corpus over the budget logs so and takes the host pipeline
    monkeypatch.setenv("AM_DEVICE_STORE_MAX_GB", "0.00001")
    for kind in ("motionx", "motionx_contact"):
        j, t, _, _ = both[kind]
        assert jds_mod.DeviceStore.try_build(j, max_bytes=int(0.00001 * (1 << 30))) is None
        assert DeviceStore.try_build(t) is None
    # the sample-mode subclasses never build a store
    assert DeviceStore.try_build(type("ContactMotionExampleDataset", (), {})()) is None


# ---------------------------------------------------------- banded switch
def _enabled(dataset) -> bool:
    loop = types.SimpleNamespace(dataloader=types.SimpleNamespace(dataset=dataset),
                                 model=types.SimpleNamespace(use_banded=False))
    TrainLoop._maybe_enable_banded(loop)
    return loop.model.use_banded


def test_banded_switch_on_the_packed_motionx_tree(trees):
    ref, _, raw = trees
    ds = create_dataset(_cfg(ref), "train")
    assert ds._packed[SET].meta["curve"] == "hilbert" and _enabled(ds)
    assert not _enabled(create_dataset(_cfg(ref, geometry_wire="full"), "train"))
    assert not _enabled(create_dataset(_cfg(ref, use_packed=False), "train"))
    assert not _enabled(create_dataset(_cfg(ref, use_banded=False), "train"))
    # the unsorted tree, packed without `sort`: no banded route
    shutil.rmtree(raw / SET / "contact_motion" / "packed", ignore_errors=True)
    port_prepare.main(["pack", "--dataset", SET, "--out_dir", str(raw)])
    unsorted = create_dataset(_cfg(raw), "train")
    assert unsorted._packed[SET].meta["morton"] is False and not _enabled(unsorted)


# ------------------------------------------------------------ a train step
def _tiny_cmdm():
    torch.manual_seed(0)
    return CMDM(motion_dim=66, latent_dim=32, time_emb_dim=32, text_feat_dim=16, contact_dim=6,
                planes=(8, 16, 32, 64), blocks=(2, 2, 2, 2), num_layers=(1, 1), num_heads=4,
                dim_feedforward=32, arch="trans_enc", dropout=0.0)


def test_train_step_through_the_store_matches_the_host_wire(trees):
    """4 items of 512 points, without the rotation (the host's rotation and
    the card's round differently; the assembly test holds those), from the
    cached hierarchy against the host wire's in-step rebuild."""
    _, tds = _datasets(trees[0], train_transforms=["NumpyToTensor"])
    tstore = DeviceStore.try_build(tds)
    tm = _tiny_cmdm()
    th = copy.deepcopy(tm)
    assert tstore.add_geometry_cache(tm, "cpu")
    assemble = make_assemble_fn(tstore, "cpu")
    ids, seed = [0, 1, 2, 3], SEED_STEP
    meta = tstore.draw_batch(tds, ids, *_gens(seed))
    assert meta["mix_mask"].any()  # one item's contact from its pred_contact file
    meta["text_emb"] = _HashText().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
    index_batch = {k: torch.from_numpy(v) for k, v in meta.items()}
    hx, hc = _host_wire(tds, ids, seed)
    hc["text_emb"] = hc["text_emb"].astype(np.float16)  # the store's wire type
    host_cond = {k: torch.from_numpy(v) for k, v in hc.items()}
    x, cond = assemble(index_batch)
    np.testing.assert_array_equal(x.numpy(), hx)
    np.testing.assert_array_equal(cond["c_pc_xyz"].numpy(), hc["c_pc_xyz"])

    diffusion = create_gaussian_diffusion(DictConfig({"steps": 500}))
    rng = np.random.default_rng(4)
    t = torch.from_numpy(np.array([10, 300, 0, 499]))
    noise = torch.from_numpy(rng.standard_normal((4, 196, 66)).astype(np.float32))
    s_store, s_host = TrainState.create(tm, lr=1e-4), TrainState.create(th, lr=1e-4)
    m_store = make_train_step(tm, diffusion, assemble=assemble)(
        s_store, None, index_batch, 0, t=t, noise=noise)
    m_host = make_train_step(th, diffusion)(s_host, torch.from_numpy(hx), host_cond, 0, t=t,
                                            noise=noise)
    np.testing.assert_allclose(float(m_store["loss"]), float(m_host["loss"]), rtol=1e-5)
    for (name, p), q in zip(tm.named_parameters(), th.parameters()):
        g, h = p.grad, q.grad
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=0,
                                   atol=1e-3 * float(h.abs().max()) + 1e-30, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for (name, b), c in zip(tm.named_buffers(), th.buffers()):
        if b.dtype.is_floating_point:
            np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=0, atol=1e-5, err_msg=name)

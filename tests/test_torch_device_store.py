"""The port's device-resident corpus (``afford_motion_torch/train/device_store.py``)
against the JAX package's, on the CPU.

One synthetic HumanML3D tree (12 motions, 128-point clouds on the 2^-8 grid,
so that every distance is exact in both frameworks) goes through the root
``prepare.py`` stages ``sort`` and ``geometry`` and ``pack_h3d``, as
``tests/test_device_store.py`` builds its tree, with stage-1 contacts for the
training mix (values on the f16 grid). Both packages' datasets read it with
the flagship chain (``RandomEraseLang``, ``RandomEraseContact`` at p = 0.5)
and a mix ratio of 0.5, and both stores are built from them.

Held bit for bit: the staged arrays and meta, the host draws (captions,
crops, mix, flags) from the same seeded generators, the index stream, the
assembled ``x``, ``x_mask``, ``c_pc_xyz`` and fps wire, and every cached
index field (int16). ``c_pc_contact`` is held to one f16 ulp: it is an f32
``exp`` rounded to f16 in each package, and numpy's, XLA's and torch's
``exp`` may differ in the last f32 bit. ``up_weight`` to 1e-5. One tiny CMDM
step through the store against one through the host wire of the same items,
to ``tests/test_torch_train.py``'s tolerances: loss 1e-5 (rel), gradients
1e-3 of each tensor's largest entry, parameters after AdamW 1e-6, BatchNorm
buffers 1e-5.
"""
import argparse
import copy
import os
import random
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.data.packed import pack_h3d
from afford_motion_tpu.models.cmdm import CMDM as JaxCMDM
from afford_motion_tpu.train import device_store as jds_mod
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import train as train_pkg
from afford_motion_torch.data import create_dataset
from afford_motion_torch.data.loader import collate_fn_general
from afford_motion_torch.data.synthetic import make_synthetic_h3d
from afford_motion_torch.diffusion import create_gaussian_diffusion
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.models.conditioning import add_hierarchies, host_prepare_cond
from afford_motion_torch.train import device_store as tds_mod
from afford_motion_torch.train.device_store import DeviceStore, index_stream, make_assemble_fn
from afford_motion_torch.train.loop import make_train_step
from afford_motion_torch.train.state import TrainState
from afford_motion_torch.utils.config import DictConfig
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
N_POINTS, N_ITEMS = 128, 12
TRANSFORMS = ["RandomEraseLang", "RandomEraseContact", "NumpyToTensor"]


class _HashText:
    """A pooled text encoder for both sides: 16 seeded numbers a caption."""

    def encode(self, texts):
        out = np.zeros((len(texts), 16), np.float32)
        for i, t in enumerate(texts):
            seed = sum(ord(c) * 31 ** j for j, c in enumerate(t)) % (2 ** 31)
            out[i] = np.random.default_rng(seed).normal(size=16).astype(np.float32)
        return out


def _cfg(data_dir, cls, **over):
    cfg = {
        "name": "ContactMotionHumanML3DDataset", "data_dir": str(data_dir), "shuffle_seed": 2023,
        "data_repr": "h3d", "contact_type": "contact_cont_joints",
        "contact_joints": [0, 10, 11, 12, 20, 21], "use_raw_dist": False, "sigma": 0.8,
        "num_points": N_POINTS, "min_horizon": 24, "max_horizon": 196, "mix_train_ratio": 0.5,
        "half_wire": True, "half_wire_x": True, "geometry_wire": "fps",
        "geometry_arch": "trans_enc", "train_transforms": TRANSFORMS,
        "test_transforms": ["NumpyToTensor"],
        "transform_cfg": {"gravity_dim": 2, "random_mask_prob": 0.5,
                          "random_mask_prob_pc": 0.5},
    }
    cfg.update(over)
    return cls(cfg)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dstore") / "data"
    make_synthetic_h3d(str(root), n_items=N_ITEMS, num_points=N_POINTS, horizon_range=(40, 100))
    rng = np.random.default_rng(8)
    for f in sorted((root / "H3D" / "contacts").glob("*.npz")):
        data = dict(np.load(f))
        data["points"][:, :3] = rng.integers(-512, 512, size=(N_POINTS, 3)) / 256.0
        np.savez(f, **data)
    pred = root / "H3D" / "pred_contact"
    pred.mkdir()
    for name in (root / "H3D" / "all.txt").read_text().split()[::2]:
        c = rng.uniform(0, 2, size=(1, N_POINTS, 6)).astype(np.float16).astype(np.float32)
        np.save(pred / f"{name}-0.npy", c)
    sys.path.insert(0, str(REPO))
    try:
        import prepare as root_prepare
    finally:
        sys.path.remove(str(REPO))
    args = argparse.Namespace(out_dir=str(root), dataset="H3D", kind="sm", batch_size=8,
                              curve="morton")
    root_prepare.cmd_sort(args)
    root_prepare.cmd_geometry(args)
    pack_h3d(str(root))
    return root


def _datasets(tree, **over):
    """The JAX package's and the port's dataset over the tree, seeded alike."""
    out = []
    for factory, cls in ((jax_create_dataset, JaxDictConfig), (create_dataset, DictConfig)):
        random.seed(3)
        np.random.seed(3)
        out.append(factory(_cfg(tree, cls, **over), "train"))
    jds, tds = out
    assert jds.name_list == tds.name_list and jds.indices == tds.indices
    return jds, tds


@pytest.fixture(scope="module")
def both(tree):
    jds, tds = _datasets(tree)
    jstore, tstore = jds_mod.DeviceStore.try_build(jds), DeviceStore.try_build(tds)
    assert jstore is not None and tstore is not None
    return jds, tds, jstore, tstore


def _fresh(store):
    """A private copy of a module-scoped store's host arrays."""
    return type(store)(dict(store.arrays), dict(store.meta))


def _gens(seed):
    return random.Random(seed), np.random.RandomState(seed + 1)


def _tiny_models(contact_dim=6, up=False):
    kw = dict(motion_dim=263, latent_dim=32, time_emb_dim=32, text_feat_dim=16,
              contact_dim=contact_dim, planes=(8, 16, 32, 64), blocks=(2, 2, 2, 2),
              num_layers=(1, 1), num_heads=4, dim_feedforward=32)
    arch = "trans_dec" if up else "trans_enc"
    jm = JaxCMDM(**kw, arch=arch)
    torch.manual_seed(0)
    tm = CMDM(**kw, arch=arch, dropout=0.0)
    return jm, tm


def _ulps_f16(a, b):
    """Largest difference of two f16 arrays in f16 ulps of the larger value."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ulp = np.maximum(np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)
                                ).astype(np.float32), 2.0 ** -24)
    return float((np.abs(a - b) / ulp).max())


# ----------------------------------------------------------------- staging
def test_staged_arrays_and_meta_match_jax(both):
    _, tds, jstore, tstore = both
    assert sorted(tstore.arrays) == sorted(jstore.arrays)
    for k, v in jstore.arrays.items():
        got = tstore.arrays[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(np.asarray(got), np.asarray(v), err_msg=k)
    assert tstore.meta == jstore.meta
    assert tstore.meta["mix"] is True and tstore.meta["flag_chain"] == [
        ("c_text_erase", 0.5), ("c_pc_erase", 0.5)]
    assert tstore.meta["n_items"] == len(tds.name_list)
    assert tstore.arrays["motion16"].dtype == np.float16
    assert tstore.arrays["geo_sm1_fps_idx"].dtype == np.int16


def test_draw_batch_matches_jax(both):
    jds, tds, jstore, tstore = both
    ids = list(range(len(tds)))
    for seed in (5, 6, 7):
        want = jstore.draw_batch(jds, ids, *_gens(seed))
        got = tstore.draw_batch(tds, ids, *_gens(seed))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k == "c_text":
                assert got[k] == v
            else:
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        # the draws are not trivially constant
        assert got["mix_mask"].any() and not got["mix_mask"].all()
        assert got["c_pc_erase"].any() or got["c_text_erase"].any()


# ---------------------------------------------------------------- assembly
def _assembled(store, assemble, ds, ids, seed, to_backend):
    meta = store.draw_batch(ds, ids, *_gens(seed))
    meta["text_emb"] = _HashText().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
    return assemble({k: to_backend(v) for k, v in meta.items()})


def _host_wire(ds, ids, seed):
    """The port's packed host path for the same items and draws: the global
    streams seeded as the generators are."""
    random.seed(seed)
    np.random.seed(seed + 1)
    batch = collate_fn_general([ds[i] for i in ids])
    x, cond = host_prepare_cond(batch, _HashText())
    return x, cond


@pytest.mark.parametrize("seed", [21, 22])
def test_assembled_batch_matches_jax_and_host_wire(both, seed):
    jds, tds, jstore, tstore = both
    ids = list(range(len(tds)))
    jx, jc = _assembled(jstore, jds_mod.make_assemble_fn(_fresh(jstore)), jds, ids, seed,
                        jnp.asarray)
    tx, tc = _assembled(tstore, make_assemble_fn(_fresh(tstore), "cpu"), tds, ids, seed,
                        torch.from_numpy)
    hx, hc = _host_wire(tds, ids, seed)
    assert tx.dtype == torch.float16 and hx.dtype == np.float16
    for want in (np.asarray(jx), hx):
        np.testing.assert_array_equal(tx.numpy(), want)
    for k in ("x_mask", "c_pc_xyz", "c_text_erase", "c_pc_erase"):
        for want in (np.asarray(jc[k]), hc[k]):
            np.testing.assert_array_equal(tc[k].numpy(), want, err_msg=k)
    assert tc["c_pc_contact"].dtype == torch.float16
    for want in (np.asarray(jc["c_pc_contact"]), hc["c_pc_contact"]):
        assert _ulps_f16(tc["c_pc_contact"].numpy(), want) <= 1.0
    fps = [k for k in hc if k.endswith("_fps_idx")]
    assert fps and sorted(fps) == sorted(k for k in tc if k.startswith("geo_"))
    for k in fps:
        assert tc[k].dtype == torch.int32  # widened from the stored int16
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
        np.testing.assert_array_equal(tc[k].numpy(), hc[k], err_msg=k)
    np.testing.assert_array_equal(tc["text_emb"].numpy(), np.asarray(jc["text_emb"]))


# ----------------------------------------------------------- geometry cache
@pytest.mark.parametrize("up", [False, True], ids=["trans_enc", "with_up"])
def test_geometry_cache_matches_jax_and_in_step_rebuild(both, up):
    jds, tds, jstore, tstore = both
    jm, tm = _tiny_models(up=up)
    jst, tst = _fresh(jstore), _fresh(tstore)
    assert jst.add_geometry_cache(jm) and tst.add_geometry_cache(tm, "cpu")
    added = sorted(k for k in tst.arrays if k not in tstore.arrays)
    assert added == sorted(k for k in jst.arrays if k not in jstore.arrays)
    assert any(k.endswith("_up_weight") for k in added) == up
    for k in added:
        want, got = np.asarray(jst.arrays[k]), tst.arrays[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k.endswith("_up_weight"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
        else:
            assert got.dtype == np.int16, k
            np.testing.assert_array_equal(got, want, err_msg=k)

    # the cached hierarchy equals the one the step rebuilds from the fps wire
    _, cond = _assembled(tst, make_assemble_fn(tst, "cpu"), tds, [0, 1, 2], 9,
                         torch.from_numpy)
    assert "geo_sm0_knn_idx" in cond
    wire = {k: v for k, v in cond.items() if not k.startswith("geo_") or k.endswith("_fps_idx")}
    cached, rebuilt = add_hierarchies(tm, cond)["levels_sm"], add_hierarchies(tm, wire)["levels_sm"]
    assert len(cached) == len(rebuilt)
    for lc, lw in zip(cached, rebuilt):
        torch.testing.assert_close(lc.xyz, lw.xyz, rtol=0, atol=0)
        for f in ("knn_idx", "fps_idx", "down_knn_idx", "up_idx"):
            a, b = getattr(lc, f), getattr(lw, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert torch.equal(a, b), f
        if lc.up_weight is not None:
            torch.testing.assert_close(lc.up_weight, lw.up_weight, rtol=0, atol=1e-5)


def test_partial_cache_keeps_the_fields_jax_keeps(both):
    _, tds, jstore, tstore = both
    jm, tm = _tiny_models()
    full = _fresh(tstore)
    assert full.add_geometry_cache(tm, "cpu")
    cache = sum(v.nbytes for k, v in full.arrays.items() if k not in tstore.arrays)
    budget = tstore.nbytes() + cache // 2
    jst, tst = _fresh(jstore), _fresh(tstore)
    assert jst.add_geometry_cache(jm, max_bytes=budget)
    assert tst.add_geometry_cache(tm, "cpu", max_bytes=budget)
    kept = sorted(k for k in tst.arrays if k not in tstore.arrays)
    assert kept == sorted(k for k in jst.arrays if k not in jstore.arrays)
    assert kept and "geo_sm0_knn_idx" not in kept
    # the hybrid (deep levels cached, level 0 rebuilt) equals the full rebuild
    _, cond = _assembled(tst, make_assemble_fn(tst, "cpu"), tds, [0, 1], 9, torch.from_numpy)
    wire = {k: v for k, v in cond.items() if not k.startswith("geo_") or k.endswith("_fps_idx")}
    for lm, lf in zip(add_hierarchies(tm, cond)["levels_sm"],
                      add_hierarchies(tm, wire)["levels_sm"]):
        assert torch.equal(lm.knn_idx, lf.knn_idx)
        assert (lm.down_knn_idx is None) == (lf.down_knn_idx is None)
        if lm.down_knn_idx is not None:
            assert torch.equal(lm.down_knn_idx, lf.down_knn_idx)
    # AM_DEVICE_GEO=off and a budget without room keep the in-step rebuild
    assert not _fresh(tstore).add_geometry_cache(tm, "cpu", max_bytes=tstore.nbytes())
    os.environ["AM_DEVICE_GEO"] = "off"
    try:
        assert not _fresh(tstore).add_geometry_cache(tm, "cpu")
    finally:
        del os.environ["AM_DEVICE_GEO"]


# -------------------------------------------------------------- the stream
def test_index_stream_matches_jax_across_passes_and_resumes():
    n_items, G, Bs = 100, 4, 3  # chunks of 12, 8 a pass, 32 steps a pass
    want = jds_mod.index_stream(n_items, G, Bs, 0, 2023, 7)
    got = index_stream(n_items, G, Bs, 0, 2023, 7)
    taken = [next(got) for _ in range(24)]  # three passes
    for chunk in taken:
        np.testing.assert_array_equal(chunk, np.asarray(next(want)))
    for start in (5 * G, 10 * G, 17 * G):
        resumed = index_stream(n_items, G, Bs, start, 2023, 7)
        jresumed = jds_mod.index_stream(n_items, G, Bs, start, 2023, 7)
        for i in range(start // G, 24):
            chunk = next(resumed)
            np.testing.assert_array_equal(chunk, taken[i])
            np.testing.assert_array_equal(chunk, np.asarray(next(jresumed)))
    seen = np.concatenate(taken[:8])
    assert len(set(seen.tolist())) == len(seen)
    assert not np.array_equal(next(index_stream(n_items, G, Bs, 0, 2023, 8)), taken[0])


# -------------------------------------------------------------- the gates
def test_try_build_rejects_what_jax_rejects(tree, both, monkeypatch):
    jds, tds, _, _ = both
    for attr, value in (("phase", "test"), ("_x16", False)):
        saved = (getattr(jds, attr), getattr(tds, attr))
        setattr(jds, attr, value)
        setattr(tds, attr, value)
        try:
            assert jds_mod.DeviceStore.try_build(jds) is None
            assert DeviceStore.try_build(tds) is None
        finally:
            setattr(jds, attr, saved[0])
            setattr(tds, attr, saved[1])
    for over in ({"train_transforms": ["RandomSetContactNull", "NumpyToTensor"]},
                 {"geometry_wire": "full"}):
        j, t = _datasets(tree, **over)
        assert jds_mod.DeviceStore.try_build(j) is None
        assert DeviceStore.try_build(t) is None
    # every store of the JAX package is ported: a MotionX dataset without
    # packed stores, and a sample-mode subclass, build none in either
    # package, silently (tests/test_torch_motionx_store.py holds the MotionX
    # stores' own gates)
    said = []
    monkeypatch.setattr(tds_mod.logger, "info", said.append)
    for name in ("ContactMapDataset", "ContactMotionDataset", "ContactMotionExampleDataset"):
        bare = type(name, (), {"_packed": {}, "phase": "train", "all_data": []})()
        assert jds_mod.DeviceStore.try_build(bare) is None
        assert DeviceStore.try_build(bare) is None
    assert said == []


# ------------------------------------------------------------ a train step
def test_train_step_through_the_store_matches_the_host_wire(both):
    _, tds, _, tstore = both
    _, tm = _tiny_models()
    th = copy.deepcopy(tm)
    st = _fresh(tstore)
    assert st.add_geometry_cache(tm, "cpu")
    assemble = make_assemble_fn(st, "cpu")
    ids, seed = [0, 1, 2, 3], 31
    meta = st.draw_batch(tds, ids, *_gens(seed))
    meta["text_emb"] = _HashText().encode(meta.pop("c_text"))[:, None, :].astype(np.float16)
    index_batch = {k: torch.from_numpy(v) for k, v in meta.items()}
    hx, hc = _host_wire(tds, ids, seed)
    hc["text_emb"] = hc["text_emb"].astype(np.float16)  # the store's wire type
    host_cond = {k: torch.from_numpy(v) for k, v in hc.items()}

    diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}))
    rng = np.random.default_rng(4)
    t = torch.from_numpy(np.array([10, 700, 0, 999]))
    noise = torch.from_numpy(rng.standard_normal((4, 196, 263)).astype(np.float32))
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


# ------------------------------------------------- the train entry, resumed
def _entry_args(tree, exp, *extra):
    return [
        "task=text_to_motion_contact_motion_gen", "model=cmdm", "model.arch=trans_enc",
        "model.data_repr=h3d", "diffusion.steps=1000", f"task.dataset.data_dir={tree}",
        f"exp_dir={tree.parent}/{exp}", f"task.dataset.num_points={N_POINTS}",
        "model.latent_dim=32", "model.time_emb_dim=32", "model.num_heads=4",
        "model.dim_feedforward=64", "model.num_layers=[1,1]",
        "model.contact_model.planes=[8,16,32,64]", "task.train.batch_size=2",
        "task.train.steps_per_dispatch=2", "task.train.save_every_step=2",
        "task.train.log_every_step=2",
        f"task.dataset.train_transforms={TRANSFORMS}".replace(" ", ""),
        "platform=jsonl", f"text_encoder.table_path={tree}/none",
        f"text_encoder.weights_dir={tree}/none", "device=cpu", *extra,
    ]


@pytest.mark.parametrize("route", ["auto", "off"], ids=["store", "host"])
def test_entry_resume_is_bit_exact(tree, monkeypatch, route):
    """6 steps straight against 4 and a run resumed from ``model000004.pt``
    to step 6, G = 2: the same weights, buffers and optimizer moments bit for
    bit, through the store and through the host route's producer thread."""
    from tests.test_torch_train import _same_file_tensors

    monkeypatch.chdir(REPO)
    store = f"task.train.device_store={route}"
    straight = train_pkg.main(_entry_args(tree, f"{route}_straight", store,
                                          "task.train.max_steps=6"))
    train_pkg.main(_entry_args(tree, f"{route}_resumed", store, "task.train.max_steps=4"))
    resumed = train_pkg.main(_entry_args(
        tree, f"{route}_resumed", store, "task.train.max_steps=6",
        f"task.train.resume_ckpt={tree.parent}/{route}_resumed/ckpt/model000004.pt"))
    assert straight["step"] == resumed["step"] == 6
    assert [e["step"] for e in resumed["logged"]] == [6]
    assert ("store" in straight) == (route == "auto")
    log = (tree.parent / f"{route}_straight" / "log" / "runtime.log").read_text()
    assert ("device store: staging" in log) == (route == "auto")
    for name in ("model000006.pt", "train_state000006.pt"):
        _same_file_tensors(tree.parent / f"{route}_straight" / "ckpt" / name,
                           tree.parent / f"{route}_resumed" / "ckpt" / name)
    assert straight["logged"][-1]["loss"] == resumed["logged"][-1]["loss"]


def test_entry_profiles_and_times_the_loop(tree, monkeypatch):
    """``task.train.profile_steps`` writes a ``torch.profiler`` trace under
    the run's ``log/profile``, and ``task.train.trace=true`` logs the
    tracer's span totals and counters at every logged step, keeps them in
    the summary, and names the program's layers in that trace as ``am.``
    ranges, backward and the denoiser among them."""
    from afford_motion_torch.utils import trace

    monkeypatch.chdir(REPO)
    try:
        summary = train_pkg.main(_entry_args(tree, "profiled", "task.train.max_steps=6",
                                             "task.train.profile_steps=2",
                                             "task.train.trace=true"))
    finally:
        trace.disable()
        trace.take()
        trace.totals()
    run = tree.parent / "profiled"
    assert (run / "log" / "profile" / "trace.json").stat().st_size > 0
    profile = (run / "log" / "profile" / "trace.json").read_text()
    assert '"am.step: backward"' in profile and '"am.model: denoiser"' in profile
    log = (run / "log" / "runtime.log").read_text()
    assert "profiler trace written to log/profile" in log
    timing = [line for line in log.splitlines() if "trace |" in line]
    assert len(timing) == 3 and all(
        all(k in line for k in ("loop: wait", "loop: step", "step: backward", "model: denoiser"))
        for line in timing)
    # the producer's three megabatches and set-up fall in the first window
    assert all(k in timing[0] for k in ("setup: train loop", "producer: prepare",
                                        "producer: bytes uploaded"))
    logged = summary["logged"]
    assert len(logged) == 3 and all(e["spans"]["seconds"]["loop: step"] > 0 for e in logged)
    assert logged[0]["spans"]["counts"]["producer: bytes uploaded"] > 0

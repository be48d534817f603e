"""The port's raw-data preparation chain against the JAX package's, on the CPU
at a small size: one synthetic raw tree (``data/synthetic.py``: HUMANISE's
``align_data_release`` and ``pure_motion`` with 6 motions of 20..60 frames,
2 ScanNet scenes of 2,048 points with segments and objects; 3 PROX
sequences with their cameras and scenes, one of them ascii; AMASS SMPL-X
sequences with their SMPL-H frame rates and HumanML3D's index), the
synthetic SMPL-X at 128 vertices, ``num_points`` 256. Each stage runs on its
own copy of the tree through the root ``prepare.py`` (or the JAX function)
and through ``python -m afford_motion_torch.prepare`` with ``--device cpu``.

Exact, byte for byte: every file the stages write but ``dist`` (the
pickles, ``annotations.csv``, ``normalize_to_center.json``, ``points/``,
``motions/``, the contacts' ``points`` and ``mask``, ``anno.csv``, the
split lists, the target masks); ``contact_data`` and the stages after it
read one set of ``motions_pos`` on both sides. Within tolerance: the
joints of ``smplx_to_vec`` and PROX's pelvis (the two frameworks' float32
LBS: 1e-5 abs + 1e-5 rel), and ``dist``, ``joint_distance_map`` and
``joint_distance_map_batch`` against the float64 brute force
(``contact_data.dist_excess`` at most 1: 16 unit roundoffs of |t|^2 + |s|^2
on the squared distance), each pair's row of a batch bit-equal to its pair
alone. Pinned: where the JAX package fails (``contact_data`` without
``annotations.csv``, ``split_all`` without a set's ``anno.csv``, an empty
caption) the port fails with the same exception type, and where JAX's broad
``except`` would carry on another way (a misaligned OpenScene feature file
in ``process_scene``) the port raises.

The JAX package's SMPL-X joints run under ``jax.jit`` here (patched into
its ``smplx_to_vec`` and ``smplx_lbs`` modules for this file): called
eagerly, as its stages call them, each costs 3-5 s of op dispatch on the
CPU; jitted they agree with the eager ones to 2.4e-7.
"""
import argparse
import logging
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from afford_motion_torch import prepare as port_prepare
from afford_motion_torch.data.synthetic import (
    make_synthetic_raw_amass,
    make_synthetic_raw_humanise,
    make_synthetic_raw_prox,
)
from afford_motion_torch.prepare import contact_data as port_cd
from afford_motion_torch.prepare.raw_datasets import HumanML3DExtractor, create_extractor

N_POINTS = 256
JOINT_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_ARGS = dict(dataset="HUMANISE", data_dir="", out_dir="", num_points=N_POINTS,
                region_size=4.0, seed=0)


def _root_prepare():
    import prepare as root_prepare

    return root_prepare


def _port(stage, data, *extra, dataset="HUMANISE", raw=None):
    port_prepare.main([stage, "--dataset", dataset, "--out_dir", str(data), "--device", "cpu",
                       "--num_points", str(N_POINTS),
                       *(["--data_dir", str(raw)] if raw else []), *extra])


def _files(root: Path, sub: str = ""):
    return sorted(str(p.relative_to(root)) for p in (root / sub).rglob("*") if p.is_file())


def _same_bytes(a: Path, b: Path, sub: str = "", skip=()):
    names = _files(a, sub)
    assert names == _files(b, sub), sub
    for name in names:
        if not name.endswith(skip):
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


@pytest.fixture(scope="module", autouse=True)
def _jax_lbs_jitted():
    """JAX's ``smplx_joints`` jitted, one trace a body model and shape."""
    import jax

    from afford_motion_tpu.eval import smplx_lbs
    from afford_motion_tpu.prepare import smplx_to_vec as jax_smplx_to_vec

    eager, cache = smplx_lbs.smplx_joints, {}

    def jitted(model, transl, orient, body_pose, betas=None):
        key = (id(model), betas is None)
        if key not in cache:
            cache[key] = (model, jax.jit(lambda *a: eager(model, *a)))
        args = (transl, orient, body_pose) + (() if betas is None else (betas,))
        return cache[key][1](*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smplx_lbs, "smplx_joints", jitted)
        mp.setattr(jax_smplx_to_vec, "smplx_joints", jitted)
        yield


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The HUMANISE chain through both packages: process, smplx_to_vec,
    process_scene, contact_data (both on the JAX side's motions_pos),
    split and target_mask; plus PROX's process on the same tree."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SMPLX_USE_SYNTHETIC", "1")
    mp.setenv("SMPLX_SYNTHETIC_VERTS", "128")
    root = tmp_path_factory.mktemp("raw_chain")
    raw, prox_raw = root / "raw", root / "prox_raw"
    jax_root, port_root = root / "jax", root / "port"
    make_synthetic_raw_humanise(str(raw), str(jax_root / "data"), n_scenes=2, scene_points=2048,
                                n_motions=6, horizon_range=(20, 61), seed=0)
    make_synthetic_raw_prox(str(prox_raw), str(jax_root / "data"), n_frames=(5, 4, 3), seed=1)
    shutil.copytree(jax_root, port_root)
    jdata, pdata = jax_root / "data", port_root / "data"
    rp = _root_prepare()
    # the root prepare.py writes process's output under ./data
    mp.chdir(jax_root)
    for dataset, src in (("HUMANISE", raw), ("PROX", prox_raw)):
        rp.cmd_process(argparse.Namespace(**dict(JAX_ARGS, dataset=dataset, data_dir=str(src))))
    mp.chdir(root)
    _port("process", pdata, raw=raw)
    _port("process", pdata, dataset="PROX", raw=prox_raw)
    out = {"jdata": jdata, "pdata": pdata, "root": root}
    for dataset in ("HUMANISE", "PROX"):
        rp.cmd_smplx_to_vec(argparse.Namespace(**dict(JAX_ARGS, dataset=dataset,
                                                      out_dir=str(jdata))))
        _port("smplx_to_vec", pdata, dataset=dataset)
    out["port_motions_pos"] = {p.name: np.load(p)
                               for p in (pdata / "HUMANISE" / "motions_pos").glob("*.npy")}
    rp.cmd_process_scene(argparse.Namespace(**dict(JAX_ARGS, out_dir=str(jdata))))
    _port("process_scene", pdata)
    # contact_data and what follows read the same joints on both sides
    shutil.rmtree(pdata / "HUMANISE" / "motions_pos")
    shutil.copytree(jdata / "HUMANISE" / "motions_pos", pdata / "HUMANISE" / "motions_pos")
    rp.cmd_contact_data(argparse.Namespace(**dict(JAX_ARGS, out_dir=str(jdata))))
    _port("contact_data", pdata)
    from afford_motion_tpu.prepare.split import split_humanise

    split_humanise(str(jdata))
    _port("split", pdata)
    rp.cmd_target_mask(argparse.Namespace(**dict(JAX_ARGS, out_dir=str(jdata))))
    _port("target_mask", pdata)
    yield out
    mp.undo()


def test_humanise_process_files_equal(chain):
    """HUMANISE's parameter pickles and ``annotations.csv``, byte for byte."""
    names = _same_bytes(chain["jdata"], chain["pdata"], "HUMANISE/motions")
    assert len(names) == 6
    assert ((chain["jdata"] / "HUMANISE" / "annotations.csv").read_bytes()
            == (chain["pdata"] / "HUMANISE" / "annotations.csv").read_bytes())


def test_smplx_to_vec_joints_match_jax(chain):
    """``motions_pos``: the same files, (L, 66) float32 joints within
    1e-5 + 1e-5 rel of JAX's LBS."""
    jdir = chain["jdata"] / "HUMANISE" / "motions_pos"
    got = chain["port_motions_pos"]
    assert sorted(got) == sorted(p.name for p in jdir.glob("*.npy")) and len(got) == 6
    for name, v in got.items():
        want = np.load(jdir / name)
        assert v.dtype == np.float32 and v.shape == want.shape and v.shape[1] == 66
        np.testing.assert_allclose(v, want, **JOINT_TOL, err_msg=name)


def test_prox_process_matches_jax(chain):
    """PROX: ``normalize_to_center.json`` byte for byte; each sequence's
    pickle with the same betas, orients, body poses and hands, its
    translations (from the port's pelvis on the device) within the joints'
    tolerance; PROX's joints likewise."""
    j, p = chain["jdata"] / "PROX", chain["pdata"] / "PROX"
    assert (j / "normalize_to_center.json").read_bytes() == (
        p / "normalize_to_center.json").read_bytes()
    names = sorted(f.name for f in (j / "motions").glob("*.pkl"))
    assert names == sorted(f.name for f in (p / "motions").glob("*.pkl")) and len(names) == 3
    for name in names:
        (jp, jb), (pp, pb) = (pickle.load(open(d / "motions" / name, "rb")) for d in (j, p))
        assert pp.dtype == jp.dtype and pp.shape == jp.shape == (jp.shape[0], 159)
        assert np.array_equal(pb, jb) and np.array_equal(pp[:, 3:], jp[:, 3:]), name
        np.testing.assert_allclose(pp[:, :3], jp[:, :3], **JOINT_TOL, err_msg=name)
        np.testing.assert_allclose(np.load(p / "motions_pos" / name.replace(".pkl", ".npy")),
                                   np.load(j / "motions_pos" / name.replace(".pkl", ".npy")),
                                   **JOINT_TOL)


def test_process_scene_files_equal(chain):
    """Every scene of both sets (PROX's ascii one too) to ``points/``, byte
    for byte."""
    for dataset, n in (("HUMANISE", 2), ("PROX", 3)):
        assert len(_same_bytes(chain["jdata"], chain["pdata"], f"{dataset}/points")) == n


def test_contact_data_matches_jax(chain):
    """``contact_motion/``: ``motions/``, ``anno.csv`` and the contacts'
    ``points`` and ``mask`` byte for byte; ``dist`` of both within its
    bound of the float64 brute force."""
    j, p = (d / "HUMANISE" / "contact_motion" for d in (chain["jdata"], chain["pdata"]))
    _same_bytes(j, p, "motions")
    assert (j / "anno.csv").read_bytes() == (p / "anno.csv").read_bytes()
    names = _files(j, "contacts")
    assert names == _files(p, "contacts") and len(names) == 6
    worst = []
    for name in names:
        jz, pz = np.load(j / name), np.load(p / name)
        assert sorted(pz.files) == ["dist", "mask", "points"]
        for key in ("points", "mask"):
            assert pz[key].dtype == jz[key].dtype and np.array_equal(pz[key], jz[key]), name
        assert pz["dist"].dtype == np.float32 and pz["dist"].shape == (N_POINTS, 22)
        pose = np.load(p / "motions" / Path(name).with_suffix(".npy").name)
        exact = port_cd.joint_distance_map_plain(pose, pz["points"][:, :3])
        for dist in (pz["dist"], jz["dist"]):
            worst.append(port_cd.dist_excess(dist, exact, pose, pz["points"][:, :3]))
    assert max(worst) <= 1.0, worst


def test_split_and_target_mask_files_equal(chain):
    """HUMANISE's split lists (scene numbers below 600 train: both splits
    non-empty) and ``contact_motion/target_mask/`` byte for byte."""
    j, p = chain["jdata"] / "HUMANISE", chain["pdata"] / "HUMANISE"
    for name in ("train.txt", "test.txt", "all.txt"):
        assert (j / name).read_bytes() == (p / name).read_bytes(), name
    assert (p / "train.txt").read_text() and (p / "test.txt").read_text()
    masks = _same_bytes(j, p, "contact_motion/target_mask")
    assert len(masks) == 6 and any(np.load(p / m).any() for m in masks)


@pytest.mark.parametrize("dataset", ["PROX", "HumanML3D"])
def test_contact_data_without_annotations_fails_as_jax(chain, dataset, tmp_path):
    """Only HUMANISE's process writes ``annotations.csv``: ``contact_data``
    of PROX (and of HumanML3D) fails on both sides with FileNotFoundError,
    the port's naming the file."""
    data = tmp_path / "data"
    shutil.copytree(chain["pdata"] / "PROX", data / dataset)
    rp = _root_prepare()
    with pytest.raises(FileNotFoundError):
        rp.cmd_contact_data(argparse.Namespace(**dict(JAX_ARGS, dataset=dataset,
                                                      out_dir=str(data))))
    with pytest.raises(FileNotFoundError, match=f"{dataset}/annotations.csv"):
        _port("contact_data", data, dataset=dataset)


def test_split_all_fails_as_jax_without_a_sets_anno(chain, tmp_path):
    """``split_all`` on a tree with HUMANISE alone: HUMANISE's lists are
    written, then PROX's missing ``anno.csv`` raises FileNotFoundError naming
    it, on both sides (the port's ``split --dataset all``)."""
    from afford_motion_tpu.prepare.split import split_all

    for side in ("jax", "port"):
        data = tmp_path / side
        shutil.copytree(chain["pdata"] / "HUMANISE" / "contact_motion",
                        data / "HUMANISE" / "contact_motion")
        with pytest.raises(FileNotFoundError, match="PROX/contact_motion/anno.csv"):
            split_all(str(data)) if side == "jax" else _port("split", data, dataset="all")
        assert (data / "HUMANISE" / "train.txt").read_bytes() == (
            chain["pdata"] / "HUMANISE" / "train.txt").read_bytes()


def test_empty_caption_fails_as_jax(tmp_path, monkeypatch):
    """An empty utterance: ``annotations.csv`` byte for byte, and pandas reads
    the empty text as NaN, on which JAX's ``contact_data`` raises TypeError
    (joining the utterances); the port raises TypeError naming the motion."""
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    trees = {}
    for side in ("jax", "port"):
        raw, data = tmp_path / side / "raw", tmp_path / side / "data"
        make_synthetic_raw_humanise(str(raw), str(data), n_scenes=2, scene_points=512,
                                    n_motions=3, horizon_range=(8, 12), seed=5, empty_caption=1)
        base = data / "HUMANISE"
        (base / "points").mkdir()
        (base / "motions_pos").mkdir()
        for i in range(3):
            np.save(base / "motions_pos" / f"{i:06d}.npy", np.zeros((8, 66), np.float32))
        trees[side] = data
    monkeypatch.chdir(tmp_path / "jax")
    rp = _root_prepare()
    rp.cmd_process(argparse.Namespace(**dict(JAX_ARGS, data_dir=str(tmp_path / "jax" / "raw"))))
    _port("process", trees["port"], raw=tmp_path / "port" / "raw")
    assert ((trees["jax"] / "HUMANISE" / "annotations.csv").read_bytes()
            == (trees["port"] / "HUMANISE" / "annotations.csv").read_bytes())
    for data in trees.values():
        for sid in ("scene0000_00", "scene0700_00"):
            np.save(data / "HUMANISE" / "points" / f"{sid}.npy", np.zeros((16, 6), np.float32))
    with pytest.raises(TypeError):
        rp.cmd_contact_data(argparse.Namespace(**dict(JAX_ARGS, out_dir=str(trees["jax"]))))
    with pytest.raises(TypeError, match="motion 1 has no text"):
        _port("contact_data", trees["port"])


def test_process_scene_raises_where_jax_carries_on(tmp_path):
    """A scene whose OpenScene feature file has another vertex count: JAX's
    ``process_all`` logs it and writes no points for it; the port raises."""
    from afford_motion_tpu.prepare.process_scene import process_all as jax_process_all

    for side in ("jax", "port"):
        data = tmp_path / side
        make_synthetic_raw_humanise(str(tmp_path / "raw"), str(data), n_scenes=1,
                                    scene_points=64, n_motions=1)
        (data / "HUMANISE" / "feat").mkdir()
        np.save(data / "HUMANISE" / "feat" / "scene0000_00_vh_clean_2_openscene_feat_distill.npy",
                np.zeros((63, 4), np.float32))
    jax_process_all(str(tmp_path / "jax"))
    assert not (tmp_path / "jax" / "HUMANISE" / "points" / "scene0000_00.npy").exists()
    with pytest.raises(AssertionError, match="misalignment"):
        _port("process_scene", tmp_path / "port")


class _Records(logging.Handler):
    """The records a logger emits (the packages' loggers do not propagate)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_humanml3d_extractor_matches_jax(tmp_path):
    """AMASS through HumanML3D's index: the same pickles byte for byte (20 fps
    from the SMPL-H frame rate, the lead trim of MPI_HDM05, the cut, a name
    with a space), the same sequences left out with a warning each (the
    humanact12 row silently); the mirrored ``smplx_to_vec`` twins within the
    joints' tolerance. Without the index CSV beside the module,
    ``create_extractor`` raises FileNotFoundError on both sides."""
    from afford_motion_tpu.prepare.raw_datasets import HumanML3DExtractor as JaxExtractor
    from afford_motion_tpu.prepare.raw_datasets import create_extractor as jax_create
    from afford_motion_tpu.prepare.smplx_to_vec import smplx_to_vec as jax_smplx_to_vec
    from afford_motion_tpu.eval.smplx_lbs import SMPLXModel as JaxSMPLX
    from afford_motion_torch.eval.smplx_lbs import SMPLXModel
    from afford_motion_torch.prepare.smplx_to_vec import smplx_to_vec

    smplx, index = make_synthetic_raw_amass(str(tmp_path / "raw"), seed=2)
    outs = {side: tmp_path / side / "motions" for side in ("jax", "port")}
    for side, cls in (("jax", JaxExtractor), ("port", HumanML3DExtractor)):
        logger = logging.getLogger(f"afford_motion_{'tpu' if side == 'jax' else 'torch'}")
        seen = _Records()
        logger.addHandler(seen)
        try:
            cls(smplx, index, str(outs[side])).process()
        finally:
            logger.removeHandler(seen)
        warned = sorted(r.getMessage().split()[0] for r in seen.records)
        assert warned == ["missing", "no", "no"], (side, warned)
    names = _same_bytes(tmp_path / "jax", tmp_path / "port", "motions")
    assert names == [f"motions/{i:06d}.pkl" for i in range(3)]
    for i, name in enumerate(names[:2]):
        with open(tmp_path / "port" / name, "rb") as f:
            smpl = pickle.load(f)
        jax_smplx_to_vec(smpl, "HumanML3D", str(tmp_path / "jax" / "pos" / f"{i}.npy"),
                         JaxSMPLX.synthetic())
        smplx_to_vec(smpl, "HumanML3D", str(tmp_path / "port" / "pos" / f"{i}.npy"),
                     SMPLXModel.synthetic())
        for twin in (f"{i}.npy", f"M{i}.npy"):
            np.testing.assert_allclose(np.load(tmp_path / "port" / "pos" / twin),
                                       np.load(tmp_path / "jax" / "pos" / twin), **JOINT_TOL)
    with pytest.raises(FileNotFoundError):
        jax_create("HumanML3D", smplx)
    with pytest.raises(FileNotFoundError, match="humanml3d_index.csv"):
        create_extractor("HumanML3D", smplx, str(tmp_path))


def test_joint_distance_map_batch_rows_equal_pairs():
    """Ragged lengths 7/33/32/100 in one batch (padded to 128 frames): each
    row bit-equal to its pair alone, and both within the bound of the
    float64 brute force, as is JAX's device path."""
    from afford_motion_tpu.prepare.contact_data import joint_distance_map as jax_map

    rng = np.random.default_rng(3)
    poses = [rng.normal(size=(n, 22, 3)).astype(np.float32) for n in (7, 33, 32, 100)]
    scenes = rng.normal(size=(4, 128, 3)).astype(np.float32)
    got = port_cd.joint_distance_map_batch(poses, scenes, "cpu")
    assert got.shape == (4, 128, 22) and got.dtype == np.float32
    for i, p in enumerate(poses):
        pair = port_cd.joint_distance_map(p, scenes[i], "cpu")
        np.testing.assert_array_equal(got[i], pair)
        exact = port_cd.joint_distance_map_plain(p, scenes[i])
        assert port_cd.dist_excess(pair, exact, p, scenes[i]) <= 1.0
        assert port_cd.dist_excess(jax_map(p, scenes[i], device=True), exact, p,
                                   scenes[i]) <= 1.0
    # a point on a joint: the expanded form cancels to ~0 there
    near = scenes[0].copy()
    near[5] = poses[0][3, 7]
    d = port_cd.joint_distance_map(poses[0], near, "cpu")
    exact = port_cd.joint_distance_map_plain(poses[0], near)
    assert exact[5, 7] == 0 and port_cd.dist_excess(d, exact, poses[0], near) <= 1.0


def test_process_writes_one_chunk_at_a_time(monkeypatch, tmp_path):
    """``process`` hands the device 16 pairs at a time (the last chunk the
    rest, a single pair alone) and its files equal those of a run in
    chunks of 1, bit for bit (a batch row is its pair's)."""
    calls = []
    real = port_cd._distance_map
    monkeypatch.setattr(port_cd, "_distance_map",
                        lambda t, n, s: calls.append(t.shape[0]) or real(t, n, s))
    rng = np.random.default_rng(4)
    scene = {"s": {"pcd": rng.uniform(-2, 2, size=(300, 6)).astype(np.float32)}}
    motions = [(rng.normal(scale=0.3, size=(int(rng.integers(5, 40)), 66)).astype(np.float32),
                [f"c{i}"], ("s", np.eye(4)), {}) for i in range(17)]
    for chunk, out in ((16, tmp_path / "a"), (1, tmp_path / "b")):
        port_cd.process(motions, scene, str(out), num_points=64,
                        rng=np.random.default_rng(0), chunk=chunk, device="cpu")
    assert calls[:2] == [16, 1] and calls[2:] == [1] * 17
    assert len(_same_bytes(tmp_path / "a", tmp_path / "b")) == 2 * 17 + 1


@pytest.mark.parametrize("fails", [False, True])
def test_main_restores_the_callers_tf32_flags(monkeypatch, tmp_path, fails):
    """A stage runs with TF32 off, and the caller's flags are back after it,
    also where the stage raises: a process that calls ``main`` in between
    its own matmuls keeps its settings."""
    seen = []

    def stage(args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        if fails:
            raise RuntimeError("stage failed")

    monkeypatch.setitem(port_prepare.STAGES, "split", stage)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    try:
        _port("split", tmp_path)
    except RuntimeError:
        assert fails
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32

"""The port's ``ContactMotionDataset`` (``afford_motion_torch.data.motionx``)
against the JAX package's on one synthetic HUMANISE + PROX tree: the same
cases in the same order, and every field of every item equal (arrays bit for
bit), in the test phase (stage-1 ``pred_contact`` handoff, target masks) and,
with the global numpy and ``random`` streams seeded alike, in the train phase
(random rotation, classifier-free-guidance flags, the half-precision wire).
"""
import random

import numpy as np
import pytest

from afford_motion_tpu.data import create_dataset as jax_create_dataset
from afford_motion_tpu.utils.config import load_config as jax_load_config
from afford_motion_torch.data import create_dataset
from afford_motion_torch.data.base import NOT_PORTED_DATASETS
from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
from afford_motion_torch.utils.config import load_config

N_POINTS, K = 64, 2


@pytest.fixture
def tree(tmp_path):
    """A fresh tree for every test: the statistics file that a dataset
    writes (and the test-phase test deletes) is never shared."""
    root = tmp_path / "motionx"
    data, contacts = root / "data", root / "contacts"
    rng = np.random.default_rng(0)
    for k, name in enumerate(("HUMANISE", "PROX")):
        make_synthetic_motionx_set(str(data), name, n_items=12, num_points=N_POINTS,
                                   horizon_range=(20, 70), seed=k)
        pred = contacts / name / "pred_contact"
        pred.mkdir(parents=True)
        for i in range(12):
            np.save(pred / f"{i:05d}.npy",
                    np.abs(rng.normal(size=(K, N_POINTS, 6))).astype(np.float32))
    return data, contacts


def _args(tree):
    data, contacts = tree
    return ["task=contact_motion_gen", "model=cmdm", f"task.dataset.data_dir={data}",
            "task.dataset.sets=[HUMANISE,PROX]", f"task.dataset.num_points={N_POINTS}",
            f"task.test.contact_folder={contacts}", "task.dataset.mix_train_ratio=0.0"]


def _assert_items_equal(a, b):
    assert list(a) == list(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def test_test_phase_items_equal_jax(tree):
    argv = _args(tree)
    tcfg, jcfg = load_config("configs", argv), jax_load_config("configs", argv)
    tds = create_dataset(tcfg.task.dataset, "test", contact_folder=str(tree[1]))
    for stats in tree[0].glob("Mean_Std_CM_*.npz"):
        stats.unlink()   # so each package computes its own statistics
    jds = jax_create_dataset(jcfg.task.dataset, "test", contact_folder=str(tree[1]))
    np.testing.assert_array_equal(tds.mean, jds.mean)
    np.testing.assert_array_equal(tds.std, jds.std)
    # horizons below min_horizon (24) are filtered out of the 3 + 3 test cases
    assert len(tds) == len(jds) and 0 < len(tds) <= 6
    assert tds.indices == jds.indices
    sets = set()
    for i in range(len(tds)):
        random.seed(i)   # the caption is drawn from the item's descriptions
        a = tds[i]
        random.seed(i)
        b = jds[i]
        _assert_items_equal(a, b)
        assert a["x"].shape == (196, 66) and a["c_pc_contact"].shape == (K, N_POINTS, 6)
        assert (a["info_obj_mask"] is None) == (a["info_set"] == "PROX")
        sets.add(a["info_set"])
    assert sets == {"HUMANISE", "PROX"}
    # each loader read to its end, so its prefetch thread has finished: a
    # thread left blocked mid-epoch would go on drawing captions from the
    # global random stream while the next test seeds and shuffles with it
    batch = list(tds.get_dataloader(batch_size=2, shuffle=False, drop_last=True))[0]
    jbatch = list(jds.get_dataloader(batch_size=2, shuffle=False, drop_last=True))[0]
    assert batch["x"].shape == (2, 196, 66) and sorted(batch) == sorted(jbatch)


def test_train_phase_items_equal_jax(tree):
    argv = _args(tree)
    tcfg, jcfg = load_config("configs", argv), jax_load_config("configs", argv)
    random.seed(3), np.random.seed(3)
    tds = create_dataset(tcfg.task.dataset, "train")
    random.seed(3), np.random.seed(3)
    jds = jax_create_dataset(jcfg.task.dataset, "train")
    assert tds.indices == jds.indices and len(tds) > 6
    for i in range(4):
        random.seed(i), np.random.seed(i)
        a = tds[i]
        random.seed(i), np.random.seed(i)
        b = jds[i]
        _assert_items_equal(a, b)
        # the half-precision wire of the shipped config
        assert a["c_pc_xyz"].dtype == np.float16 and a["x"].dtype == np.float16


def test_dataset_refusals(tree):
    """What waits for its own slice is refused by name: the other classes of
    the family, and a packed MotionX store under the training wire format."""
    argv = _args(tree)
    for name in NOT_PORTED_DATASETS:
        cfg = load_config("configs", argv + [f"task.dataset.name={name}"])
        with pytest.raises(NotImplementedError, match="not ported yet"):
            create_dataset(cfg.task.dataset, "test", contact_folder=str(tree[1]))
    with pytest.raises(AssertionError, match="contact folder"):
        create_dataset(load_config("configs", argv).task.dataset, "test")
    packed = tree[0] / "PROX" / "contact_motion" / "packed"
    packed.mkdir()
    (packed / "meta.json").write_text("{}")
    try:
        cfg = load_config("configs", argv)
        with pytest.raises(NotImplementedError, match="packed MotionX store .* is not ported yet"):
            create_dataset(cfg.task.dataset, "train")
        # the test phase never reads the store, and use_packed=false passes it over
        assert len(create_dataset(cfg.task.dataset, "test", contact_folder=str(tree[1]))) > 0
        cfg = load_config("configs", argv + ["task.dataset.use_packed=false"])
        assert len(create_dataset(cfg.task.dataset, "train")) > 0
    finally:
        (packed / "meta.json").unlink()
        packed.rmdir()

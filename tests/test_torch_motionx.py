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
from afford_motion_torch.utils.registry import DATASET
from afford_motion_torch.data.synthetic import make_synthetic_motionx_set
from afford_motion_torch.utils.config import load_config

N_POINTS, K = 64, 2
# the ten registered classes of the family
FAMILY = ("MotionXDataset", "ContactMapDataset", "ContactMotionDataset", "MotionXExampleDataset",
          "ContactMapExampleDataset", "ContactMotionExampleOriginDataset",
          "ContactMotionExampleDataset", "MotionXCustomDataset", "ContactMapCustomDataset",
          "ContactMotionCustomDataset")


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
    """Every class of the MotionX family is ported and the factory refuses
    none by name: each is registered in both packages, and
    ``MotionXDataset`` builds through the factory in both phases. What is
    still refused: the test phase of ``ContactMotionDataset`` without a
    contact folder. A packed store that cannot be opened (a meta of another
    version) is passed over for the ``.npz`` files, as the H3D store is; an
    opened one serves the train phase (``tests/test_torch_motionx_store.py``)."""
    from afford_motion_tpu.utils.registry import DATASET as JAX_DATASET

    argv = _args(tree)
    for name in FAMILY:
        assert name in DATASET and name in JAX_DATASET, name
    cfg = load_config("configs", argv + ["task.dataset.name=MotionXDataset",
                                         "task.dataset.use_color=true"])
    for phase in ("test", "train"):
        ds = create_dataset(cfg.task.dataset, phase)
        assert type(ds).__name__ == "MotionXDataset" and len(ds) > 0
        assert ds[0]["c_pc_feat"].shape == (N_POINTS, 3) and ds[0]["x"].shape == (196, 66)
    with pytest.raises(AssertionError, match="contact folder"):
        create_dataset(load_config("configs", argv).task.dataset, "test")
    packed = tree[0] / "PROX" / "contact_motion" / "packed"
    packed.mkdir()
    (packed / "meta.json").write_text("{}")
    try:
        cfg = load_config("configs", argv)
        train = create_dataset(cfg.task.dataset, "train")
        assert train._packed == {} and len(train) > 0
        # the test phase never reads the store, and use_packed=false passes it over
        assert len(create_dataset(cfg.task.dataset, "test", contact_folder=str(tree[1]))) > 0
        cfg = load_config("configs", argv + ["task.dataset.use_packed=false"])
        assert len(create_dataset(cfg.task.dataset, "train")) > 0
    finally:
        (packed / "meta.json").unlink()
        packed.rmdir()

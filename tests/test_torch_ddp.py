"""Data parallelism of the port (``afford_motion_torch/parallel/mesh.py``) on
the CPU: world 2 over gloo, two processes started by ``torchrun``
(``python -m torch.distributed.run --standalone``) with a ``file://``
rendezvous for the group under the test's directory, a group timeout
(``AM_DDP_TIMEOUT_S``) and a join timeout, one torch thread a process. The
ranks (``tests/torch_ddp_workers.py``) import no JAX; every input comes from
here, made from numpy seeds, and one spawn runs every task.

Held, each at its test:

- the world-2 ``trans_enc`` train step (``tests/test_torch_train.py``'s
  width: batch 4 x 512 points, dropout 0, t and noise injected) against the
  JAX package's step on a 2-device CPU mesh, with that file's tolerances:
  loss 1e-5 (rel) at the first step and 1e-4 after, gradients 1e-3 of each
  tensor's largest entry, grad_norm 1e-4, parameters after AdamW 1e-6 where
  the gradient is not at rounding level (else 2 lr), BatchNorm buffers
  1e-5; both ranks' weights and buffers bit-equal after three steps;
- the synced ``PointNorm`` against one process: output, input and
  parameter gradients and running statistics within 1e-5 of the largest
  entry (float32 sums in another order);
- the sharded ``fetch`` bit for bit against the replicated one, on arrays
  with negative zeros and NaN payloads whose pad rows hold a sentinel, and
  the batch assembled from the prepared tree's sharded store (geometry cache
  included) against the replicated store's rows;
- a world-2 run of ``afford_motion_torch.train_ddp`` through the sharded
  store, 4 steps straight against 2 + 2 resumed, bit for bit; one that names
  no ``exp_dir``, whose ranks load their configs in different seconds, in
  rank 0's experiment directory alone;
- the test entry's chain at world 2 (shares of 1 and 2 rows, and an empty
  one) against one process, and the SMPL-X fit at world 2 against one
  process and the JAX package's fit on its mesh;
- the refusal of a global batch the world does not divide, and the
  collectives' bit carriage.
"""
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afford_motion_tpu.diffusion import create_gaussian_diffusion as jax_diffusion
from afford_motion_tpu.eval import joints_to_smplx as jfit
from afford_motion_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from afford_motion_tpu.train.state import TrainState as JaxTrainState
from afford_motion_tpu.train.state import make_optimizer as jax_make_optimizer
from afford_motion_tpu.utils.config import DictConfig as JaxDictConfig
from afford_motion_torch import test as test_entry
from afford_motion_torch.data import create_dataset
from afford_motion_torch.eval import joints_to_smplx as tfit
from afford_motion_torch.models.cmdm import CMDM
from afford_motion_torch.models.pointtransformer import PointNorm
from afford_motion_torch.parallel import mesh
from afford_motion_torch.train import loop as loop_mod
from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
from afford_motion_torch.utils.config import DictConfig
from afford_motion_torch.utils.convert import cmdm_state_dict_from_jax
from tests.test_torch_device_store import N_POINTS, _cfg, _entry_args, tree  # noqa: F401
from tests.test_torch_train import (  # noqa: F401 (setup is a fixture)
    ARCH, BLOCKS, LAYERS, _assert_trees_close, _flat, _jax_step, _same_file_tensors, _to_tree,
    setup)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, LR = 2, 1e-4
# the group's timeout and the spawn's join timeout, seconds
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 300
TINY_ARCH = dict(motion_dim=263, latent_dim=32, time_emb_dim=32, text_feat_dim=16,
                 contact_dim=6, planes=(8, 16, 32, 64), blocks=(2, 2, 2, 2), num_layers=(1, 1),
                 num_heads=4, dim_feedforward=32)
FIT_B, FIT_L, FIT_STEPS = 3, 12, 5
IDS = [0, 5, 2, 7]


def _synthetic_arrays():
    """Seven rows in the store's dtypes, with negative zeros and NaN
    payloads a sum in float arithmetic would not keep."""
    rng = np.random.default_rng(4)
    f16 = rng.normal(size=(7, 3)).astype(np.float16)
    f16[1, 0] = -0.0
    f16.view(np.uint16)[2, 1] = 0x7E01
    f32 = rng.normal(size=(7, 2, 2)).astype(np.float32)
    f32[3, 1, 1] = -0.0
    f32.view(np.uint32)[4, 0, 0] = 0x7FC00123
    return {"f16": f16, "f32": f32, "i16": rng.integers(-30000, 30000, (7,)).astype(np.int16),
            "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, (7, 4)).astype(np.int32),
            "flag": rng.random((7, 3)) < 0.5, "scene_row": np.arange(7, dtype=np.int32)[::-1].copy()}


SYNTHETIC_ROWS = [np.array([6, 0, 6, 3, 1, 5]), np.array([2, 2, 4, 4, 6, 6])]


@pytest.fixture(scope="module")
def contacts(tree):  # noqa: F811
    """The stage-1 handoff the test entry reads for each test item."""
    root = tree.parent / "contacts"
    pred = root / "H3D" / "pred_contact"
    pred.mkdir(parents=True)
    rng = np.random.default_rng(9)
    for name in (tree / "H3D" / "test.txt").read_text().split():
        np.save(pred / f"{name}-0.npy", rng.uniform(size=(1, N_POINTS, 6)).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def regressor_file(tmp_path_factory):
    jreg = jfit.JointsToSMPLXRegressor()
    variables = jax.device_get(jreg.init({"params": jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 8, 66)), jnp.zeros((1, 8), bool),
                                         train=False))
    path = str(tmp_path_factory.mktemp("fit") / "regressor.npz")
    jfit.save_regressor_npz(path, variables["params"])
    return path


def _fit_inputs():
    rng = np.random.default_rng(0)
    x_mask = np.zeros((FIT_B, FIT_L), dtype=bool)
    x_mask[0, 9:] = True
    x_mask[2, 5:] = True
    return rng.normal(size=(FIT_B, FIT_L, 66)).astype(np.float32) * 0.5, x_mask


def _test_args(tree, contacts, *extra):  # noqa: F811
    return _entry_args(tree, "straight", "task.train.batch_size=4",
                       f"task.test.contact_folder={contacts}", "task.evaluator.eval_nbatch=1",
                       "diffusion.timestep_respacing=ddim4", *extra)


TEST_RUNS = (("task.test.batch_size=3", "task.test.sampler=ddpm"),
             ("task.test.batch_size=1", "task.test.sampler=ddim"))


@pytest.fixture(scope="module")
def ranks(setup, tree, contacts, regressor_file, tmp_path_factory):  # noqa: F811
    """One world-2 spawn that runs every task; returns (its output
    directory, the payload)."""
    work = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(11)
    entry = lambda exp, *extra: _entry_args(tree, exp, "task.train.batch_size=4", *extra)  # noqa: E731
    joints, x_mask = _fit_inputs()
    payload = {
        "tasks": ["step", "pointnorm", "fetch", "fit", "entry", "dirs"],
        "env": {"SMPLX_USE_SYNTHETIC": "1", "SMPLX_SYNTHETIC_VERTS": "64"},
        "arch": ARCH, "lr": LR, "weight_decay": 0.0, "lr_anneal_steps": 0,
        "state_dict": cmdm_state_dict_from_jax(setup["variables"], num_layers=LAYERS,
                                               blocks=BLOCKS),
        "x": torch.from_numpy(setup["x"]), "cond": setup["tcond"],
        "ts": [torch.from_numpy(t) for t in setup["ts"]],
        "noises": [torch.from_numpy(n) for n in setup["noises"]],
        "norm": {"weight": torch.from_numpy(rng.normal(size=5).astype(np.float32)),
                 "bias": torch.from_numpy(rng.normal(size=5).astype(np.float32)),
                 "running_mean": torch.from_numpy(rng.normal(size=5).astype(np.float32)),
                 "running_var": torch.from_numpy(rng.uniform(0.5, 2, size=5).astype(np.float32)),
                 "num_batches_tracked": torch.tensor(3)},
        "arrays": _synthetic_arrays(), "rows": SYNTHETIC_ROWS,
        "dataset_cfg": _cfg(tree, dict), "tiny_arch": TINY_ARCH, "ids": IDS,
        "fit_weights": regressor_file, "fit_steps": FIT_STEPS, "joints": joints,
        "x_mask": x_mask, "repo": REPO, "init": f"file://{work / 'rendezvous'}",
        "straight": entry("straight", "task.train.max_steps=4"),
        "first": entry("resumed", "task.train.max_steps=2"),
        "resumed": entry("resumed", "task.train.max_steps=4",
                         f"task.train.resume_ckpt={tree.parent}/resumed/ckpt/model000002.pt"),
        "tests": [_test_args(tree, contacts, *extra) for extra in TEST_RUNS],
        "dirs": [a for a in entry("unused", "task.train.max_steps=2") if not a.startswith(
            "exp_dir=")] + [f"output_dir={work / 'dirs'}", "exp_name=dirs"],
    }
    payload["pn_x"] = torch.from_numpy(rng.normal(size=(8, 7, 5)).astype(np.float32) * 3 + 1)
    payload["pn_w"] = torch.from_numpy(rng.normal(size=(8, 7, 5)).astype(np.float32))
    torch.save(payload, work / "payload.pt")
    _torchrun(["-m", "tests.torch_ddp_workers", str(work / "payload.pt"), str(work)],
              work / "ranks.log")
    return work, payload


def _torchrun(argv, log):
    """Start ``argv`` as the WORLD ranks of a group under ``torchrun``,
    output to ``log``; wait at most JOIN_TIMEOUT_S, then stop the launcher
    and its ranks. A rank that fails makes the launcher stop the others and
    exit non-zero: raise with the tail of the output."""
    env = dict(os.environ, AM_DDP_TIMEOUT_S=str(GROUP_TIMEOUT_S), OMP_NUM_THREADS="1")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", str(WORLD), *argv], cwd=REPO, env=env,
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=JOIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = f"not done within {JOIN_TIMEOUT_S} s"
    if rc != 0:
        raise RuntimeError(f"torchrun: {rc}\n{open(log).read()[-6000:]}")


def _load(work, task, rank):
    return torch.load(work / f"{task}_rank{rank}.pt", weights_only=False)


# ------------------------------------------------------------- the train step
def test_world2_train_step_matches_jax_mesh(setup, ranks):  # noqa: F811
    """Three steps at world 2 against the JAX step on a 2-device mesh."""
    work, _ = ranks
    got = _load(work, "step", 0)
    variables = setup["variables"]
    cfg = JaxDictConfig({"steps": 1000})
    jd = jax_diffusion(cfg)
    two = create_mesh(jax.devices()[:WORLD])
    jstate = replicate(JaxTrainState.create(
        params=variables["params"], batch_stats=variables["batch_stats"],
        tx=jax_make_optimizer(LR, 0.0, 0, params=variables["params"])), two)
    x, jcond = shard_batch((jnp.asarray(setup["x"]), setup["jcond"]), two)
    jstep = jax.jit(lambda s, x, c, t, n: _jax_step(setup["jm"], jd, s, x, c, t, n))
    for i, (t, noise) in enumerate(zip(setup["ts"], setup["noises"])):
        jstate, jloss, jgrads = jstep(jstate, x, jcond, *shard_batch(
            (jnp.asarray(t), jnp.asarray(noise)), two))
        np.testing.assert_allclose(got["loss"][i], float(jloss), rtol=1e-5 if i == 0 else 1e-4)
        if i == 0:
            jg = jax.device_get(jgrads)
            _assert_trees_close(_to_tree(got["grads"])["params"], jg, rel_of_max=1e-3,
                                what="grad")
            want_norm = np.sqrt(sum(float((g ** 2).sum()) for _, g in _flat(jg)))
            np.testing.assert_allclose(got["grad_norm"][0], want_norm, rtol=1e-4)
            after = _to_tree(got["after1"])
            jafter = dict(_flat(jax.device_get(jstate.params)))
            before, jgf = dict(_flat(variables["params"])), dict(_flat(jg))
            zero = 1e-5 * max(np.abs(g).max() for g in jgf.values())
            for path, v in _flat(after["params"]):
                v = np.asarray(v)
                # Adam moves a numerically zero gradient's entry by +-lr
                if np.abs(jgf[path]).max() < zero:
                    assert np.abs(v - before[path]).max() <= LR * 1.001, path
                    continue
                big = np.abs(jgf[path]) >= 1e-6
                np.testing.assert_allclose(v[big], jafter[path][big], rtol=0, atol=1e-6,
                                           err_msg="/".join(path))
                assert np.abs(v - jafter[path]).max() <= 2 * LR * 1.001, path
            _assert_trees_close(after["batch_stats"], jax.device_get(jstate.batch_stats),
                                atol=1e-5, what="buffer after step")
    assert int(jstate.step) == 3


def test_world2_ranks_agree_after_steps(ranks):
    """Both ranks hold the same weights and running statistics, bit for bit,
    and logged the same global loss."""
    work, _ = ranks
    a, b = _load(work, "step", 0), _load(work, "step", 1)
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for k, v in a["after"].items():
        assert torch.equal(v, b["after"][k]), k
    assert any("running_var" in k for k in a["after"])


def test_loss_second_moment_history_is_the_global_batchs(setup, ranks):  # noqa: F811
    """The loss-second-moment sampler at world 2 folds in the all-gathered t
    and losses in global row order: both ranks hold the same history, which
    one process's three steps give (counts exactly, losses within 1e-5
    (rel), float32 sums in another order)."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.diffusion.resample import LossSecondMomentResampler
    from afford_motion_torch.train.state import TrainState

    work, p = ranks
    a, b = (_load(work, "step", r)["sampler_state"] for r in range(WORLD))
    assert all(torch.equal(a[k], b[k]) for k in a)
    tm = CMDM(**ARCH, dropout=0.0)
    tm.load_state_dict(p["state_dict"], strict=True)
    sampler = LossSecondMomentResampler(1000, history_per_term=2)
    state = TrainState.create(tm, lr=LR, sampler_state=sampler.init_state())
    step = loop_mod.make_train_step(tm, create_gaussian_diffusion(DictConfig({"steps": 1000})),
                                    sampler)
    for i, (t, noise) in enumerate(zip(p["ts"], p["noises"])):
        step(state, p["x"], p["cond"], seed=i, t=t, noise=noise)
    want = state.sampler_state
    assert torch.equal(a["loss_counts"], want["loss_counts"]) and int(want["loss_counts"].sum()) > 0
    np.testing.assert_allclose(a["loss_history"].numpy(), want["loss_history"].numpy(),
                               rtol=1e-5, atol=0)


# -------------------------------------------------------------- the statistics
def test_synced_pointnorm_matches_one_process(ranks):
    """Forward, backward and running statistics of the world-2 PointNorm
    against one process's over the whole batch."""
    work, p = ranks
    pn = PointNorm(5).train()
    pn.load_state_dict(p["norm"])
    x = p["pn_x"].clone().requires_grad_(True)
    y = pn(x)
    (y * p["pn_w"]).sum().backward()
    got = [_load(work, "pointnorm", r) for r in range(WORLD)]

    def close(a, b, what):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, b.abs().max().item()), err_msg=what)

    close(torch.cat([g["y"] for g in got]), y.detach(), "y")
    close(torch.cat([g["x_grad"] for g in got]), x.grad, "x grad")
    close(sum(g["weight_grad"] for g in got), pn.weight.grad, "weight grad")
    close(sum(g["bias_grad"] for g in got), pn.bias.grad, "bias grad")
    for k in ("running_mean", "running_var"):
        close(got[0]["buffers"][k], pn.state_dict()[k], k)
        assert torch.equal(got[0]["buffers"][k], got[1]["buffers"][k])


# ----------------------------------------------------------- the sharded store
def test_sharded_fetch_is_bit_equal_to_the_replicated_one(ranks):
    """Every array but the scene table sharded (``min_bytes=0``), seven rows
    over two ranks (rank 1's pad row a sentinel): each rank's fetch is its
    rows of the replicated gather, bit for bit."""
    work, p = ranks
    for r in range(WORLD):
        got = _load(work, "fetch", r)
        assert got["sharded_keys"] == sorted(k for k in p["arrays"] if k != "scene_row")
        for j, rows in enumerate(SYNTHETIC_ROWS):
            mine = rows[r * 3:(r + 1) * 3]
            for k, a in p["arrays"].items():
                v = got["synthetic"][(j, k)].numpy()
                assert v.dtype == a.dtype and v.shape == (3,) + a.shape[1:], k
                assert v.tobytes() == a[mine].tobytes(), (j, k)


def test_sharded_store_assembles_the_replicated_batch(tree, ranks):  # noqa: F811
    """The prepared tree's store sharded over two ranks, its geometry cache
    computed by each rank for its scenes: each rank's assembled batch is its
    rows of the replicated store's, bit for bit."""
    import random

    work, p = ranks
    random.seed(3)
    np.random.seed(3)
    ds = create_dataset(DictConfig(p["dataset_cfg"]), "train")
    torch.manual_seed(0)
    model = CMDM(**TINY_ARCH, dropout=0.0)
    store = DeviceStore.try_build(ds, max_bytes=1 << 30)
    store.add_geometry_cache(model, "cpu")
    meta = store.draw_batch(ds, IDS, random.Random(5), np.random.RandomState(6))
    meta.pop("c_text")
    meta["text_emb"] = np.zeros((len(IDS), 1, 16), np.float16)
    x, cond = make_assemble_fn(store, "cpu")(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in meta.items()})
    want = {"x": x, **cond}
    for r in range(WORLD):
        got = _load(work, "fetch", r)
        assert "xyz16" in got["store_sharded_keys"] and "geo_sm0_knn_idx" in got["store_sharded_keys"]
        assert set(got["assembled"]) == set(want)
        for k, v in want.items():
            g = got["assembled"][k]
            assert g.dtype == v.dtype and torch.equal(g, v[r * 2:(r + 1) * 2]), k


# ------------------------------------------------------------------ the entries
def test_world2_entry_resume_is_bit_exact(tree, ranks):  # noqa: F811
    """``afford_motion_torch.train_ddp`` at world 2 through the sharded
    store: 4 steps straight and 2 + 2 resumed end in the same files."""
    work, _ = ranks
    for r in range(WORLD):
        res = _load(work, "entry", r)
        straight, resumed = res["straight"], res["resumed"]
        assert straight["world"] == WORLD and straight["rank"] == r
        assert straight["store"]["sharded"], "nothing sharded"
        assert straight["step"] == resumed["step"] == 4
        assert straight["logged"][-1]["loss"] == resumed["logged"][-1]["loss"]
    for name in ("model000004.pt", "train_state000004.pt"):
        _same_file_tensors(tree.parent / "straight" / "ckpt" / name,
                           tree.parent / "resumed" / "ckpt" / name)


def test_world2_test_chain_matches_one_process(tree, contacts, ranks, monkeypatch):  # noqa: F811
    """The test entry's chain at world 2 (test batch 3: shares of 1 and 2
    rows, a respaced DDPM-4 chain; batch 1: an empty share, DDIM-4) against
    one process from the same checkpoint: every draw is made for the whole
    batch, so the rows agree bit for bit."""
    work, _ = ranks
    monkeypatch.chdir(REPO)
    got = _load(work, "entry", 0)["tests"]
    for extra, out in zip(TEST_RUNS, got):
        want = np.load(os.path.join(test_entry.main(_test_args(tree, contacts, *extra)),
                                    "samples.npz"))
        assert out["sample"].shape == want["sample"].shape
        np.testing.assert_array_equal(out["sample"], want["sample"])


def test_world2_fit_matches_one_process_and_jax_mesh(ranks, regressor_file, monkeypatch):
    """The fit's rows split 1 + 2 over the ranks, the denominators summed
    over them, against the one-process fit and the JAX package's fit on its
    3-device mesh, each within ``tests/test_torch_fit.py``'s bound (2 lr a
    step everywhere, 1e-4 on 99% of the entries): the regressor's and the
    skinning's products at 1 and 2 rows sum in other orders than at 3 on
    the CPU, and Adam's first steps move a rounding-level gradient's entry
    by lr with a noisy sign. Both ranks return the same params."""
    monkeypatch.setenv("SMPLX_USE_SYNTHETIC", "1")
    monkeypatch.setenv("SMPLX_SYNTHETIC_VERTS", "64")
    work, _ = ranks
    joints, x_mask = _fit_inputs()
    one = tfit.JointsToSMPLXFitter(regressor_file, opt_rate=0.02, opt_steps=FIT_STEPS,
                                   device="cpu").fit(joints, x_mask)
    jax_fit = jfit.JointsToSMPLXFitter(regressor_file, opt_rate=0.02,
                                       opt_steps=FIT_STEPS).fit(joints, x_mask)
    got = _load(work, "fit", 0)["params"]
    np.testing.assert_array_equal(got, _load(work, "fit", 1)["params"])
    assert got.shape == (FIT_B, FIT_L, 69) and got.dtype == np.float32
    for want in (one, jax_fit):
        diff = np.abs(got - want)[~x_mask]
        assert diff.max() <= 2 * 0.02 * FIT_STEPS + 1e-6 and (diff > 1e-4).mean() <= 0.01


def test_world2_entry_without_exp_dir_shares_rank0s(ranks):
    """A world-2 run of ``train_ddp`` that names no ``exp_dir``: each rank
    resolves the time in ``exp_dir`` when it loads its config, rank 1 more
    than a second after rank 0, and both train in rank 0's directory, the
    only one made."""
    work, _ = ranks
    got = [_load(work, "dirs", r) for r in range(WORLD)]
    assert got[0]["last_ckpt"] == got[1]["last_ckpt"] and os.path.isfile(got[0]["last_ckpt"])
    made = os.listdir(work / "dirs")
    assert len(made) == 1 and made[0].endswith("_dirs"), made
    assert got[0]["last_ckpt"].startswith(str(work / "dirs" / made[0]))


# --------------------------------------------------------------------- the rest
def test_indivisible_global_batch_is_refused(tree, monkeypatch):  # noqa: F811
    """A kept divergence from the JAX loop, whose mesh takes the largest
    device prefix that divides the batch: here the launcher fixes the world,
    so a global batch of 4 over 3 ranks raises, naming both."""
    dp = mesh.DataParallel(0, 3, torch.device("cpu"), "gloo")
    monkeypatch.setattr(loop_mod, "current", lambda: dp)
    monkeypatch.chdir(REPO)
    from afford_motion_torch import train as train_pkg

    with pytest.raises(ValueError, match=r"global batch of 4 rows does not split over 3"):
        train_pkg.main(_entry_args(tree, "refused", "task.train.batch_size=4",
                                   "task.train.max_steps=2"))
    assert dp.chunk(4) == slice(0, 1) and mesh.DataParallel(2, 3, "cpu", "gloo").chunk(4) == \
        slice(2, 4)


def test_dropout_streams_differ_by_rank(setup):  # noqa: F811
    """A kept divergence: above one process each rank draws its dropout
    masks from a generator of ``rank_seed(step seed, rank)``, so two ranks
    with the same rows, weights, t and noise part at dropout 0.1 and agree
    at 0; at world 1 the masks come from the step's generator, as without a
    group. The collectives are stood in for (one process, no group)."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.train.state import TrainState

    sd = cmdm_state_dict_from_jax(setup["variables"], num_layers=LAYERS, blocks=BLOCKS)
    x, cond = torch.from_numpy(setup["x"]), setup["tcond"]
    t = torch.from_numpy(np.concatenate([setup["ts"][0]] * 2))
    noise = torch.from_numpy(np.concatenate([setup["noises"][0]] * 2))

    def loss(p, world, rank):
        tm = CMDM(**ARCH, dropout=p)
        tm.load_state_dict(sd, strict=True)
        dp = None
        if world:
            dp = mesh.DataParallel(rank, world, torch.device("cpu"), "gloo")
            dp.all_reduce = lambda v: v * world  # the ranks' sum of equal values
        step = loop_mod.make_train_step(tm, create_gaussian_diffusion(DictConfig({"steps": 1000})),
                                        dp=dp)
        state = TrainState.create(tm, lr=LR)
        n = x.shape[0] * (world or 1)
        return float(step(state, x, cond, seed=7, t=t[:n], noise=noise[:n])["loss"])

    assert loss(0.1, 2, 0) != loss(0.1, 2, 1)
    assert loss(0.0, 2, 0) == loss(0.0, 2, 1)
    assert loss(0.1, 1, 0) == loss(0.1, None, 0)
    seeds = {loop_mod.rank_seed(loop_mod.step_seed(2023, s), r) for s in range(8) for r in range(8)}
    assert len(seeds) == 64


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32, torch.float64,
                                   torch.int8, torch.uint8, torch.int16, torch.int32,
                                   torch.int64, torch.bool])
def test_collectives_carry_bits(dtype):
    """What rides a collective as integers comes back bit for bit."""
    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 256, size=64, dtype=np.uint8))
    t = raw.view(dtype) if dtype != torch.bool else raw < 128
    v = mesh.to_bits(t)
    assert v.dtype in (torch.int32, torch.int64)
    back = mesh.from_bits(v + torch.zeros_like(v), t.dtype)
    assert back.dtype == t.dtype and back.view(torch.uint8).tolist() == t.view(
        torch.uint8).tolist()

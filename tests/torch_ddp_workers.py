"""The ranks of ``tests/test_torch_ddp.py``: each is a process of a world-2
gloo group on the CPU, started by ``torchrun``:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m tests.torch_ddp_workers <payload.pt> <out_dir>

It imports neither JAX nor the JAX package: the parent test hands it every
input in ``payload.pt`` (torch tensors, numpy arrays and plain dicts) and
reads back ``<out_dir>/<task>_rank<r>.pt``. One torch thread a process; the
group's timeout comes from ``AM_DDP_TIMEOUT_S``.
"""
import os
import random
import sys
import time

import numpy as np
import torch


def task_step(p, dp, out):
    """Three optimizer steps of the world-2 CMDM train step with injected t
    and noise, from the parent's weights, on this rank's rows."""
    from afford_motion_torch.diffusion import create_gaussian_diffusion
    from afford_motion_torch.diffusion.resample import LossSecondMomentResampler
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.train.loop import make_train_step
    from afford_motion_torch.train.state import TrainState
    from afford_motion_torch.utils.config import DictConfig

    tm = CMDM(**p["arch"], dropout=0.0)
    tm.load_state_dict(p["state_dict"], strict=True)
    td = create_gaussian_diffusion(DictConfig({"steps": 1000}))
    state = TrainState.create(tm, lr=p["lr"], weight_decay=p["weight_decay"],
                              lr_anneal_steps=p["lr_anneal_steps"])
    dp.broadcast_module(tm)
    step = make_train_step(tm, td, dp=dp, forward=dp.wrap(tm))
    rows = dp.local_rows(p["x"].shape[0])
    x, cond = p["x"][rows], {k: v[rows] for k, v in p["cond"].items()}
    res = {"loss": [], "grad_norm": []}
    for i, (t, noise) in enumerate(zip(p["ts"], p["noises"])):
        m = step(state, x, cond, seed=i, t=t, noise=noise)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            res["grads"] = {k: q.grad.clone() for k, q in tm.named_parameters()
                            if q.grad is not None}
            res["after1"] = {k: v.clone() for k, v in tm.state_dict().items()}
    res["after"] = tm.state_dict()
    # the loss-second-moment sampler folds in the all-gathered t and losses
    sampler = LossSecondMomentResampler(1000, history_per_term=2)
    tm = CMDM(**p["arch"], dropout=0.0)
    tm.load_state_dict(p["state_dict"], strict=True)
    state = TrainState.create(tm, lr=p["lr"], sampler_state=sampler.init_state())
    step = make_train_step(tm, td, sampler, dp=dp, forward=dp.wrap(tm))
    for i, (t, noise) in enumerate(zip(p["ts"], p["noises"])):
        step(state, x, cond, seed=i, t=t, noise=noise)
    res["sampler_state"] = state.sampler_state
    torch.save(res, out)


def task_pointnorm(p, dp, out):
    """A train-mode PointNorm over this rank's rows: output, input and
    parameter gradients of sum(y * w), running statistics."""
    from afford_motion_torch.models.pointtransformer import PointNorm

    pn = PointNorm(p["pn_x"].shape[-1]).train()
    pn.load_state_dict(p["norm"])
    rows = dp.local_rows(p["pn_x"].shape[0])
    x = p["pn_x"][rows].clone().requires_grad_(True)
    y = pn(x)
    (y * p["pn_w"][rows]).sum().backward()
    torch.save({"y": y.detach(), "x_grad": x.grad, "weight_grad": pn.weight.grad,
                "bias_grad": pn.bias.grad, "buffers": pn.state_dict()}, out)


def task_fetch(p, dp, out):
    """The sharded fetch against the replicated one: synthetic arrays with
    an odd row count whose pad rows hold a sentinel, then the assembled
    batch of the prepared tree's store."""
    from afford_motion_torch.data import create_dataset
    from afford_motion_torch.models.cmdm import CMDM
    from afford_motion_torch.train.device_store import DeviceStore, make_assemble_fn
    from afford_motion_torch.train.loop import take_rows
    from afford_motion_torch.utils.config import DictConfig

    res = {"synthetic": {}, "assembled": {}}
    arrays = {k: v.copy() for k, v in p["arrays"].items()}
    sharded = DeviceStore(dict(arrays), {})
    sharded.shard_rows(dp, min_bytes=0)
    for k, (n, total) in sharded.sharded.items():
        local = sharded.arrays[k]
        pad = (dp.rank + 1) * n - total
        if pad > 0:  # a sentinel a fetch must never return
            local[n - pad:].view(np.uint8)[...] = 0xA5
    sharded.ensure_device("cpu")
    res["sharded_keys"] = sorted(sharded.sharded)
    for j, rows in enumerate(p["rows"]):
        r = torch.from_numpy(rows)
        for k in arrays:
            res["synthetic"][(j, k)] = sharded.fetch(k, r)

    cfg = DictConfig(p["dataset_cfg"])
    random.seed(3)
    np.random.seed(3)
    ds = create_dataset(cfg, "train")
    torch.manual_seed(0)
    model = CMDM(**p["tiny_arch"], dropout=0.0)
    store = DeviceStore.try_build(ds, max_bytes=1 << 30)
    store.shard_rows(dp, min_bytes=0)
    store.add_geometry_cache(model, "cpu")
    res["store_sharded_keys"] = sorted(store.sharded)
    assemble = make_assemble_fn(store, "cpu")
    ids = p["ids"]
    rows = np.arange(len(ids))[dp.local_rows(len(ids))]
    meta = store.draw_batch(ds, ids, random.Random(5), np.random.RandomState(6), own=rows)
    item_row = meta.pop("item_row")
    meta = take_rows(meta, rows)
    meta.pop("c_text")
    meta["text_emb"] = np.zeros((len(rows), 1, 16), np.float16)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in meta.items()}
    batch["item_row"] = torch.from_numpy(item_row)
    x, cond = assemble(batch)
    res["assembled"] = {"x": x, **cond}
    torch.save(res, out)


def task_fit(p, dp, out):
    """The SMPL-X fit of the parent's joints, its rows split over the ranks."""
    from afford_motion_torch.eval.joints_to_smplx import JointsToSMPLXFitter

    fitter = JointsToSMPLXFitter(p["fit_weights"], opt_rate=0.02, opt_steps=p["fit_steps"],
                                 device="cpu")
    torch.save({"params": fitter.fit(p["joints"], p["x_mask"])}, out)


def task_entry(p, dp, out):
    """The train entry through the sharded store, 4 steps straight and 2 +
    2 resumed, then the test entry's DDIM chain at test batches of 3 (shares
    of 1 and 2) and 1 (an empty share)."""
    from afford_motion_torch import test as test_entry
    from afford_motion_torch import train_ddp
    from afford_motion_torch.train import device_store

    os.chdir(p["repo"])
    device_store.SHARD_MIN_BYTES = 0  # the tiny tree's arrays are sharded too
    res = {"straight": train_ddp.main(p["straight"]), "first": train_ddp.main(p["first"]),
           "resumed": train_ddp.main(p["resumed"])}
    # each run's samples as it ends: two runs in one second share a directory
    res["tests"] = [dict(np.load(os.path.join(test_entry.main(args), "samples.npz")))
                    for args in p["tests"]]
    torch.save(res, out)


def task_dirs(p, dp, out):
    """A train entry run that names no ``exp_dir``, rank 1 loading its
    config more than a second after rank 0, so that the time in its own
    ``exp_dir`` differs from rank 0's."""
    from afford_motion_torch import train_ddp

    os.chdir(p["repo"])
    dp.barrier()
    if dp.rank:
        time.sleep(1.5)
    torch.save(train_ddp.main(p["dirs"]), out)


TASKS = {"step": task_step, "pointnorm": task_pointnorm, "fetch": task_fetch,
         "fit": task_fit, "entry": task_entry, "dirs": task_dirs}


def main(payload_path: str, out_dir: str) -> None:
    from afford_motion_torch.parallel import session

    torch.set_num_threads(1)
    p = torch.load(payload_path, weights_only=False)
    for k, v in p.get("env", {}).items():
        os.environ[k] = v
    with session("cpu", init_method=p["init"]) as dp:
        for name in p["tasks"]:
            TASKS[name](p, dp, os.path.join(out_dir, f"{name}_rank{dp.rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:])

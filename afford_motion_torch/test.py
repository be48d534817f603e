"""Test-time generation with the port (counterpart of the root ``test.py``):

    python -m afford_motion_torch.test <the same config overrides as test.py>

Loads the natsort-latest ``model*.pt`` of ``<exp_dir>/ckpt`` with
``strict=True``, runs the sampling chain over the test split (for the CMDM a
k-sample repeat takes the k-th pre-generated contact, ``c_pc_contact[:, k]``;
the CDM samples contact maps, whose evaluators write the stage-1 handoff
``pred_contact/*.npy`` that a CMDM test reads through
``task.test.contact_folder``), hands
the samples to the task's evaluator (``eval/``) as ``sample_list`` /
``k_samples_list``, and writes the evaluator's ``metrics.txt`` /
``metrics.json`` and result files, ``samples.npz`` (the generated motions
and their case ids) and ``timing.json`` to ``<eval_dir>/test-<ts>/``.
It runs on ``cuda:<gpu>`` unless the caller names another device (the
``device=cpu`` override, or ``main(argv, device=...)``), and raises when the
card is asked for and absent.

Under ``torchrun`` (``torchrun --nproc_per_node <cards> -m
afford_motion_torch.test ...``), or inside an open ``parallel.session``, the
chain is sharded as the root ``test.py`` shards it over the mesh: each rank
samples a contiguous share of every batch (shares may be unequal or empty),
every draw made for the whole batch and sliced, so that a row comes out as
in one process; the samples are all-gathered, rank 0 alone writes and runs
the evaluator, and the other ranks take part in its collective steps (the
scene evaluator's sharded SMPL-X fit, ``Eval.assist``).
"""
from __future__ import annotations

import json
import os
import random
import sys
import time

import numpy as np
import torch

from .data import create_dataset
from .eval import create_evaluator
from .models.base import create_model_and_diffusion
from .models.conditioning import cond_to_device, host_prepare_cond
from .models.text import create_text_encoder
from .parallel import current, launched, session
from .train.checkpoint import latest_ckpt, load_ckpt
from .train.loop import take_rows
from .train.sampling import make_sample_fn, parity_noise
from .utils.config import DictConfig, load_config
from .utils.device import resolve_device
from .utils.io import add_file_handler, get_logger, mkdir_if_not_exists, time_str
from .utils.misc import compute_repr_dimension

logger = get_logger()


def test(cfg: DictConfig, device: torch.device) -> str:
    """Generate for the test split; returns the output directory (rank 0's,
    on every rank of a data-parallel run)."""
    dp = current()
    test_dir = os.path.join(cfg.eval_dir, "test-" + time_str())
    if dp is not None:
        test_dir = dp.broadcast_object(test_dir)
    if dp is None or dp.rank == 0:
        mkdir_if_not_exists(test_dir)
        add_file_handler(os.path.join(test_dir, "test.log"))
    logger.info(f"[Test] ==> Begin testing on {device}..")
    timing: dict = {"device": str(device), "batches_s": [], "chains": []}
    if device.type == "cuda":
        timing["device_name"] = torch.cuda.get_device_name(device)
    t_start = time.monotonic()

    test_kwargs = {k: v for k, v in cfg.task.test.items()
                   if k not in ("batch_size", "num_workers")}
    test_dataset = create_dataset(cfg.task.dataset, "test", **test_kwargs)
    timing["dataset_load_s"] = time.monotonic() - t_start
    logger.info(f"Load test dataset size: {len(test_dataset)}")
    test_dataloader = test_dataset.get_dataloader(
        batch_size=cfg.task.test.batch_size,
        num_workers=cfg.task.test.get("num_workers", 0),
        shuffle=False,
        drop_last=True,
    )

    model, diffusion = create_model_and_diffusion(cfg, device)
    te_cfg = cfg.get("text_encoder", DictConfig({}))
    text_encoder = create_text_encoder(
        cfg.model.text_model.version,
        table_path=te_cfg.get("table_path"),
        weights_dir=te_cfg.get("weights_dir"),
        max_length=int(cfg.model.text_model.max_length),
        per_token=str(cfg.model.name) == "CMDM",
        device=device,
    )
    ckpt = latest_ckpt(os.path.join(cfg.exp_dir, "ckpt"))
    if ckpt is None:
        raise FileNotFoundError("No checkpoint found.")
    load_ckpt(model, ckpt)
    logger.info(f"Load checkpoint from {ckpt}")
    timing["init_restore_s"] = time.monotonic() - t_start - timing["dataset_load_s"]

    evaluator = create_evaluator(cfg.task, device=device)
    sample_fn = make_sample_fn(
        model, diffusion, clip_denoised=False,
        sampler=str(cfg.task.test.get("sampler", "ddpm")),
        eta=float(cfg.task.test.get("ddim_eta", 0.0)),
    )
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    noise_seed = cfg.task.test.get("noise_inject_seed", None)
    chain_idx = 0

    B = cfg.task.test.batch_size
    is_cmdm = str(cfg.model.name).startswith("CMDM")
    k_samples = evaluator.k_samples
    k_batches = set(range(evaluator.num_k_samples // B)) if k_samples > 0 else set()
    sample_list, k_samples_list = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_loop = time.monotonic()
    for i, data in enumerate(test_dataloader):
        t_batch = time.monotonic()
        use_k = i in k_batches
        logger.info(f"batch {i}, k_sample={use_k}, cases={data['info_index']}")
        shape = tuple(np.shape(data["x"]))
        rows = dp.chunk(shape[0]) if dp is not None else None
        cond = {}
        if rows is None or rows.stop > rows.start:  # an empty share runs no model
            _, cond = host_prepare_cond(data if rows is None else take_rows(
                data, np.arange(rows.start, rows.stop)), text_encoder)
            cond = cond_to_device(cond, device)
        per_k = []
        for k in range(k_samples if use_k else 1):
            cond_k = dict(cond)
            if is_cmdm and "c_pc_contact" in cond_k and cond_k["c_pc_contact"].ndim == 4:
                cond_k["c_pc_contact"] = cond_k["c_pc_contact"][:, k]
            noise = noise_seq = None
            if noise_seed is not None:
                init_n, seq_n = parity_noise(noise_seed, chain_idx, shape,
                                             diffusion.num_timesteps)
                if rows is not None:
                    init_n, seq_n = init_n[rows], seq_n[:, rows]
                noise = torch.from_numpy(np.ascontiguousarray(init_n)).to(device)
                noise_seq = torch.from_numpy(np.ascontiguousarray(seq_n)).to(device)
            chain = {"steps": diffusion.num_timesteps}
            t_chain = time.monotonic()
            x0 = sample_fn(shape, cond_k, generator, noise, noise_seq, timing=chain,
                           rows=rows).cpu().numpy()
            if dp is not None:  # the ranks' shares, in row order, on every rank
                x0 = np.concatenate(dp.gather_objects(x0), axis=0)
            per_k.append(x0)
            chain["chain_s"] = time.monotonic() - t_chain
            timing["chains"].append(chain)
            chain_idx += 1
        # one entry per case, the batch's fields beside its sample
        for bsi in range(shape[0]):
            case = {key: data[key][bsi] for key in data}
            sample_list.append({"sample": per_k[0][bsi], **case})
            if use_k:
                k_samples_list.append({"k_samples": np.stack([s[bsi] for s in per_k]), **case})
        timing["batches_s"].append(time.monotonic() - t_batch)
        if i + 1 >= evaluator.eval_nbatch:
            break

    timing["generation_loop_s"] = time.monotonic() - t_loop
    timing["n_motions"] = len(timing["chains"]) * B
    if dp is not None and dp.rank != 0:
        evaluator.assist(sample_list, k_samples_list, test_dataloader)
        dp.barrier()  # returns once rank 0 has written the directory
        return test_dir
    out = {"sample": np.stack([s["sample"] for s in sample_list])}
    for key in ("x_mask", "info_index", "info_caption_index", "info_set", "c_text"):
        if sample_list and key in sample_list[0]:
            out[key] = np.asarray([s[key] for s in sample_list])
    if k_samples_list:
        out["k_samples"] = np.stack([s["k_samples"] for s in k_samples_list])
    np.savez(os.path.join(test_dir, "samples.npz"), **out)

    t_eval = time.monotonic()
    evaluator.evaluate(sample_list, k_samples_list, test_dir, test_dataloader)
    evaluator.report(test_dir)
    timing["evaluator_s"] = time.monotonic() - t_eval
    timing["evaluator"] = dict(evaluator.timing)
    if device.type == "cuda":
        timing["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    timing["total_s"] = time.monotonic() - t_start
    with open(os.path.join(test_dir, "timing.json"), "w") as f:
        json.dump(timing, f, indent=1)
    logger.info(f"[Test] {timing['n_motions']} motions in "
                f"{timing['generation_loop_s']:.2f}s, evaluator {timing['evaluator_s']:.2f}s; "
                f"results in {test_dir}")
    if dp is not None:
        dp.barrier()
    return test_dir


def main(argv=None, device=None) -> str:
    cfg = load_config("configs", argv if argv is not None else sys.argv[1:])
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
    mkdir_if_not_exists(cfg.eval_dir)
    # f32 stays f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(cfg, device)
    if launched() and current() is None:
        with session(dev):
            return test(cfg, dev)
    return test(cfg, dev)


if __name__ == "__main__":
    main()

"""Sampling / demo entry of the port (counterpart of the root ``sample.py``):

    python -m afford_motion_torch.sample exp_dir=<run> task=contact_gen model=cdm ...
    python -m afford_motion_torch.sample exp_dir=<run> task=contact_motion_gen model=cmdm \\
        task.sample.contact_folder=<stage-1 sample dir> ...

Drives the ``sample:`` section of the task config: the example set
``task.sample.dataset_name`` over the prompt file ``task.sample.data_path``
(``desc#set#index[#frames]`` a line), the natsort-latest ``model*.pt`` of
``<exp_dir>/ckpt`` (``strict=True``), one chain a batch of
``task.sample.batch_size`` with ``task.sample.sampler`` (``ddpm`` or
``ddim``) and ``task.sample.ddim_eta``, its noise from a ``torch.Generator``
on the entry's device seeded by ``seed``, and the task's visualizer into
``<exp_dir>/sample-<ts>/``. For the two-stage demo chain, stage 1's
``ContactVisualizer`` writes ``<case>/contact.npy`` (points then distances),
which stage 2's ``ContactMotionExampleDataset`` reads through
``task.sample.contact_folder``; stage 2's ``ContactMotionVisualizer`` writes
each case's frames as PLYs. ``timing.json`` beside them holds each chain's
seconds (``prepare_s``, the hierarchy and the encodings; ``loop_s``, the
denoiser steps; each to a device synchronize) and each batch's visualizer
seconds. Runs on ``cuda:<gpu>`` unless the caller names
another device (the ``device=cpu`` override, or ``main(argv, device=...)``),
and raises when the card is asked for and absent.
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
from .eval.visualize import create_visualizer
from .models.base import create_model_and_diffusion
from .models.conditioning import cond_to_device, host_prepare_cond
from .models.text import create_text_encoder
from .train.checkpoint import latest_ckpt, load_ckpt
from .train.sampling import make_sample_fn
from .utils.config import DictConfig, load_config
from .utils.device import resolve_device
from .utils.io import add_file_handler, get_logger, mkdir_if_not_exists, time_str
from .utils.misc import compute_repr_dimension

logger = get_logger()


def sample(cfg: DictConfig, device: torch.device) -> str:
    """Generate for every full batch of the example set and visualize it;
    returns the output directory."""
    sample_dir = os.path.join(cfg.exp_dir, "sample-" + time_str())
    mkdir_if_not_exists(sample_dir)
    add_file_handler(os.path.join(sample_dir, "sample.log"))
    logger.info(f"[Sample] ==> Begin sampling on {device}..")

    scfg = cfg.task.sample
    ds_cfg = DictConfig(dict(cfg.task.dataset))
    ds_cfg["name"] = scfg.dataset_name
    kwargs = {k: v for k, v in scfg.items()
              if k not in ("batch_size", "num_workers", "dataset_name")}
    dataset = create_dataset(ds_cfg, "test", **kwargs)
    logger.info(f"Load sample dataset size: {len(dataset)}")
    dataloader = dataset.get_dataloader(batch_size=min(int(scfg.batch_size), len(dataset)),
                                        shuffle=False, drop_last=True)

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

    visualizer = create_visualizer(cfg.task)
    sample_fn = make_sample_fn(model, diffusion, clip_denoised=False,
                               sampler=str(scfg.get("sampler", "ddpm")),
                               eta=float(scfg.get("ddim_eta", 0.0)))
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    timing: dict = {"device": str(device), "chains": [], "visualize_s": []}
    if device.type == "cuda":
        timing["device_name"] = torch.cuda.get_device_name(device)
    for i, data in enumerate(dataloader):
        x, cond = host_prepare_cond(data, text_encoder)
        cond = cond_to_device(cond, device)
        if "c_pc_contact" in cond and cond["c_pc_contact"].ndim == 4:
            cond["c_pc_contact"] = cond["c_pc_contact"][:, 0]
        chain = {"steps": diffusion.num_timesteps}
        out = sample_fn(tuple(x.shape), cond, generator, timing=chain).cpu().numpy()
        timing["chains"].append(chain)
        t0 = time.monotonic()
        visualizer.visualize(out, sample_dir, i, dataloader, **data)
        timing["visualize_s"].append(time.monotonic() - t0)
        logger.info(f"batch {i}: chain {chain['prepare_s'] + chain['loop_s']:.3f} s, "
                    f"visualized in {timing['visualize_s'][-1]:.3f} s")
    with open(os.path.join(sample_dir, "timing.json"), "w") as f:
        json.dump(timing, f, indent=1)
    logger.info(f"[Sample] results in {sample_dir}")
    return sample_dir


def main(argv=None, device=None) -> str:
    cfg = load_config("configs", argv if argv is not None else sys.argv[1:])
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
    # f32 stays f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return sample(cfg, resolve_device(cfg, device))


if __name__ == "__main__":
    main()

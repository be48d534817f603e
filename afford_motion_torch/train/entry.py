"""Training entry of the port (counterpart of the root ``train.py``):

    python -m afford_motion_torch.train <the same config overrides as train.py>

Trains the configured model (a CMDM or a CDM) with the host
dataloader and writes ``config.yaml``, ``log/runtime.log`` and
``ckpt/model{step:06d}.pt`` (plus ``train_state{step:06d}.pt`` for resume:
``task.train.resume_ckpt=<.../model000004.pt>``) under ``exp_dir``. It runs
on ``cuda:<gpu>`` unless the caller names another device (the ``device=cpu``
override, or ``main(argv, device=...)``), and raises when the card is asked
for and absent.
"""
from __future__ import annotations

import os
import random
import sys
from typing import Any, Dict

import numpy as np
import torch

from ..data import create_dataset
from ..models.base import create_model_and_diffusion
from ..models.text import create_text_encoder
from ..parallel.mesh import is_main
from ..utils.config import DictConfig, load_config, save_config
from ..utils.device import resolve_device
from ..utils.io import Board, add_file_handler, get_logger, mkdir_if_not_exists
from ..utils.misc import compute_repr_dimension
from .loop import TrainLoop

logger = get_logger()


def train(cfg: DictConfig, device: torch.device) -> Dict[str, Any]:
    """Run the training loop; returns its summary (logged losses, seconds
    per logged window, last checkpoint, peak device memory)."""
    phase = cfg.task.train.get("phase", "train")
    dataset = create_dataset(cfg.task.dataset, phase)
    logger.info(f"Load train dataset size: {len(dataset)}")
    dataloader = dataset.get_dataloader(
        batch_size=cfg.task.train.batch_size,
        num_workers=0,
        prefetch=0,
        shuffle=True,
        drop_last=True,
        seed=cfg.seed,
    )
    # the seeded init: the same seed gives the same weights on any device
    torch.manual_seed(int(cfg.seed))
    model, diffusion = create_model_and_diffusion(cfg, device)
    te_cfg = cfg.get("text_encoder", DictConfig({}))
    text_encoder = create_text_encoder(
        cfg.model.text_model.version,
        table_path=te_cfg.get("table_path"),
        weights_dir=te_cfg.get("weights_dir"),
        max_length=int(cfg.model.text_model.max_length),
        per_token=str(cfg.model.name) == "CMDM",
        device=device,
        # training is strict: a stale table must not silently train on hash
        # embeddings (escape hatch: text_encoder.allow_fallback=true)
        strict_table=not bool(te_cfg.get("allow_fallback", False)),
    )
    logger.info(f"[Train] ==> Begin training on {device}..")
    return TrainLoop(cfg, model, diffusion, dataloader, text_encoder, device=device,
                     exp_dir=cfg.exp_dir, seed=int(cfg.seed)).run_loop()


def main(argv=None, device=None) -> Dict[str, Any]:
    cfg = load_config("configs", argv if argv is not None else sys.argv[1:])
    return run(cfg, resolve_device(cfg, device))


def run(cfg: DictConfig, dev: torch.device) -> Dict[str, Any]:
    """The entry after its configuration and device: seeds, TF32 off, the
    experiment's directories, config, log and board (rank 0 of a
    data-parallel run writes them), then :func:`train`."""
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
    # f32 stays f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    mkdir_if_not_exists(cfg.log_dir)
    mkdir_if_not_exists(cfg.ckpt_dir)
    mkdir_if_not_exists(cfg.eval_dir)
    if is_main():
        add_file_handler(os.path.join(cfg.log_dir, "runtime.log"))
        save_config(cfg, os.path.join(cfg.exp_dir, "config.yaml"))
        Board().create_board(cfg.platform, log_dir=cfg.log_dir)
    logger.info(f"[Train] experiment dir: {cfg.exp_dir}")
    try:
        return train(cfg, dev)
    finally:
        Board().close()

"""Checkpoints in the reference layout (counterpart of
``afford_motion_tpu/train/checkpoint.py``): ``model{step:06d}.pt`` is a bare
torch state_dict, the natsort-latest one is loaded for testing. What a
resumed training run needs besides (optimizer moments, step count, the
schedule sampler's history) goes into ``train_state{step:06d}.pt`` beside
it."""
from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch
from torch import nn

from ..utils.convert import load_torch_state_dict
from ..utils.misc import natsorted


def latest_ckpt(ckpt_dir: str) -> Optional[str]:
    """natsort-latest ``model*.pt`` file in ``ckpt_dir``, or None."""
    cands = [p for p in glob.glob(os.path.join(ckpt_dir, "model*.pt")) if os.path.isfile(p)]
    return natsorted(cands)[-1] if cands else None


def save_ckpt(model: nn.Module, ckpt_dir: str, step: int) -> str:
    """Write the model's state_dict as ``model{step:06d}.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model{step:06d}.pt")
    torch.save(model.state_dict(), path)
    return path


def load_ckpt(model: nn.Module, path: str) -> None:
    """Load a state_dict file (a bare dict or ``{"state_dict": ...}``,
    DDP's ``module.`` prefix stripped) with ``strict=True``."""
    model.load_state_dict(load_torch_state_dict(path), strict=True)


def _train_state_path(model_path: str) -> str:
    head, name = os.path.split(model_path)
    m = re.fullmatch(r"model(\d+)\.pt", name)
    if m is None:
        raise ValueError(f"not a model{{step}}.pt checkpoint: {model_path}")
    return os.path.join(head, f"train_state{m.group(1)}.pt")


def save_train_state(state, ckpt_dir: str) -> str:
    """``model{step}.pt`` plus ``train_state{step}.pt`` for ``state`` (a
    :class:`~afford_motion_torch.train.state.TrainState`); returns the model
    file's path."""
    path = save_ckpt(state.model, ckpt_dir, state.step)
    torch.save({"step": int(state.step),
                "optimizer": state.optimizer.state_dict(),
                "sampler_state": state.sampler_state}, _train_state_path(path))
    return path


def load_train_state(state, model_path: str) -> None:
    """Restore ``state`` in place from ``model{step}.pt`` and the
    ``train_state{step}.pt`` beside it: weights, BatchNorm buffers, optimizer
    moments, step count and sampler history."""
    load_ckpt(state.model, model_path)
    device = next(state.model.parameters()).device
    extra = torch.load(_train_state_path(model_path), map_location=device, weights_only=True)
    state.optimizer.load_state_dict(extra["optimizer"])
    state.step = int(extra["step"])
    state.sampler_state = extra["sampler_state"]

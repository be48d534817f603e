"""Checkpoints in the reference layout (counterpart of
``afford_motion_tpu/train/checkpoint.py``): ``model{step:06d}.pt`` files
holding a torch state_dict, the natsort-latest one loaded for testing."""
from __future__ import annotations

import glob
import os
from typing import Optional

import torch
from torch import nn

from afford_motion_tpu.utils.misc import natsorted


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
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)

"""Model + diffusion factories (counterpart of
``afford_motion_tpu/models/base.py``); the CMDM only, so far."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..diffusion import GaussianDiffusion, create_gaussian_diffusion
from .cmdm import CMDM, build_cmdm


def create_model(model_cfg: Any, device: torch.device) -> CMDM:
    """The configured model on ``device``, in eval mode; a train step puts
    it in train mode itself."""
    name = str(model_cfg.name)
    if name != "CMDM":
        raise NotImplementedError(f"model {name!r} is not ported yet")
    return build_cmdm(model_cfg).to(device).eval()


def create_model_and_diffusion(cfg: Any, device: torch.device) -> Tuple[CMDM, GaussianDiffusion]:
    return create_model(cfg.model, device), create_gaussian_diffusion(cfg.diffusion, device)

"""Model + diffusion factories (counterpart of
``afford_motion_tpu/models/base.py``): the CMDM and the CDM."""
from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from ..diffusion import GaussianDiffusion, create_gaussian_diffusion
from .cdm import CDM, build_cdm
from .cmdm import CMDM, build_cmdm

_BUILDERS = {"CDM": build_cdm, "CMDM": build_cmdm}


def create_model(model_cfg: Any, device: torch.device) -> Union[CMDM, CDM]:
    """The configured model on ``device``, in eval mode; a train step puts
    it in train mode itself."""
    name = str(model_cfg.name)
    if name not in _BUILDERS:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    return _BUILDERS[name](model_cfg).to(device).eval()


def create_model_and_diffusion(cfg: Any, device: torch.device
                               ) -> Tuple[Union[CMDM, CDM], GaussianDiffusion]:
    return create_model(cfg.model, device), create_gaussian_diffusion(cfg.diffusion, device)

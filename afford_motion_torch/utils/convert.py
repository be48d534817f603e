"""Weights from the JAX package: flax CMDM variables -> the port's
state_dict, through ``afford_motion_tpu.utils.torch_convert`` (numpy only).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from afford_motion_tpu.utils.torch_convert import export_cmdm_checkpoint


def cmdm_state_dict_from_jax(variables_np: Dict, *, num_layers: Sequence[int],
                             blocks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a ``trans_enc`` CMDM (numpy
    leaves) -> a state_dict that :class:`afford_motion_torch.models.cmdm.CMDM`
    loads with ``strict=True``, BatchNorm running stats included."""
    sd = export_cmdm_checkpoint(variables_np, num_layers=tuple(num_layers),
                                blocks=tuple(blocks), arch="trans_enc")
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}

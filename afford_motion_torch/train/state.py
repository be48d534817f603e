"""Training state and optimizer (counterpart of
``afford_motion_tpu/train/state.py``).

AdamW as ``optax.adamw`` runs it in the JAX package: betas (0.9, 0.999),
epsilon 1e-8, decoupled weight decay passed explicitly (torch's default is
0.01, the configs' is 0.0), and the linear anneal ``lr * (1 - step /
lr_anneal_steps)`` read at the step count before the update. Parameters
under a frozen prefix (the CDM's pretrained ``scene_model``) get no gradient
and no optimizer state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn


def trainable_parameters(model: nn.Module,
                         frozen_prefixes: Sequence[str] = ("scene_model",)) -> List[nn.Parameter]:
    """Turn off ``requires_grad`` under the frozen prefixes and return the
    rest, in ``named_parameters`` order."""
    out = []
    for name, p in model.named_parameters():
        if any(part in frozen_prefixes for part in name.split(".")):
            p.requires_grad_(False)
        else:
            out.append(p)
    return out


def make_optimizer(model: nn.Module, lr: float, weight_decay: float = 0.0,
                   frozen_prefixes: Sequence[str] = ("scene_model",)) -> torch.optim.AdamW:
    return torch.optim.AdamW(trainable_parameters(model, frozen_prefixes), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def annealed_lr(lr: float, step: int, lr_anneal_steps: int = 0) -> float:
    """The learning rate of the update that follows ``step`` finished ones."""
    if lr_anneal_steps and lr_anneal_steps > 0:
        return lr * max(0.0, 1.0 - step / lr_anneal_steps)
    return lr


@dataclass
class TrainState:
    """What one optimizer step reads and updates in place: the model
    (parameters and BatchNorm buffers), the optimizer, the step count and the
    schedule sampler's history."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr: float
    lr_anneal_steps: int = 0
    step: int = 0
    sampler_state: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, *, lr: float, weight_decay: float = 0.0,
               lr_anneal_steps: int = 0, sampler_state: Any = None) -> "TrainState":
        return cls(model, make_optimizer(model, lr, weight_decay), float(lr),
                   int(lr_anneal_steps), 0, sampler_state)

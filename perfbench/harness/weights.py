"""The weights of a run, made by the benchmark from the seed: one draw of
standard normals on the model's device from a ``torch.Generator`` there,
cut into the model's parameters in ``named_parameters`` order and scaled by
each leaf's kind. The same tensors go to the program (loaded into its
model) and to the plain reference."""
from __future__ import annotations

from typing import Dict

import torch


def weight_seed(seed: int) -> int:
    """The weights' generator seed, apart from the loop's base seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x5851F42D4C957F2D) % (1 << 63)


def leaf_scale(name: str, shape) -> tuple:
    """(offset, scale) of a leaf's normals: matrices 1/sqrt(fan in), a
    norm's scale about 1, biases and shifts small."""
    if len(shape) >= 2:
        return 0.0, float(shape[1]) ** -0.5
    if name.endswith("weight"):
        return 1.0, 0.05
    return 0.0, 0.02


def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` drawn from ``seed`` on ``device``,
    loaded into the model; returns the drawn tensors (float32), which stay
    apart from the model's."""
    named = list(model.named_parameters())
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn((total,), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, p in named:
        offset, scale = leaf_scale(name, tuple(p.shape))
        out[name] = flat[at:at + p.numel()].view(p.shape) * scale + offset
        at += p.numel()
    missing, unexpected = model.load_state_dict(out, strict=False)
    buffers = {n for n, _ in model.named_buffers()}
    if unexpected or any(n not in buffers for n in missing):
        raise KeyError(f"weights do not fit the model: missing {missing}, unexpected "
                       f"{unexpected}")
    return out

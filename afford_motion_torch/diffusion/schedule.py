"""Beta schedules and timestep respacing (a copy of
``afford_motion_tpu/diffusion/schedule.py``, which is numpy only but whose
package import loads jax).

Numerically equivalent to the reference formulas
(reference: diffusion/gaussian_diffusion.py:19-63 for schedules,
diffusion/respace.py:8-61 for respacing). All schedule construction happens
once, on the host, in float64; device pytrees are float32.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Set, Union

import numpy as np


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedule; 'linear' (Ho et al., scaled to any T) or 'cosine'."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas."""
    i = np.arange(num_diffusion_timesteps, dtype=np.float64)
    t1 = i / num_diffusion_timesteps
    t2 = (i + 1) / num_diffusion_timesteps
    ab = np.vectorize(alpha_bar)
    return np.minimum(1.0 - ab(t2) / ab(t1), max_beta)


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Pick a subset of timesteps from an original process.

    Same contract as the reference (diffusion/respace.py:8-61): a list of
    per-section counts, or a "ddimN" string using DDIM-paper striding.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired_count:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: List[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


def respaced_betas(betas: np.ndarray, use_timesteps: Set[int]):
    """Collapse an original beta schedule onto a subset of retained steps.

    Returns (new_betas, timestep_map) where timestep_map[i] is the original
    timestep index of respaced step i (reference: diffusion/respace.py:77-88).
    """
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas: List[float] = []
    timestep_map: List[int] = []
    for i, ac in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1.0 - ac / last_alpha_cumprod)
            last_alpha_cumprod = ac
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int32)

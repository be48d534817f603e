"""End-to-end sampling chain (counterpart of
``afford_motion_tpu/train/sampling.py``): the point hierarchy and the
contact encoding run once per chain, then the denoiser alone runs through
the DDPM or DDIM loop."""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion import GaussianDiffusion
from ..models.conditioning import add_hierarchies, encode_conditions


def parity_noise(seed: int, chain_idx: int, shape, num_steps: int):
    """The shared noise stream of the JAX package's parity hook, drawn
    identically: x_T, then one draw per step in chain order t = T-1..0."""
    rng = np.random.default_rng([int(seed), int(chain_idx)])
    init = rng.standard_normal(tuple(shape)).astype(np.float32)
    seq = rng.standard_normal((int(num_steps),) + tuple(shape)).astype(np.float32)
    return init, seq


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_sample_fn(model, diffusion: GaussianDiffusion, *, clip_denoised: bool = False,
                   sampler: str = "ddpm", eta: float = 0.0):
    """Returns ``sample(shape, cond, generator=None, noise=None,
    noise_seq=None, timing=None) -> x0``. ``cond`` holds tensors on the
    diffusion's device. A ``timing`` dict receives ``prepare_s`` (hierarchy
    + contact encoding) and ``loop_s`` (the denoising loop), each measured
    to a device synchronize."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler {sampler!r}")

    @torch.no_grad()
    def sample(shape: Tuple[int, ...], cond: Dict[str, Any],
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               noise_seq: Optional[torch.Tensor] = None,
               timing: Optional[Dict[str, float]] = None) -> torch.Tensor:
        dev = diffusion.device
        t0 = time.perf_counter()
        cond_h = add_hierarchies(model, cond)
        enc = encode_conditions(model, cond_h)

        def model_fn(x, t):
            return model.denoise(x, t, cond_h, enc)

        if timing is not None:
            _sync(dev)
            timing["prepare_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        if sampler == "ddim":
            if noise_seq is not None:
                raise ValueError("noise_seq is a DDPM stream; DDIM with eta=0 draws "
                                 "no per-step noise and eta>0 would not consume it")
            x0 = diffusion.ddim_sample_loop(model_fn, shape, generator=generator,
                                            noise=noise, clip_denoised=clip_denoised,
                                            eta=eta)
        else:
            x0 = diffusion.p_sample_loop(model_fn, shape, generator=generator, noise=noise,
                                         noise_seq=noise_seq, clip_denoised=clip_denoised)
        if timing is not None:
            _sync(dev)
            timing["loop_s"] = time.perf_counter() - t1
        return x0

    return sample

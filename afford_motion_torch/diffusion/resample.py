"""Timestep schedule samplers (counterpart of
``afford_motion_tpu/diffusion/resample.py``).

``UniformSampler`` is what every shipped config uses. The loss-second-moment
importance sampler keeps its history in a plain ``state`` dict of tensors
(``loss_history`` (T, history), ``loss_counts`` (T,)), which a checkpoint can
hold. Draws come from an explicit ``torch.Generator``; they are torch's
numbers, not JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

SamplerState = Dict[str, torch.Tensor]


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def init_state(self, device=None) -> Optional[SamplerState]:
        return None

    def sample(self, generator: Optional[torch.Generator], batch_size: int, device,
               state: Optional[SamplerState] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                          device=device)
        return t, torch.ones((batch_size,), dtype=torch.float32, device=device)

    def update(self, state, ts, losses):
        return state


class LossSecondMomentResampler:
    """Importance-samples t by the root mean square of each timestep's last
    ``history_per_term`` losses, once every timestep has a full history;
    uniform until then."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self, device=None) -> SamplerState:
        return {
            "loss_history": torch.zeros((self.num_timesteps, self.history_per_term),
                                        dtype=torch.float32, device=device),
            "loss_counts": torch.zeros((self.num_timesteps,), dtype=torch.int32, device=device),
        }

    def weights(self, state: SamplerState) -> torch.Tensor:
        uniform = torch.full((self.num_timesteps,), 1.0 / self.num_timesteps,
                             dtype=torch.float32, device=state["loss_counts"].device)
        if not bool((state["loss_counts"] == self.history_per_term).all()):
            return uniform
        w = torch.sqrt((state["loss_history"] ** 2).mean(dim=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch_size: int, device,
               state: SamplerState) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.weights(state)
        t = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    def update(self, state: SamplerState, ts: torch.Tensor,
               losses: torch.Tensor) -> SamplerState:
        """Fold a batch of (t, loss) pairs into the history, in batch order:
        append while a timestep's history has room, else shift it left."""
        hist, counts = state["loss_history"].clone(), state["loss_counts"].clone()
        for t, loss in zip(ts.tolist(), losses.detach().float().tolist()):
            if counts[t] == self.history_per_term:
                hist[t, :-1] = hist[t, 1:].clone()
                hist[t, -1] = loss
            else:
                hist[t, counts[t]] = loss
                counts[t] += 1
        return {"loss_history": hist, "loss_counts": counts}


def create_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name in ("loss-second-moment", "loss_second_moment"):
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")

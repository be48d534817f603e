"""Gaussian diffusion (counterpart of
``afford_motion_tpu/diffusion/gaussian.py``).

The schedule is computed once on the host in float64 and kept as float32
tensors on one device, as the JAX package keeps it. Models are plain
functions ``model_fn(x, t) -> prediction`` with the condition bound by
closure. The sampling loops are Python loops over the reversed schedule;
noise is drawn from an explicit ``torch.Generator`` or injected (``noise``
for x_T, ``noise_seq`` for the per-step draws). ``training_losses`` is the
per-sample loss of one noised batch: the MSE is averaged over valid frames
x features only.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .losses import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
    sum_flat,
)
from .schedule import get_named_beta_schedule, respaced_betas, space_timesteps

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class ModelMeanType(str, enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"


class ModelVarType(str, enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(str, enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"


@dataclass(frozen=True)
class DiffusionConfig:
    model_mean_type: ModelMeanType
    model_var_type: ModelVarType
    loss_type: LossType = LossType.MSE
    rescale_timesteps: bool = False
    original_num_steps: int = 1000


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients, reshaped to broadcast over (B, ...)."""
    return arr[t].reshape(t.shape[0], *([1] * (ndim - 1)))


_SCHEDULE_FIELDS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "log_betas", "fixed_large_variance",
    "log_fixed_large_variance",
)


class GaussianDiffusion:
    """Schedule tensors + the sampling and training math."""

    def __init__(self, arrays: Dict[str, torch.Tensor], timestep_map: torch.Tensor,
                 config: DiffusionConfig):
        for name in _SCHEDULE_FIELDS:
            setattr(self, name, arrays[name])
        self.timestep_map = timestep_map
        self.config = config

    @classmethod
    def create(
        cls,
        betas: np.ndarray,
        *,
        model_mean_type: ModelMeanType,
        model_var_type: ModelVarType,
        loss_type: LossType = LossType.MSE,
        rescale_timesteps: bool = False,
        timestep_map: Optional[np.ndarray] = None,
        original_num_steps: Optional[int] = None,
        device: torch.device = torch.device("cpu"),
    ) -> "GaussianDiffusion":
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        T = betas.shape[0]
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        fixed_large = np.append(posterior_variance[1], betas[1:])
        arrays64 = {
            "betas": betas,
            "alphas_cumprod": alphas_cumprod,
            "alphas_cumprod_prev": alphas_cumprod_prev,
            "alphas_cumprod_next": alphas_cumprod_next,
            "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
            "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
            "log_one_minus_alphas_cumprod": np.log(1.0 - alphas_cumprod),
            "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod - 1),
            "posterior_variance": posterior_variance,
            "posterior_log_variance_clipped": np.log(
                np.append(posterior_variance[1], posterior_variance[1:])),
            "posterior_mean_coef1":
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
            "posterior_mean_coef2":
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
            "log_betas": np.log(betas),
            "fixed_large_variance": fixed_large,
            "log_fixed_large_variance": np.log(fixed_large),
        }
        arrays = {k: torch.tensor(v.astype(np.float32), device=device)
                  for k, v in arrays64.items()}
        if timestep_map is None:
            timestep_map = np.arange(T, dtype=np.int32)
        return cls(
            arrays,
            torch.tensor(np.asarray(timestep_map, dtype=np.int64), device=device),
            DiffusionConfig(model_mean_type, model_var_type, loss_type, rescale_timesteps,
                            int(original_num_steps or T)),
        )

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Timesteps as the model sees them: respacing map, then the
        optional rescale to a 1000-step range."""
        new_t = self.timestep_map[t]
        if self.config.rescale_timesteps:
            return new_t.float() * (1000.0 / self.config.original_num_steps)
        return new_t

    # -------------------------------------------------------------- q-process
    def q_mean_variance(self, x_start, t):
        nd = x_start.ndim
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start,
                _extract(1.0 - self.alphas_cumprod, t, nd),
                _extract(self.log_one_minus_alphas_cumprod, t, nd))

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (_extract(self.posterior_mean_coef1, t, nd) * x_start
                + _extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, _extract(self.posterior_variance, t, nd),
                _extract(self.posterior_log_variance_clipped, t, nd))

    # -------------------------------------------------------------- p-process
    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        nd = x_t.ndim
        return (_extract(1.0 / self.posterior_mean_coef1, t, nd) * xprev
                - _extract(self.posterior_mean_coef2 / self.posterior_mean_coef1, t, nd) * x_t)

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return ((_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart)
                / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def p_mean_variance(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor, *,
                        clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
        cfg = self.config
        nd = x.ndim
        model_output = model_fn(x, self.model_timesteps(t))

        if cfg.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            # the doubled channel dim is the last one for (B, L, D) data
            model_output, var_values = torch.split(
                model_output, [x.shape[-1], model_output.shape[-1] - x.shape[-1]], dim=-1)
            if cfg.model_var_type == ModelVarType.LEARNED:
                model_log_variance = var_values
            else:
                min_log = _extract(self.posterior_log_variance_clipped, t, nd)
                max_log = _extract(self.log_betas, t, nd)
                frac = (var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif cfg.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = _extract(self.fixed_large_variance, t, nd) * torch.ones_like(x)
            model_log_variance = (_extract(self.log_fixed_large_variance, t, nd)
                                  * torch.ones_like(x))
        else:
            model_variance = _extract(self.posterior_variance, t, nd) * torch.ones_like(x)
            model_log_variance = (_extract(self.posterior_log_variance_clipped, t, nd)
                                  * torch.ones_like(x))

        def process_xstart(xs):
            return torch.clamp(xs, -1.0, 1.0) if clip_denoised else xs

        if cfg.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        elif cfg.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
            model_mean = self.q_posterior_mean_variance(pred_xstart, x, t)[0]
        else:
            pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean = self.q_posterior_mean_variance(pred_xstart, x, t)[0]
        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    # ---------------------------------------------------------------- sampling
    def _randn(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator, device=self.device,
                           dtype=torch.float32)

    def _timestep(self, idx: int, batch: int) -> torch.Tensor:
        return torch.full((batch,), idx, dtype=torch.long, device=self.device)

    def p_sample(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None, clip_denoised: bool = True,
                 noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised)
        if noise is None:
            noise = self._randn(x.shape, generator)
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(self, model_fn: ModelFn, shape: Sequence[int], *,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      noise_seq: Optional[torch.Tensor] = None,
                      clip_denoised: bool = True) -> torch.Tensor:
        """Ancestral DDPM chain t = T-1..0. ``noise_seq`` (T, *shape) replaces
        the per-step draws in chain order (the parity hook of
        ``train/sampling.py parity_noise``)."""
        x = noise if noise is not None else self._randn(shape, generator)
        for step, idx in enumerate(range(self.num_timesteps - 1, -1, -1)):
            out = self.p_sample(
                model_fn, x, self._timestep(idx, shape[0]), generator=generator,
                clip_denoised=clip_denoised,
                noise=None if noise_seq is None else noise_seq[step],
            )
            x = out["sample"]
        return x

    def ddim_sample(self, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None, clip_denoised: bool = True,
                    eta: float = 0.0) -> Dict[str, torch.Tensor]:
        out = self.p_mean_variance(model_fn, x, t, clip_denoised=clip_denoised)
        nd = x.ndim
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_prev = _extract(self.alphas_cumprod_prev, t, nd)
        if eta == 0.0:
            # deterministic DDIM: sigma is 0, so no noise is drawn
            sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                      + torch.sqrt(1 - alpha_bar_prev) * eps)
            return {"sample": sample, "pred_xstart": out["pred_xstart"]}
        alpha_bar = _extract(self.alphas_cumprod, t, nd)
        sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
                 * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
        noise = self._randn(x.shape, generator)
        mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                     + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (nd - 1)))
        return {"sample": mean_pred + nonzero_mask * sigma * noise,
                "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(self, model_fn: ModelFn, shape: Sequence[int], *,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None, clip_denoised: bool = True,
                         eta: float = 0.0) -> torch.Tensor:
        x = noise if noise is not None else self._randn(shape, generator)
        for idx in range(self.num_timesteps - 1, -1, -1):
            x = self.ddim_sample(model_fn, x, self._timestep(idx, shape[0]),
                                 generator=generator, clip_denoised=clip_denoised,
                                 eta=eta)["sample"]
        return x


    # ---------------------------------------------------------------- training
    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, *, clip_denoised=True):
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised)
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"],
                                 out["log_variance"])) / np.log(2.0)
        decoder_nll = mean_flat(-discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])) / np.log(2.0)
        return {"output": torch.where(t == 0, decoder_nll, kl),
                "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        x_mask: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Per-sample masked diffusion loss. ``x_mask`` (B, L) is the padding
        mask, True = padded frame; the MSE is averaged over valid frames x
        features only. ``noise`` is drawn from ``generator`` unless given."""
        cfg = self.config
        if noise is None:
            noise = self._randn(x_start.shape, generator).to(x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        if x_mask is None:
            x_mask = torch.zeros(x_start.shape[:-1], dtype=torch.bool, device=x_start.device)
        valid = (~x_mask.bool()).to(x_start.dtype)[..., None]      # (B, L, 1)

        terms: Dict[str, torch.Tensor] = {}
        if cfg.loss_type in (LossType.KL, LossType.RESCALED_KL):
            terms["loss"] = self._vb_terms_bpd(model_fn, x_start, x_t, t,
                                               clip_denoised=False)["output"]
            if cfg.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model_fn(x_t, self.model_timesteps(t))
        if cfg.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            C = x_t.shape[-1]
            model_output, var_values = torch.split(
                model_output, [C, model_output.shape[-1] - C], dim=-1)
            # the bound trains the variance only: the mean is detached
            frozen_out = torch.cat([model_output.detach(), var_values], dim=-1)
            terms["vb"] = self._vb_terms_bpd(lambda *_args: frozen_out, x_start, x_t, t,
                                             clip_denoised=False)["output"]
            if cfg.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

        if cfg.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif cfg.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        mse = (target - model_output) ** 2
        terms["mse"] = sum_flat(mse * valid) / (sum_flat(valid) * target.shape[-1])
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms


def create_gaussian_diffusion(diff_cfg: Any,
                              device: torch.device = torch.device("cpu")) -> GaussianDiffusion:
    """A (possibly respaced) diffusion from the config's ``diffusion`` block."""
    steps = int(diff_cfg.get("steps", 1000))
    predict_xstart = bool(diff_cfg.get("predict_xstart", True))
    learn_sigma = bool(diff_cfg.get("learn_sigma", False))
    sigma_small = bool(diff_cfg.get("sigma_small", True))
    noise_schedule = str(diff_cfg.get("noise_schedule", "cosine"))
    timestep_respacing = diff_cfg.get("timestep_respacing", "") or [steps]

    betas = get_named_beta_schedule(noise_schedule, steps)
    new_betas, timestep_map = respaced_betas(betas, space_timesteps(steps, timestep_respacing))
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    elif sigma_small:
        var_type = ModelVarType.FIXED_SMALL
    else:
        var_type = ModelVarType.FIXED_LARGE
    return GaussianDiffusion.create(
        new_betas,
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=var_type,
        loss_type=LossType(str(diff_cfg.get("loss_type", "MSE")).lower()),
        rescale_timesteps=bool(diff_cfg.get("rescale_timesteps", False)),
        timestep_map=timestep_map,
        original_num_steps=steps,
        device=device,
    )

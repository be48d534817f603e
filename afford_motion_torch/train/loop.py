"""Training loop (counterpart of ``afford_motion_tpu/train/loop.py``).

One optimizer step: point hierarchy (no gradient) -> draw t and the noise ->
q_sample -> denoiser forward in train mode (batch statistics, dropout) ->
masked MSE -> backward -> AdamW. Every draw of a step comes from one
generator seeded by (base seed, step), so a resumed run repeats the straight
one. The host data stream is a pure function of (base seed, step) too: the
loader's shuffle is seeded per epoch, and the datasets' own random choices
(caption, crop start, contact mix, erase flags) are re-seeded per group of
steps, with the items loaded serially. On a curve-sorted packed store with
the fps geometry wire the loop switches the banded kernels on
(``_maybe_enable_banded``).

Not ported yet: the device-resident corpus, the device mesh and its
prefetcher, the profiler trace, the pretrained scene-model load.
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..diffusion import GaussianDiffusion
from ..diffusion.resample import LossSecondMomentResampler, UniformSampler
from ..models.conditioning import add_hierarchies, cond_to_device, host_prepare_cond
from ..models.layers import set_dropout_generator
from ..models.text import TextEncoder
from ..utils.io import Board, get_logger, mkdir_if_not_exists
from .checkpoint import load_train_state, save_train_state
from .state import TrainState, annealed_lr

logger = get_logger()


def step_seed(base_seed: int, step: int) -> int:
    """Seed of a step's generator: a function of the base seed and the step,
    the same mix as the JAX loop's."""
    return (int(base_seed) * 2654435761 + int(step)) & 0xFFFFFFFF


def make_train_step(model, diffusion: GaussianDiffusion, sampler=None) -> Callable:
    """Returns ``train_step(state, x, cond, seed, t=None, noise=None) ->
    metrics``. ``state`` (a :class:`TrainState` around ``model``) is updated
    in place. ``cond`` holds tensors on the diffusion's device; ``t`` (B,)
    and ``noise`` (like ``x``) replace the step's own draws. ``metrics`` are
    0-d tensors on the device (``loss``, ``mse``, ``grad_norm``), so the step
    itself never waits for the device."""
    sampler = sampler if sampler is not None else UniformSampler(diffusion.num_timesteps)

    def train_step(state: TrainState, x: torch.Tensor, cond: Dict[str, Any], seed: int,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = diffusion.device
        model.train()
        generator = torch.Generator(device=dev).manual_seed(int(seed))
        set_dropout_generator(model, generator)
        x = x.float()  # a half-precision wire target; q_sample and the loss run in f32
        if t is None:
            t, weights = sampler.sample(generator, x.shape[0], dev, state.sampler_state)
        else:
            weights = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
        cond_h = add_hierarchies(model, cond)

        def model_fn(x_t, ts):
            return model(x_t, ts, cond_h)

        terms = diffusion.training_losses(model_fn, x, t, generator=generator,
                                          x_mask=cond_h.get("x_mask"), noise=noise)
        loss = (terms["loss"] * weights).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_dropout_generator(model, None)
        norms = [torch.linalg.vector_norm(p.grad) for group in state.optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        lr = annealed_lr(state.lr, state.step, state.lr_anneal_steps)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        state.sampler_state = sampler.update(state.sampler_state, t, terms["loss"])
        return {"loss": loss.detach(),
                "mse": terms.get("mse", terms["loss"]).mean().detach(),
                "grad_norm": torch.linalg.vector_norm(torch.stack(norms))}

    return train_step


class TrainLoop:
    """Step-driven training with resume, periodic save and board logging. No
    EMA, gradient clipping or accumulation, as in the reference's trainer."""

    def __init__(self, cfg: Any, model, diffusion: GaussianDiffusion, dataloader,
                 text_encoder: TextEncoder, *, device: torch.device,
                 exp_dir: str = "outputs/exp", seed: int = 2023):
        tcfg = cfg.task.train
        self.model, self.diffusion = model, diffusion
        self.dataloader, self.text_encoder = dataloader, text_encoder
        self.device = device
        self.max_steps = int(tcfg.max_steps)
        self.log_every_step = int(tcfg.get("log_every_step", 100))
        self.save_every_step = int(tcfg.get("save_every_step", 10000))
        self.ckpt_dir = mkdir_if_not_exists(os.path.join(exp_dir, "ckpt"))
        self._base_seed = int(seed)
        self._maybe_enable_banded()

        # serial item loading keeps the datasets' random choices a function
        # of (seed, step); see the module docstring
        dataloader.prefetch = 0
        dataloader.num_workers = 0

        sampler_type = str(tcfg.get("schedule_sampler_type", "uniform"))
        if sampler_type in ("loss-second-moment", "loss_second_moment"):
            self._sampler = LossSecondMomentResampler(diffusion.num_timesteps)
        else:
            self._sampler = UniformSampler(diffusion.num_timesteps)
        self.state = TrainState.create(
            model, lr=float(tcfg.lr), weight_decay=float(tcfg.get("weight_decay", 0.0)),
            lr_anneal_steps=int(tcfg.get("lr_anneal_steps", 0)),
            sampler_state=self._sampler.init_state(device))
        n_params = sum(p.numel() for p in model.parameters())
        logger.info(f"Model initialized: {n_params / 1e6:.2f}M params")
        resume = str(tcfg.get("resume_ckpt", "") or "")
        if resume:
            load_train_state(self.state, resume)
            logger.info(f"Resumed from {resume} at step {self.state.step}")

        # steps_per_dispatch survives as the megabatch draw of the host
        # stream: one (G*B)-item batch per G steps, as the JAX loop draws it
        self.steps_per_dispatch = int(tcfg.get("steps_per_dispatch", 4))
        self.batch_size = B = int(dataloader.batch_size)
        if (self.steps_per_dispatch > self.max_steps
                or len(dataloader.dataset) < self.steps_per_dispatch * B
                or not getattr(dataloader, "drop_last", False)):
            self.steps_per_dispatch = 1
        self.train_step = make_train_step(model, diffusion, self._sampler)
        # what the run measured, for the caller: one entry per logged window
        self.summary: Dict[str, Any] = {"device": str(device), "logged": []}

    def _maybe_enable_banded(self) -> None:
        """Enable the banded windowed-neighbourhood kernels when the data
        supports them: curve-sorted packed store(s) plus the fps-only
        geometry wire, so that every neighbourhood index is produced on the
        device by the windowed kNN. Carried on the model (``use_banded`` ->
        ``LevelGeometry.banded``), not process-global state. See
        ``ops/cuda/banded.py``."""
        ds = self.dataloader.dataset
        dcfg = getattr(ds, "cfg", None)
        if dcfg is None or not bool(dcfg.get("use_banded", True)):
            return
        if str(dcfg.get("geometry_wire", "full")) != "fps":
            return
        packed = getattr(ds, "_packed", None)
        stores = (
            list(packed.values()) if isinstance(packed, dict)
            else ([packed] if packed is not None else [])
        )
        if stores and all(st.meta.get("morton") for st in stores):
            curves = {st.meta.get("curve", "morton") for st in stores}
            self.model.use_banded = True
            logger.info(
                "banded windowed-neighborhood kernels enabled "
                f"({'/'.join(sorted(str(c) for c in curves))}-sorted packed "
                "data, fps geometry wire)"
            )

    def _groups(self, start_step: int) -> Iterator[Dict[str, Any]]:
        """The host stream from ``start_step`` on: collated (G*B)-item
        batches, the position found by index arithmetic alone."""
        G = self.steps_per_dispatch
        loader = self.dataloader
        loader.batch_size = G * self.batch_size
        per_epoch = max(1, len(loader))
        group = start_step // G
        while True:
            epoch, offset = divmod(group, per_epoch)
            loader.set_epoch(epoch)
            batches = loader.iter_batches(skip=offset)
            while True:
                random.seed((self._base_seed * 1000003 + group) & 0xFFFFFFFF)
                np.random.seed((self._base_seed * 69069 + group * 40503 + 12345) & 0x7FFFFFFF)
                batch = next(batches, None)
                if batch is None:
                    break
                yield batch
                group += 1

    def run_loop(self) -> Dict[str, Any]:
        G, B = self.steps_per_dispatch, self.batch_size
        state, board = self.state, Board()
        steps_per_epoch = max(len(self.dataloader.dataset) // B, 1)
        if state.step % G:
            raise ValueError(f"cannot resume at step {state.step} with "
                             f"steps_per_dispatch={G}: not a multiple")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t_window, steps_window, last_saved = time.monotonic(), 0, None
        for batch in self._groups(state.step):
            if state.step >= self.max_steps:
                break
            x_host, cond_host = host_prepare_cond(batch, self.text_encoder)
            for g in range(G):
                rows = slice(g * B, (g + 1) * B)
                x = torch.as_tensor(np.ascontiguousarray(x_host[rows]), device=self.device)
                cond = cond_to_device({k: v[rows] for k, v in cond_host.items()}, self.device)
                metrics = self.train_step(state, x, cond,
                                          step_seed(self._base_seed, state.step))
                steps_window += 1
                step = state.step
                if step % self.log_every_step == 0:
                    m = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    dt = time.monotonic() - t_window
                    epoch = step // steps_per_epoch
                    logger.info(
                        f"step {step}/{self.max_steps} | epoch {epoch} | loss {m['loss']:.6f} "
                        f"| mse {m['mse']:.6f} | {steps_window / max(dt, 1e-9):.2f} steps/s")
                    board.write({"train/loss": m["loss"], "train/mse": m["mse"],
                                 "train/epoch": epoch,
                                 "train/steps_per_sec": steps_window / max(dt, 1e-9),
                                 "step": step})
                    self.summary["logged"].append(
                        {"step": step, **m, "steps": steps_window, "seconds": dt})
                    t_window, steps_window = time.monotonic(), 0
                if step % self.save_every_step == 0:
                    last_saved = self.save()
                if step >= self.max_steps:
                    break
        if last_saved is None or not last_saved.endswith(f"model{state.step:06d}.pt"):
            last_saved = self.save()
        self.summary["step"] = state.step
        self.summary["last_ckpt"] = last_saved
        if self.device.type == "cuda":
            self.summary["device_name"] = torch.cuda.get_device_name(self.device)
            self.summary["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        return self.summary

    def save(self) -> str:
        path = save_train_state(self.state, self.ckpt_dir)
        logger.info(f"Saved checkpoint to {path}")
        return path

"""Training loop (counterpart of ``afford_motion_tpu/train/loop.py``).

One optimizer step: point hierarchy (no gradient) -> draw t and the noise ->
q_sample -> denoiser forward in train mode (batch statistics, dropout) ->
masked MSE -> backward -> AdamW. Every draw of a step comes from one
generator seeded by (base seed, step), so a resumed run repeats the straight
one. The data come in megabatches of G = ``steps_per_dispatch`` steps, made
by one producer thread (``parallel/mesh.py``) while the card computes, by
one of two routes:

- the device store (``device_store.py``; ``task.train.device_store``,
  ``auto`` or ``off``): on a packed tree with the fps geometry wire and the
  f16 motion wire the corpus and its cached hierarchy live on the card, and
  the host draws only item indices (``index_stream``), captions, crops and
  flags, from generators seeded per megabatch;
- the host route otherwise: the loader's collated megabatches, whose
  datasets draw from the global ``random`` / ``np.random``, re-seeded per
  megabatch by the producer thread, the only thread that draws from them
  while training runs.

Both streams are pure functions of (base seed, step). On a curve-sorted
packed store with the fps geometry wire the loop switches the banded
kernels on (``_maybe_enable_banded``). ``task.train.profile_steps`` traces
that many steps with ``torch.profiler`` after the first 2 G, into
``<exp_dir>/log/profile``; ``AM_LOOP_TIMING=1`` logs the loop's wall time by
phase at every logged step.

Not ported yet: the device mesh (one device), the pretrained scene-model
load.
"""
from __future__ import annotations

import itertools
import os
import random
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..diffusion import GaussianDiffusion
from ..diffusion.resample import LossSecondMomentResampler, UniformSampler
from ..models.conditioning import add_hierarchies, encode_text, host_prepare_cond
from ..models.layers import set_dropout_generator
from ..models.text import TextEncoder
from ..parallel.mesh import DevicePrefetcher
from ..utils.io import Board, get_logger, mkdir_if_not_exists
from .checkpoint import load_train_state, save_train_state
from .device_store import DeviceStore, index_stream, make_assemble_fn
from .state import TrainState, annealed_lr

logger = get_logger()


def step_seed(base_seed: int, step: int) -> int:
    """Seed of a step's generator: a function of the base seed and the step,
    the same mix as the JAX loop's."""
    return (int(base_seed) * 2654435761 + int(step)) & 0xFFFFFFFF


def make_train_step(model, diffusion: GaussianDiffusion, sampler=None,
                    assemble: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, x, cond, seed, t=None, noise=None) ->
    metrics``. ``state`` (a :class:`TrainState` around ``model``) is updated
    in place. ``cond`` holds tensors on the diffusion's device; ``t`` (B,)
    and ``noise`` (like ``x``) replace the step's own draws. With
    ``assemble`` (a device store's :func:`make_assemble_fn`) ``cond`` is the
    store's index batch and ``x`` is None: the step assembles both on the
    device first. ``metrics`` are 0-d tensors on the device (``loss``,
    ``mse``, ``grad_norm``), so the step itself never waits for the
    device."""
    sampler = sampler if sampler is not None else UniformSampler(diffusion.num_timesteps)

    def train_step(state: TrainState, x: torch.Tensor, cond: Dict[str, Any], seed: int,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = diffusion.device
        if assemble is not None:
            x, cond = assemble(cond)
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
        self.profile_steps = int(tcfg.get("profile_steps", 0))
        self.exp_dir = exp_dir
        self.ckpt_dir = mkdir_if_not_exists(os.path.join(exp_dir, "ckpt"))
        self._base_seed = int(seed)
        # what the run measured, for the caller: one entry per logged window
        self.summary: Dict[str, Any] = {"device": str(device), "logged": []}
        self._maybe_enable_banded()

        # items load serially inside the producer thread's megabatch draw,
        # so that the datasets' random choices follow its per-megabatch seeds
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

        # steps_per_dispatch survives as the megabatch draw of the data
        # stream: one (G*B)-item batch per G steps, as the JAX loop draws it
        self.steps_per_dispatch = int(tcfg.get("steps_per_dispatch", 4))
        self.batch_size = B = int(dataloader.batch_size)
        if (self.steps_per_dispatch > self.max_steps
                or len(dataloader.dataset) < self.steps_per_dispatch * B
                or not getattr(dataloader, "drop_last", False)):
            self.steps_per_dispatch = 1

        self._store = self._assemble = None
        # 'off' on the command line reads as YAML's false
        if str(tcfg.get("device_store", "auto")).lower() not in ("off", "false"):
            self._build_store()
        self.train_step = make_train_step(model, diffusion, self._sampler, self._assemble)

    def _build_store(self) -> None:
        """The device-resident corpus, where ``DeviceStore.try_build``
        accepts the dataset: its hierarchy cached from the fps wire, then
        uploaded to the loop's device."""
        store = DeviceStore.try_build(self.dataloader.dataset)
        if store is None:
            return
        t0 = time.monotonic()
        cached = store.add_geometry_cache(self.model, self.device)
        store.ensure_device(self.device)
        seconds = time.monotonic() - t0
        self._store, self._assemble = store, make_assemble_fn(store, self.device)
        self.summary["store"] = {"bytes": store.nbytes(), "seconds": seconds}
        logger.info(f"device store: {store.nbytes() / 1e9:.3f}GB in {len(store.arrays)} arrays "
                    f"on {self.device} (geometry cache {'on' if cached else 'off'}), "
                    f"{seconds:.2f} s for the cache and the upload")

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
        batches, the position found by index arithmetic alone. The datasets
        draw from the global ``random`` and ``np.random``, seeded here per
        megabatch: only the thread that iterates this draws from them."""
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

    def _drop_cond_suffixes(self) -> tuple:
        """Geometry fields the model never reads: an encoder-only SceneMap
        (CMDM ``trans_enc``) uses no 3-NN up-interpolation. The datasets
        already leave them out where ``geometry_arch`` names the encoder."""
        if self.model.needs_up_interpolation:
            return ()
        return ("_up_idx", "_up_weight")

    def _host_stream(self, start_step: int):
        """(megabatches, prepare) of the host route: collated items ->
        {"x", cond arrays}."""
        drop = self._drop_cond_suffixes()

        def prepare(batch):
            x, cond = host_prepare_cond(batch, self.text_encoder, drop)
            return {"x": x, **cond}

        return lambda: self._groups(start_step), prepare

    def _store_stream(self, start_step: int):
        """(megabatches, prepare) of the device-store route: index chunks of
        ``index_stream`` -> the index batch, whose random choices come from
        generators seeded by (base seed, megabatch), as the JAX loop seeds
        them, and whose captions are encoded to an f16 ``text_emb``."""
        G, B = self.steps_per_dispatch, self.batch_size
        dataset, store = self.dataloader.dataset, self._store
        group = [start_step // G]  # the producer thread calls prepare in stream order

        def prepare(ids):
            gi = group[0]
            group[0] += 1
            py_rng = random.Random((self._base_seed * 1000003 + gi) & 0xFFFFFFFF)
            np_rng = np.random.RandomState((self._base_seed * 69069 + gi * 40503 + 12345)
                                           & 0x7FFFFFFF)
            meta = store.draw_batch(dataset, ids, py_rng, np_rng)
            text = encode_text(self.text_encoder, meta.pop("c_text"))
            meta["text_emb"] = text.pop("text_emb").astype(np.float16)
            meta.update(text)
            return meta

        loader_seed = int(getattr(self.dataloader, "seed", 0))
        return lambda: index_stream(len(dataset), G, B, start_step, self._base_seed,
                                    loader_seed), prepare

    def run_loop(self) -> Dict[str, Any]:
        G, B = self.steps_per_dispatch, self.batch_size
        state, board = self.state, Board()
        steps_per_epoch = max(len(self.dataloader.dataset) // B, 1)
        if state.step % G:
            raise ValueError(f"cannot resume at step {state.step} with "
                             f"steps_per_dispatch={G}: not a multiple")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        groups, prepare = (self._store_stream if self._store is not None
                           else self._host_stream)(state.step)
        # the producer stops after the last megabatch the run takes
        n_groups = max(0, -(-(self.max_steps - state.step) // G))
        prefetcher = DevicePrefetcher(lambda: itertools.islice(groups(), n_groups), prepare,
                                      self.device)
        profile_start = 2 * G if self.profile_steps > 0 else -1
        profile_stop = profile_start + self.profile_steps
        profiler = None
        # AM_LOOP_TIMING=1: the loop's wall time by phase, logged and reset
        # at every logged step
        timing = os.environ.get("AM_LOOP_TIMING", "") == "1"
        tm = {"wait_batch": 0.0, "dispatch": 0.0, "metrics_get": 0.0, "other": 0.0}
        t_mark = time.monotonic()

        def mark(key):
            nonlocal t_mark
            now = time.monotonic()
            tm[key] += now - t_mark
            t_mark = now

        t_window, steps_window, last_saved = time.monotonic(), 0, None
        megabatches = iter(prefetcher)
        try:
            while state.step < self.max_steps:
                mark("other")
                mega = next(megabatches, None)
                mark("wait_batch")
                if mega is None:
                    break
                for g in range(G):
                    mark("other")
                    if profiler is None and 0 <= profile_start <= state.step:
                        profiler = self._start_profiler()
                        profile_start = -1  # one trace a run
                    elif profiler is not None and state.step >= profile_stop:
                        self._stop_profiler(profiler)
                        profiler = None
                    cond = {k: v[g * B:(g + 1) * B] for k, v in mega.items()}
                    x = cond.pop("x", None)
                    metrics = self.train_step(state, x, cond,
                                              step_seed(self._base_seed, state.step))
                    mark("dispatch")
                    steps_window += 1
                    step = state.step
                    if step % self.log_every_step == 0:
                        m = {k: float(v) for k, v in metrics.items()}  # waits for the device
                        mark("metrics_get")
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
                        if timing:
                            self.summary["logged"][-1]["timing"] = dict(tm)
                            total = sum(tm.values()) or 1e-9
                            logger.info("loop timing | " + " | ".join(
                                f"{k} {v:.2f}s ({100 * v / total:.0f}%)" for k, v in tm.items()))
                            for k in tm:
                                tm[k] = 0.0
                        t_window, steps_window = time.monotonic(), 0
                    if step % self.save_every_step == 0:
                        last_saved = self.save()
                    if step >= self.max_steps:
                        break
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            prefetcher.close()
        if last_saved is None or not last_saved.endswith(f"model{state.step:06d}.pt"):
            last_saved = self.save()
        self.summary["step"] = state.step
        self.summary["last_ckpt"] = last_saved
        if self.device.type == "cuda":
            self.summary["device_name"] = torch.cuda.get_device_name(self.device)
            self.summary["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        return self.summary

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()
        out = mkdir_if_not_exists(os.path.join(self.exp_dir, "log", "profile"))
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("profiler trace written to log/profile")

    def save(self) -> str:
        path = save_train_state(self.state, self.ckpt_dir)
        logger.info(f"Saved checkpoint to {path}")
        return path

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
  flags (for the MotionX sets the mix and the rotation angles), from
  generators seeded per megabatch;
- the host route otherwise: the loader's collated megabatches, whose
  datasets draw from the global ``random`` / ``np.random``, re-seeded per
  megabatch by the producer thread, the only thread that draws from them
  while training runs.

Both streams are pure functions of (base seed, step). On a curve-sorted
packed store with the fps geometry wire the loop switches the banded
kernels on (``_maybe_enable_banded``). ``task.train.profile_steps`` traces
that many steps with ``torch.profiler`` after the first 2 G, into
``<exp_dir>/log/profile``; ``task.train.trace`` switches the port's tracer
on (``utils/trace.py``): spans of set-up, the producer, the loop, the step's
parts and the model's two halves, whose totals and counters the loop logs at
every logged step, and which every profiler trace shows as ``am.`` ranges.
A CDM's frozen scene model takes the pretrained weights of
``model.scene_model.pretrained_weight`` where that file exists
(``_maybe_load_pretrained_scene``).

Data parallelism (``parallel/mesh.py``; launched by ``torchrun`` through
``afford_motion_torch.train_ddp``): ``task.train.batch_size`` is the global
batch, which the world must divide, and rank ``r`` of ``W`` trains on rows
``[r B / W, (r + 1) B / W)`` of every step's batch, in
``DistributedDataParallel`` with the ``PointNorm`` statistics taken over
the global batch, so that a world-W run computes what a world-1 run does up
to the order of sums. Every rank draws the same global megabatch; on the
host route it loads it whole and keeps its rows (the per-item draws chain
through the global generators), on the store route it loads only its rows'
mix files; captions are encoded for its rows only. The device store shards
its rows over the ranks (``task.train.device_store_shard``, ``auto`` or
``off``; the budget is then the world's). Rank 0 writes the checkpoints,
the logs and the board, with a barrier after each save.
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
from ..models.pointtransformer import load_pretrained_scene
from ..models.text import TextEncoder
from ..parallel.mesh import DataParallel, DevicePrefetcher, current
from ..utils import trace
from ..utils.io import Board, get_logger, mkdir_if_not_exists
from ..utils.trace import span
from .checkpoint import load_train_state, save_train_state
from .device_store import DeviceStore, index_stream, make_assemble_fn, max_bytes_from_env
from .state import TrainState, annealed_lr

logger = get_logger()


def step_seed(base_seed: int, step: int) -> int:
    """Seed of a step's generator: a function of the base seed and the step,
    the same mix as the JAX loop's."""
    return (int(base_seed) * 2654435761 + int(step)) & 0xFFFFFFFF


def take_rows(batch: Dict[str, Any], idx: np.ndarray) -> Dict[str, Any]:
    """The rows ``idx`` of a collated batch or an index batch: arrays by
    their first axis, lists item by item, anything else as it is."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim > 0:
            out[k] = v[idx]
        elif isinstance(v, (list, tuple)):
            out[k] = [v[i] for i in idx]
        else:
            out[k] = v
    return out


def rank_seed(seed: int, rank: int) -> int:
    """Seed of a rank's dropout generator in a step of a data-parallel run
    of more than one process: the step's seed mixed with the rank, so that
    no two ranks draw the same masks over their different rows."""
    return (int(seed) * 0x9E3779B1 + (int(rank) + 1) * 0x85EBCA77) & 0xFFFFFFFF


def make_train_step(model, diffusion: GaussianDiffusion, sampler=None,
                    assemble: Optional[Callable] = None, dp: Optional[DataParallel] = None,
                    forward: Optional[torch.nn.Module] = None) -> Callable:
    """Returns ``train_step(state, x, cond, seed, t=None, noise=None) ->
    metrics``. ``state`` (a :class:`TrainState` around ``model``) is updated
    in place. ``cond`` holds tensors on the diffusion's device; ``t`` (B,)
    and ``noise`` (like ``x``) replace the step's own draws. With
    ``assemble`` (a device store's :func:`make_assemble_fn`) ``cond`` is the
    store's index batch and ``x`` is None: the step assembles both on the
    device first. ``metrics`` are 0-d tensors on the device (``loss``,
    ``mse``, ``grad_norm``), so the step itself never waits for the
    device.

    ``dp`` (a data-parallel context, :mod:`..parallel.mesh`): ``x`` and
    ``cond`` hold this rank's rows of the global batch (the index batch's
    ``item_row`` all of them), ``forward`` is ``model`` in
    ``DistributedDataParallel``. ``t`` and the noise are drawn for the
    global batch from the step's generator and sliced (injected ones are
    the global batch's too); each rank's loss is the mean over its equal
    share, which the averaged gradients make the global mean's; ``loss`` and
    ``mse`` are all-reduced; ``grad_norm`` is the averaged gradients'; a
    loss-second-moment sampler folds in the all-gathered ``t`` and losses in
    global row order. Above one process the dropout masks come from a
    generator of :func:`rank_seed`; at world 1 from the step's generator,
    as without a group."""
    sampler = sampler if sampler is not None else UniformSampler(diffusion.num_timesteps)
    forward = model if forward is None else forward
    world, rank = (dp.world, dp.rank) if dp is not None else (1, 0)

    def train_step(state: TrainState, x: torch.Tensor, cond: Dict[str, Any], seed: int,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = diffusion.device
        with span("step: assemble"):
            if assemble is not None:
                x, cond = assemble(cond)
            x = x.float()  # a half-precision wire target; q_sample and the loss run in f32
        model.train()
        with span("step: draws"):
            generator = torch.Generator(device=dev).manual_seed(int(seed))
            b = x.shape[0]
            rows = slice(rank * b, (rank + 1) * b)
            if t is None:
                t, weights = sampler.sample(generator, world * b, dev, state.sampler_state)
                t, weights = t[rows], weights[rows]
            else:
                t = t[rows]
                weights = torch.ones((b,), dtype=torch.float32, device=dev)
            noise = (diffusion.randn_rows((world * b,) + tuple(x.shape[1:]), generator, rows)
                     if noise is None else noise[rows])
            set_dropout_generator(model, generator if world == 1 else torch.Generator(
                device=dev).manual_seed(rank_seed(seed, rank)))
        with span("step: hierarchy"):
            cond_h = add_hierarchies(model, cond)

        def model_fn(x_t, ts):
            return forward(x_t, ts, cond_h)

        with span("step: loss"):
            terms = diffusion.training_losses(model_fn, x, t, generator=generator,
                                              x_mask=cond_h.get("x_mask"), noise=noise)
            loss = (terms["loss"] * weights).mean()
        with span("step: optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("step: backward"):
            loss.backward()
        set_dropout_generator(model, None)
        with span("step: optimizer"):
            norms = [torch.linalg.vector_norm(p.grad) for group in state.optimizer.param_groups
                     for p in group["params"] if p.grad is not None]
            lr = annealed_lr(state.lr, state.step, state.lr_anneal_steps)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        state.step += 1
        with span("step: metrics"):
            losses = terms["loss"].detach()
            metrics = torch.stack([loss.detach(),
                                   terms.get("mse", terms["loss"]).mean().detach()])
            if world > 1:
                metrics = dp.all_reduce(metrics) / world
                if state.sampler_state is not None:
                    t, losses = dp.all_gather_rows(t), dp.all_gather_rows(losses)
            state.sampler_state = sampler.update(state.sampler_state, t, losses)
            grad_norm = torch.linalg.vector_norm(torch.stack(norms))
        return {"loss": metrics[0], "mse": metrics[1], "grad_norm": grad_norm}

    return train_step


class TrainLoop:
    """Step-driven training with resume, periodic save and board logging. No
    EMA, gradient clipping or accumulation, as in the reference's trainer.
    Inside a data-parallel session (``parallel.current()``) it trains this
    rank's share, as the module's docstring says."""

    def __init__(self, cfg: Any, model, diffusion: GaussianDiffusion, dataloader,
                 text_encoder: TextEncoder, *, device: torch.device,
                 exp_dir: str = "outputs/exp", seed: int = 2023):
        tcfg = cfg.task.train
        if bool(tcfg.get("trace", False)):
            trace.enable()
        with span("setup: train loop"):
            self.model, self.diffusion = model, diffusion
            self.dataloader, self.text_encoder = dataloader, text_encoder
            self.device = device
            self.dp = current()
            self.world, self.rank = (self.dp.world, self.dp.rank) if self.dp else (1, 0)
            self.max_steps = int(tcfg.max_steps)
            self.log_every_step = int(tcfg.get("log_every_step", 100))
            self.save_every_step = int(tcfg.get("save_every_step", 10000))
            self.profile_steps = int(tcfg.get("profile_steps", 0))
            self.exp_dir = exp_dir
            self.ckpt_dir = mkdir_if_not_exists(os.path.join(exp_dir, "ckpt"))
            self._base_seed = int(seed)
            # what the run measured, for the caller: one entry per logged window
            self.summary: Dict[str, Any] = {"device": str(device), "logged": [],
                                            "rank": self.rank, "world": self.world}
            # the global batch's rows of this rank (raises where W does not divide it)
            self.batch_size = B = int(dataloader.batch_size)
            self._rows = self.dp.local_rows(B) if self.dp else slice(0, B)
            self._maybe_enable_banded()
            self._maybe_load_pretrained_scene(cfg)

            # items load serially inside the producer thread's megabatch draw,
            # so that the datasets' random choices follow its per-megabatch seeds
            dataloader.prefetch = 0
            dataloader.num_workers = 0

            sampler_type = str(tcfg.get("schedule_sampler_type", "uniform"))
            if sampler_type in ("loss-second-moment", "loss_second_moment"):
                self._sampler = LossSecondMomentResampler(diffusion.num_timesteps)
            else:
                self._sampler = UniformSampler(diffusion.num_timesteps)
            with span("setup: optimizer"):  # the first AdamW imports torch._dynamo
                self.state = TrainState.create(
                    model, lr=float(tcfg.lr), weight_decay=float(tcfg.get("weight_decay", 0.0)),
                    lr_anneal_steps=int(tcfg.get("lr_anneal_steps", 0)),
                    sampler_state=self._sampler.init_state(device))
            n_params = sum(p.numel() for p in model.parameters())
            logger.info(f"Model initialized: {n_params / 1e6:.2f}M params")
            resume = str(tcfg.get("resume_ckpt", "") or "")
            if resume:
                load_train_state(self.state, resume)  # on every rank
                logger.info(f"Resumed from {resume} at step {self.state.step}")
            self._forward = model
            if self.dp is not None:
                self.dp.broadcast_module(model)
                self._forward = self.dp.wrap(model)

            # steps_per_dispatch survives as the megabatch draw of the data
            # stream: one (G*B)-item batch per G steps, as the JAX loop draws it
            self.steps_per_dispatch = int(tcfg.get("steps_per_dispatch", 4))
            if (self.steps_per_dispatch > self.max_steps
                    or len(dataloader.dataset) < self.steps_per_dispatch * B
                    or not getattr(dataloader, "drop_last", False)):
                self.steps_per_dispatch = 1

            self._store = self._assemble = None
            # 'off' on the command line reads as YAML's false
            if str(tcfg.get("device_store", "auto")).lower() not in ("off", "false"):
                with span("setup: device store"):
                    self._build_store(str(tcfg.get("device_store_shard", "auto")).lower()
                                      not in ("off", "false"))
            self.train_step = make_train_step(model, diffusion, self._sampler, self._assemble,
                                              dp=self.dp, forward=self._forward)

    def _build_store(self, shard: bool = True) -> None:
        """The device-resident corpus, where ``DeviceStore.try_build``
        accepts the dataset: above one process its rows sharded over the
        ranks (``shard``: ``task.train.device_store_shard`` not ``off``)
        within the world's budget, as the JAX loop shards it over the mesh;
        then its hierarchy cached from the fps wire and uploaded to the
        loop's device."""
        sharded = shard and self.world > 1
        budget = max_bytes_from_env() * (self.world if sharded else 1)
        store = DeviceStore.try_build(self.dataloader.dataset, max_bytes=budget)
        if store is None:
            return
        t0 = time.monotonic()
        if sharded:
            store.shard_rows(self.dp)
        elif self.dp is not None:
            store.dp = self.dp  # replicated: a rank fetches its rows of the batch
        cached = store.add_geometry_cache(self.model, self.device)
        store.ensure_device(self.device)
        seconds = time.monotonic() - t0
        self._store, self._assemble = store, make_assemble_fn(store, self.device)
        self.summary["store"] = {"bytes": store.nbytes(), "seconds": seconds,
                                 "sharded": sorted(store.sharded)}
        logger.info(f"device store: {store.nbytes() / 1e9:.3f}GB in {len(store.arrays)} arrays "
                    f"on {self.device} (geometry cache {'on' if cached else 'off'}"
                    + (f", {len(store.sharded)} arrays sharded over {self.world} ranks"
                       if store.sharded else "")
                    + f"), {seconds:.2f} s for the cache and the upload")

    def _maybe_load_pretrained_scene(self, cfg: Any) -> None:
        """A CDM's frozen scene model from ``model.scene_model.pretrained_weight``
        (the reference's ``.pth``: its ``enc*``/``dec*`` entries, loaded with
        ``strict=True``); where that file does not exist the scene model
        keeps its initial weights, with a warning."""
        scene = getattr(self.model, "scene_model", None)
        if scene is None:
            return
        weight = str(cfg.model.scene_model.get("pretrained_weight", "") or "")
        if not weight or not os.path.exists(weight):
            logger.warning(f"pretrained scene weights not found at {weight!r}; "
                           "the frozen scene model keeps its random init")
            return
        load_pretrained_scene(scene, weight)
        logger.info(f"Loaded pretrained scene model from {weight}")

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
        already leave them out where ``geometry_arch`` names the encoder. A
        model that does not say (the CDM) keeps them, as in the JAX loop."""
        if getattr(self.model, "needs_up_interpolation", True):
            return ()
        return ("_up_idx", "_up_weight")

    def _local_positions(self, n: int) -> np.ndarray:
        """This rank's positions in a megabatch of ``n`` rows, G steps of B:
        its rows of each step in step order (all of them without a group)."""
        B, r = self.batch_size, self._rows
        return np.concatenate([np.arange(g + r.start, g + r.stop) for g in range(0, n, B)])

    def _host_stream(self, start_step: int):
        """(megabatches, prepare) of the host route: collated items ->
        {"x", cond arrays}. Above one process every rank loads the whole
        megabatch, since each item's draws continue the global generators
        where the item before left them, and keeps its rows before the
        captions are encoded."""
        drop = self._drop_cond_suffixes()

        def prepare(batch):
            if self.world > 1:
                batch = take_rows(batch, self._local_positions(len(batch["c_text"])))
            x, cond = host_prepare_cond(batch, self.text_encoder, drop)
            return {"x": x, **cond}

        return lambda: self._groups(start_step), prepare

    def _store_stream(self, start_step: int):
        """(megabatches, prepare) of the device-store route: index chunks of
        ``index_stream`` -> the index batch, whose random choices come from
        generators seeded by (base seed, megabatch), as the JAX loop seeds
        them, and whose captions are encoded to an f16 ``text_emb``. Above
        one process each rank draws for the whole megabatch, loads the mix
        files of its rows only and keeps its rows of every field but
        ``item_row``, the global index list the sharded ``fetch`` takes."""
        G, B = self.steps_per_dispatch, self.batch_size
        dataset, store = self.dataloader.dataset, self._store
        group = [start_step // G]  # the producer thread calls prepare in stream order

        def prepare(ids):
            gi = group[0]
            group[0] += 1
            py_rng = random.Random((self._base_seed * 1000003 + gi) & 0xFFFFFFFF)
            np_rng = np.random.RandomState((self._base_seed * 69069 + gi * 40503 + 12345)
                                           & 0x7FFFFFFF)
            with span("store: draw batch"):
                if self.world > 1:
                    own = self._local_positions(len(ids))
                    meta = store.draw_batch(dataset, ids, py_rng, np_rng, own=own)
                    item_row = meta.pop("item_row")
                    meta = take_rows(meta, own)
                    meta["item_row"] = item_row
                else:
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
        b = B // self.world  # this rank's rows of a step
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
                                      self.device, first=state.step // G)
        profile_start = 2 * G if self.profile_steps > 0 else -1
        profile_stop = profile_start + self.profile_steps
        profiler = None
        t_window, steps_window, last_saved = time.monotonic(), 0, None
        megabatches = iter(prefetcher)
        try:
            while state.step < self.max_steps:
                with span("loop: wait", megabatch=state.step // G):
                    mega = next(megabatches, None)
                if mega is None:
                    break
                for g in range(G):
                    if profiler is None and 0 <= profile_start <= state.step:
                        profiler = self._start_profiler()
                        profile_start = -1  # one trace a run
                    elif profiler is not None and state.step >= profile_stop:
                        self._stop_profiler(profiler)
                        profiler = None
                    with span("loop: step", step=state.step):
                        cond = {k: v[g * B:(g + 1) * B] if k == "item_row"
                                else v[g * b:(g + 1) * b] for k, v in mega.items()}
                        x = cond.pop("x", None)
                        metrics = self.train_step(state, x, cond,
                                                  step_seed(self._base_seed, state.step))
                    steps_window += 1
                    step = state.step
                    if step % self.log_every_step == 0:  # every rank: metrics are global
                        with span("loop: metrics"):
                            m = {k: float(v) for k, v in metrics.items()}  # waits for the device
                        dt = time.monotonic() - t_window
                        epoch = step // steps_per_epoch
                        logger.info(
                            f"step {step}/{self.max_steps} | epoch {epoch} | loss {m['loss']:.6f} "
                            f"| mse {m['mse']:.6f} | {steps_window / max(dt, 1e-9):.2f} steps/s")
                        if self.rank == 0:
                            board.write({"train/loss": m["loss"], "train/mse": m["mse"],
                                         "train/epoch": epoch,
                                         "train/steps_per_sec": steps_window / max(dt, 1e-9),
                                         "step": step})
                        self.summary["logged"].append(
                            {"step": step, **m, "steps": steps_window, "seconds": dt})
                        if trace.enabled():
                            self._log_trace(self.summary["logged"][-1])
                        t_window, steps_window = time.monotonic(), 0
                    if step % self.save_every_step == 0:
                        with span("loop: save"):
                            last_saved = self.save()
                    if step >= self.max_steps:
                        break
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            prefetcher.close()
        if last_saved is None or not last_saved.endswith(f"model{state.step:06d}.pt"):
            with span("loop: save"):
                last_saved = self.save()
        self.summary["step"] = state.step
        self.summary["last_ckpt"] = last_saved
        if self.device.type == "cuda":
            self.summary["device_name"] = torch.cuda.get_device_name(self.device)
            self.summary["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        return self.summary

    @staticmethod
    def _log_trace(entry: Dict[str, Any]) -> None:
        """The tracer's span totals and counters since the last logged step:
        kept in the summary's ``entry`` under ``spans`` and logged."""
        entry["spans"] = totals = trace.totals()
        logger.info("trace | " + " | ".join(
            [f"{k} {v:.3f}s" for k, v in sorted(totals["seconds"].items())]
            + [f"{k} {v}" for k, v in sorted(totals["counts"].items())]))

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
        if self.rank != 0:
            return
        out = mkdir_if_not_exists(os.path.join(self.exp_dir, "log", "profile"))
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("profiler trace written to log/profile")

    def save(self) -> str:
        """Rank 0 writes ``model{step}.pt`` and ``train_state{step}.pt``; every
        rank waits for it at a barrier, then returns the model file's path."""
        path = save_train_state(self.state, self.ckpt_dir)
        if self.dp is not None:
            self.dp.barrier()
        logger.info(f"Saved checkpoint to {path}")
        return path

"""Traffic runner ``train_loop``: the program's training entry as a user
runs it, through ``afford_motion_torch.train.loop.TrainLoop.run_loop``.

Set-up builds what ``afford_motion_torch.train`` builds (configuration,
dataset and loader on the prepared corpus, model and diffusion, text
encoder, ``TrainLoop`` with its device store), with the weights made here
from the seed. One ``run_loop`` then does everything, in this order:

1. ``warmup_megabatches`` megabatches: the shapes of the cell compile and
   warm up, and the first ``check_steps`` steps, from the seed, are the ones
   the plain reference follows (their losses, the first gradient from the
   optimizer's state, the parameters' change after them);
2. with ``--trace 1``, ``trace_megabatches`` megabatches under the profiler;
3. the timed window: from a device synchronize to the first megabatch
   boundary after ``--seconds``, again to a device synchronize.

The benchmark wraps three attributes of the loop object from its own side
and edits no file of the program: ``train_step`` (the step count, the
window's bounds, the readings), the loop module's ``DevicePrefetcher``
(the time the loop waits for a megabatch) and ``save`` (nothing is
written). Once the window has closed, the program's state is freed and the
reference runs its steps (``perfbench/reference``).
"""
from __future__ import annotations

import contextlib
import gc
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.harness import compare, corpus, trace
from perfbench.harness.core import load_module
from perfbench.harness.weights import make_weights, weight_seed

NEVER = 10 ** 12  # the loop's step budget: the window ends it


class _Window:
    """What the wrapped step records: the steps' bounds and times."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.steps = 0
        self.waits: List[tuple] = []


def _timed_prefetcher(base, window: _Window, span):
    class TimedPrefetcher(base):
        """The program's prefetcher; each wait of the loop for a megabatch
        is timed."""

        def __iter__(self):
            it = super().__iter__()
            while True:
                t = time.monotonic()
                with span("wait for a megabatch"):
                    item = next(it, None)
                window.waits.append((t, time.monotonic()))
                if item is None:
                    return
                yield item

    return TimedPrefetcher


def _resolved(cfg, key: str):
    v = cfg
    for part in key.split("."):
        v = v[part] if isinstance(v, dict) else getattr(v, part)
    return v


def _same(want, got) -> bool:
    if isinstance(want, bool) or isinstance(want, str):
        return str(want).lower() == str(got).lower()
    if isinstance(want, (int, float)):
        return float(got) == float(want)
    return len(want) == len(got) and all(_same(w, g) for w, g in zip(want, got))


def check_resolved(cfg, resolved: Dict[str, Any]) -> None:
    """The configuration file's ``resolved`` values against the program's
    configuration as it resolves them: a default that moves shows here."""
    wrong = {k: (v, _resolved(cfg, k)) for k, v in resolved.items()
             if not _same(v, _resolved(cfg, k))}
    if wrong:
        raise ValueError(f"the program resolves the configuration otherwise: {wrong}")


def _span_step_phases(tracer, loop_mod, diffusion, opt) -> None:
    """Host spans of the step's phases, from the calls the step makes into
    the program's layers and the libraries: the hierarchy, the forward and
    loss, the backward and the optimizer."""
    tracer.wrap(loop_mod, "add_hierarchies", "train step: hierarchy")
    tracer.wrap(diffusion, "training_losses", "train step: forward and loss")
    tracer.wrap(torch.Tensor, "backward", "train step: backward")
    tracer.wrap(opt, "step", "train step: optimizer")


def _first_moment(opt, p, beta1: float) -> torch.Tensor:
    """The gradient the optimizer took in its first step, from its first
    moment; not a number where the optimizer keeps none."""
    m = opt.state.get(p, {}).get("exp_avg")
    return torch.full_like(p, float("nan")) if m is None else m / (1.0 - beta1)


def _leaf_norms(named, fn) -> Dict[str, torch.Tensor]:
    """Each leaf's norm of ``fn(name, parameter)``, a packed in-projection's
    by its three projections (``compare.leaf_parts``)."""
    return {part: torch.linalg.vector_norm(t.float()) for name, p in named
            for part, t in compare.leaf_parts(name, fn(name, p))}


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    from afford_motion_torch.data import create_dataset
    from afford_motion_torch.models.base import create_model_and_diffusion
    from afford_motion_torch.models.text import create_text_encoder
    from afford_motion_torch.train import loop as loop_mod
    from afford_motion_torch.utils.config import load_config
    from afford_motion_torch.utils.misc import compute_repr_dimension

    config, traffic, workload = ctx["config"], ctx["traffic"], ctx["workload"]
    dev, seed = ctx["device"], int(ctx["seed"])
    phases = {"imports": time.monotonic()}
    data_dir = corpus.ensure(traffic["corpus"], traffic["prepare"], ctx["cache"],
                             "cuda:0" if dev.type == "cuda" else "cpu")
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
    overrides = list(config["overrides"]) + list(ctx.get("extra_overrides", [])) + [
        f"task.dataset.data_dir={data_dir}",
        f"text_encoder.table_path={data_dir / 'text_embeddings.npz'}",
        f"text_encoder.weights_dir={data_dir / 'no_text_weights'}",
        f"exp_dir={tmp.name}", f"seed={seed}", f"task.train.max_steps={NEVER}"]
    cfg = load_config(str(Path(ctx["root"]) / "configs"), overrides)
    check_resolved(cfg, config["resolved"])
    phases["corpus and configuration"] = time.monotonic()
    # what afford_motion_torch.train's entry does before it trains
    random.seed(cfg.seed)
    np.random.seed(cfg.seed % 2 ** 32)
    cfg.model.input_feats = compute_repr_dimension(cfg.model.data_repr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dataset = create_dataset(cfg.task.dataset, "train")
    dataloader = dataset.get_dataloader(batch_size=cfg.task.train.batch_size, num_workers=0,
                                        prefetch=0, shuffle=True, drop_last=True, seed=cfg.seed)
    phases["dataset"] = time.monotonic()
    torch.manual_seed(int(cfg.seed))
    model, diffusion = create_model_and_diffusion(cfg, dev)
    weights = make_weights(model, weight_seed(seed), dev)
    te_cfg = cfg.text_encoder
    text_encoder = create_text_encoder(
        cfg.model.text_model.version, table_path=te_cfg.get("table_path"),
        weights_dir=te_cfg.get("weights_dir"), max_length=int(cfg.model.text_model.max_length),
        per_token=str(cfg.model.name) == "CMDM", device=dev, strict_table=True)
    phases["model, weights, text"] = time.monotonic()

    window = _Window()
    tracer = trace.Tracer(ctx["roofline"], load_module) if ctx["trace"] else None
    base_prefetcher = loop_mod.DevicePrefetcher
    span = tracer.span if tracer else (lambda name: contextlib.nullcontext())
    loop_mod.DevicePrefetcher = _timed_prefetcher(base_prefetcher, window, span)
    try:
        loop = loop_mod.TrainLoop(cfg, model, diffusion, dataloader, text_encoder, device=dev,
                                  exp_dir=tmp.name, seed=seed)
        phases["loop, optimizer, store"] = time.monotonic()
        G = loop.steps_per_dispatch
        n_check = int(workload["check_steps"])
        warm = int(traffic["warmup_megabatches"]) * G
        # traced: the device segment, then one megabatch for the kernels' segment
        kernels_at = warm + (int(traffic["trace_megabatches"]) * G if tracer else 0)
        start = kernels_at + (G if tracer else 0)
        if n_check > warm:
            raise ValueError("the checked steps must lie in the warm-up")
        seconds = float(ctx["seconds"])
        step, opt = loop.train_step, loop.state.optimizer
        named = list(model.named_parameters())
        beta1 = opt.param_groups[0]["betas"][0]
        readings: Dict[str, Any] = {"loss": []}
        if tracer is not None:
            _span_step_phases(tracer, loop_mod, diffusion, opt)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def train_step(state, x, cond, seed_k, t=None, noise=None):
            k = state.step
            if tracer is not None and k == warm:
                tracer.start_device(dev)
            if tracer is not None and k == kernels_at:
                tracer.stop_device(dev)
                tracer.start_kernels(dev)
            if k == start:
                if tracer is not None:
                    tracer.stop_kernels(dev)
                sync()
                window.t0 = time.monotonic()
                phases["warm-up"] = window.t0
            with span("train step: assembly, draws, metrics"):
                out = step(state, x, cond, seed_k, t, noise)
            if k < n_check:
                readings["loss"].append(out["loss"].detach())
                if k == 0:  # the first gradient as the optimizer has it: m_1 = (1 - b1) g
                    readings["grad"] = _leaf_norms(named, lambda n, p: _first_moment(
                        opt, p, beta1))
                if k == n_check - 1:
                    readings["change"] = _leaf_norms(named, lambda n, p: p.detach() - weights[n])
            done = state.step - start
            if (k >= start and done % G == 0
                    and time.monotonic() - window.t0 >= seconds):
                sync()
                window.t1 = time.monotonic()
                window.steps = done
                loop.max_steps = state.step  # the loop stops after this step
            return out

        loop.train_step = train_step
        loop.save = lambda: f"model{loop.state.step:06d}.pt"  # nothing is written
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)  # the peak of the loop alone
        loop.run_loop()
    finally:
        loop_mod.DevicePrefetcher = base_prefetcher
        if tracer is not None:
            tracer.restore()
    if window.t1 is None:
        raise RuntimeError("the loop ended before the window closed")
    setup_s = window.t0 - ctx["t_start"]
    marks = [ctx["t_start"]] + list(phases.values())
    print("perfbench: set-up " + ", ".join(f"{name} {b - a:.2f} s" for name, a, b in zip(
        phases, marks, marks[1:])), file=sys.stderr)
    window_s = window.t1 - window.t0
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    wait_s = sum(max(0.0, min(b, window.t1) - max(a, window.t0)) for a, b in window.waits)
    batch = int(cfg.task.train.batch_size)
    program = {"loss": [float(v) for v in readings["loss"]],
               "grad": {n: float(v) for n, v in readings["grad"].items()},
               "change": {n: float(v) for n, v in readings["change"].items()}}
    traced_run = tracer.reduce() if tracer is not None else None

    # the program's state goes before the reference runs on the card
    plain_cfg = cfg.to_dict()
    host_weights = {n: w.detach().cpu() for n, w in weights.items()}
    del loop, model, diffusion, dataset, dataloader, text_encoder, step, opt, named, weights
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from perfbench.reference import train as reference

    t_ref = time.monotonic()
    ref = reference.readings(plain_cfg, traffic["corpus"], host_weights, seed, n_check, G, dev,
                             cache=ctx["cache"])
    print(f"perfbench: the reference's {n_check} steps took {time.monotonic() - t_ref:.1f} s",
          file=sys.stderr)
    checks = compare.checks(program, ref, workload["limits"], workload.get("leaf_groups"))
    tmp.cleanup()
    return {
        "correct": compare.correct(checks), "checks": checks,
        "attempted": window.steps, "failed": 0,
        "steps": window.steps, "samples": window.steps * batch, "batch": batch,
        "window_s": window_s, "setup_s": setup_s, "wait_s": wait_s,
        "peak_bytes": peak, "device_name": device_name, "trace": traced_run,
        "program": program, "reference": ref,
        "reference_args": (plain_cfg, traffic["corpus"], host_weights, seed, n_check, G),
        "reference_cache": ctx["cache"],
    }

"""Where one full-width train step's time goes on the card:

    python -m afford_motion_torch.tools.profile_train_step [out_dir] [--banded]

Builds the flagship CMDM ``trans_enc`` (latent 512, 5 layers, planes
32/64/128/256, bf16) from a seeded init and one random batch of 32 items
(8192-point clouds, 196x263 motions) on the card, runs a few warm-up steps,
then (1) times the parts of a step by a host clock to a device synchronize
(hierarchy, forward with loss, backward, optimizer) over a few steps and
(2) traces one step with ``torch.profiler`` and prints the device time by
kernel. Prints the card's name and power limit first; writes the table to
``out_dir`` (default ``build/profile``). No dataset is read: this measures the
device's step, not the host's loading. With ``--banded`` it profiles the
banded step instead, as the loop runs it on a curve-sorted packed store: the
clouds are Hilbert-sorted, the batch carries each item's cached ascending
``fps_idx`` (so no FPS runs in the step) and the model has ``use_banded`` on;
the table goes to ``profile_train_step_banded.txt``.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..diffusion import create_gaussian_diffusion
from ..models.cmdm import CMDM
from ..models.conditioning import add_hierarchies
from ..models.layers import set_dropout_generator
from ..train.loop import make_train_step
from ..train.state import TrainState, annealed_lr
from ..utils.config import DictConfig

B, N, L, D = 32, 8192, 196, 263


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _banded_batch(rng, dev):
    """Hilbert-sorted clouds (f16 on the wire) and their cached FPS indices,
    as the packed store with the fps geometry wire delivers them."""
    from ..models.pointtransformer import SCENEMAP_NSAMPLES, SCENEMAP_STRIDES
    from ..ops.curves import curve_order
    from ..ops.hierarchy import build_point_hierarchy

    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    pts = np.stack([p[curve_order(p, "hilbert")] for p in pts])
    with torch.no_grad():
        levels = build_point_hierarchy(torch.from_numpy(pts).to(dev), SCENEMAP_STRIDES,
                                       SCENEMAP_NSAMPLES, with_up=False, sort_fps=True)
    cond = {f"geo_sm{li}_fps_idx": lvl.fps_idx.to(torch.int16)
            for li, lvl in enumerate(levels) if lvl.fps_idx is not None}
    cond["c_pc_xyz"] = torch.from_numpy(pts.astype(np.float16)).to(dev)
    return cond


def main(out_dir: str = "build/profile", banded: bool = False) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_step runs only on a CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(2023)
    model = CMDM(motion_dim=D, dtype=torch.bfloat16, dropout=0.1).to(dev)
    diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}), dev)
    state = TrainState.create(model, lr=1e-4)
    step = make_train_step(model, diffusion)
    rng = np.random.default_rng(2023)
    x_mask = np.arange(L)[None, :] >= rng.integers(40, L + 1, size=(B, 1))
    if banded:
        model.use_banded = True
        cond = _banded_batch(rng, dev)
    else:
        cond = {"c_pc_xyz":
                torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float16)).to(dev)}
    cond.update({
        "c_pc_contact": torch.from_numpy(rng.uniform(size=(B, N, 6)).astype(np.float16)).to(dev),
        "text_emb": torch.from_numpy(rng.normal(size=(B, 1, 512)).astype(np.float32)).to(dev),
        "x_mask": torch.from_numpy(x_mask).to(dev),
    })
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    for i in range(3):
        step(state, x, cond, seed=i)

    # (1) the parts of a step, each to a synchronize
    parts = {"hierarchy": [], "forward+loss": [], "backward": [], "optimizer": []}
    for i in range(5):
        model.train()
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        set_dropout_generator(model, gen)
        t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
        cond_h, ms = _sync_time(lambda: add_hierarchies(model, cond))
        parts["hierarchy"].append(ms)
        loss, ms = _sync_time(lambda: diffusion.training_losses(
            lambda x_t, ts: model(x_t, ts, cond_h), x, t, generator=gen,
            x_mask=cond_h["x_mask"])["loss"].mean())
        parts["forward+loss"].append(ms)
        state.optimizer.zero_grad(set_to_none=True)
        _, ms = _sync_time(loss.backward)
        parts["backward"].append(ms)
        for group in state.optimizer.param_groups:
            group["lr"] = annealed_lr(state.lr, state.step, state.lr_anneal_steps)
        _, ms = _sync_time(state.optimizer.step)
        parts["optimizer"].append(ms)
    lines = [f"{'banded' if banded else 'non-banded'} step: parts of one step, ms to a "
             "synchronize (5 steps: min / mean / max):"]
    for name, v in parts.items():
        lines.append(f"  {name}: {min(v):.3f} / {np.mean(v):.3f} / {max(v):.3f}")
    whole = [_sync_time(lambda i=i: step(state, x, cond, seed=200 + i))[1] for i in range(5)]
    lines.append(f"  whole step: {min(whole):.3f} / {np.mean(whole):.3f} / {max(whole):.3f}")

    # (2) one traced step
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_ms = _sync_time(lambda: step(state, x, cond, seed=300))
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and "cuda" in str(e.device_type).lower()]
    if not events:
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
    total = sum(e.self_device_time_total for e in events) / 1e3
    count = sum(e.count for e in events)
    lines.append(f"traced step: {traced_ms:.3f} ms wall with the profiler on, "
                 f"{total:.3f} ms of device kernels in {count} launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:30]:
        lines.append(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:110]}")
    text = "\n".join(lines)
    print(text, flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = "profile_train_step_banded.txt" if banded else "profile_train_step.txt"
    (out / name).write_text(text + "\n")


if __name__ == "__main__":
    _args = [a for a in sys.argv[1:] if a != "--banded"]
    main(*_args[:1], banded="--banded" in sys.argv[1:])

"""Where one full-width train step's time goes on the card:

    python -m afford_motion_torch.tools.profile_train_step [out_dir]
        [--banded | --store | --flash] [--dtype bfloat16 | float32]

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
the table goes to ``profile_train_step_banded.txt``. With ``--store`` it
profiles the step as the loop runs it on the device store
(``train/device_store.py``): the same sorted clouds, motions of 40..196
frames and contacts held in a store on the card, the whole hierarchy cached
at upload, and each step assembling its batch on the card from an index
batch of random items and crops; the parts are the assembly, the hierarchy
from the cache, forward with loss, backward and the optimizer, and the table
goes to ``profile_train_step_store.txt``. With ``--flash`` the model
has dropout 0 and every step is taken twice, with ``AM_FLASH_ATTN=1`` (the
fused attention's kernels, forward and backward) and ``0`` (the einsum
route), in turns; besides the whole and the traced steps it times one
layer's attention, forward and backward, at the step's shape each way with
``chip_smoke.time_ms``, and sums the fused kernels' device time in the
traced step; the table goes to ``profile_train_step_flash.txt``. ``--dtype
float32`` builds the model in float32 (the config's reference-parity dtype)
instead of the train config's bf16; with ``--flash`` that routes every layer
through the f32 forward and backward kernels, and the table goes to
``profile_train_step_flash_float32.txt``.
"""
from __future__ import annotations

import argparse
import subprocess
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


def _store_batch(rng, dev, model):
    """A device store of B items on the card, as the loop builds it from a
    prepared tree (sorted clouds with their cached FPS indices, f16 motions
    of 40..196 frames, f16 distances), its hierarchy cached at upload, and
    one index batch of random items and crops: (assemble, index batch)."""
    from ..train.device_store import DeviceStore, make_assemble_fn

    wire = _banded_batch(rng, dev)
    wire["xyz16"] = wire.pop("c_pc_xyz")
    lengths = rng.integers(40, L + 1, size=B).astype(np.int32)
    motion16 = rng.normal(size=(B, L, D)).astype(np.float16)
    motion16[np.arange(L)[None, :] >= lengths[:, None]] = 0
    arrays = {"motion16": motion16, "length": lengths,
              "scene_row": np.arange(B, dtype=np.int32),
              "dist16": rng.uniform(0, 2, size=(B, N, 6)).astype(np.float16),
              **{k: v.cpu().numpy() for k, v in wire.items()}}
    meta = {"kind": "h3d", "n_items": B, "max_horizon": L, "unit_length": 4, "sigma": 0.5,
            "use_raw_dist": False, "motion_dim": D, "mix": False, "flag_chain": []}
    store = DeviceStore(arrays, meta)
    if not store.add_geometry_cache(model, dev):
        raise RuntimeError("the store's geometry cache was not built")
    assemble = make_assemble_fn(store, dev)
    crop_len = (lengths // 4) * 4
    batch = {"item_row": rng.permutation(B).astype(np.int32),
             "text_emb": rng.normal(size=(B, 1, 512)).astype(np.float16)}
    batch["crop_len"] = crop_len[batch["item_row"]]
    batch["crop_start"] = rng.integers(0, lengths[batch["item_row"]] - batch["crop_len"] + 1
                                       ).astype(np.int32)
    return assemble, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _attention_alone(smoke, model, x_mask, dev) -> list:
    """One layer's attention at the step's shape (batch 32, 1 + 1 + 128 + 196
    tokens, the motions' padding masked) in the model's type, forward and
    backward, fused and einsum, by ``chip_smoke.time_ms``: lines of the
    table."""
    from ..models import layers
    from ..ops.cuda.attention import attention_cuda

    mha = model.self_attn_layer.layers[0].self_attn
    heads, width = mha.num_heads, mha.d_model
    seq = 2 + 128 + L
    gen = torch.Generator(device=dev).manual_seed(7)
    dtype = model.dtype
    q, k, v = (torch.randn(B, seq, width, device=dev, generator=gen).to(dtype)
               .requires_grad_(True) for _ in range(3))
    do = torch.randn(B, seq, width, device=dev, generator=gen).to(dtype)
    pad = torch.cat([torch.zeros((B, seq - L), dtype=torch.bool, device=dev), x_mask], dim=1)
    routes = {"fused": lambda: attention_cuda(q, k, v, heads, pad),
              "einsum": lambda: layers._attention(q, k, v, heads, pad, mha.dropout)}
    lines = [f"one layer's attention ({B},{seq},{heads}x{width // heads}) {str(dtype)[6:]}, "
             f"ms per call "
             f"(chip_smoke.time_ms: median of {smoke.TIME_BLOCKS} blocks of 20 calls):"]
    for name, fwd in routes.items():
        with torch.no_grad():
            f_ms = smoke.time_ms(fwd, 20)[0]
        out = fwd()
        b_ms = smoke.time_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True),
                             20)[0]
        lines.append(f"  {name}: forward {f_ms:.4f}, backward {b_ms:.4f}, both {f_ms + b_ms:.4f}; "
                     f"x {len(model.self_attn_layer.layers)} layers a step: "
                     f"{len(model.self_attn_layer.layers) * (f_ms + b_ms):.4f}")
    return lines


def _traced(step, state, x, cond, seed: int):
    """One traced step: (wall ms, device ms, launches, [(ms, count, name)]).
    Ranges the profiler marks as user annotations (the optimizer's step) are
    left out: their device time is that of the kernels inside them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, traced_ms = _sync_time(lambda: step(state, x, cond, seed=seed))
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    cuda = [e for e in events if "cuda" in str(e.device_type).lower()]
    events = cuda or events
    total = sum(e.self_device_time_total for e in events) / 1e3
    count = sum(e.count for e in events)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events),
                  key=lambda r: -r[0])
    return traced_ms, total, count, rows


def main(out_dir: str = "build/profile", banded: bool = False, flash: bool = False,
         dtype: str = "bfloat16", store: bool = False) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_step runs only on a CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(2023)
    model = CMDM(motion_dim=D, dtype=getattr(torch, dtype),
                 dropout=0.0 if flash else 0.1).to(dev)
    diffusion = create_gaussian_diffusion(DictConfig({"steps": 1000}), dev)
    state = TrainState.create(model, lr=1e-4)
    rng = np.random.default_rng(2023)
    assemble = None
    if store:
        model.use_banded = True
        assemble, batch = _store_batch(rng, dev, model)
        x = None
        cond = batch
    else:
        x_mask = np.arange(L)[None, :] >= rng.integers(40, L + 1, size=(B, 1))
        if banded:
            model.use_banded = True
            cond = _banded_batch(rng, dev)
        else:
            cond = {"c_pc_xyz":
                    torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float16)).to(dev)}
        cond.update({
            "c_pc_contact": torch.from_numpy(rng.uniform(size=(B, N, 6)).astype(np.float16)
                                             ).to(dev),
            "text_emb": torch.from_numpy(rng.normal(size=(B, 1, 512)).astype(np.float32)
                                         ).to(dev),
            "x_mask": torch.from_numpy(x_mask).to(dev),
        })
        x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    step = make_train_step(model, diffusion, assemble=assemble)
    if flash:
        text = "\n".join([f"model in {dtype}"]
                         + _flash_table(model, step, state, x, cond, diffusion, dev))
        print(text, flush=True)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        name = "profile_train_step_flash" + ("_float32" if dtype == "float32" else "")
        (out / f"{name}.txt").write_text(text + "\n")
        return
    for i in range(3):
        step(state, x, cond, seed=i)

    # (1) the parts of a step, each to a synchronize
    parts = {"assemble": [], "hierarchy": [], "forward+loss": [], "backward": [],
             "optimizer": []}
    if assemble is None:
        del parts["assemble"]
    for i in range(5):
        model.train()
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        set_dropout_generator(model, gen)
        t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
        x_i, cond_i = x, cond
        if assemble is not None:
            (x_i, cond_i), ms = _sync_time(lambda: assemble(cond))
            parts["assemble"].append(ms)
            x_i = x_i.float()
        cond_h, ms = _sync_time(lambda: add_hierarchies(model, cond_i))
        parts["hierarchy"].append(ms)
        loss, ms = _sync_time(lambda: diffusion.training_losses(
            lambda x_t, ts: model(x_t, ts, cond_h), x_i, t, generator=gen,
            x_mask=cond_h["x_mask"])["loss"].mean())
        parts["forward+loss"].append(ms)
        state.optimizer.zero_grad(set_to_none=True)
        _, ms = _sync_time(loss.backward)
        parts["backward"].append(ms)
        for group in state.optimizer.param_groups:
            group["lr"] = annealed_lr(state.lr, state.step, state.lr_anneal_steps)
        _, ms = _sync_time(state.optimizer.step)
        parts["optimizer"].append(ms)
    route = "store" if store else "banded" if banded else "non-banded"
    lines = [f"{route} step: parts of one step, ms to a synchronize (5 steps: min / mean / max):"]
    for name, v in parts.items():
        lines.append(f"  {name}: {min(v):.3f} / {np.mean(v):.3f} / {max(v):.3f}")
    whole = [_sync_time(lambda i=i: step(state, x, cond, seed=200 + i))[1] for i in range(5)]
    lines.append(f"  whole step: {min(whole):.3f} / {np.mean(whole):.3f} / {max(whole):.3f}")

    # (2) one traced step
    traced_ms, total, count, rows = _traced(step, state, x, cond, 300)
    lines.append(f"traced step: {traced_ms:.3f} ms wall with the profiler on, "
                 f"{total:.3f} ms of device kernels in {count} launches")
    for ms, n, key in rows[:30]:
        lines.append(f"  {ms:9.3f} ms  {n:5d}x  {key[:110]}")
    text = "\n".join(lines)
    print(text, flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = {"store": "profile_train_step_store.txt", "banded": "profile_train_step_banded.txt",
            "non-banded": "profile_train_step.txt"}[route]
    (out / name).write_text(text + "\n")


def _flash_table(model, step, state, x, cond, diffusion, dev) -> list:
    """The --flash table: whole steps and traced steps with AM_FLASH_ATTN=1
    and 0 in turns, and one layer's attention alone each way."""
    from .kernel_ab import _smoke

    smoke = _smoke()
    for i in range(3):
        for value in ("1", "0"):
            with smoke.flash_switch(value):
                step(state, x, cond, seed=i)
    whole = {"1": [], "0": []}
    for i in range(4):
        for value in ("1", "0") if i % 2 == 0 else ("0", "1"):
            with smoke.flash_switch(value):
                whole[value].append(_sync_time(lambda: step(state, x, cond, seed=200 + i))[1])
    lines = ["dropout 0; whole step, ms to a synchronize (4 steps each way, in turns: "
             "min / mean / max):"]
    for value, v in whole.items():
        lines.append(f"  AM_FLASH_ATTN={value}: {min(v):.3f} / {np.mean(v):.3f} / {max(v):.3f}")
    for value in ("1", "0", "1", "0"):
        with smoke.flash_switch(value):
            traced_ms, total, count, rows = _traced(step, state, x, cond, 300)
        fused = [(ms, n, key) for ms, n, key in rows if "attention" in key and "_kernel" in key]
        lines.append(f"traced step, AM_FLASH_ATTN={value}: {traced_ms:.3f} ms wall with the "
                     f"profiler on, {total:.3f} ms of device kernels in {count} launches; the "
                     f"fused attention's kernels {sum(r[0] for r in fused):.3f} ms")
        for ms, n, key in fused:
            lines.append(f"  {ms:9.3f} ms  {n:5d}x  {key[:110]}")
    for ms, n, key in rows[:12]:   # the einsum route's largest kernels
        lines.append(f"  einsum route: {ms:9.3f} ms  {n:5d}x  {key[:100]}")
    return lines + _attention_alone(smoke, model, cond["x_mask"], dev)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="build/profile")
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--store", action="store_true")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    main(args.out_dir, banded=args.banded, flash=args.flash, dtype=args.dtype, store=args.store)
